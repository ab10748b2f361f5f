"""Inspectors: per-iteration tracing and performance statistics of ICP.

Counterpart of the JAX package's ``ops/registration/inspectors.py``
(reference pointmatcher/InspectorsImpl.{h,cpp}: PerformanceInspector
accumulates named statistics; VTKFileInspector dumps every ICP iteration's
clouds to VTK files, selected in ros/open3d_slam_ros/param/icp.yaml:39-41).

``register_trace`` runs ``max_iterations`` trips of the production
``icp.iteration_step`` with no early stop, keeps every iterate on the
device and reads the trace back once, as the JAX package's ``lax.scan``
program does (``inspectors.py:51-69``); the host then writes the dumps.
"""
from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Dict, List

import numpy as np
import torch

from ...utils.device import to_device
from ...utils.pointcloud import PointCloud
from ..hashgrid import HashGrid
from .icp import ICPConfig, iteration_step, prepare_reference, reference_centroid


@dataclasses.dataclass(frozen=True)
class ICPTrace:
    """Per-iteration registration trace (``max_iterations`` entries, host
    arrays); transforms[i] is the pose AFTER iteration i."""

    transforms: np.ndarray    # [I, 4, 4]
    rot_deltas: np.ndarray    # [I]
    trans_deltas: np.ndarray  # [I]
    match_ratios: np.ndarray  # [I]
    rmses: np.ndarray         # [I]


def register_trace(source: PointCloud, ref_grid: HashGrid, init_T,
                   cfg: ICPConfig = ICPConfig()) -> ICPTrace:
    """``max_iterations`` ICP steps, every iterate recorded: the math of
    ``icp.register`` (the shared ``iteration_step``) without its stopping
    tests; one readback at the end."""
    centroid = reference_centroid(ref_grid)
    nn_ref = prepare_reference(cfg, ref_grid)
    T = to_device(init_T, source.device)
    rows = []
    for _ in range(cfg.max_iterations):
        T, rd, td, mr, rmse = iteration_step(cfg, source, ref_grid, centroid, T, nn_ref)
        rows.append(torch.cat([T.reshape(16), torch.stack([rd, td, mr, rmse])]))
    host = torch.stack(rows).cpu().numpy()
    return ICPTrace(transforms=host[:, :16].reshape(-1, 4, 4), rot_deltas=host[:, 16],
                    trans_deltas=host[:, 17], match_ratios=host[:, 18], rmses=host[:, 19])


def dump_iterations(source: PointCloud, ref_grid: HashGrid, init_T, cfg: ICPConfig,
                    out_dir: str, prefix: str = "icp", fmt: str = "vtk") -> List[str]:
    """Write every iteration's transformed reading cloud and a statistics
    table (≙ VTKFileInspector::dumpIteration): ``<prefix>-reading-0000.vtk``
    ... and ``<prefix>-stats.csv``.  Returns the paths written."""
    from ...utils import io as cloud_io

    trace = register_trace(source, ref_grid, init_T, cfg)
    os.makedirs(out_dir, exist_ok=True)
    host = source.to("cpu")
    paths: List[str] = []
    for i, T in enumerate(trace.transforms):
        moved = host.transform(torch.from_numpy(T))
        p = os.path.join(out_dir, f"{prefix}-reading-{i:04d}.{fmt}")
        cloud_io.save_vtk(p, moved) if fmt == "vtk" else cloud_io.save_cloud(p, moved)
        paths.append(p)
    stats_path = os.path.join(out_dir, f"{prefix}-stats.csv")
    with open(stats_path, "w") as f:
        f.write("iteration,rot_delta,trans_delta,match_ratio,rmse\n")
        for i in range(len(trace.transforms)):
            f.write(f"{i},{float(trace.rot_deltas[i]):.8f},"
                    f"{float(trace.trans_deltas[i]):.8f},"
                    f"{float(trace.match_ratios[i]):.6f},"
                    f"{float(trace.rmses[i]):.6f}\n")
    paths.append(stats_path)
    return paths


class PerformanceInspector:
    """Named-statistic accumulator (≙ PerformanceInspector::addStat /
    dumpStats): wraps registration calls and records wall time (to the
    result's readback), iterations, match ratio and RMSE."""

    def __init__(self):
        self.stats: Dict[str, List[float]] = {}

    def add_stat(self, name: str, value: float) -> None:
        self.stats.setdefault(name, []).append(float(value))

    def wrap(self, fn):
        """Wrap a registration callable; records its duration and result."""

        def wrapped(*args, **kwargs):
            t0 = _time.perf_counter()
            res = fn(*args, **kwargs)
            r = res[0] if isinstance(res, tuple) else res
            vals = torch.stack([r.iterations.to(torch.float32), r.match_ratio.float(),
                                r.rmse.float()]).cpu().tolist()
            self.add_stat("duration_s", _time.perf_counter() - t0)
            for name, v in zip(("iterations", "match_ratio", "rmse"), vals):
                self.add_stat(name, v)
            return res

        return wrapped

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.stats.items():
            arr = np.asarray(vals)
            out[name] = {"count": int(arr.size), "mean": float(arr.mean()),
                         "min": float(arr.min()), "max": float(arr.max())}
        return out

    def dump_stats(self) -> str:
        return "\n".join(f"{k}: n={v['count']} mean={v['mean']:.6f} "
                         f"min={v['min']:.6f} max={v['max']:.6f}"
                         for k, v in self.summary().items())
