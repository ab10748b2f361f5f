"""The plain reference, stage by stage, and the numbers that compare the
program's answers with it.

Each stage starts from the recorded inputs (the bag or the KITTI files) and,
where a SLAM stage can only be followed from the state the program built
before it (the map a scan is registered against, the pose graph a solve
starts from), from that state; it works out again whatever the program
derived.  Every answer is judged by what it says:

* decode: the frontend's cloud against the raw bytes, lane by lane;
* scan registration: the reference decodes, deskews (constant velocity from
  the last odometry poses, per-point time) and voxelizes the sweep itself,
  crops the map patch from the program's table as it stood before the scan
  (its voxel means; the normals are the reference's own, from those means),
  and runs point-to-plane ICP to convergence from the program's pose; the
  gap is how far that moves a point 30 m out;
* map insertion: the reference's voxels of the scan at the reference's pose
  against the weights the program's table gained in the call;
* scan-to-scan odometry: GICP of the reference's own clouds from the
  configuration's start (the identity), stopped by the configuration's
  differential checker;
* the pose-graph solve: the same graph (the program's constraints and
  starting poses) solved to convergence by Levenberg-Marquardt with a
  numerical Jacobian in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import bagfile
from . import geometry, se3

LEVER_M = 30.0  # a pose gap is how far it moves a point this far out


# -- decode --------------------------------------------------------------------

def bag_index(path: str, cloud_topic: str, odom_topic: str):
    """The bag's clouds (raw messages) and their header stamps in order, and
    its odometry as sorted stamps with f64 poses."""
    clouds, cloud_stamps, stamps, poses = [], [], [], []
    for topic, _, raw in bagfile.read_messages(path, {cloud_topic, odom_topic}):
        if topic == cloud_topic:
            clouds.append(raw)
            cloud_stamps.append(bagfile.message_stamp(raw))
        else:
            stamp, pos, quat = bagfile.decode_odometry(raw)
            T = np.eye(4)
            T[:3, :3] = se3.quaternion_to_matrix(*quat).numpy()
            T[:3, 3] = pos
            stamps.append(stamp)
            poses.append(T)
    order = np.argsort(stamps, kind="stable")
    return clouds, np.asarray(cloud_stamps), np.asarray(stamps)[order], np.stack(poses)[order]


def decode_bag_cloud(raw):
    """(stamp, xyz f32[n, 3], t f32[n] seconds from the sweep's first point)."""
    stamp, cols = bagfile.decode_pointcloud2(raw)
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float32)
    t = cols["t"].astype(np.float64)
    t = ((t - t.min()) / 1e9).astype(np.float32)
    return stamp, xyz, t


def decode_kitti_scan(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3].copy()


def lanes_off(cloud, xyz: np.ndarray, t) -> int:
    """Lanes of the program's cloud that disagree with the reference's
    decoding: a point moved by a single bit, a time more than 0.1 us off, a
    valid lane too many or too few."""
    mask = cloud.mask.cpu().numpy()
    got = cloud.xyz.cpu().numpy()
    n = xyz.shape[0]
    off = int((~mask[:n]).sum()) + int(mask[n:].sum()) + max(n - mask.shape[0], 0)
    m = min(n, mask.shape[0])
    bad = (got[:m].view(np.uint32) != xyz[:m].view(np.uint32)).any(-1)
    if t is not None:
        names = list(cloud.attr_names or ())
        if "t" not in names:
            return off + m
        got_t = cloud.attrs[:, names.index("t")].cpu().numpy()[:m]
        bad |= np.abs(got_t.astype(np.float64) - t[:m]) > 1e-7
    return off + int((bad & mask[:m]).sum())


# -- odometry lookups and deskew -------------------------------------------------

def lookup(stamps: np.ndarray, poses: np.ndarray, t: float) -> np.ndarray:
    """The odometry at ``t``: slerp and lerp between the bracketing poses."""
    i = int(np.searchsorted(stamps, t))
    for j in (i - 1, i):
        if 0 <= j < len(stamps) and abs(stamps[j] - t) < 1e-9:
            return poses[j]
    i = min(max(i, 1), len(stamps) - 1)
    a = (t - stamps[i - 1]) / (stamps[i] - stamps[i - 1])
    T0, T1 = torch.as_tensor(poses[i - 1]), torch.as_tensor(poses[i])
    rel = se3.inverse(T0) @ T1
    R = T0[:3, :3] @ se3.so3_exp(a * se3.so3_log(rel[:3, :3]))
    out = np.eye(4)
    out[:3, :3] = R.numpy()
    out[:3, 3] = ((1 - a) * T0[:3, 3] + a * T1[:3, 3]).numpy()
    return out


def deskew_twist(frame_poses: list, frame_times: list, period_s: float) -> np.ndarray:
    """Constant velocity over the given poses (oldest first), scaled to one
    sweep: the configuration's motion compensation."""
    if len(frame_poses) < 2:
        return np.zeros(6)
    dt = max(frame_times[-1] - frame_times[0], 1e-6)
    rel = np.linalg.inv(frame_poses[0]) @ frame_poses[-1]
    return se3.se3_log(torch.as_tensor(rel)).numpy() * (period_s / dt)


def deskew(xyz: torch.Tensor, t: torch.Tensor, twist: np.ndarray) -> torch.Tensor:
    """Move each point to the sweep's end: exp((t / t_max - 1) twist) p."""
    phase = torch.clamp(t.double() / max(float(t.max()), 1e-6), 0.0, 1.0)
    T = se3.se3_exp((phase - 1.0)[:, None] * torch.as_tensor(twist, device=xyz.device)[None])
    return (T[:, :3, :3] @ xyz.double()[:, :, None])[:, :, 0] + T[:, :3, 3]


# -- the map -------------------------------------------------------------------------

def table_voxels(vmap, cell: float):
    """(keys i64[V, 3], weights, means f64[V, 3], unit normals) of a table's
    occupied voxels, keyed by their means."""
    acc = vmap.acc.double()
    w = acc[:, 6]
    occ = (vmap.ptable != vmap.ptable.new_tensor(2 ** 31 - 1)) & (w > 0)
    acc, w = acc[occ], w[occ]
    means = acc[:, :3] / w[:, None]
    nrm = acc[:, 3:6]
    nlen = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    nrm = torch.where(nlen > 1e-6, nrm / nlen.clamp(min=1e-12), 0.0)
    return geometry.voxel_keys(means.float(), cell), w, means, nrm


def patch(vmap, center: torch.Tensor, radius: float, capacity: int, cell: float,
          normal_radius: float):
    """The map points within ``radius`` of ``center``, the first
    ``capacity`` of them in the table's slot order (the configuration's
    fixed-size map patch), with normals of the reference's own: each the
    least eigenvector of the table's means within ``normal_radius``."""
    _, _, means, _ = table_voxels(vmap, cell)
    dist = torch.linalg.vector_norm(means - center, dim=-1)
    near = means[dist <= radius + normal_radius]
    nrm = geometry.radius_normals(near, normal_radius)
    keep = dist[dist <= radius + normal_radius] <= radius
    return near[keep][:capacity], nrm[keep][:capacity]


def key_counts(keys: torch.Tensor, weights: torch.Tensor):
    uk, inv = torch.unique(keys, dim=0, return_inverse=True)
    return uk, torch.zeros(uk.shape[0], dtype=torch.float64,
                           device=keys.device).index_add_(0, inv, weights.double())


def gained(before, after, cell: float):
    """The weight each voxel gained between two tables."""
    kb, wb, _, _ = table_voxels(before, cell)
    ka, wa, _, _ = table_voxels(after, cell)
    keys = torch.cat([ka, kb])
    return key_counts(keys, torch.cat([wa, -wb]))


def miss_pct(expected_keys: torch.Tensor, got_keys: torch.Tensor,
             got_weights: torch.Tensor) -> float:
    """Points of the scan that did not land in their voxel, in percent:
    half the summed difference of the two voxel histograms over the scan's
    points."""
    keys = torch.cat([expected_keys, got_keys])
    w = torch.cat([torch.ones(expected_keys.shape[0], dtype=torch.float64,
                              device=expected_keys.device), -got_weights.double()])
    _, diff = key_counts(keys, w)
    return float(diff.abs().sum() / 2.0 / max(expected_keys.shape[0], 1) * 100.0)


# -- GICP ------------------------------------------------------------------------------

def _disk(n: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    return torch.eye(3, dtype=n.dtype, device=n.device) - (1.0 - eps) * n[:, :, None] * n[:, None, :]


def gicp(src: torch.Tensor, src_n: torch.Tensor, ref: torch.Tensor, ref_n: torch.Tensor,
         T0: torch.Tensor, icp: dict) -> torch.Tensor:
    """Generalized ICP as the configuration runs it (libpointmatcher's loop
    with Open3D's GICP model): each trip matches every point to its nearest
    reference point within ``match_m``, keeps matches at or below the
    ``trimmed_ratio`` quantile, weighs each residual by (C_src + C_ref +
    1e-6 I)^-1 (a point's covariance a disk with variance 1e-3 along its
    normal) and takes the Gauss-Newton step about the reference centroid
    (relative damping ``damping`` x trace / 6).  The differential checker
    stops the loop once the mean rotation and translation steps of the
    last ``smooth`` trips fall below ``min_rot`` and ``min_trans``, or
    after ``max_trips``."""
    T = T0.double().clone()
    src, src_n, ref, ref_n = src.double(), src_n.double(), ref.double(), ref_n.double()
    k = min(int(icp["trimmed_ratio"] * src.shape[0]), src.shape[0] - 1)
    eye = torch.eye(3, dtype=torch.float64, device=src.device)
    center = ref.mean(0)
    shift = torch.eye(4, dtype=torch.float64, device=src.device)
    shift[:3, 3] = center
    ring = [(float("inf"), float("inf"))] * icp["smooth"]
    for trip in range(icp["max_trips"]):
        if (trip >= icp["smooth"] and sum(r for r, _ in ring) / len(ring) < icp["min_rot"]
                and sum(t for _, t in ring) / len(ring) < icp["min_trans"]):
            break
        p = se3.apply(T, src)
        pn = src_n @ T[:3, :3].T
        idx, d2 = geometry.nearest(p, ref, icp["match_m"])
        thresh = torch.sort(d2).values[k]
        keep = torch.isfinite(d2) & (d2 <= thresh)
        pk, q = p[keep] - center, ref[idx][keep] - center
        M = torch.linalg.inv(_disk(pn[keep]) + _disk(ref_n[idx][keep]) + 1e-6 * eye)
        J = torch.cat([-se3.hat(pk), eye.expand(pk.shape[0], 3, 3)], -1)
        MJ = M @ J
        H = torch.einsum("nij,nik->jk", J, MJ)
        H = H + icp["damping"] * torch.trace(H) / 6.0 * torch.eye(6, dtype=H.dtype,
                                                                 device=H.device)
        xi = torch.linalg.solve(H, -torch.einsum("nij,ni->j", MJ, pk - q))
        T = shift @ se3.se3_exp(xi) @ se3.inverse(shift) @ T
        ring = [(float(xi[:3].norm()), float(xi[3:].norm()))] + ring[:-1]
    return T


def odometry_motion(src, src_n, ref, ref_n, o: dict) -> torch.Tensor:
    """The scan-to-scan odometry's motion as the configuration makes it
    (Odometry.cpp): GICP from the identity; a step longer than
    ``max_step_m`` or with fewer than ``min_fitness`` of the points matched
    is rejected for the identity."""
    eye = torch.eye(4, dtype=torch.float64, device=src.device)
    T = gicp(src, src_n, ref, ref_n, eye, o)
    _, d2 = geometry.nearest(se3.apply(T, src.double()), ref, o["match_m"])
    fitness = float(torch.isfinite(d2).double().mean())
    if float(T[:3, 3].norm()) > o["max_step_m"] or fitness < o["min_fitness"]:
        return eye
    return T


# -- pose graph --------------------------------------------------------------------------

def solve_graph(node_poses: list, constraints: list, preference: float, reference_node: int,
                iterations: int = 300) -> np.ndarray:
    """The pose graph solved to convergence: certain edges and switchable
    uncertain ones, s = (phi / (phi + chi2))^2 with phi the preference times
    the mean diagonal information, cost sum s chi2 + phi (1 - sqrt s)^2 over
    the switchable edges; nodes move by right perturbations, the reference
    node is pinned.  Returns f64[N, 4, 4]."""
    X0 = torch.as_tensor(np.stack(node_poses), dtype=torch.float64)
    N = X0.shape[0]
    src = torch.tensor([c[0] for c in constraints])
    dst = torch.tensor([c[1] for c in constraints])
    Tm_inv = se3.inverse(torch.as_tensor(np.stack([c[2] for c in constraints])))
    info = torch.as_tensor(np.stack([c[3] for c in constraints]))
    unc = torch.tensor([bool(c[4]) for c in constraints])
    phi = preference * max(float(torch.diagonal(info, dim1=-2, dim2=-1).mean()), 1e-6)
    free = [i for i in range(N) if i != reference_node]

    def residuals(d):
        X = X0 @ se3.se3_exp(d)
        return se3.se3_log(Tm_inv @ se3.inverse(X[src]) @ X[dst])

    def weights(r):
        chi2 = torch.einsum("ei,eij,ej->e", r, info, r)
        return chi2, torch.where(unc, (phi / (phi + chi2)) ** 2, torch.ones_like(chi2))

    def cost(d):
        chi2, s = weights(residuals(d))
        return float((s * chi2).sum() + torch.where(unc, phi * (1 - torch.sqrt(s)) ** 2,
                                                     torch.zeros_like(s)).sum())

    d = torch.zeros((N, 6), dtype=torch.float64)
    lam, c = 1e-6, cost(d)
    for _ in range(iterations):
        r = residuals(d)
        _, s = weights(r)
        J = torch.zeros((r.numel(), 6 * len(free)), dtype=torch.float64)
        for a, node in enumerate(free):
            for j in range(6):
                e = torch.zeros_like(d)
                e[node, j] = 1e-6
                J[:, 6 * a + j] = ((residuals(d + e) - residuals(d - e)) / 2e-6).reshape(-1)
        W = torch.block_diag(*(s[:, None, None] * info))
        H = J.T @ W @ J
        g = -(J.T @ W @ r.reshape(-1))
        while True:
            step = torch.linalg.solve(H + lam * torch.diag(torch.diagonal(H).clamp(min=1e-12)), g)
            d_new = d.clone()
            d_new[free] += step.reshape(len(free), 6)
            c_new = cost(d_new)
            if c_new <= c:
                break
            lam *= 10.0
            if lam > 1e12:
                return (X0 @ se3.se3_exp(d)).numpy()
        converged = float(torch.linalg.vector_norm(step)) < 1e-12 or c - c_new <= 1e-15 * max(c, 1e-30)
        d, c, lam = d_new, c_new, max(lam / 10.0, 1e-12)
        if converged:
            break
    return (X0 @ se3.se3_exp(d)).numpy()


def graph_gap(X_prog: np.ndarray, X_ref: np.ndarray) -> float:
    return float(se3.pose_gap(torch.as_tensor(X_prog), torch.as_tensor(X_ref), LEVER_M).max())
