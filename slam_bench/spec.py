"""The manifest and the files it names: a cell's configuration, its traffic
mix, the reader of each of its metrics and the extensions its configuration
lists, found by name."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: pathlib.Path = ROOT  # where the cell's files were found


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    manifest = load_manifest(root)
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / HERE.name / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if _reports(m, name) and m["moves"] in reported]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer, root)


def _load(path: pathlib.Path, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: pathlib.Path = ROOT):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    return _load(root / HERE.name / "metrics" / f"{metric}.py",
                 f"slam_bench_metric_{metric}").read


def extensions(config: dict, root: pathlib.Path = ROOT) -> Dict[str, ModuleType]:
    """The modules ``extensions/<name>.py`` of the names the configuration
    lists under ``"extensions"``, in its order (none where it lists none)."""
    out = {}
    for name in config.get("extensions", ()):
        path = root / HERE.name / "extensions" / f"{name}.py"
        if not path.is_file():
            raise SystemExit(f"configuration {config.get('name')!r} lists the extension "
                             f"{name!r}, and there is no {path}")
        out[name] = _load(path, f"slam_bench_extension_{name}")
    return out


def call(exts: Dict[str, ModuleType], hook: str, *args) -> Dict[str, object]:
    """``hook(*args)`` of each extension that defines it, by name."""
    return {name: getattr(m, hook)(*args) for name, m in exts.items() if hasattr(m, hook)}


def read_metrics(metrics: List[dict], ctx, root: pathlib.Path = ROOT) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
