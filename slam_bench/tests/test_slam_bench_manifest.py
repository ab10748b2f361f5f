"""``BENCHMARK.json`` against the benchmark's contract: names, units, the
layers' end-to-end metrics, and the files every entry names."""
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert MANIFEST["command"] == ["python3", "slam_bench/run.py"]
    assert MANIFEST["paths"] == ["slam_bench"]


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_exactly_their_keys(section):
    for entry in MANIFEST[section]:
        extra = set(entry) - KEYS[section] - ({"workloads"} if section in (
            "end_to_end", "per_layer") else set())
        assert not extra and KEYS[section] <= set(entry), (section, entry["name"])


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_names_units_and_readers(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "slam_bench" / "metrics" / f"{metric['name']}.py").is_file()
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert _line(metric["layer"])


def test_names_are_unique():
    for group in (METRICS, MANIFEST["workloads"], MANIFEST["configs"]):
        names = [m["name"] for m in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=[m["name"] for m in MANIFEST["per_layer"]])
def test_each_layer_metric_moves_a_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=CELLS)
def test_cells_name_their_files(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] == 1
    assert (ROOT / "slam_bench" / "traffic" / f"{cell['traffic']}.json").is_file()
    conf = {c["name"]: c for c in MANIFEST["configs"]}[cell["config"]]
    assert conf["file"].startswith("slam_bench/") and (ROOT / conf["file"]).is_file()
    reported = [m for m in MANIFEST["end_to_end"] if cell["name"] in m.get("workloads", CELLS)]
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert any(cell["name"] in m.get("workloads", CELLS) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("conf", MANIFEST["configs"], ids=[c["name"] for c in MANIFEST["configs"]])
def test_configs(conf):
    assert NAME.match(conf["name"]) and _line(conf["source"]) and _line(conf["why"])
    assert len(conf["reduced"]) <= 16 and all(NAME.match(k) for k in conf["reduced"])
    body = json.loads((ROOT / conf["file"]).read_text())
    assert body["name"] == conf["name"] and body["reduced"] == conf["reduced"]
    assert all(k in body for k in conf["reduced"])
    assert body["limits"]["decode_lanes_off"] == 0
    assert sum(c["file"] == conf["file"] for c in MANIFEST["configs"]) == 1
    assert any(w["config"] == conf["name"] for w in MANIFEST["workloads"])


def test_paths_hold_only_name_characters():
    for p in (ROOT / "slam_bench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
