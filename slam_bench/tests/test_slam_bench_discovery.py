"""A cell, a configuration, a traffic mix and a metric are found by adding
files and manifest entries alone."""
import json
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slam_bench import harness, spec  # noqa: E402


def test_a_new_cell_config_traffic_and_metric_are_found_from_files(tmp_path):
    shutil.copytree(ROOT / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "slam_bench/configs/os1-32-bag.json").read_text())
    config["name"] = "os1-64-bag"
    config["sensor"]["rings"] = 64
    (tmp_path / "slam_bench/configs/os1-64-bag.json").write_text(json.dumps(config))
    traffic = json.loads((ROOT / "slam_bench/traffic/loop.json").read_text())
    traffic["path"]["radius_m"] = 9.0
    (tmp_path / "slam_bench/traffic/small-loop.json").write_text(json.dumps(traffic))
    (tmp_path / "slam_bench/metrics/scans_in_window.py").write_text(
        '"""Scans in the window."""\n\n\ndef read(ctx):\n    return len(ctx.window.step_s)\n')
    manifest["configs"].append({"name": "os1-64-bag", "source": "a test",
                                "file": "slam_bench/configs/os1-64-bag.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "os1-64-small-loop", "config": "os1-64-bag",
                                  "traffic": "small-loop", "chips": 1, "why": "a test"})
    manifest["per_layer"].append({"name": "scans_in_window", "unit": "scans", "better": "higher",
                                  "source": "host_clock", "layer": "device",
                                  "moves": "scans_per_s", "workloads": ["os1-64-small-loop"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = spec.cell("os1-64-small-loop", root=tmp_path)
    assert cell.config["sensor"]["rings"] == 64
    assert cell.traffic["path"]["radius_m"] == 9.0
    assert "scans_in_window" in [m["name"] for m in cell.per_layer]
    assert "scans_in_window" not in [m["name"] for m in spec.cell("os1-32-loop",
                                                                   root=tmp_path).per_layer]
    window = type("W", (), {"step_s": [0.1, 0.2, 0.3], "window_s": 1.0})()
    got = spec.read_metrics(cell.per_layer, harness.Context(window, 1.0), root=tmp_path)
    assert got == {"scans_in_window": {"value": 3.0, "unit": "scans"}}
    got = spec.read_metrics(cell.end_to_end, harness.Context(window, 2.5), root=tmp_path)
    assert got["scans_per_s"]["value"] == 3.0 and got["setup_s"]["value"] == 2.5
