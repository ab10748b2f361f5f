"""A configuration's extensions, found by name in a copy of the benchmark
and called at their points: ``prepare`` once, ``start`` in the warm-up and
in each mission, ``judge`` in the program's reading and in the control's;
a number of theirs needs its limit.  A configuration without them draws the
same seed streams and writes the same bytes.  A localization deployment is
built from extension files alone."""
import copy
import dataclasses
import hashlib
import pathlib
import shutil
import time

import numpy as np
import pytest
import torch

from slam_bench import checking, control, harness, session, spec, traffic_gen
from slam_bench.tests import recording_extension, tiny_cell

HERE = pathlib.Path(__file__).resolve().parent

SEED = 2 ** 31 + 4242
# The run tests' seed, on which the tiny cell's every number is inside its
# limit: there only the extension's number can make the run incorrect.
SOUND_SEED = 2 ** 31 + 12345
# The window, in readings of ``Ticks`` (one to start, one a mission, three
# a scan): the first mission whole and the first frames of a second, of the
# tiny cell's 8 scans and of the localization test's 6.
WINDOW, LOCALIZATION_WINDOW = 45.0, 30.0


class Ticks:
    """The window's clock, one second a reading: the window then holds the
    same frames on any host, however busy."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 1.0
        return self.now

    time_ns = staticmethod(time.time_ns)


@pytest.fixture
def ticks(monkeypatch):
    monkeypatch.setattr(session, "time", Ticks())


@pytest.fixture
def kept(monkeypatch):
    """The result of the test's ``harness.measure``, under ``"m"``."""
    out = {}
    measure = harness.measure

    def keeping(*args, **kwargs):
        out["m"] = measure(*args, **kwargs)
        return out["m"]

    monkeypatch.setattr(harness, "measure", keeping)
    return out


def installed(tmp_path, **extensions) -> spec.Cell:
    """The tiny cell in a copy of the benchmark that holds the given
    ``extensions/<name>.py``, its configuration listing them."""
    shutil.copytree(tiny_cell.ROOT / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "slam_bench" / "extensions").mkdir()
    for name, source in extensions.items():
        shutil.copy(HERE / source, tmp_path / "slam_bench" / "extensions" / f"{name}.py")
    c = tiny_cell.cell()
    c.root = tmp_path
    c.config["extensions"] = list(extensions)
    return c


def recording_cell(tmp_path, program: float) -> spec.Cell:
    c = installed(tmp_path, recording="recording_extension.py")
    c.config["recording"] = {"program": program, "control": 50.0}
    c.config["limits"]["recorded_number"] = 10.0
    return c


def test_each_hook_is_called_at_its_point(tmp_path, ticks, kept):
    c = recording_cell(tmp_path, program=1.0)
    row = control.read_seed(c, SEED, WINDOW, "cpu", str(tmp_path / "data"))
    m = kept["m"]
    calls = m.capture.extensions["recording"].CALLS
    by_hook = {hook: [args for h, args in calls if h == hook]
               for hook in ("prepare", "start", "judge")}

    (prepared,) = by_hook["prepare"]
    assert prepared["out_dir"] == m.data_dir and prepared["world_points"] > 0
    np.testing.assert_array_equal(prepared["truth"], m.seq.truth)
    stream = traffic_gen.seeds(SEED, traffic_gen.EXTENSION_STREAM + 1)[-1]
    assert prepared["draw"] == int(stream.generate_state(1)[0])
    assert m.seq.extras == {"recording": {"draw": prepared["draw"]}}

    # The warm-up's session and the window's two, the second cut by the
    # close; each start comes after the initial transform (the bag's first
    # odometry pose) and before the first scan.
    assert [x["complete"] for x in m.capture.missions] == [True, False]
    assert len(by_hook["start"]) == 3
    for started in by_hook["start"]:
        assert started["scans_taken"] == 0 and started["extras"] is m.seq.extras
        np.testing.assert_allclose(started["pose"], m.seq.truth[0], atol=1e-4)
    assert len(m.capture.scans) == c.traffic["check_scans"]

    assert by_hook["judge"] == [False, True]
    assert row["program"]["recorded_number"] == 1.0
    assert row["control"]["recorded_number"] == 50.0
    assert not checking.verdict(row["control"], c.config["limits"])[0]


def test_an_extension_number_past_its_limit_is_not_correct(tmp_path, ticks):
    c = recording_cell(tmp_path, program=11.0)
    r = harness.run_cell(c, SOUND_SEED, WINDOW, False, "cpu", time.perf_counter(),
                         data_root=str(tmp_path / "data"))
    assert r["correct"] is False
    assert r["check"]["recorded_number"] == {"value": 11.0, "limit": 10.0}
    others = {k: v for k, v in r["check"].items() if k != "recorded_number"}
    assert all(v["value"] <= v["limit"] for k, v in others.items() if k != "scans_judged")
    assert others["scans_judged"]["value"] >= others["scans_judged"]["limit"]


def test_an_extension_number_without_a_limit_is_refused(tmp_path):
    c = tiny_cell.cell()
    c.config["recording"] = {"program": 1.0, "control": 50.0}
    seq = traffic_gen.generate(c.config, c.traffic, SEED, str(tmp_path), "cpu")
    capture = session.Capture([], {"recording": recording_extension})
    with pytest.raises(ValueError, match="recorded_number"):
        checking.judge(capture, seq, c.config, "cpu")
    c.config["limits"]["recorded_number"] = 10.0
    assert checking.judge(capture, seq, c.config, "cpu")["recorded_number"] == 1.0


def _digest(root: pathlib.Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_an_extension_leaves_the_streams_and_the_sequence_as_they_were(tmp_path):
    plain, extended = traffic_gen.seeds(SEED, 4), traffic_gen.seeds(SEED, 6)
    for a, b in zip(plain, extended):
        assert (a.generate_state(4) == b.generate_state(4)).all()
    c = tiny_cell.cell()
    exts = {"recording": recording_extension}
    seqs = [traffic_gen.generate(c.config, c.traffic, SEED, str(tmp_path / name), "cpu", e)
            for name, e in (("plain", None), ("extended", exts))]
    assert seqs[0].extras == {} and set(seqs[1].extras) == {"recording"}
    np.testing.assert_array_equal(seqs[0].truth, seqs[1].truth)
    assert seqs[0].bytes_written == seqs[1].bytes_written
    assert _digest(tmp_path / "plain") == _digest(tmp_path / "extended")


def test_localization_on_a_prior_map_from_extension_files_alone(tmp_path, monkeypatch, ticks,
                                                                kept):
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models import map_initializer

    c = installed(tmp_path, localization="localization_extension.py")
    # The copy differs from the benchmark by the extension's file alone.
    added = set(_digest(tmp_path / "slam_bench").items()) - set(
        _digest(tiny_cell.ROOT / "slam_bench").items())
    assert {name for name, _ in added} == {"extensions/localization.py"}
    ml = c.config["parameters"]["mapper"]["mapper_localizer"]
    ml.update(is_use_map_initialization=True, is_merge_scans_into_map=False)
    # No scan merges, so no voxel of a scan lands in the table: map_miss_pct
    # does not apply.
    limits = c.config["limits"]
    del limits["map_miss_pct"]
    limits["prior_map_voxels_changed"] = 0
    # A shorter path, of which 3 scans are checked: fewer sessions' map
    # set-up on the CPU.
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic["path"]["steps"], c.traffic["check_scans"] = 6, 3
    initialized = []
    real = map_initializer.SlamMapInitializer.initialize

    def counting(self, *args, **kwargs):
        initialized.append(self.slam)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(map_initializer.SlamMapInitializer, "initialize", counting)
    row = control.read_seed(c, SEED, LOCALIZATION_WINDOW, "cpu", str(tmp_path / "data"))
    assert [m["complete"] for m in row["mission_stats"]] == [True, False]
    assert len(initialized) == 3  # the warm-up's session and the window's two
    assert row["program"]["prior_map_voxels_changed"] == 0.0
    assert row["control"]["prior_map_voxels_changed"] > 0.0
    assert all(m["submaps"] == 1 for m in row["mission_stats"] if m["complete"])
    assert checking.verdict(row["program"], limits)[0], (row["program"], row["mission_stats"])
    assert not checking.verdict(row["control"], limits)[0]

    # A voxel the prior map loses counts as well as one it gains.
    m = kept["m"]
    scan = m.capture.scans[0]
    table = scan.map_after
    slot = int((table.acc[:, 6] > 0).nonzero()[0, 0])
    acc = table.acc.clone().index_fill_(0, torch.tensor([slot]), 0.0)
    lost = dataclasses.replace(table, acc=acc)
    capture = session.Capture([])
    capture.scans = [dataclasses.replace(scan, map_after=lost)]
    judge = m.capture.extensions["localization"].judge
    assert judge(capture, m.seq, c.config, "cpu", False) == {"prior_map_voxels_changed": 1.0}
