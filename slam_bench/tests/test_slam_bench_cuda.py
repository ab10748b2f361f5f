"""The tiny cell on the card: a sound traced run is correct and reads every
per-layer metric, the kernels' rooflines included.  Run on a machine with a
CUDA device:

    python -m pytest -p no:cacheprovider slam_bench/tests/test_slam_bench_cuda.py -m cuda
"""
import time

import pytest
import torch

from slam_bench import harness
from slam_bench.tests import tiny_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels K1 and K2 run only on the card")
    return "cuda"


@pytest.mark.cuda
def test_a_traced_run_on_the_card_is_correct_and_reads_every_layer(card, tmp_path):
    cell = tiny_cell.cell()
    r = harness.run_cell(cell, 2 ** 33 + 7, 20.0, True, card, time.perf_counter(),
                         data_root=str(tmp_path))
    assert r["correct"] is True, r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    for name in ("frontend_ms", "mapper_ms", "device_idle_pct", "nn_roofline_pct",
                 "moments_roofline_pct"):
        assert name in r["metrics"], name
    assert 0 < r["metrics"]["nn_roofline_pct"]["value"] <= 100
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
