"""What the benchmark and its reference import, read from ``sys.modules`` in
fresh processes and compared by whole top-level names (the port's name
begins with the JAX package's)."""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
JAX_NAMES = {"jax", "jaxlib", "flax", "open3d_slam_advanced_rss_2024_public_tpu"}
PORT = "open3d_slam_advanced_rss_2024_public_tpu_torch"


def top_level_modules(code: str) -> set:
    script = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_port_it_drives_import_no_jax():
    mods = top_level_modules(
        "import slam_bench.harness, slam_bench.control, slam_bench.checking, slam_bench.tracing\n"
        "import open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam\n"
        "import open3d_slam_advanced_rss_2024_public_tpu_torch.frontends.rosbag\n"
        "import open3d_slam_advanced_rss_2024_public_tpu_torch.frontends.kitti")
    assert PORT in mods and not mods & JAX_NAMES


def test_a_run_leaves_no_jax_in_the_process():
    mods = top_level_modules(
        "import sys, time, tempfile\n"
        "sys.path.insert(0, '.')\n"
        "from slam_bench import harness\n"
        "from slam_bench.tests import tiny_cell\n"
        "harness.run_cell(tiny_cell.cell(), 5, 2.0, False, 'cpu', time.perf_counter(),"
        " data_root=tempfile.mkdtemp())")
    assert PORT in mods and not mods & JAX_NAMES


def test_the_reference_imports_nothing_of_the_port():
    mods = top_level_modules(
        "import slam_bench.reference.checks, slam_bench.reference.geometry\n"
        "import slam_bench.reference.se3, slam_bench.roofline, slam_bench.traffic_gen")
    assert PORT not in mods and not mods & JAX_NAMES
