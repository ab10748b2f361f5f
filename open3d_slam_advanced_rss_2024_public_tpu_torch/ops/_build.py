"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``tiles.cu`` holds the tile-planning kernels on their own, ``nn.cu`` K1 and
``moments.cu`` K2; the last two include the planning kernels from
``tiles.cuh`` so that one host call enqueues a plan and its sweep.  Each
source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds instead of the minutes a ``torch/extension.h``
translation unit costs.  All sources compile in parallel, at first use,
into ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``).  A library whose source and headers are unchanged is reused.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("tiles", "nn", "moments")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict = {}
# What ptxas reported (registers, shared memory, spills) per source built
# in this process; read by chip_smoke.py.
ptxas_report: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(name: str) -> pathlib.Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_all() -> dict:
    """Compile every kernel source that has no up-to-date library, all
    ``nvcc`` processes at once, and load them.  Returns name -> CDLL."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            out = _target(name)
            if not out.exists():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                procs[name] = (subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            ptxas_report[name] = "\n".join(
                line for line in log.splitlines() if "ptxas" in line)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs


def library(name: str) -> ctypes.CDLL:
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
