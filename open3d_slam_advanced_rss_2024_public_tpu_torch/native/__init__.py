"""Native (C++) host components, built at first use, with numpy fallbacks.

The port's copy of the JAX package's ``native/`` (``native/__init__.py``):
``scan_io.cpp`` decodes float32 record files (KITTI velodyne scans) and
binary PCD payloads, and holds a lock-free single-producer ring buffer.  It
is compiled with ``g++`` at first use into ``build/native/`` at the
repository root (listed in ``.gitignore``), not next to its source.  Every
entry point has a numpy fallback for hosts with no toolchain; ``backend()``
says which of the two is in use.  A host file decoder, not a device kernel.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "scan_io.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
_LIB = BUILD_DIR / "libscan_io.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
                        "-o", str(tmp)], check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:  # no toolchain, or it failed
        print(f"[native] build failed, numpy fallback in use: {e}", file=sys.stderr)
        return False
    tmp.replace(_LIB)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first where it is missing or older than its
    source; None where it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB.is_file() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError as e:
            print(f"[native] load failed: {e}", file=sys.stderr)
            return None
        f32p, c_long = ctypes.POINTER(ctypes.c_float), ctypes.c_long
        lib.decode_f32_file.restype = c_long
        lib.decode_f32_file.argtypes = [ctypes.c_char_p, f32p, c_long]
        lib.file_size_bytes.restype = c_long
        lib.file_size_bytes.argtypes = [ctypes.c_char_p]
        lib.pcd_read_binary.restype = c_long
        lib.pcd_read_binary.argtypes = [ctypes.c_char_p, c_long, f32p, c_long]
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [c_long, c_long]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_size.restype = c_long
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.ring_push.restype = ctypes.c_int
        lib.ring_push.argtypes = [ctypes.c_void_p, f32p, c_long, ctypes.c_double]
        lib.ring_pop.restype = c_long
        lib.ring_pop.argtypes = [ctypes.c_void_p, f32p, c_long,
                                 ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def backend() -> str:
    """"native" where the library loads, else "numpy"."""
    return "native" if get_lib() is not None else "numpy"


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_f32_file(path: str, max_floats: Optional[int] = None) -> np.ndarray:
    """Decode a float32 record file (KITTI .bin etc.)."""
    lib = get_lib()
    if lib is None:
        return np.fromfile(path, dtype=np.float32,
                           count=-1 if max_floats is None else max_floats)
    size = lib.file_size_bytes(str(path).encode())
    if size < 0:
        raise FileNotFoundError(path)
    n = size // 4 if max_floats is None else min(size // 4, max_floats)
    out = np.empty(n, dtype=np.float32)
    got = lib.decode_f32_file(str(path).encode(), _ptr(out), n)
    if got < 0:
        raise IOError(f"native decode failed for {path}")
    return out[:got]


def pcd_read_binary_payload(path: str, data_offset: int, n_floats: int) -> np.ndarray:
    """The float32 payload of a binary PCD file, from ``data_offset``."""
    lib = get_lib()
    if lib is None:
        with open(path, "rb") as f:
            f.seek(data_offset)
            return np.frombuffer(f.read(n_floats * 4), dtype="<f4").copy()
    out = np.empty(n_floats, dtype=np.float32)
    got = lib.pcd_read_binary(str(path).encode(), data_offset, _ptr(out), n_floats)
    if got < 0:
        raise IOError(f"native pcd read failed for {path}")
    return out[:got]


class NativeRingBuffer:
    """SPSC lock-free scan buffer (≙ CircularBuffer.hpp); a Python deque
    where the native library is unavailable."""

    def __init__(self, n_slots: int = 4, slot_floats: int = 4 * 131072):
        self._lib = get_lib()
        self.slot_floats = slot_floats
        self._n_slots = n_slots
        if self._lib is not None:
            self._h = self._lib.ring_create(n_slots, slot_floats)
            self._fallback = None
        else:
            from collections import deque

            self._h = None
            self._fallback = deque(maxlen=n_slots)

    def push(self, payload: np.ndarray, stamp: float) -> bool:
        payload = np.ascontiguousarray(payload, dtype=np.float32).reshape(-1)
        if self._lib is not None:
            return bool(self._lib.ring_push(self._h, _ptr(payload), payload.size,
                                            float(stamp)))
        if len(self._fallback) >= self._n_slots:
            return False
        self._fallback.append((payload.copy(), float(stamp)))
        return True

    def pop(self):
        if self._lib is not None:
            out = np.empty(self.slot_floats, dtype=np.float32)
            stamp = ctypes.c_double()
            n = self._lib.ring_pop(self._h, _ptr(out), self.slot_floats, ctypes.byref(stamp))
            if n == 0:
                return None
            return out[:n], stamp.value
        if not self._fallback:
            return None
        return self._fallback.popleft()

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.ring_size(self._h))
        return len(self._fallback)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
