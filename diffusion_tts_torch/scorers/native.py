"""ctypes bindings for the repo's native runtime, native/libdtts_native.so
(counterpart of diffusion_tts_tpu/scorers/native.py, kept as the port's own
copy: importing the JAX package's scorers pulls JAX in).

The library is built with the in-tree Makefile (g++ and libjpeg) on first
use when it is missing; when it cannot be built or loaded, callers fall
back to PIL, which gives the same bytes.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdtts_native.so")
ABI_VERSION = 1
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> None:
    """``make -C native``, one process at a time (an exclusive lock on the
    Makefile), and only if no other process built the library meanwhile."""
    with open(os.path.join(_NATIVE_DIR, "Makefile")) as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if not os.path.exists(_LIB_PATH):
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True,
                               text=True, timeout=120)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIB_PATH):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
        except (OSError, subprocess.SubprocessError):
            return None
        lib.dtts_jpeg_sizes.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.dtts_jpeg_sizes.restype = None
        lib.dtts_native_abi_version.argtypes = []
        lib.dtts_native_abi_version.restype = ctypes.c_int
        if lib.dtts_native_abi_version() != ABI_VERSION:
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def jpeg_sizes(images_uint8: np.ndarray, quality: int = 80, n_threads: int = 0) -> np.ndarray:
    """Batched JPEG sizes in bytes through libjpeg: images [N, H, W, C]
    uint8 (C = 1 or 3) -> int32 [N]. Raises if the library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (build native/ with make)")
    imgs = np.ascontiguousarray(images_uint8, dtype=np.uint8)
    if imgs.ndim != 4 or imgs.shape[-1] not in (1, 3):
        raise ValueError(f"expected [N, H, W, 1 or 3] images, got {imgs.shape}")
    n, h, w, c = imgs.shape
    out = np.zeros(n, np.int32)
    lib.dtts_jpeg_sizes(imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, c,
                        int(quality), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        int(n_threads))
    return out


__all__ = ["jpeg_sizes", "native_available"]
