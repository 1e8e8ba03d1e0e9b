"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/kernels/lib<name>-<hash>.so`` (the hash is of the source,
so an edited kernel is rebuilt and a stale library is never loaded). The
build happens at first use, on the machine with the card; nothing is
compiled when a module is imported. Several sources build in parallel, one
``nvcc`` each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("qkv_attention", "attention_bwd", "groupnorm", "geglu_ff", "conv3x3")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, tuple[float, str]]:
    """Compile every source in ``names`` whose library is missing, all
    nvcc processes at once. Returns {name: (seconds, ptxas report)} for the
    sources it built; raises with the compiler's output on a failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, library_path(name))
        built[name] = (time.perf_counter() - t0, log)
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


__all__ = ["build", "load", "library_path", "SOURCES", "BUILD_DIR"]
