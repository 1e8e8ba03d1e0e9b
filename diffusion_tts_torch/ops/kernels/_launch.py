"""What every kernel wrapper of the port does around a launch: bind the C
function of a built library, check the tensors it is handed, find the
current stream, and raise on a failed launch."""
from __future__ import annotations

import ctypes
import functools

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

PTR, INT, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@functools.cache
def bind(source: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """``symbol`` of the library built from ``csrc/<source>.cu`` (built at
    first use), returning the launch's cudaError_t as an int."""
    from diffusion_tts_torch.ops.kernels.build import load

    fn = getattr(load(source), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def check(x: torch.Tensor, name: str) -> None:
    """Raise unless ``x`` is a contiguous float32 or bfloat16 CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer."""
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")


__all__ = ["DTYPE_CODES", "PTR", "INT", "I64", "F32", "bind", "check", "stream", "raise_on"]
