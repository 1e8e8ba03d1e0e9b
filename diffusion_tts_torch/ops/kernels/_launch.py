"""What every kernel wrapper of the port does around a launch: bind the C
function of a built library, check the tensors it is handed (and, for a
tensor-core route, their alignment), find the current stream, raise on a
failed launch, and give a forward-only kernel its gradient."""
from __future__ import annotations

import ctypes
import functools

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The routes of a kernel with two designs: "fma", the products in fp32 FMA on
# the CUDA cores; "mma", bf16 products on the tensor cores (mma.sync).
ROUTES = ("fma", "mma")
ROUTE_CODES = {route: code for code, route in enumerate(ROUTES)}

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


def check_aligned(kernel: str, ptrs, strides=(), item: int = 1) -> None:
    """Raise unless every pointer, and every stride of ``item``-byte
    elements, is a multiple of 16 bytes: the tensor-core routes (attention
    and GEGLU "mma", conv "ring" and "wgmma") and GroupNorm's "slab" copy
    rows in 16-byte pieces."""
    bad = [p for p in ptrs if p % 16] + [s for s in strides if s * item % 16]
    if bad:
        raise ValueError(f"{kernel}: this route copies 16-byte pieces and needs 16-byte aligned "
                         f"pointers and rows, got {bad}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer."""
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")


class _TwinBackward(torch.autograd.Function):
    """Forward: ``kernel(*args)``. Backward: autograd through
    ``plain(*args)``, recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.others = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*(a for a, t in zip(args, ctx.is_tensor) if t))
        return kernel(*args)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        args = [next(saved).detach() if t else o for t, o in zip(ctx.is_tensor, ctx.others)]
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[2:]) if need]
        for i in wanted:
            args[i].requires_grad_(True)
        with torch.enable_grad():
            out = ctx.plain(*args)
        outs, grads = zip(*((o, g) for o, g in zip(
            (out,) if isinstance(out, torch.Tensor) else out, grads) if o.requires_grad))
        got = torch.autograd.grad(outs, [args[i] for i in wanted], grads, allow_unused=True)
        result = [None] * len(args)
        for i, g in zip(wanted, got):
            result[i] = g
        return (None, None, *result)


def with_twin_backward(kernel, plain, *args):
    """``kernel(*args)``, differentiable. The JAX package gives its
    forward-only Pallas kernels the VJP of their jnp reference; likewise
    here the forward is the kernel and the gradient is autograd's through
    the plain twin ``plain(*args)``, recomputed from the saved inputs (one
    more forward of the twin per backward, no saved intermediates). ``args``
    are tensors, None or plain values, positionally the same for both
    callables. Without a gradient to compute this is just the kernel call."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return _TwinBackward.apply(kernel, plain, *args)
    return kernel(*args)


__all__ = ["with_twin_backward", "DTYPE_CODES", "ROUTES", "ROUTE_CODES", "PTR", "INT", "I64",
           "F32", "bind", "check", "check_aligned", "stream", "raise_on"]
