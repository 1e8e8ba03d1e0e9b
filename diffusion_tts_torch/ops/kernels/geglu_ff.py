"""GEGLU feed-forward: the CUDA kernel and its plain twin.

Replaces diffusion_tts_tpu/ops/pallas/geglu_ff.py::geglu_ff (Pallas
kernels ``_geglu_kernel`` and ``_geglu_stream_kernel``). The source is
``csrc/geglu_ff.cu``; its header says what bounds it on the H100 and what
the design does about that.

Weights are in PyTorch's ``[out, in]`` layout, as ``nn.Linear`` keeps them:
w0 ``[2F, C]`` (h rows, then gate rows), w2 ``[C, F]``; x, the weights and
the biases share one dtype. A CPU tensor goes through the plain PyTorch
version; a CUDA tensor goes through the kernel or the call raises.
``LAUNCHES`` counts kernel launches, two per call (gate, then out). The
kernels are forward-only, as the Pallas ones are; the gradient is autograd's
through the plain twin (``_launch.with_twin_backward``).

Two routes, picked by ``route(dtype, c, f)`` before the launch: ``"mma"``
(the products on the tensor cores) for bf16 and ``"fma"`` (fp32 FMA on the
CUDA cores) for fp32. The mma route copies rows in 16-byte pieces: bf16 with
C or F not a multiple of 8, or an operand not 16-byte aligned, raises before
any launch. ``ROUTE_LAUNCHES`` counts launches per route. A caller may ask
for ``route="fma"`` at any shape, which times the first design.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from diffusion_tts_torch.ops.kernels import _launch

LAUNCHES_PER_CALL = 2
_ARGTYPES = (_launch.PTR,) * 7 + (_launch.INT,) * 5 + (_launch.PTR,)

LAUNCHES = 0
ROUTE_LAUNCHES = {r: 0 for r in _launch.ROUTES}


def route(dtype: torch.dtype, c: int, f: int) -> str:
    """The kernels' route for ``dtype`` and widths C, F: "mma" for bf16,
    "fma" for fp32. Raises for bf16 with C or F not a multiple of 8, which
    the mma route cannot take."""
    if dtype != torch.bfloat16:
        return "fma"
    if c % 8 or f % 8:
        raise ValueError(f"geglu_ff: the mma route takes C and F multiples of 8, got C={c}, "
                         f"F={f}")
    return "mma"


def geglu_ff_plain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin with the kernel's cast points (the Pallas
    reference ``_geglu_reference``): fp32 products, the projection rounded
    to x.dtype after its bias, the gelu gate in fp32 (exact erf) rounded
    again, the output rounded once."""
    dtype = x.dtype
    f = w2.shape[1]
    q = F.linear(x.float(), w0.float(), b0.float()).to(dtype)
    h, gate = q[..., :f].float(), q[..., f:].float()
    g = (h * F.gelu(gate)).to(dtype)
    return F.linear(g.float(), w2.float(), b2.float()).to(dtype)


def geglu_ff(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor, *, route: str | None = None) -> torch.Tensor:
    """(h * gelu(gate)) . w2^T + b2 with [h | gate] = x . w0^T + b0.
    x: [..., C]; returns x.shape in x.dtype. ``route``: None takes
    ``route(x.dtype, C, F)``'s; "fma" forces the CUDA-core kernels."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w0, b0, w2, b2)
    kernel = functools.partial(_geglu_ff_kernel, forced=route)
    return _launch.with_twin_backward(kernel, geglu_ff_plain, x, w0, b0, w2, b2)


def _geglu_ff_kernel(x, w0, b0, w2, b2, forced: str | None = None):
    global LAUNCHES
    c = x.shape[-1]
    f = w2.shape[-1]
    chosen = "fma" if forced == "fma" else route(x.dtype, c, f)
    if forced not in (None, chosen):
        raise ValueError(f"geglu_ff: the mma route takes bfloat16, got {x.dtype}")
    for name, t, shape in (("w0", w0, (2 * f, c)), ("b0", b0, (2 * f,)), ("w2", w2, (c, f)),
                           ("b2", b2, (c,))):
        _launch.check(t, name)
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {list(shape)} in {x.dtype}, got "
                             f"{list(t.shape)} in {t.dtype}")
    x2 = x.reshape(-1, c)
    _launch.check(x2, "x")
    m = x2.shape[0]
    g = torch.empty((m, f), dtype=x.dtype, device=x.device)
    out = torch.empty((m, c), dtype=x.dtype, device=x.device)
    if chosen == "mma":
        _launch.check_aligned("geglu_ff", (x2.data_ptr(), w0.data_ptr(), w2.data_ptr(),
                                           g.data_ptr(), out.data_ptr()))
    fn = _launch.bind("geglu_ff", "dtts_geglu_ff", _ARGTYPES)
    err = fn(x2.data_ptr(), w0.data_ptr(), b0.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             g.data_ptr(), out.data_ptr(), _launch.DTYPE_CODES[x.dtype], m, c, f,
             _launch.ROUTE_CODES[chosen], _launch.stream(x))
    _launch.raise_on(err, "geglu_ff")
    LAUNCHES += LAUNCHES_PER_CALL
    ROUTE_LAUNCHES[chosen] += LAUNCHES_PER_CALL
    return out.reshape(x.shape)


__all__ = ["geglu_ff", "geglu_ff_plain", "route", "LAUNCHES", "LAUNCHES_PER_CALL",
           "ROUTE_LAUNCHES"]
