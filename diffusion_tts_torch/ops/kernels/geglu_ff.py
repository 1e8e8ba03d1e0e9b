"""GEGLU feed-forward: the CUDA kernel and its plain twin.

Replaces diffusion_tts_tpu/ops/pallas/geglu_ff.py::geglu_ff (Pallas
kernels ``_geglu_kernel`` and ``_geglu_stream_kernel``). The source is
``csrc/geglu_ff.cu``; its header says what bounds it on the H100 and what
the design does about that.

Weights are in PyTorch's ``[out, in]`` layout, as ``nn.Linear`` keeps them:
w0 ``[2F, C]`` (h rows, then gate rows), w2 ``[C, F]``; x, the weights and
the biases share one dtype. A CPU tensor goes through the plain PyTorch
version; a CUDA tensor goes through the kernel or the call raises.
``LAUNCHES`` counts kernel launches, two per call (gate, then out).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from diffusion_tts_torch.ops.kernels import _launch

LAUNCHES_PER_CALL = 2
_ARGTYPES = (_launch.PTR,) * 7 + (_launch.INT,) * 4 + (_launch.PTR,)

LAUNCHES = 0


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
             b2: torch.Tensor) -> torch.Tensor:
    """(h * gelu(gate)) . w2^T + b2 with [h | gate] = x . w0^T + b0.
    x: [..., C]; returns x.shape in x.dtype."""
    global LAUNCHES
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w0, b0, w2, b2)
    c = x.shape[-1]
    f = w2.shape[-1]
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
    fn = _launch.bind("geglu_ff", "dtts_geglu_ff", _ARGTYPES)
    err = fn(x2.data_ptr(), w0.data_ptr(), b0.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             g.data_ptr(), out.data_ptr(), _launch.DTYPE_CODES[x.dtype], m, c, f,
             _launch.stream(x))
    _launch.raise_on(err, "geglu_ff")
    LAUNCHES += LAUNCHES_PER_CALL
    return out.reshape(x.shape)


__all__ = ["geglu_ff", "geglu_ff_plain", "LAUNCHES", "LAUNCHES_PER_CALL"]
