"""Self-attention: the CUDA kernel and its plain twin.

Replaces two Pallas kernels of diffusion_tts_tpu/ops/pallas/attention.py:
``qkv_self_attention`` (``_qkv_attn_kernel``, ``_qkv_attn_pair_kernel``)
and ``flash_attention`` (``_attn_kernel``, ``_attn_kernel_dual``). The
source is ``csrc/qkv_attention.cu``; its header says what bounds it on the
H100 and what the design does about that.

``qkv_self_attention`` takes ``[B, T, 3C]`` with q|k|v in contiguous
thirds, each head-major (the layout ``models.torch_import`` produces) and
returns ``[B, T, C]``. ``attention`` runs the same kernel on separate
``[B, T, H, D]`` q, k and v. The kernel takes the head widths in
``HEAD_DIMS``: 64 (the EDM UNet), 40/80/160 (the SD UNet), 512 (the SD
VAE's single head) and 4 ... 32 (the test-width SD nets). A CPU tensor goes through the plain PyTorch version; a
CUDA tensor goes through the kernel or the call raises. ``LAUNCHES`` counts
kernel launches.
"""
from __future__ import annotations

import math

import torch

from diffusion_tts_torch.ops.kernels import _launch

_LOG2E = 1.4426950408889634
HEAD_DIMS = (4, 8, 16, 32, 40, 64, 80, 160, 512)
_ARGTYPES = ((_launch.PTR,) * 4 + (_launch.INT,) * 5 + (_launch.I64,) * 6
             + (_launch.F32, _launch.PTR))

LAUNCHES = 0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] attention with the reference cast points
    (diffusion_tts_tpu/ops/attention.py::_xla_attention): scores from q and
    k upcast to fp32, softmax in fp32, weights cast to the input dtype for
    P.V, P.V accumulated in fp32 and cast back."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float() * scale)
    w = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float())
    return out.to(dtype)


def _split_heads(qkv: torch.Tensor, heads: int):
    b, t, c3 = qkv.shape
    c = c3 // 3
    return (qkv[..., i * c:(i + 1) * c].reshape(b, t, heads, c // heads) for i in range(3))


def qkv_self_attention_plain(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (the Pallas reference
    ``_qkv_attention_reference``): split heads, attend, merge."""
    b, t, c3 = qkv.shape
    return attention_plain(*_split_heads(qkv, heads)).reshape(b, t, c3 // 3)


def _check_width(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head widths {HEAD_DIMS}, got {d}")


def _launch_kernel(q_ptr: int, k_ptr: int, v_ptr: int, out: torch.Tensor, d: int, b: int,
                   h: int, t: int, in_strides: tuple[int, int, int],
                   out_strides: tuple[int, int, int]) -> None:
    """One launch over (batch, head, q tile); strides in elements for
    (batch, token, head), the head width's stride being 1."""
    global LAUNCHES
    fn = _launch.bind("qkv_attention", "dtts_attention", _ARGTYPES)
    err = fn(q_ptr, k_ptr, v_ptr, out.data_ptr(), _launch.DTYPE_CODES[out.dtype], d, b, h, t,
             *in_strides, *out_strides, _LOG2E / math.sqrt(d), _launch.stream(out))
    _launch.raise_on(err, "attention")
    LAUNCHES += 1


def qkv_self_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """All-heads self-attention, [B, T, 3C] -> [B, T, C] in qkv.dtype."""
    if qkv.device.type == "cpu":
        return qkv_self_attention_plain(qkv, heads)
    _launch.check(qkv, "qkv_self_attention")
    if qkv.ndim != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"qkv must be [B, T, 3C] with C % heads == 0, got "
                         f"{tuple(qkv.shape)} and {heads} heads")
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    _check_width(d)
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    base, item = qkv.data_ptr(), qkv.element_size()
    _launch_kernel(base, base + c * item, base + 2 * c * item, out, d, b, heads, t,
                   (t * c3, c3, d), (t * c, c, d))
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] attention through the same kernel, [B, T, H, D] out."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _launch.check(x, name)
    if not (q.shape == k.shape == v.shape and q.dtype == k.dtype == v.dtype) or q.ndim != 4:
        raise ValueError("q, k and v must be [B, T, H, D] of one shape and dtype, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    _check_width(d)
    out = torch.empty_like(q)
    strides = (t * h * d, h * d, d)
    _launch_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out, d, b, h, t, strides, strides)
    return out


__all__ = ["qkv_self_attention", "qkv_self_attention_plain", "attention",
           "attention_plain", "LAUNCHES", "HEAD_DIMS"]
