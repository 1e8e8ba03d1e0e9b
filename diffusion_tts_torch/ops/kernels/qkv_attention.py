"""Fused all-heads qkv self-attention: the CUDA kernel and its plain twin.

Replaces diffusion_tts_tpu/ops/pallas/attention.py::qkv_self_attention
(Pallas kernels ``_qkv_attn_kernel`` and ``_qkv_attn_pair_kernel``). The
source is ``csrc/qkv_attention.cu``; its header says what bounds it on the
H100 and what the design does about that.

``qkv_self_attention`` takes ``[B, T, 3C]`` with q|k|v in contiguous
thirds, each head-major (the layout ``models.torch_import`` produces) and
returns ``[B, T, C]``. ``attention`` runs the same kernel on separate
``[B, T, H, D]`` q, k and v. A CPU tensor goes through the plain PyTorch
version; a CUDA tensor goes through the kernel or the call raises.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

_LOG2E = 1.4426950408889634
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64

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


@functools.cache
def _kernel_fn():
    from diffusion_tts_torch.ops.kernels.build import load

    fn = load("qkv_attention").dtts_attention_d64
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")


def _launch(q_ptr: int, k_ptr: int, v_ptr: int, out: torch.Tensor, b: int, h: int,
            t: int, in_strides: tuple[int, int, int],
            out_strides: tuple[int, int, int]) -> None:
    """One launch over (batch, head, 64-row q tile); strides in elements
    for (batch, token, head), the head width's stride being 1."""
    global LAUNCHES
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = _kernel_fn()(q_ptr, k_ptr, v_ptr, out.data_ptr(), _DTYPE_CODES[out.dtype],
                       b, h, t, *in_strides, *out_strides,
                       _LOG2E / math.sqrt(HEAD_DIM), stream)
    if err != 0:
        raise RuntimeError(f"qkv_attention kernel launch failed: cudaError {err}")
    LAUNCHES += 1


def qkv_self_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """All-heads self-attention, [B, T, 3C] -> [B, T, C] in qkv.dtype."""
    if qkv.device.type == "cpu":
        return qkv_self_attention_plain(qkv, heads)
    _check(qkv, "qkv_self_attention")
    if qkv.ndim != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"qkv must be [B, T, 3C] with C % heads == 0, got "
                         f"{tuple(qkv.shape)} and {heads} heads")
    b, t, c3 = qkv.shape
    c = c3 // 3
    if c // heads != HEAD_DIM:
        raise ValueError(f"the kernel takes head width {HEAD_DIM}, got {c // heads}")
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    base, item = qkv.data_ptr(), qkv.element_size()
    _launch(base, base + c * item, base + 2 * c * item, out, b, heads, t,
            (t * c3, c3, HEAD_DIM), (t * c, c, HEAD_DIM))
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] attention through the same kernel, [B, T, H, D] out."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(x, name)
    if not (q.shape == k.shape == v.shape and q.dtype == k.dtype == v.dtype) or q.ndim != 4:
        raise ValueError("q, k and v must be [B, T, H, D] of one shape and dtype, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the kernel takes head width {HEAD_DIM}, got {d}")
    out = torch.empty_like(q)
    strides = (t * h * d, h * d, d)
    _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out, b, h, t, strides, strides)
    return out


__all__ = ["qkv_self_attention", "qkv_self_attention_plain", "attention",
           "attention_plain", "LAUNCHES", "HEAD_DIM"]
