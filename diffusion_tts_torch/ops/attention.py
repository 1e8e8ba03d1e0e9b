"""Self-attention for UNet feature maps with fp32-softmax semantics
(counterpart of diffusion_tts_tpu/ops/attention.py).

The reference computes attention weights in fp32 whatever the activation
dtype (AttentionOp, edm/training/networks.py:113-126): softmax over keys of
q.k / sqrt(d) with q and k upcast, the weights cast back to the activation
dtype, then P.V. Both entry points run the hand-written CUDA kernel
(ops/kernels/qkv_attention.py) on a CUDA tensor, which takes every EDM
shape in fp32 and bf16 (the JAX package's fp32 fallback to flash_attention
at 32x32 exists only for TPU VMEM), and the plain PyTorch version on a CPU
tensor.
"""
from __future__ import annotations

import torch

from diffusion_tts_torch.ops.kernels import qkv_attention as _kernel


def multihead_attention_fp32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, T, H, D] -> [B, T, H, D] in q.dtype."""
    return _kernel.attention(q, k, v)


def fused_qkv_self_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """qkv: [B, T, 3C], q|k|v contiguous thirds, head-major within each ->
    [B, T, C] in qkv.dtype."""
    return _kernel.qkv_self_attention(qkv, heads)


__all__ = ["multihead_attention_fp32", "fused_qkv_self_attention"]
