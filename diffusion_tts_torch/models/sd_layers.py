"""Building blocks of the Stable Diffusion UNet and VAE in PyTorch, NCHW
(counterpart of diffusion_tts_tpu/models/sd_layers.py).

Behavioural counterparts of the diffusers layers SD-1.5 uses (reference
sd/diffusers/src/diffusers/models/: resnet.py ResnetBlock2D, attention.py
BasicTransformerBlock, transformer_2d.py, downsampling.py, upsampling.py),
with the JAX package's numerics:

  * linear and conv weights live in the module's compute dtype (rounded
    once at load time); inputs are cast to it, as flax's Dense and Conv
    promote them;
  * GroupNorm and LayerNorm keep fp32 parameters and statistics; every
    standalone GroupNorm, with or without its SiLU, is the CUDA kernel of
    ``ops/kernels/groupnorm.py``;
  * self-attention is the CUDA attention kernel (``ops/attention.py``);
    cross-attention (77 keys) stays the inline fp32-score einsum of the JAX
    package (sd_layers.py:298-305);
  * the GEGLU feed-forward is the CUDA kernel of ``ops/kernels/geglu_ff.py``;
  * 3x3 stride-1 convs route as the JAX package's default configuration
    does (``ops/kernels/conv3x3.py`` holds the predicates): with C and K
    multiples of 128 at 96 pixels and more (the VAE decoder from 128x128
    up) they are the CUDA conv kernel, with the resnet's GroupNorm+SiLU
    folded into its prologue (the norm module then only takes the
    statistics, ``group_norm_stats``) and the bias, the skip add or the 1x1
    ``conv_shortcut`` projection folded into its epilogue; the upsamplers
    with a source of 64 pixels and more are the up-conv kernel. Every other
    conv is stock cuDNN with the skip added after it, and every other
    upsampler ``ops/resample.py``.

Module and parameter names are diffusers', so a diffusers state dict (the
goldens' ``sd::`` entries, a ``.safetensors`` checkpoint) loads as it is
(models/sd_import.py). Every module keeps activations NCHW-contiguous, the
layout the GroupNorm kernel takes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_tts_torch.ops.attention import multihead_attention_fp32
from diffusion_tts_torch.ops.kernels import conv3x3 as _conv
from diffusion_tts_torch.ops.kernels import geglu_ff as _geglu
from diffusion_tts_torch.ops.kernels import groupnorm as _gn
from diffusion_tts_torch.ops.resample import nn_upsample2x_conv3x3


def sd_timestep_embedding(timesteps: torch.Tensor, dim: int, *, flip_sin_to_cos: bool = True,
                          downscale_freq_shift: float = 0.0,
                          max_period: float = 10000.0) -> torch.Tensor:
    """diffusers get_timestep_embedding: [sin, cos] of t * freqs in fp32,
    flipped to [cos, sin] for SD."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    emb = torch.exp(exponent / (half - downscale_freq_shift))[None, :] * timesteps.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class Linear(nn.Linear):
    """nn.Linear in the compute dtype; the input is cast to it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class Conv2d(nn.Conv2d):
    """nn.Conv2d in the compute dtype; the input is cast to it, and an
    optional ``residual`` is added to the output (the resnet skip)."""

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        out = super().forward(x.to(self.weight.dtype))
        return out if residual is None else out + residual


class Conv3x3(Conv2d):
    """3x3 conv with padding 1 and ``nn.Conv2d``'s parameters (the JAX
    package's Conv3x3 / conv3), routed to the CUDA conv kernel where
    ``conv3_eligible`` says so. ``residual`` [B, K, H, W] is the resnet skip;
    ``gn = (scale, shift)``, fp32 [B, C], is a GroupNorm+SiLU of the input
    folded by the caller; ``shortcut = (sc_x, weight [K, Cres, 1, 1], bias
    [K])`` is the resnet's 1x1 conv_shortcut of a second input. On the kernel
    route all three join the conv in one launch; elsewhere the same math runs
    as separate ops around cuDNN."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__(in_channels, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None,
                gn: tuple[torch.Tensor, torch.Tensor] | None = None,
                shortcut: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
        dtype = self.weight.dtype
        x, bias = x.to(dtype), self.bias
        if shortcut is not None:
            sc_x, sc_w = shortcut[0].to(dtype), shortcut[1][:, :, 0, 0]
            bias = bias + shortcut[2]  # the shortcut's own bias, in the compute dtype
        if _conv.conv3_eligible(x, self.weight):
            kw = dict(gn_scale=gn[0], gn_shift=gn[1]) if gn is not None else {}
            if shortcut is not None:
                return _conv.conv3x3_same(x, self.weight, bias, shortcut=(sc_x, sc_w), **kw)
            if residual is not None:
                residual = residual.to(dtype)
            return _conv.conv3x3_same(x, self.weight, bias, residual, **kw)
        if gn is not None:
            xn = x.float() * gn[0][:, :, None, None] + gn[1][:, :, None, None]
            x = F.silu(xn).to(dtype)
        out = F.conv2d(x, self.weight, bias, padding=1)
        if residual is not None:
            out = out + residual
        if shortcut is not None:
            out = out + F.conv2d(sc_x, sc_w[:, :, None, None])
        return out


class GroupNorm(nn.Module):
    """nn.GroupNorm(min(32, C), eps) with fp32 statistics and affine, and
    SiLU after it when ``apply_silu``; one CUDA kernel on the card. With
    ``return_scale_shift`` it normalizes nothing: it takes the statistics in
    one read of x (the ``group_norm_stats`` kernel) and returns them folded
    with the affine into fp32 [B, C] vectors, (x - m) * rstd * gamma + beta
    == x * scale + shift, for a consumer that normalizes as it loads (the
    conv kernel's prologue)."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 apply_silu: bool = False):
        super().__init__()
        self.groups = min(num_groups, num_channels)
        self.eps, self.apply_silu = eps, apply_silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, return_scale_shift: bool = False):
        if return_scale_shift:
            mean, rstd = _gn.group_norm_stats(x, groups=self.groups, eps=self.eps)
            scale = rstd * self.weight.float()[None, :]
            return scale, self.bias.float()[None, :] - mean * scale
        return _gn.group_norm_silu(x, self.weight, self.bias, groups=self.groups, eps=self.eps,
                                   apply_silu=self.apply_silu)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics and affine, output in the input dtype
    (flax's LayerNorm)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class ResnetBlock2D(nn.Module):
    """GN-SiLU-conv / + time / GN-SiLU-conv / + skip (diffusers ResnetBlock2D
    with time_embedding_norm='default'; dropout is inference-off)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int | None = None,
                 groups: int = 32, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps, apply_silu=True)
        self.conv1 = Conv3x3(in_channels, out_channels, dtype)
        self.time_emb_proj = (Linear(temb_channels, out_channels, dtype=dtype)
                              if temb_channels else None)
        self.norm2 = GroupNorm(out_channels, groups, eps, apply_silu=True)
        self.conv2 = Conv3x3(out_channels, out_channels, dtype)
        # holds the 1x1 projection's parameters; runs standalone only when the
        # projection is not folded into conv2's kernel
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None) -> torch.Tensor:
        in_ch, hh, ww = x.shape[1:]
        out_ch = self.conv1.out_channels
        # Where the conv takes the kernel, its GroupNorm+SiLU is folded into
        # the conv's input load: the norm only takes the statistics.
        if in_ch % self.norm1.groups == 0 and _conv.conv3_shape_eligible(hh, ww, in_ch, out_ch):
            h = self.conv1(x, gn=self.norm1(x, return_scale_shift=True))
        else:
            h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None].to(h.dtype)
        fuse2 = (out_ch % self.norm2.groups == 0
                 and _conv.conv3_shape_eligible(hh, ww, out_ch, out_ch))
        gn2 = self.norm2(h, return_scale_shift=True) if fuse2 else None
        if not fuse2:
            h = self.norm2(h)
        if self.conv_shortcut is not None:
            if fuse2 and _conv.shortcut_eligible(in_ch):
                # the 1x1 projection of the skip runs inside conv2's kernel
                sc = self.conv_shortcut
                return self.conv2(h, gn=gn2, shortcut=(x, sc.weight, sc.bias))
            x = self.conv_shortcut(x)
        return self.conv2(h, residual=x, gn=gn2)


class CrossAttention(nn.Module):
    """diffusers Attention: to_q/to_k/to_v (no bias) and to_out.0, softmax
    in fp32. Self-attention (``context`` None) runs the CUDA kernel."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.ModuleList([Linear(inner, query_dim, dtype=dtype)])

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, tq, _ = x.shape
        tk = ctx.shape[1]
        q = self.to_q(x).reshape(b, tq, self.heads, self.dim_head)
        k = self.to_k(ctx).reshape(b, tk, self.heads, self.dim_head)
        v = self.to_v(ctx).reshape(b, tk, self.heads, self.dim_head)
        if context is None:
            out = multihead_attention_fp32(q, k, v)
        else:
            scale = 1.0 / math.sqrt(self.dim_head)
            w = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
            w = torch.softmax(w, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(v.dtype)
        return self.to_out[0](out.reshape(b, tq, self.heads * self.dim_head))


class GEGLU(nn.Module):
    """Parameter holder of diffusers' GEGLU (``net.0.proj``: [2F, C])."""

    def __init__(self, dim: int, inner: int, dtype: torch.dtype):
        super().__init__()
        self.proj = Linear(dim, 2 * inner, dtype=dtype)


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers FeedForward): proj to 2 * 4 * dim,
    h * gelu(gate), project back; one CUDA kernel call (two launches)."""

    def __init__(self, dim: int, mult: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, dtype), nn.Identity(),
                                  Linear(dim * mult, dim, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        return _geglu.geglu_ff(x.to(proj.weight.dtype), proj.weight, proj.bias, out.weight,
                               out.bias)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attention, LN -> cross-attention, LN -> GEGLU FF, each
    residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, dtype=dtype)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out -> + input
    (diffusers Transformer2DModel, use_linear_projection=False: SD-1.5)."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 depth: int = 1, groups: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = GroupNorm(channels, groups, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, dim_head, context_dim, dtype)
             for _ in range(depth)])
        self.proj_out = Conv2d(channels, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            t = block(t, context)
        t = t.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()
        return self.proj_out(t, residual=x)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv (diffusers downsampling.py): ``padding`` 1 on every
    side (the UNet's downsampler), or 0 after a (0, 1) pad of H and W (the
    VAE encoder's). A stock cuDNN conv either way: the conv kernel takes
    stride 1 only, so this is a plain ``Conv2d``, not a ``Conv3x3``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32, padding: int = 1):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=padding, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv.padding == (0, 0):
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x then 3x3 conv, run as the 2x2-phase decomposition, which
    never builds the upsampled input: the CUDA up-conv kernel where
    ``up2_eligible`` says so, else ``ops/resample.py``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3x3(channels, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.conv.weight, self.conv.bias
        x = x.to(weight.dtype)
        if _conv.up2_eligible(x, weight):
            return _conv.conv3x3_up2(x, weight, bias)
        return nn_upsample2x_conv3x3(x, weight, bias)


__all__ = [
    "sd_timestep_embedding", "Linear", "Conv2d", "Conv3x3", "GroupNorm", "LayerNorm",
    "ResnetBlock2D", "CrossAttention", "GEGLU", "FeedForward", "BasicTransformerBlock",
    "Transformer2D", "Downsample2D", "Upsample2D",
]
