"""Building blocks of the EDM model family in PyTorch, NCHW (counterpart of
diffusion_tts_tpu/models/layers.py).

Behavioural counterparts of the reference's primitive modules
(edm/training/networks.py:30-187), with the JAX package's numerics:

  * Linear and conv weights are stored in ``param_dtype`` and cast to the
    compute ``dtype`` per use, as the JAX package's flax modules do. Serving
    keeps ``param_dtype = dtype`` (the default): the weights are rounded once
    at load time, which gives the same values at half the memory. Training
    in bf16 keeps fp32 parameters (``param_dtype=torch.float32``), so that
    the optimizer updates unrounded weights and gets fp32 gradients,
  * GroupNorm statistics and affine run in fp32 and the result is cast back,
  * attention softmax runs in fp32 (ops/attention.py).

Parameter names and shapes are the reference's, so a reference
``state_dict`` loads with only the qkv de-interleave applied
(models/torch_import.py). Only the pieces the ADM (DhariwalUNet) uses are
here: resampling with ``resample_filter=(1, 1)``, adaptive GroupNorm.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_tts_torch.ops.attention import fused_qkv_self_attention
from diffusion_tts_torch.ops.resample import nn_upsample2x_conv3x3


def _init_(t: torch.Tensor, mode: str, scale: float, fan_in: int, fan_out: int) -> None:
    """The reference's weight_init (networks.py:19-24), times ``scale``."""
    with torch.no_grad():
        if scale == 0.0:
            t.zero_()
        elif mode == "kaiming_uniform":
            t.copy_((torch.rand(t.shape) * 2 - 1) * math.sqrt(3.0 / fan_in) * scale)
        elif mode == "kaiming_normal":
            t.copy_(torch.randn(t.shape) * math.sqrt(1.0 / fan_in) * scale)
        else:
            raise ValueError(f"invalid init mode {mode!r}")


class EDMLinear(nn.Module):
    """Dense layer with the reference's init (networks.py:30-43)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init_mode: str = "kaiming_normal", init_weight: float = 1.0,
                 init_bias: float = 0.0, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype))
        _init_(self.weight, init_mode, init_weight, in_features, out_features)
        self.bias = None
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features, dtype=param_dtype))
            _init_(self.bias, init_mode, init_bias, in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class EDMConv(nn.Module):
    """Conv with optional 2x up/downsampling (networks.py:49-90), for
    ``resample_filter=(1, 1)``: up is nearest-2x duplication, down is a 2x2
    mean. ``kernel=0`` resamples only. A 3x3 conv after an up runs as the
    2x2-phase decomposition (ops/resample.py)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, bias: bool = True,
                 up: bool = False, down: bool = False, init_mode: str = "kaiming_normal",
                 init_weight: float = 1.0, init_bias: float = 0.0,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None):
        super().__init__()
        assert not (up and down)
        self.up, self.down, self.dtype = up, down, dtype
        self.out_channels = out_channels
        self.weight = self.bias = None
        param_dtype = param_dtype or dtype
        if kernel:
            fan_in, fan_out = in_channels * kernel * kernel, out_channels * kernel * kernel
            self.weight = nn.Parameter(
                torch.empty(out_channels, in_channels, kernel, kernel, dtype=param_dtype))
            _init_(self.weight, init_mode, init_weight, fan_in, fan_out)
            if bias:
                self.bias = nn.Parameter(torch.empty(out_channels, dtype=param_dtype))
                _init_(self.bias, init_mode, init_bias, fan_in, fan_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = None if self.weight is None else self.weight.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        if self.up and w is not None and w.shape[-1] == 3:
            return nn_upsample2x_conv3x3(x, w, bias)
        if self.up:
            x = torch.repeat_interleave(torch.repeat_interleave(x, 2, dim=2), 2, dim=3)
        if self.down:
            x = F.avg_pool2d(x, 2)
        if w is not None:
            x = F.conv2d(x, w, bias, padding=w.shape[-1] // 2)
        return x


def _group_norm_fp32(x: torch.Tensor, groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """GroupNorm with fp32 statistics and fp32 affine, returned in fp32."""
    return F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)


class EDMGroupNorm(nn.Module):
    """GroupNorm with num_groups=min(32, C//4) and fp32 statistics
    (networks.py:96-106); ``silu`` applies SiLU after it (the UNet's
    norm0/out_norm pattern)."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 min_channels_per_group: int = 4, eps: float = 1e-5, silu: bool = False):
        super().__init__()
        self.num_groups = min(num_groups, num_channels // min_channels_per_group)
        self.eps, self.silu = eps, silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _group_norm_fp32(x, self.num_groups, self.weight, self.bias, self.eps)
        return (F.silu(out) if self.silu else out).to(x.dtype)


def EDMGroupNormSiLU(num_channels: int, **kwargs) -> EDMGroupNorm:
    """GroupNorm followed by SiLU; same parameters as EDMGroupNorm."""
    return EDMGroupNorm(num_channels, silu=True, **kwargs)


class EDMAdaptiveGroupNormSiLU(EDMGroupNorm):
    """AdaGN: silu(shift + GN(x) * (scale + 1)), the ADM UNetBlock norm1
    (networks.py:172-174), with per-sample modulation [B, C]: GN in fp32
    cast to x.dtype, then modulation and SiLU in x.dtype."""

    def forward(self, x: torch.Tensor, mod_scale: torch.Tensor,
                mod_shift: torch.Tensor) -> torch.Tensor:
        gn = _group_norm_fp32(x, self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)
        ms = mod_scale.to(x.dtype)[:, :, None, None]
        sh = mod_shift.to(x.dtype)[:, :, None, None]
        return F.silu(sh + gn * (ms + 1.0))


class PositionalEmbedding(nn.Module):
    """DDPM++/ADM timestep embedding (networks.py:193-207):
    outer(t, freqs) -> cat[cos, sin], in fp32."""

    def __init__(self, num_channels: int, max_positions: int = 10000, endpoint: bool = False):
        super().__init__()
        self.num_channels, self.max_positions, self.endpoint = (
            num_channels, max_positions, endpoint)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.num_channels // 2
        freqs = torch.arange(half, dtype=torch.float32, device=x.device)
        freqs = freqs / (half - (1 if self.endpoint else 0))
        freqs = torch.pow(torch.tensor(1.0 / self.max_positions, device=x.device), freqs)
        args = torch.outer(x.float(), freqs)
        return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


class UNetBlock(nn.Module):
    """ADM residual block (networks.py:134-187): GN-SiLU-conv(resample),
    adaptive timestep scale/shift, GN-SiLU-dropout-conv(zero-init), residual
    with optional 1x1/resample skip, then optional self-attention with fp32
    softmax. The ADM's settings are fixed here (skip_scale 1, adaptive
    scale, no resample projection); the SongUNet's come with the second
    slice of the port. The qkv projection's output channels are in
    (q|k|v, head, d) order: models/torch_import.py de-interleaves the
    reference's ((head, d), 3) layout at load time, so the kernel reads q,
    k and v as contiguous thirds.

    Dropout is active in ``train()`` mode with ``dropout > 0`` and draws
    its keep mask from the ``generator`` handed to ``forward``, never from
    the global RNG."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 up: bool = False, down: bool = False, attention: bool = False,
                 channels_per_head: int = 64, dropout: float = 0.0, eps: float = 1e-5,
                 init: dict | None = None, init_zero: dict | None = None,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None):
        super().__init__()
        init = dict(init or {}, param_dtype=param_dtype)
        init_zero = dict(init_zero or {"init_weight": 0.0}, param_dtype=param_dtype)
        self.out_channels = out_channels
        self.num_heads = out_channels // channels_per_head if attention else 0
        self.dropout, self.dtype = dropout, dtype

        self.norm0 = EDMGroupNormSiLU(in_channels, eps=eps)
        self.conv0 = EDMConv(in_channels, out_channels, 3, up=up, down=down,
                             dtype=dtype, **init)
        self.affine = EDMLinear(emb_channels, out_channels * 2, dtype=dtype, **init)
        self.norm1 = EDMAdaptiveGroupNormSiLU(out_channels, eps=eps)
        self.conv1 = EDMConv(out_channels, out_channels, 3, dtype=dtype, **init_zero)
        self.skip = None
        if out_channels != in_channels or up or down:
            kernel = 1 if out_channels != in_channels else 0
            self.skip = EDMConv(in_channels, out_channels, kernel, up=up, down=down,
                                dtype=dtype, **init)
        if self.num_heads:
            self.norm2 = EDMGroupNorm(out_channels, eps=eps)
            self.qkv = EDMConv(out_channels, out_channels * 3, 1, dtype=dtype, **init)
            self.proj = EDMConv(out_channels, out_channels, 1, dtype=dtype, **init_zero)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        orig = x
        x = self.conv0(self.norm0(x))
        scale, shift = self.affine(emb).to(x.dtype).chunk(2, dim=1)  # [B, C] each
        x = self.norm1(x, scale, shift)
        if self.training and self.dropout > 0.0:
            if generator is None:
                raise ValueError("dropout in train() mode needs a generator")
            keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.dropout
            x = x * keep.to(x.dtype) / (1.0 - self.dropout)
        x = self.conv1(x)
        skip = self.skip(orig) if self.skip is not None else orig
        x = x + skip

        if self.num_heads:
            b, c, h, w = x.shape
            qkv = self.qkv(self.norm2(x))  # [B, 3C, H, W]
            qkv = qkv.permute(0, 2, 3, 1).reshape(b, h * w, 3 * c).contiguous()
            a = fused_qkv_self_attention(qkv, self.num_heads)  # [B, T, C]
            a = a.reshape(b, h, w, c).permute(0, 3, 1, 2)
            x = self.proj(a) + x
        return x


__all__ = [
    "EDMLinear",
    "EDMConv",
    "EDMGroupNorm",
    "EDMGroupNormSiLU",
    "EDMAdaptiveGroupNormSiLU",
    "PositionalEmbedding",
    "UNetBlock",
]
