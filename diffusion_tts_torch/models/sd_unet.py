"""UNet2DConditionModel, the SD-1.5 denoiser, in PyTorch, NCHW (counterpart
of diffusion_tts_tpu/models/sd_unet.py).

Behavioural counterpart of diffusers' UNet2DConditionModel
(unets/unet_2d_condition.py) at the Stable Diffusion configuration:
CrossAttnDownBlock2D x3 + DownBlock2D, a cross-attention mid block,
UpBlock2D + CrossAttnUpBlock2D x3, conv-projection transformers, GEGLU
feed-forwards, 'default' resnet time conditioning. Module names are
diffusers', so its state dicts load by name.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_tts_torch.models.sd_layers import (
    Conv3x3,
    Downsample2D,
    GroupNorm,
    Linear,
    ResnetBlock2D,
    Transformer2D,
    Upsample2D,
    sd_timestep_embedding,
)


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2 on the sinusoidal embedding."""

    def __init__(self, in_channels: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.linear_1 = Linear(in_channels, dim, dtype=dtype)
        self.linear_2 = Linear(dim, dim, dtype=dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t)))


class _Block(nn.Module):
    """One down, mid or up block: ``resnets``, optional ``attentions`` (one
    per resnet) and optional ``downsamplers``/``upsamplers`` (one each)."""

    def __init__(self, resnets, attentions=None, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNet2DConditionModel(nn.Module):
    """Takes sample [B, C, H, W], timesteps [B] (or a scalar) and
    encoder_hidden_states [B, L, cross_attention_dim]; returns
    [B, out_channels, H, W] in the compute dtype."""

    def __init__(self, sample_size: int = 64, in_channels: int = 4, out_channels: int = 4,
                 down_block_types: Sequence[str] = (
                     "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                     "DownBlock2D"),
                 up_block_types: Sequence[str] = (
                     "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                     "CrossAttnUpBlock2D"),
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2,
                 attention_head_dim: int | Sequence[int] = 8,  # SD quirk: the head COUNT
                 cross_attention_dim: int = 768, norm_num_groups: int = 32,
                 norm_eps: float = 1e-5, transformer_layers_per_block: int = 1,
                 flip_sin_to_cos: bool = True, freq_shift: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bo = tuple(block_out_channels)
        self.sample_size, self.in_channels = sample_size, in_channels
        self.cross_attention_dim, self.dtype = cross_attention_dim, dtype
        self.flip_sin_to_cos, self.freq_shift = flip_sin_to_cos, freq_shift
        ahd = attention_head_dim
        heads = lambda level: ahd[level] if isinstance(ahd, (tuple, list)) else ahd
        temb = bo[0] * 4
        norm = dict(groups=norm_num_groups, eps=norm_eps, dtype=dtype)
        attn = lambda ch, level: Transformer2D(
            ch, heads(level), ch // heads(level), cross_attention_dim,
            depth=transformer_layers_per_block, groups=norm_num_groups, dtype=dtype)

        self.conv_in = Conv3x3(in_channels, bo[0], dtype)
        self.time_embedding = TimestepEmbedding(bo[0], temb, dtype)

        skips, ch = [bo[0]], bo[0]
        self.down_blocks = nn.ModuleList()
        for i, btype in enumerate(down_block_types):
            resnets, attns = [], []
            for _ in range(layers_per_block):
                resnets.append(ResnetBlock2D(ch, bo[i], temb, **norm))
                ch = bo[i]
                if btype == "CrossAttnDownBlock2D":
                    attns.append(attn(ch, i))
                skips.append(ch)
            down = Downsample2D(ch, dtype) if i < len(bo) - 1 else None
            if down is not None:
                skips.append(ch)
            self.down_blocks.append(_Block(resnets, attns, downsample=down))

        self.mid_block = _Block([ResnetBlock2D(ch, ch, temb, **norm),
                                 ResnetBlock2D(ch, ch, temb, **norm)],
                                [attn(ch, len(bo) - 1)])

        self.up_blocks = nn.ModuleList()
        rev = bo[::-1]
        for i, btype in enumerate(up_block_types):
            resnets, attns = [], []
            for _ in range(layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skips.pop(), rev[i], temb, **norm))
                ch = rev[i]
                if btype == "CrossAttnUpBlock2D":
                    attns.append(attn(ch, len(bo) - 1 - i))
            up = Upsample2D(ch, dtype) if i < len(bo) - 1 else None
            self.up_blocks.append(_Block(resnets, attns, upsample=up))

        self.conv_norm_out = GroupNorm(ch, norm_num_groups, norm_eps, apply_silu=True)
        self.conv_out = Conv3x3(ch, out_channels, dtype)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = sd_timestep_embedding(timesteps, self.conv_in.out_channels,
                                     flip_sin_to_cos=self.flip_sin_to_cos,
                                     downscale_freq_shift=self.freq_shift)
        temb = self.time_embedding(temb)
        ctx = encoder_hidden_states.to(self.dtype)

        x = self.conv_in(sample)
        res = [x]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(x, temb)
                if hasattr(block, "attentions"):
                    x = block.attentions[j](x, ctx)
                res.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                res.append(x)

        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, temb), ctx), temb)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, res.pop()], dim=1), temb)
                if hasattr(block, "attentions"):
                    x = block.attentions[j](x, ctx)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


__all__ = ["UNet2DConditionModel", "TimestepEmbedding"]
