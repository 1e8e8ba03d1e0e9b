"""AutoencoderKL's decoder, the SD latent VAE's search-path half, in
PyTorch, NCHW (counterpart of diffusion_tts_tpu/models/sd_vae.py:
VAEAttention, _MidBlock, Decoder and AutoencoderKL.decode).

Behavioural counterpart of diffusers' AutoencoderKL at the SD
configuration: four UpDecoderBlocks, a single-head mid-block attention,
scaling_factor 0.18215. Module names are diffusers'. The encoder and
quant_conv are not on the search path and are not ported yet: their keys
in a state dict are listed in ``UNPORTED_PREFIXES`` and skipped on load.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from diffusion_tts_torch.models.sd_layers import (
    Conv2d,
    Conv3x3,
    GroupNorm,
    Linear,
    ResnetBlock2D,
    Upsample2D,
)
from diffusion_tts_torch.models.sd_unet import _Block
from diffusion_tts_torch.ops.attention import multihead_attention_fp32


class VAEAttention(nn.Module):
    """Mid-block self-attention over the spatial tokens: GroupNorm, one
    head of width C, fp32 softmax (the CUDA attention kernel at d = C),
    + input."""

    def __init__(self, channels: int, groups: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.group_norm = GroupNorm(channels, groups, eps=1e-6)
        self.to_q = Linear(channels, channels, dtype=dtype)
        self.to_k = Linear(channels, channels, dtype=dtype)
        self.to_v = Linear(channels, channels, dtype=dtype)
        self.to_out = nn.ModuleList([Linear(channels, channels, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = (proj(t).reshape(b, h * w, 1, c) for proj in (self.to_q, self.to_k, self.to_v))
        out = self.to_out[0](multihead_attention_fp32(q, k, v).reshape(b, h * w, c))
        return x + out.transpose(1, 2).contiguous().view(b, c, h, w)


class Decoder(nn.Module):
    """conv_in -> mid block -> up blocks -> GN + SiLU -> conv_out."""

    def __init__(self, block_out_channels: Sequence[int], layers_per_block: int,
                 latent_channels: int, out_channels: int, groups: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bo = tuple(block_out_channels)
        norm = dict(groups=groups, eps=1e-6, dtype=dtype)
        ch = bo[-1]
        self.conv_in = Conv3x3(latent_channels, ch, dtype)
        self.mid_block = _Block([ResnetBlock2D(ch, ch, **norm), ResnetBlock2D(ch, ch, **norm)],
                                [VAEAttention(ch, groups, dtype)])
        self.up_blocks = nn.ModuleList()
        for i, out in enumerate(reversed(bo)):
            resnets = []
            for _ in range(layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch, out, **norm))
                ch = out
            up = Upsample2D(ch, dtype) if i < len(bo) - 1 else None
            self.up_blocks.append(_Block(resnets, upsample=up))
        self.conv_norm_out = GroupNorm(ch, groups, eps=1e-6, apply_silu=True)
        self.conv_out = Conv3x3(ch, out_channels, dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](self.conv_in(z))))
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """The decoding half of SD's KL autoencoder: ``decode`` maps latents
    [B, latent_channels, h, w] (already divided by ``scaling_factor``) to
    images [B, out_channels, 8h, 8w] in [-1, 1] (unclipped), in the compute
    dtype."""

    UNPORTED_PREFIXES = ("encoder.", "quant_conv.")

    def __init__(self, out_channels: int = 3, latent_channels: int = 4,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, norm_num_groups: int = 32,
                 scaling_factor: float = 0.18215, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_out_channels = tuple(block_out_channels)
        self.scaling_factor, self.dtype = scaling_factor, dtype
        self.decoder = Decoder(block_out_channels, layers_per_block, latent_channels,
                               out_channels, norm_num_groups, dtype)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1, dtype=dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)


__all__ = ["AutoencoderKL", "Decoder", "VAEAttention"]
