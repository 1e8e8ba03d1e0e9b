"""AutoencoderKL, the SD latent VAE, in PyTorch, NCHW (counterpart of
diffusion_tts_tpu/models/sd_vae.py: VAEAttention, _MidBlock, Encoder,
Decoder, EncoderOutput and AutoencoderKL).

Behavioural counterpart of diffusers' AutoencoderKL at the SD
configuration: four DownEncoderBlocks and four UpDecoderBlocks, a
single-head mid-block attention, scaling_factor 0.18215. Module names are
diffusers', so every key of a diffusers ``vae/`` state dict loads. The
encoder's resnets, mid block and ``conv_norm_out`` take the same routes as
the decoder's (the conv kernel with the GroupNorm folded into its prologue
from 128x128 up, the GroupNorm and attention kernels elsewhere); its
stride-2 downsamplers are stock cuDNN convs.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from diffusion_tts_torch.models.sd_layers import (
    Conv2d,
    Conv3x3,
    Downsample2D,
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


def _mid_block(ch: int, groups: int, dtype: torch.dtype) -> _Block:
    norm = dict(groups=groups, eps=1e-6, dtype=dtype)
    return _Block([ResnetBlock2D(ch, ch, **norm), ResnetBlock2D(ch, ch, **norm)],
                  [VAEAttention(ch, groups, dtype)])


def _run_mid(mid: _Block, x: torch.Tensor) -> torch.Tensor:
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))


class Encoder(nn.Module):
    """conv_in -> down blocks (the last without a downsampler) -> mid block
    -> GN + SiLU -> conv_out to 2 * latent_channels (mean and log-variance)."""

    def __init__(self, block_out_channels: Sequence[int], layers_per_block: int,
                 latent_channels: int, in_channels: int, groups: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bo = tuple(block_out_channels)
        norm = dict(groups=groups, eps=1e-6, dtype=dtype)
        self.conv_in = Conv3x3(in_channels, bo[0], dtype)
        self.down_blocks = nn.ModuleList()
        ch = bo[0]
        for i, out in enumerate(bo):
            resnets = []
            for _ in range(layers_per_block):
                resnets.append(ResnetBlock2D(ch, out, **norm))
                ch = out
            down = Downsample2D(ch, dtype, padding=0) if i < len(bo) - 1 else None
            self.down_blocks.append(_Block(resnets, downsample=down))
        self.mid_block = _mid_block(ch, groups, dtype)
        self.conv_norm_out = GroupNorm(ch, groups, eps=1e-6, apply_silu=True)
        self.conv_out = Conv3x3(ch, 2 * latent_channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
        return self.conv_out(self.conv_norm_out(_run_mid(self.mid_block, x)))


class EncoderOutput(NamedTuple):
    """The encoder's diagonal Gaussian over latents: ``mean`` and ``logvar``
    [B, latent_channels, h, w]."""

    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, generator: torch.Generator | None = None, *,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """mean + exp(logvar / 2) * noise, logvar clamped to [-30, 20]; the
        unit noise drawn from ``generator`` (on the latents' device) unless
        handed in."""
        std = torch.exp(0.5 * torch.clamp(self.logvar, -30.0, 20.0))
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + std * noise.to(self.mean.dtype)


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
        self.mid_block = _mid_block(ch, groups, dtype)
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
        x = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """SD's KL autoencoder. ``encode`` maps images [B, in_channels, H, W] in
    [-1, 1] to an ``EncoderOutput`` over latents [B, latent_channels, H/8,
    W/8]; ``decode`` maps latents (already divided by ``scaling_factor``)
    to images [B, out_channels, 8h, 8w] in [-1, 1] (unclipped), in the
    compute dtype; ``forward`` is encode -> sample -> decode."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, latent_channels: int = 4,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, norm_num_groups: int = 32,
                 scaling_factor: float = 0.18215, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_out_channels = tuple(block_out_channels)
        self.scaling_factor, self.dtype = scaling_factor, dtype
        self.encoder = Encoder(block_out_channels, layers_per_block, latent_channels,
                               in_channels, norm_num_groups, dtype)
        self.decoder = Decoder(block_out_channels, layers_per_block, latent_channels,
                               out_channels, norm_num_groups, dtype)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1, dtype=dtype)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1, dtype=dtype)

    def encode(self, x: torch.Tensor) -> EncoderOutput:
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return EncoderOutput(mean=mean, logvar=logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None, *,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        return self.decode(self.encode(x).sample(generator, noise=noise))


__all__ = ["AutoencoderKL", "Encoder", "Decoder", "EncoderOutput", "VAEAttention"]
