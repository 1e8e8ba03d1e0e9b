"""Guided-diffusion EncoderUNetModel, the noisy-ImageNet classifier, in
PyTorch, NCHW (counterpart of diffusion_tts_tpu/models/classifier.py;
reference edm/unet.py:701-911, used by ImageNetScorer).

ResBlocks with scale-shift GroupNorm conditioning and resblock up/down,
AttentionBlocks with the *legacy* (heads, 3, ch) qkv channel layout,
attention pooling (AttentionPool2d, edm/unet.py:40-69) with the *new*
(3, heads, ch) layout, sinusoidal timestep embeddings
(edm/nn_utils.py:103-121). The model runs in fp32 throughout. The JAX
package's classifier runs no Pallas kernel, so plain torch ops serve here,
and none of the port's kernels.

Module names and parameter shapes are guided-diffusion's
(``input_blocks.1.0.in_layers.0.weight``, conv1d ``[O, I, 1]`` qkv and
projection weights), so ``64x64_classifier.pt`` and the goldens' ``sd::``
state dicts load as they are. ``state_dict_from_flax_classifier`` turns the
JAX package's flax tree into the same names.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, cos first (edm/nn_utils.py:103-121)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32, eps 1e-5) (edm/nn_utils.py:17-21)."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-5)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2)


def _nearest_up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _qkv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """guided-diffusion attention numerics (edm/unet.py:355-377): scores with
    1/sqrt(sqrt(ch)) on both q and k. q, k, v: [B, H, ch, T] -> [B, H, ch, T]."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[2]))
    w = torch.softmax(torch.einsum("bhct,bhcs->bhts", q * scale, k * scale), dim=-1)
    return torch.einsum("bhts,bhcs->bhct", w, v)


class GDResBlock(nn.Module):
    """guided-diffusion ResBlock (edm/unet.py:161-275)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int, *,
                 dropout: float = 0.0, use_scale_shift_norm: bool = True, up: bool = False,
                 down: bool = False):
        super().__init__()
        self.up, self.down, self.use_scale_shift_norm = up, down, use_scale_shift_norm
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                       nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            nn.Linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels))
        self.out_layers = nn.Sequential(GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(dropout),
                                        nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = nn.Identity() if out_channels == channels else \
            nn.Conv2d(channels, out_channels, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        norm, act, conv = self.in_layers
        h = act(norm(x))
        if self.up:
            h, x = _nearest_up2(h), _nearest_up2(x)
        elif self.down:
            h, x = _avg_pool2(h), _avg_pool2(x)
        h = conv(h)
        emb_out = self.emb_layers(emb)[:, :, None, None]
        out_norm, out_rest = self.out_layers[0], self.out_layers[1:]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = out_rest(out_norm(h) * (1.0 + scale) + shift)
        else:
            h = out_rest(out_norm(h + emb_out))
        return self.skip_connection(x) + h


class GDAttentionBlock(nn.Module):
    """AttentionBlock with the legacy qkv layout: the 3C channels split as
    (heads, 3, ch) (edm/unet.py:277-343,346-377)."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, *spatial = x.shape
        x = x.reshape(b, c, -1)
        qkv = self.qkv(self.norm(x)).reshape(b, self.num_heads, 3, c // self.num_heads, -1)
        a = _qkv_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, c, -1)
        return (x + self.proj_out(a)).reshape(b, c, *spatial)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling (edm/unet.py:40-69): the mean token
    first, a positional embedding [C, T+1], one attention layer with the
    *new* (3, heads, ch) qkv layout; returns the pooled (first) token."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_head_channels: int,
                 output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** 2 + 1) / embed_dim ** 0.5)
        self.qkv_proj = nn.Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = nn.Conv1d(embed_dim, output_dim, 1)
        self.num_heads = embed_dim // num_head_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        x = x.reshape(b, c, -1)
        x = torch.cat([x.mean(dim=-1, keepdim=True), x], dim=-1)
        x = x + self.positional_embedding[None]
        qkv = self.qkv_proj(x).reshape(b, 3, self.num_heads, c // self.num_heads, -1)
        a = _qkv_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2]).reshape(b, c, -1)
        return self.c_proj(a)[:, :, 0]


class EncoderUNetModel(nn.Module):
    """Half-UNet classifier (edm/unet.py:701-911). The defaults are the
    64x64 noisy-ImageNet classifier's (edm/scorers.py:76-88): width 128,
    mult 1/2/3/4, 4 blocks, attention at downsample factors 2/4/8,
    scale-shift norm, resblock up/down, attention pooling with 64 head
    channels, 1000 classes. Input NCHW; returns logits [B, out_channels]."""

    def __init__(self, image_size: int = 64, in_channels: int = 3, model_channels: int = 128,
                 out_channels: int = 1000, num_res_blocks: int = 4,
                 attention_resolutions: Sequence[int] = (2, 4, 8), dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 3, 4), num_head_channels: int = 64,
                 use_scale_shift_norm: bool = True, resblock_updown: bool = True):
        super().__init__()
        self.image_size, self.model_channels = image_size, model_channels
        emb_ch = model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))
        res = dict(dropout=dropout, use_scale_shift_norm=use_scale_shift_norm)
        ch = int(channel_mult[0] * model_channels)
        blocks = [nn.ModuleList([nn.Conv2d(in_channels, ch, 3, padding=1)])]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                out = int(mult * model_channels)
                layers = [GDResBlock(ch, emb_ch, out, **res)]
                ch = out
                if ds in attention_resolutions:
                    layers.append(GDAttentionBlock(ch, ch // num_head_channels))
                blocks.append(nn.ModuleList(layers))
            if level != len(channel_mult) - 1:
                blocks.append(nn.ModuleList(
                    [GDResBlock(ch, emb_ch, ch, down=True, **res)] if resblock_updown else []))
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([GDResBlock(ch, emb_ch, ch, **res),
                                           GDAttentionBlock(ch, ch // num_head_channels),
                                           GDResBlock(ch, emb_ch, ch, **res)])
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 AttentionPool2d(image_size // ds, ch, num_head_channels,
                                                 out_channels))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        h = x.float()
        for block in self.input_blocks:
            if not len(block):  # a level change without resblock_updown
                h = _avg_pool2(h)
            for layer in block:
                h = layer(h, emb) if isinstance(layer, GDResBlock) else layer(h)
        for layer in self.middle_block:
            h = layer(h, emb) if isinstance(layer, GDResBlock) else layer(h)
        return self.out(h)


_FLAX_SUBMODULES = {"in_norm": "in_layers.0", "in_conv": "in_layers.2",
                    "emb_proj": "emb_layers.1", "out_norm": "out_layers.0",
                    "out_conv": "out_layers.3", "skip": "skip_connection"}
# 1x1 projections stored as conv1d [O, I, 1] in guided-diffusion
_CONV1D = {"qkv", "proj_out", "qkv_proj", "c_proj"}


def state_dict_from_flax_classifier(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's classifier ``params`` tree (numpy leaves, no
    ``"params"`` wrapper; ``convert_classifier_state_dict``'s layout) ->
    the port's guided-diffusion-named state dict."""
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [k])
            return
        value = np.asarray(node, np.float32)
        *mods, leaf = path
        head, rest = mods[0], mods[1:]
        top, _, index = head.rpartition("_")
        if top.startswith("input_blocks_"):
            prefix = f"input_blocks.{top.split('_')[-1]}.{index}"
        elif top in ("time_embed", "middle_block", "out"):
            prefix = f"{top}.{index}"
        else:
            raise ValueError(f"unmapped classifier module {'/'.join(path)}")
        names = [prefix] + [_FLAX_SUBMODULES.get(m, m) for m in rest]
        if leaf == "kernel":
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif rest and rest[-1] in _CONV1D:
                value = value.T[:, :, None]  # dense [I, O] -> conv1d [O, I, 1]
            else:
                value = value.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf not in ("bias", "positional_embedding"):
            raise ValueError(f"unmapped leaf {'/'.join(path)}")
        out[".".join(names + [leaf])] = torch.from_numpy(np.array(value))

    walk(params, [])
    return out


__all__ = ["EncoderUNetModel", "GroupNorm32", "timestep_embedding",
           "state_dict_from_flax_classifier"]
