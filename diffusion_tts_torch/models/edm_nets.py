"""SongUNet (DDPM++ / NCSN++) and DhariwalUNet (ADM) in PyTorch, NCHW
(counterpart of diffusion_tts_tpu/models/edm_nets.py).

Behavioural counterparts of the reference architectures
(edm/training/networks.py:229-363 SongUNet, :372-461 DhariwalUNet), with
the reference's module names ("{res}x{res}_{role}") so reference state
dicts load by name.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_tts_torch.models.layers import (
    EDMConv,
    EDMGroupNorm,
    EDMGroupNormSiLU,
    EDMLinear,
    FourierEmbedding,
    PositionalEmbedding,
    UNetBlock,
)


def _label_keep(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """label_dropout's keep mask [B, 1], drawn from ``generator``."""
    if generator is None:
        raise ValueError("label_dropout in train() mode needs a generator")
    return torch.rand((x.shape[0], 1), generator=generator, device=x.device) >= rate


class SongUNet(nn.Module):
    """DDPM++ / NCSN++ (reference networks.py:229-363): a single attention
    head per block, the timestep embedding added before norm1, skip_scale
    sqrt(1/2), xavier init. ``encoder_type`` 'standard' is DDPM++, 'skip'
    adds the downsampled input at each level, 'residual' (NCSN++) merges an
    aux image pyramid at each downsampling; ``decoder_type`` 'skip' adds the
    progressive-output pyramid. Takes x [B, C, H, W], noise_labels [B],
    class_labels [B or 1, label_dim] and, with ``augment_dim``,
    augment_labels [B, augment_dim]; returns [B, out_channels, H, W] in the
    compute dtype. ``train()`` turns on the blocks' dropout and
    ``label_dropout``, both drawn from the ``generator`` handed to
    ``forward``. Parameters are stored in ``param_dtype`` (default:
    ``dtype``; see models/layers.py)."""

    def __init__(self, img_resolution: int, in_channels: int, out_channels: int,
                 label_dim: int = 0, augment_dim: int = 0, model_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 2, 2, 2), channel_mult_emb: int = 4,
                 num_blocks: int = 4, attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.10, label_dropout: float = 0.0,
                 embedding_type: str = "positional", channel_mult_noise: int = 1,
                 encoder_type: str = "standard", decoder_type: str = "standard",
                 resample_filter: Sequence[int] = (1, 1),
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None):
        super().__init__()
        if embedding_type not in ("fourier", "positional"):
            raise ValueError(f"unknown embedding_type {embedding_type!r}")
        if encoder_type not in ("standard", "skip", "residual"):
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        if decoder_type not in ("standard", "skip"):
            raise ValueError(f"unknown decoder_type {decoder_type!r}")
        self.dtype, self.label_dropout, self.label_dim = dtype, label_dropout, label_dim
        emb_channels = model_channels * channel_mult_emb
        noise_channels = model_channels * channel_mult_noise
        init = dict(init_mode="xavier_uniform")
        init_zero = dict(init_mode="xavier_uniform", init_weight=1e-5)
        init_attn = dict(init_mode="xavier_uniform", init_weight=math.sqrt(0.2))
        block = dict(emb_channels=emb_channels, num_heads=1, dropout=dropout,
                     skip_scale=math.sqrt(0.5), eps=1e-6, resample_filter=resample_filter,
                     resample_proj=True, adaptive_scale=False, init=init, init_zero=init_zero,
                     init_attn=init_attn, dtype=dtype, param_dtype=param_dtype)
        init = dict(init, dtype=dtype, param_dtype=param_dtype)
        init_zero = dict(init_zero, dtype=dtype, param_dtype=param_dtype)

        # Mapping.
        self.map_noise = (PositionalEmbedding(num_channels=noise_channels, endpoint=True)
                          if embedding_type == "positional" else
                          FourierEmbedding(num_channels=noise_channels))
        self.map_label = EDMLinear(label_dim, noise_channels, **init) if label_dim else None
        self.map_augment = (EDMLinear(augment_dim, noise_channels, bias=False, **init)
                            if augment_dim else None)
        self.map_layer0 = EDMLinear(noise_channels, emb_channels, **init)
        self.map_layer1 = EDMLinear(emb_channels, emb_channels, **init)

        # Encoder (reference :276-297).
        self.enc = nn.ModuleDict()
        cout = caux = in_channels
        for level, mult in enumerate(channel_mult):
            res = img_resolution >> level
            if level == 0:
                cin, cout = cout, model_channels
                self.enc[f"{res}x{res}_conv"] = EDMConv(cin, cout, 3, **init)
            else:
                self.enc[f"{res}x{res}_down"] = UNetBlock(cout, cout, down=True, **block)
                if encoder_type == "skip":
                    self.enc[f"{res}x{res}_aux_down"] = EDMConv(
                        caux, caux, 0, down=True, resample_filter=resample_filter, **init)
                    self.enc[f"{res}x{res}_aux_skip"] = EDMConv(caux, cout, 1, **init)
                if encoder_type == "residual":
                    self.enc[f"{res}x{res}_aux_residual"] = EDMConv(
                        caux, cout, 3, down=True, resample_filter=resample_filter,
                        fused_resample=True, **init)
                    caux = cout
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=(res in attn_resolutions), **block)
        skips = [m.out_channels for name, m in self.enc.items() if "aux" not in name]

        # Decoder (reference :300-317).
        self.dec = nn.ModuleDict()
        for level, mult in reversed(list(enumerate(channel_mult))):
            res = img_resolution >> level
            if level == len(channel_mult) - 1:
                self.dec[f"{res}x{res}_in0"] = UNetBlock(cout, cout, attention=True, **block)
                self.dec[f"{res}x{res}_in1"] = UNetBlock(cout, cout, **block)
            else:
                self.dec[f"{res}x{res}_up"] = UNetBlock(cout, cout, up=True, **block)
            for idx in range(num_blocks + 1):
                cin, cout = cout + skips.pop(), model_channels * mult
                self.dec[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=(idx == num_blocks and res in attn_resolutions),
                    **block)
            if decoder_type == "skip" or level == 0:
                if decoder_type == "skip" and level < len(channel_mult) - 1:
                    self.dec[f"{res}x{res}_aux_up"] = EDMConv(
                        out_channels, out_channels, 0, up=True,
                        resample_filter=resample_filter, **init)
                self.dec[f"{res}x{res}_aux_norm"] = EDMGroupNorm(cout, eps=1e-6)
                self.dec[f"{res}x{res}_aux_conv"] = EDMConv(cout, out_channels, 3, **init_zero)

    def forward(self, x: torch.Tensor, noise_labels: torch.Tensor,
                class_labels: torch.Tensor | None = None,
                augment_labels: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        # Mapping (reference :319-331). The embedding's halves are swapped to
        # [sin, cos], a quirk of the Song codebase that the weights bake in.
        emb = self.map_noise(noise_labels)
        emb = emb.reshape(emb.shape[0], 2, -1).flip(1).reshape(emb.shape)
        if self.map_label is not None:
            tmp = class_labels
            if self.training and self.label_dropout > 0.0:
                tmp = tmp * _label_keep(x, self.label_dropout, generator).to(tmp.dtype)
            # scaled by sqrt(label_dim), the label layer's fan-in (reference :325)
            emb = emb + self.map_label(tmp * math.sqrt(self.label_dim))
        if self.map_augment is not None and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels)
        emb = F.silu(self.map_layer0(emb))
        emb = F.silu(self.map_layer1(emb))

        # Encoder (reference :333-345).
        x = aux = x.to(self.dtype)
        skips = []
        for name, m in self.enc.items():
            if "aux_down" in name:
                aux = m(aux)
            elif "aux_skip" in name:
                x = skips[-1] = x + m(aux)
            elif "aux_residual" in name:
                x = skips[-1] = aux = (x + m(aux)) / math.sqrt(2.0)
            else:
                x = m(x, emb, generator) if isinstance(m, UNetBlock) else m(x)
                skips.append(x)

        # Decoder (reference :347-362).
        aux = tmp = None
        for name, m in self.dec.items():
            if "aux_up" in name:
                aux = m(aux)
            elif "aux_norm" in name:
                tmp = m(x)
            elif "aux_conv" in name:
                tmp = m(F.silu(tmp))
                aux = tmp if aux is None else tmp + aux
            else:
                if "_block" in name:
                    x = torch.cat([x, skips.pop()], dim=1)
                x = m(x, emb, generator)
        return aux


class DhariwalUNet(nn.Module):
    """ADM: multi-head attention with 64 channels per head, adaptive-scale
    conditioning, kaiming-uniform init. Takes x [B, C, H, W], noise_labels
    [B], class_labels [B or 1, label_dim] and, with ``augment_dim``,
    augment_labels [B, augment_dim]; returns [B, out_channels, H, W] in the
    compute dtype. ``train()`` takes the place of the JAX module's
    ``train=True``: it turns on the blocks' dropout and ``label_dropout``,
    both drawn from the ``generator`` handed to ``forward``. Parameters are
    stored in ``param_dtype`` (default: ``dtype``; see models/layers.py)."""

    def __init__(self, img_resolution: int, in_channels: int, out_channels: int,
                 label_dim: int = 0, augment_dim: int = 0, model_channels: int = 192,
                 channel_mult: Sequence[int] = (1, 2, 3, 4), channel_mult_emb: int = 4,
                 num_blocks: int = 3, attn_resolutions: Sequence[int] = (32, 16, 8),
                 dropout: float = 0.10, label_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype, self.label_dropout = dtype, label_dropout
        emb_channels = model_channels * channel_mult_emb
        init = dict(init_mode="kaiming_uniform", init_weight=math.sqrt(1.0 / 3.0),
                    init_bias=math.sqrt(1.0 / 3.0))
        init_zero = dict(init_mode="kaiming_uniform", init_weight=0.0, init_bias=0.0)
        block = dict(emb_channels=emb_channels, channels_per_head=64, dropout=dropout,
                     init=init, init_zero=init_zero, dtype=dtype, param_dtype=param_dtype)
        init = dict(init, dtype=dtype, param_dtype=param_dtype)
        init_zero = dict(init_zero, dtype=dtype, param_dtype=param_dtype)

        self.map_noise = PositionalEmbedding(num_channels=model_channels)
        self.map_augment = (EDMLinear(augment_dim, model_channels, bias=False, **init_zero)
                            if augment_dim else None)
        self.map_layer0 = EDMLinear(model_channels, emb_channels, **init)
        self.map_layer1 = EDMLinear(emb_channels, emb_channels, **init)
        self.map_label = (
            EDMLinear(label_dim, emb_channels, bias=False, init_mode="kaiming_normal",
                      init_weight=math.sqrt(label_dim), dtype=dtype, param_dtype=param_dtype)
            if label_dim else None)

        self.enc = nn.ModuleDict()
        cout = in_channels
        for level, mult in enumerate(channel_mult):
            res = img_resolution >> level
            if level == 0:
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_conv"] = EDMConv(cin, cout, 3, **init)
            else:
                self.enc[f"{res}x{res}_down"] = UNetBlock(cout, cout, down=True, **block)
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=(res in attn_resolutions), **block)
        skips = [m.out_channels for m in self.enc.values()]

        self.dec = nn.ModuleDict()
        for level, mult in reversed(list(enumerate(channel_mult))):
            res = img_resolution >> level
            if level == len(channel_mult) - 1:
                self.dec[f"{res}x{res}_in0"] = UNetBlock(cout, cout, attention=True, **block)
                self.dec[f"{res}x{res}_in1"] = UNetBlock(cout, cout, **block)
            else:
                self.dec[f"{res}x{res}_up"] = UNetBlock(cout, cout, up=True, **block)
            for idx in range(num_blocks + 1):
                cin, cout = cout + skips.pop(), model_channels * mult
                self.dec[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=(res in attn_resolutions), **block)
        self.out_norm = EDMGroupNormSiLU(cout)
        self.out_conv = EDMConv(cout, out_channels, 3, **init_zero)

    def forward(self, x: torch.Tensor, noise_labels: torch.Tensor,
                class_labels: torch.Tensor | None = None,
                augment_labels: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        # Mapping (reference :440-450): label embedding added after layer1,
        # silu applied last.
        emb = self.map_noise(noise_labels)
        if self.map_augment is not None and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels)
        emb = F.silu(self.map_layer0(emb))
        emb = self.map_layer1(emb)
        if self.map_label is not None:
            tmp = class_labels
            if self.training and self.label_dropout > 0.0:
                tmp = tmp * _label_keep(x, self.label_dropout, generator).to(tmp.dtype)
            emb = emb + self.map_label(tmp)
        emb = F.silu(emb)

        x = x.to(self.dtype)
        skips = []
        for name, m in self.enc.items():
            x = m(x, emb, generator) if isinstance(m, UNetBlock) else m(x)
            skips.append(x)
        for name, m in self.dec.items():
            if "_block" in name:
                x = torch.cat([x, skips.pop()], dim=1)
            x = m(x, emb, generator)
        return self.out_conv(self.out_norm(x))


__all__ = ["SongUNet", "DhariwalUNet"]
