"""Scorer protocol and the uint8 value grid (counterpart of
diffusion_tts_tpu/scorers/base.py).

The reference scores ``(x*127.5+128).clip(0,255).to(uint8)`` decodes
(edm/main.py:126-129). Scorers here take float images already on that
grid, so scoring stays on the device.
"""
from __future__ import annotations

from typing import Protocol

import torch


def quantize_to_uint8_grid(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] model output -> trunc(clip(x*127.5+128, 0, 255)) / 255 in
    fp32. torch's ``.to(uint8)`` truncates; after the clip the values are
    >= 0, so floor == trunc."""
    q = torch.clamp(x.float() * 127.5 + 128.0, 0.0, 255.0)
    return torch.floor(q) / 255.0


class Scorer(Protocol):
    """score(images01 [B,H,W,C] float in [0,1], cond, timesteps) -> [B]."""

    def __call__(self, images01: torch.Tensor, cond=None,
                 timesteps: torch.Tensor | None = None) -> torch.Tensor:
        ...


__all__ = ["Scorer", "quantize_to_uint8_grid"]
