"""Perceived-luminance reward (counterpart of
diffusion_tts_tpu/scorers/brightness.py; reference edm/scorers.py:25-54):
Rec.709 weights, clamped to [0,1]."""
from __future__ import annotations

import torch

_WEIGHTS = (0.2126, 0.7152, 0.0722)


class BrightnessScorer:
    def __call__(self, images01: torch.Tensor, cond=None, timesteps=None) -> torch.Tensor:
        x = images01.float()
        if x.shape[-1] == 3:
            w = torch.tensor(_WEIGHTS, dtype=torch.float32, device=x.device)
            lum = torch.einsum("bhwc,c->b", x, w) / (x.shape[1] * x.shape[2])
        else:
            lum = x.mean(dim=(1, 2, 3))
        return torch.clamp(lum, 0.0, 1.0)


__all__ = ["BrightnessScorer"]
