"""Search backend for EDM (counterpart of
diffusion_tts_tpu/search/backend.py::EDMSearchBackend).

The searched variable is the churn noise ``eps`` of one Heun step
(edm/main.py:84-85). Candidates are scored on the decoded predicted clean
image, on the uint8 grid the reference feeds its scorers
(edm/main.py:824-838). ``rollout`` (MCTS) and candidate sharding come with
later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from diffusion_tts_torch.samplers.edm import EDMHeunSampler
from diffusion_tts_torch.scorers.base import quantize_to_uint8_grid


@dataclasses.dataclass
class EDMSearchBackend:
    """EDM backend: Heun/churn step, pixel-space decode = uint8 quantize."""

    sampler: EDMHeunSampler
    scorer: Any  # scorers.Scorer
    scorer_cond: torch.Tensor | None = None  # class labels [B, label_dim]

    @property
    def num_steps(self) -> int:
        return self.sampler.num_steps

    def init_latents(self, z: torch.Tensor) -> torch.Tensor:
        return self.sampler.init_latents(z)

    def base_step(self, x: torch.Tensor, i) -> None:
        """Per-step work shared by all candidates: none on EDM."""
        return None

    def expand(self, x: torch.Tensor, i, aux, eps: torch.Tensor):
        """Step every candidate: x [B, ...], eps [N, B, ...] ->
        (x_next [N, B, ...], images01 [N*B, H, W, C])."""
        n, b = eps.shape[:2]
        x_flat = x.unsqueeze(0).expand(eps.shape).reshape((n * b,) + x.shape[1:])
        x_next, pred_x0 = self.sampler.step(x_flat, i, eps.reshape((n * b,) + eps.shape[2:]))
        return x_next.reshape(eps.shape), quantize_to_uint8_grid(pred_x0)

    def advance(self, x: torch.Tensor, i, aux, eps: torch.Tensor) -> torch.Tensor:
        """Commit the chosen noise: one sampler step."""
        return self.sampler.step(x, i, eps)[0]

    def final_images(self, x: torch.Tensor) -> torch.Tensor:
        return quantize_to_uint8_grid(x)

    def score(self, images01: torch.Tensor, timesteps=None) -> torch.Tensor:
        b = images01.shape[0]
        cond = self.scorer_cond
        if cond is not None and cond.shape[0] != b:
            cond = cond.repeat((b // cond.shape[0],) + (1,) * (cond.ndim - 1))
        if timesteps is None:
            timesteps = torch.zeros((b,), dtype=torch.float32, device=images01.device)
        return self.scorer(images01, cond, timesteps)


__all__ = ["EDMSearchBackend"]
