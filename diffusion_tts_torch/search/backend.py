"""Search backend for EDM (counterpart of
diffusion_tts_tpu/search/backend.py::EDMSearchBackend).

The searched variable is the churn noise ``eps`` of one Heun step
(edm/main.py:84-85). Candidates are scored on the decoded predicted clean
image, on the uint8 grid the reference feeds its scorers
(edm/main.py:824-838). With ``candidate_sharding`` (a
``parallel.mesh.CandidateShards``) each rank runs the Heun step of its slice
of the flattened [N*B] candidates and gathers the rest, as the JAX backend's
sharding constraint spreads them over a mesh; ``base_step`` and ``rollout``
run whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from diffusion_tts_torch.parallel.mesh import CandidateShards
from diffusion_tts_torch.samplers.edm import EDMHeunSampler
from diffusion_tts_torch.scorers.base import quantize_to_uint8_grid


@dataclasses.dataclass
class EDMSearchBackend:
    """EDM backend: Heun/churn step, pixel-space decode = uint8 quantize."""

    sampler: EDMHeunSampler
    scorer: Any  # scorers.Scorer
    scorer_cond: torch.Tensor | None = None  # class labels [B, label_dim]
    candidate_sharding: CandidateShards | None = None

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
        eps_flat = eps.reshape((n * b,) + eps.shape[2:])
        step = lambda xs, es: self.sampler.step(xs, i, es)
        shards = self.candidate_sharding
        x_next, pred_x0 = (step(x_flat, eps_flat) if shards is None
                           else shards.map(step, x_flat, eps_flat))
        return x_next.reshape(eps.shape), quantize_to_uint8_grid(pred_x0)

    def advance(self, x: torch.Tensor, i, aux, eps: torch.Tensor) -> torch.Tensor:
        """Commit the chosen noise: one sampler step."""
        return self.sampler.step(x, i, eps)[0]

    def rollout(self, x: torch.Tensor, i) -> torch.Tensor:
        """MCTS's simulation (edm/main.py:630-645): zero-noise Heun steps to
        the end from step i (an int or a per-sample [B] index); every step
        runs for the whole batch and lanes with j < i keep their state.
        Returns the final images01."""
        i = torch.as_tensor(i, dtype=torch.long, device=x.device)
        live_shape = i.shape + (1,) * (x.ndim - i.ndim)
        zeros = torch.zeros_like(x)
        for j in range(self.num_steps):
            x = torch.where((j >= i).reshape(live_shape), self.sampler.step(x, j, zeros)[0], x)
        return self.final_images(x)

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
