"""Naive sampling, rejection (best-of-N) search and trajectory replay
(counterpart of diffusion_tts_tpu/search/naive.py).

naive: fresh churn / variance noise per step, one trajectory (reference
edm/main.py:862-866). rejection: N independent full trajectories batched
candidate-major on the leading axis ([N*B], sample index fastest, the
layout the backends' conditioning tiles), the terminal reward's argmax per
sample (edm/main.py:101-137).
"""
from __future__ import annotations

import torch

from diffusion_tts_torch.search.noise import SALT_STEP, InjectedNoise
from diffusion_tts_torch.utils import rng


def _run_steps(backend, x: torch.Tensor, key: int, step_noise: torch.Tensor | None) -> torch.Tensor:
    """Advance x over every step with step_noise[i] (reshaped to x) or the
    port's own draw on (SALT_STEP, i)."""
    for i in range(backend.num_steps):
        eps = (step_noise[i].to(x.device, x.dtype).reshape(x.shape) if step_noise is not None
               else rng.normal(key, (SALT_STEP, i), x.shape, x.device))
        x = backend.advance(x, i, backend.base_step(x, i), eps)
    return x


def naive_sample(backend, z: torch.Tensor, key: int,
                 noise: InjectedNoise | None = None) -> torch.Tensor:
    """One trajectory with fresh per-step noise; returns terminal latents.
    noise.step_noise [steps, B, *feat] replaces the port's own draws."""
    inj = noise if noise is not None else InjectedNoise()
    return _run_steps(backend, backend.init_latents(z), key, inj.step_noise)


def rejection_search(backend, z: torch.Tensor, key: int, n: int,
                     noise: InjectedNoise | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-of-N full trajectories: (best terminal latents [B, ...], their
    scores [B]). noise.step_noise [steps, N, B, *feat] replaces the port's
    own draws."""
    b = z.shape[0]
    inj = noise if noise is not None else InjectedNoise()
    z_rep = z.repeat((n,) + (1,) * (z.ndim - 1))  # [N*B, ...] candidate-major
    x = _run_steps(backend, backend.init_latents(z_rep), key, inj.step_noise)
    scores = backend.score(backend.final_images(x)).reshape(n, b)
    best = torch.argmax(scores, dim=0)  # [B], first maximum
    x_best = x.reshape((n, b) + x.shape[1:])[best, torch.arange(b, device=x.device)]
    return x_best, scores.max(dim=0).values


def replay_trajectory(backend, z: torch.Tensor, noises: torch.Tensor) -> torch.Tensor:
    """Advance with an explicit per-step noise trajectory [steps, B, ...]:
    replaying a search's selected noises reproduces its sample."""
    return _run_steps(backend, backend.init_latents(z), 0, noises)


__all__ = ["naive_sample", "rejection_search", "replay_trajectory"]
