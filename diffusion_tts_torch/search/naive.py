"""Naive sampling (counterpart of diffusion_tts_tpu/search/naive.py::
naive_sample): fresh churn noise per step, one trajectory (reference
edm/main.py:862-866). Rejection search and trajectory replay come with the
second slice of the port."""
from __future__ import annotations

import torch

from diffusion_tts_torch.search.noise import SALT_STEP, InjectedNoise
from diffusion_tts_torch.utils import rng


def naive_sample(backend, z: torch.Tensor, key: int,
                 noise: InjectedNoise | None = None) -> torch.Tensor:
    """One trajectory with fresh per-step noise; returns terminal latents.
    noise.step_noise [steps, B, *feat] replaces the port's own draws."""
    x = backend.init_latents(z)
    inj = noise if noise is not None else InjectedNoise()
    for i in range(backend.num_steps):
        eps = (inj.step_noise[i].to(x.device, x.dtype) if inj.step_noise is not None
               else rng.normal(key, (SALT_STEP, i), x.shape, x.device))
        x = backend.advance(x, i, backend.base_step(x, i), eps)
    return x


__all__ = ["naive_sample"]
