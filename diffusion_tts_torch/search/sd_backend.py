"""SD search backend: stochastic-DDIM latent search with one-step lookahead
(counterpart of diffusion_tts_tpu/search/sd_backend.py::SDSearchBackend).

The modified SD pipeline's candidate evaluation
(pipeline_stable_diffusion.py:1368-1435): per timestep ONE CFG UNet forward
gives the base noise prediction every candidate reuses; each candidate's
DDIM variance noise gives latents_cand; a lookahead UNet call AT THE SAME t
(the reference's quirk, :1386-1411) gives a refined pred-x0, which is
VAE-decoded and scored on the (x*127.5+128) uint8 grid (:1413-1420). The
committed step reuses the base prediction with the winning noise (:1435).
The N candidates run as one batched UNet and one batched VAE call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from diffusion_tts_torch.samplers.ddim import StochasticDDIMSampler
from diffusion_tts_torch.scorers.base import quantize_to_uint8_grid


@dataclasses.dataclass
class SDSearchBackend:
    """``sampler.eps_model`` is already CFG-combined; ``vae_decode`` maps
    unscaled latents [B, h, w, C] to images [B, H, W, 3] in [-1, 1]."""

    sampler: StochasticDDIMSampler
    vae_decode: Callable[[torch.Tensor], torch.Tensor]
    scorer: Any  # scorers.Scorer
    scorer_cond: Any = None

    @property
    def num_steps(self) -> int:
        return self.sampler.num_steps

    def init_latents(self, z: torch.Tensor) -> torch.Tensor:
        return self.sampler.init_latents(z)

    def base_step(self, x: torch.Tensor, i) -> torch.Tensor:
        """The shared CFG UNet forward (pipeline:1341-1362)."""
        return self.sampler.eps_model(x, self.sampler.timestep(i, x.shape[0], x.device))

    def expand(self, x: torch.Tensor, i, aux: torch.Tensor, eps: torch.Tensor):
        """x [B, ...], eps [N, B, ...] -> (latents [N, B, ...], images01
        [N*B, H, W, 3]) after the lookahead and the decode."""
        n, b = eps.shape[:2]
        flat = lambda t: t.unsqueeze(0).expand((n,) + t.shape).reshape((n * b,) + t.shape[1:])
        lat_cand, _ = self.sampler.step_math(flat(x), i, flat(aux),
                                             eps.reshape((n * b,) + eps.shape[2:]))
        lookahead = self.sampler.eps_model(lat_cand,
                                           self.sampler.timestep(i, n * b, x.device))
        _, pred_x0 = self.sampler.step_math(lat_cand, i, lookahead, None)
        images = quantize_to_uint8_grid(self.vae_decode(pred_x0))
        return lat_cand.reshape(eps.shape), images

    def advance(self, x: torch.Tensor, i, aux: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return self.sampler.step_math(x, i, aux, eps)[0]

    def rollout(self, x: torch.Tensor, i) -> torch.Tensor:
        """MCTS's simulation: deterministic DDIM (one CFG UNet call a step,
        no variance noise) to the end from step i (an int or a per-sample
        [B] index); lanes with j < i keep their state. Returns the decoded
        final images01."""
        i = torch.as_tensor(i, dtype=torch.long, device=x.device)
        live_shape = i.shape + (1,) * (x.ndim - i.ndim)
        for j in range(self.num_steps):
            eps_pred = self.sampler.eps_model(x, self.sampler.timestep(j, x.shape[0], x.device))
            x_next, _ = self.sampler.step_math(x, j, eps_pred, None)
            x = torch.where((j >= i).reshape(live_shape), x_next, x)
        return self.final_images(x)

    def final_images(self, x: torch.Tensor) -> torch.Tensor:
        return quantize_to_uint8_grid(self.vae_decode(x))

    def score(self, images01: torch.Tensor, timesteps=None) -> torch.Tensor:
        b = images01.shape[0]
        cond = self.scorer_cond
        if cond is not None and cond.shape[0] not in (1, b):
            cond = cond.repeat((b // cond.shape[0],) + (1,) * (cond.ndim - 1))
        return self.scorer(images01, cond, timesteps)


__all__ = ["SDSearchBackend"]
