"""Zero-order local search and epsilon-greedy search over injected noise
(counterpart of diffusion_tts_tpu/search/zero_order.py).

Reference semantics (edm/main.py:714-866): per timestep, start from a
fresh Gaussian pivot and run K local-search iterations. Each iteration
draws N candidates: with prob (1-eps) a perturbation ``pivot + U(0,1) *
lambda * sqrt(CHW) * unit(randn)``, with prob eps a fresh Gaussian (one
Bernoulli per candidate slot, shared across the batch, edm/main.py:751).
All candidates are stepped, their decoded pred-x0 scored, and the pivot
moves to the first-maximum argmax. The committed step reuses the winning
candidate's already computed x_next. zero_order is eps=0.

Python loops replace the JAX package's ``lax.scan``s; candidates run as
one batched denoiser call per iteration.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from diffusion_tts_torch.search.noise import (
    SALT_BERN, SALT_DIR, SALT_FRESH, SALT_PIVOT, SALT_SCALE, InjectedNoise,
)
from diffusion_tts_torch.utils import rng
from diffusion_tts_torch.utils.config import SearchParams


class ZeroOrderResult(NamedTuple):
    x: torch.Tensor  # terminal latents [B, ...]
    best_noises: torch.Tensor | None  # [steps, K, B, ...] selected pivots


def zero_order_timestep(backend, x: torch.Tensor, key: int, i: int, params: SearchParams,
                        *, explore_eps: float = 0.0, record_noises: bool = False,
                        noise: InjectedNoise | None = None):
    """One timestep: K iterations of N-candidate expansion + argmax, then
    the committed step. Returns (x_next, [K, B, ...] selected pivots or
    None)."""
    n, k_iters = params.N, params.K
    b, feat = x.shape[0], x.shape[1:]
    dev = x.device
    lam = params.lambda_ * math.sqrt(math.prod(feat))
    inj = noise if noise is not None else InjectedNoise()
    given = lambda t: t.to(dev, torch.float32)
    rows = torch.arange(b, device=dev)

    aux = backend.base_step(x, i)
    pivot = (given(inj.pivots[i]) if inj.pivots is not None
             else rng.normal(key, (SALT_PIVOT, i), x.shape, dev))
    x_next, picks = None, []
    for k in range(k_iters):
        dirs = (given(inj.directions[i, k]) if inj.directions is not None
                else rng.normal(key, (SALT_DIR, i, k), (n,) + x.shape, dev))
        dirs = rng.unit_normalize(dirs.reshape((n * b,) + feat)).reshape(dirs.shape)
        scale_shape = (n, b) + (1,) * len(feat)
        scales01 = (given(inj.scales01[i, k]).reshape(scale_shape) if inj.scales01 is not None
                    else rng.uniform(key, (SALT_SCALE, i, k), scale_shape, dev))
        perturbed = pivot.unsqueeze(0) + scales01 * lam * dirs
        fresh = (given(inj.fresh[i, k]) if inj.fresh is not None
                 else rng.normal(key, (SALT_FRESH, i, k), (n,) + x.shape, dev))
        bern = (given(inj.explore01[i, k]) if inj.explore01 is not None
                else rng.uniform(key, (SALT_BERN, i, k), (n,), dev))
        explore = (bern < explore_eps).reshape((n,) + (1,) * x.ndim)
        cands = torch.where(explore, fresh, perturbed)

        x_next_cands, images = backend.expand(x, i, aux, cands)
        scores = backend.score(images).reshape(n, b)
        best = torch.argmax(scores, dim=0)  # [B], first maximum
        pivot = cands[best, rows]
        x_next = x_next_cands[best, rows]
        if record_noises:
            picks.append(pivot)
    if k_iters == 0:  # degenerate K=0: commit the fresh pivot
        x_next = backend.advance(x, i, aux, pivot)
    return x_next, (torch.stack(picks) if record_noises else None)


def zero_order_search(backend, z: torch.Tensor, key: int, params: SearchParams, *,
                      explore_eps: float = 0.0, record_noises: bool = False,
                      noise: InjectedNoise | None = None) -> ZeroOrderResult:
    x = backend.init_latents(z)
    noises = []
    for i in range(backend.num_steps):
        x, picks = zero_order_timestep(backend, x, key, i, params, explore_eps=explore_eps,
                                       record_noises=record_noises, noise=noise)
        noises.append(picks)
    return ZeroOrderResult(x=x, best_noises=torch.stack(noises) if record_noises else None)


def eps_greedy_search(backend, z: torch.Tensor, key: int, params: SearchParams, *,
                      record_noises: bool = False,
                      noise: InjectedNoise | None = None) -> ZeroOrderResult:
    """The paper's headline method: zero-order exploitation plus
    eps-probability global exploration (edm/main.py:789-795)."""
    return zero_order_search(backend, z, key, params, explore_eps=params.eps,
                             record_noises=record_noises, noise=noise)


__all__ = ["zero_order_search", "zero_order_timestep", "eps_greedy_search",
           "ZeroOrderResult"]
