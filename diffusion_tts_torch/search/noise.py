"""External noise injection for reproducible search (counterpart of
diffusion_tts_tpu/search/noise.py).

The reference lets a caller drive every pivot, candidate direction and
fresh exploration draw of a search from a ``precomputed_noise`` dict
(edm/main.py:54,113-121,723-796). Here each field is ``None`` (the search
makes its own draws, addressed by the salts below through
``utils.rng``) or a full per-step tensor indexed inside the search. A fully
populated ``InjectedNoise`` makes the search a deterministic function of
its inputs; the tests use it to feed the JAX package and the port the same
numbers.

``record_*_draws`` pre-draw every field on the salt paths the searches use,
on the device they run on (a torch generator's numbers depend on its
device), so ``search(key=k2, noise=record(k1)) == search(key=k1)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diffusion_tts_torch.utils import rng
from diffusion_tts_torch.utils.config import SearchParams

# Salts of the port's own draws, one per kind of draw (the JAX package's
# values; the port's generators do not reproduce its numbers).
SALT_PIVOT = 0x21
SALT_DIR = 0x22
SALT_SCALE = 0x23
SALT_BERN = 0x24
SALT_FRESH = 0x25
SALT_STEP = 0x5A1
SALT_MCTS_TAB = 0x41
SALT_MCTS_PICK = 0x42
SALT_MCTS_EXPAND = 0x43


class InjectedNoise(NamedTuple):
    """Optional external noise for one search run. ``B`` = sample batch,
    ``feat`` = latent feature shape, ``steps`` = sampler steps. A field
    left ``None`` falls back to the search's own draws."""

    pivots: torch.Tensor | None = None      # [steps, B, *feat]
    directions: torch.Tensor | None = None  # [steps, K, N, B, *feat]
    fresh: torch.Tensor | None = None       # [steps, K, N, B, *feat]
    scales01: torch.Tensor | None = None    # [steps, K, N, B]  U(0,1) perturbation scale
    explore01: torch.Tensor | None = None   # [steps, K, N]     U(0,1) explore Bernoulli
    step_noise: torch.Tensor | None = None  # naive [steps, B, *feat] / rejection [steps, N, B, *feat]
    mcts_table: torch.Tensor | None = None  # [steps, B, b, *feat]  per-depth expansion table
    beam_noise: torch.Tensor | None = None  # [steps, N, M, B, *feat]  per-beam candidates
    #   (M = params.B beams in score-rank order)


def record_zero_order_draws(key: int, num_steps: int, params: SearchParams,
                            sample_shape: tuple[int, ...], device="cpu") -> InjectedNoise:
    """Every draw of zero_order / eps_greedy, as the search makes it.
    sample_shape = (B, *feat)."""
    n, k_iters, b = params.N, params.K, sample_shape[0]
    cand = (n,) + tuple(sample_shape)
    scale_shape = (n, b) + (1,) * (len(sample_shape) - 1)
    empty = lambda *shape: torch.empty((num_steps, k_iters) + shape, device=device)
    out = InjectedNoise(pivots=torch.empty((num_steps,) + tuple(sample_shape), device=device),
                        directions=empty(*cand), fresh=empty(*cand), scales01=empty(n, b),
                        explore01=empty(n))
    for i in range(num_steps):
        out.pivots[i] = rng.normal(key, (SALT_PIVOT, i), sample_shape, device)
        for k in range(k_iters):
            out.directions[i, k] = rng.normal(key, (SALT_DIR, i, k), cand, device)
            out.fresh[i, k] = rng.normal(key, (SALT_FRESH, i, k), cand, device)
            out.scales01[i, k] = rng.uniform(key, (SALT_SCALE, i, k), scale_shape,
                                             device).reshape(n, b)
            out.explore01[i, k] = rng.uniform(key, (SALT_BERN, i, k), (n,), device)
    return out


def record_step_draws(key: int, num_steps: int, shape: tuple[int, ...],
                      device="cpu") -> InjectedNoise:
    """Per-step noise of naive (shape = (B, *feat)) or rejection (shape =
    (N*B, *feat), candidate-major; reshape to [steps, N, B, *feat])."""
    return InjectedNoise(step_noise=torch.stack(
        [rng.normal(key, (SALT_STEP, i), shape, device) for i in range(num_steps)]))


def record_mcts_table(key: int, num_steps: int, b: int, b_exp: int,
                      feat_shape: tuple[int, ...], device="cpu") -> InjectedNoise:
    """The per-depth expansion table MCTS draws once (edm/main.py:437-447)."""
    return InjectedNoise(mcts_table=rng.normal(
        key, (SALT_MCTS_TAB,), (num_steps, b, b_exp) + tuple(feat_shape), device))


__all__ = ["InjectedNoise", "record_zero_order_draws", "record_step_draws",
           "record_mcts_table", "SALT_PIVOT", "SALT_DIR", "SALT_SCALE", "SALT_BERN",
           "SALT_FRESH", "SALT_STEP", "SALT_MCTS_TAB", "SALT_MCTS_PICK", "SALT_MCTS_EXPAND"]
