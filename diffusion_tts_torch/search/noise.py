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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Salts of the port's own draws, one per kind of draw (the JAX package's
# values; the port's generators do not reproduce its numbers).
SALT_PIVOT = 0x21
SALT_DIR = 0x22
SALT_SCALE = 0x23
SALT_BERN = 0x24
SALT_FRESH = 0x25
SALT_STEP = 0x5A1


class InjectedNoise(NamedTuple):
    """Optional external noise for one search run. ``B`` = sample batch,
    ``feat`` = latent feature shape, ``steps`` = sampler steps. A field
    left ``None`` falls back to the search's own draws."""

    pivots: torch.Tensor | None = None      # [steps, B, *feat]
    directions: torch.Tensor | None = None  # [steps, K, N, B, *feat]
    fresh: torch.Tensor | None = None       # [steps, K, N, B, *feat]
    scales01: torch.Tensor | None = None    # [steps, K, N, B]  U(0,1) perturbation scale
    explore01: torch.Tensor | None = None   # [steps, K, N]     U(0,1) explore Bernoulli
    step_noise: torch.Tensor | None = None  # naive [steps, B, *feat]


__all__ = ["InjectedNoise", "SALT_PIVOT", "SALT_DIR", "SALT_SCALE", "SALT_BERN",
           "SALT_FRESH", "SALT_STEP"]
