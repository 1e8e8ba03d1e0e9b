"""Unified search entry point (counterpart of
diffusion_tts_tpu/search/api.py::run_search).

PyTorch runs eagerly, so the JAX package's program cache and dispatch
modes have no counterpart here: the search is a Python loop over steps and
iterations whose candidate batches run on the tensors' device.
"""
from __future__ import annotations

import dataclasses

import torch

from diffusion_tts_torch.search.naive import naive_sample
from diffusion_tts_torch.search.noise import InjectedNoise
from diffusion_tts_torch.search.zero_order import eps_greedy_search, zero_order_search
from diffusion_tts_torch.utils.config import SearchParams

METHODS = ("naive", "zero_order", "eps_greedy")
# Methods of the JAX package that later slices of the port bring.
NOT_YET_PORTED = {"rejection": "ROADMAP.md Queue 1 item 8",
                  "beam": "ROADMAP.md Queue 1 item 8",
                  "mcts": "ROADMAP.md Queue 1 item 8"}


@dataclasses.dataclass
class SearchResult:
    x: torch.Tensor  # terminal latents [B, ...]
    images: torch.Tensor  # decoded images01 [B, H, W, C]
    score: torch.Tensor  # final reward per sample [B]
    best_noises: torch.Tensor | None = None  # [steps, K, B, ...] when recorded


@torch.no_grad()
def run_search(method: str, backend, z: torch.Tensor, key: int,
               params: SearchParams | None = None, *, record_noises: bool = False,
               noise: InjectedNoise | None = None) -> SearchResult:
    """Run one search method end to end. z: [B, H, W, C] unit-variance
    latents on the device the search runs on; key: the integer seed of the
    search's own draws. The final images and scores are always computed
    (edm/main.py:869-877)."""
    params = params or SearchParams()
    if method in NOT_YET_PORTED:
        raise NotImplementedError(
            f"search method {method!r} is not ported yet ({NOT_YET_PORTED[method]})")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    noises = None
    if method == "naive":
        x = naive_sample(backend, z, key, noise=noise)
    else:
        search = eps_greedy_search if method == "eps_greedy" else zero_order_search
        x, noises = search(backend, z, key, params, record_noises=record_noises, noise=noise)
    images = backend.final_images(x)
    return SearchResult(x=x, images=images, score=backend.score(images), best_noises=noises)


__all__ = ["run_search", "SearchResult", "METHODS"]
