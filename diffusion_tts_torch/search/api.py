"""Unified search entry point (counterpart of
diffusion_tts_tpu/search/api.py::run_search).

PyTorch runs eagerly, so the JAX package's program cache and dispatch
modes have no counterpart here: the search is a Python loop over steps and
iterations whose candidate batches run on the tensors' device.
"""
from __future__ import annotations

import dataclasses

import torch

from diffusion_tts_torch.search.beam import beam_search
from diffusion_tts_torch.search.mcts import mcts_search
from diffusion_tts_torch.search.naive import naive_sample, rejection_search
from diffusion_tts_torch.search.noise import InjectedNoise
from diffusion_tts_torch.search.zero_order import eps_greedy_search, zero_order_search
from diffusion_tts_torch.utils.config import SearchParams

METHODS = ("naive", "rejection", "beam", "mcts", "zero_order", "eps_greedy")


@dataclasses.dataclass
class SearchResult:
    x: torch.Tensor  # terminal latents [B, ...]
    images: torch.Tensor  # decoded images01 [B, H, W, C]
    score: torch.Tensor  # final reward per sample [B]
    best_noises: torch.Tensor | None = None  # when recorded: [steps, K, B, ...]; beam [steps, B, M]


@torch.no_grad()
def run_search(method: str, backend, z: torch.Tensor, key: int,
               params: SearchParams | None = None, *, record_noises: bool = False,
               mcts_rollout_batch: int | None = None, mcts_fresh_expansion: bool = False,
               noise: InjectedNoise | None = None) -> SearchResult:
    """Run one search method end to end. z: [B, H, W, C] unit-variance
    latents on the device the search runs on; key: the integer seed of the
    search's own draws. The final images and scores are always computed
    (edm/main.py:869-877). With ``record_noises``, zero_order and
    eps_greedy return their selected pivots and beam its kept candidate
    ids [steps, B, M] (flat n*M + m, best first) as ``best_noises``."""
    params = params or SearchParams()
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    noises = None
    if method == "naive":
        x = naive_sample(backend, z, key, noise=noise)
    elif method == "rejection":
        x, _ = rejection_search(backend, z, key, params.N, noise=noise)
    elif method == "beam":
        x, _, noises = beam_search(backend, z, key, params, noise=noise, record=record_noises)
    elif method == "mcts":
        x = mcts_search(backend, z, key, params, rollout_batch=mcts_rollout_batch, noise=noise,
                        fresh_expansion=mcts_fresh_expansion).x
    else:
        search = eps_greedy_search if method == "eps_greedy" else zero_order_search
        x, noises = search(backend, z, key, params, record_noises=record_noises, noise=noise)
    images = backend.final_images(x)
    return SearchResult(x=x, images=images, score=backend.score(images), best_noises=noises)


__all__ = ["run_search", "SearchResult", "METHODS"]
