"""Beam search over injected noise (counterpart of
diffusion_tts_tpu/search/beam.py).

The SD implementation's semantics (pipeline_stable_diffusion.py:1045-1170),
on both backends: keep M = params.B beams per sample; each step draw N
candidate noises per beam, advance every (candidate, beam) pair in one
batched call, score the decoded pred-x0 and keep each sample's top M; after
the last step decode every beam and return the best.

Ties: the JAX package ranks with ``lax.top_k``, whose ties fall to the
lower index; ``torch.topk`` promises no order among ties, so the ranking
here is a stable descending sort.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diffusion_tts_torch.search.noise import InjectedNoise
from diffusion_tts_torch.utils import rng
from diffusion_tts_torch.utils.config import SearchParams

_SALT_BEAM = 0x31


class BeamResult(NamedTuple):
    x: torch.Tensor  # best terminal latents [B, ...]
    score: torch.Tensor  # [B]
    picks: torch.Tensor | None = None  # [steps, B, M] kept flat ids n*M + m, best first


def beam_search(backend, z: torch.Tensor, key: int, params: SearchParams, *,
                noise: InjectedNoise | None = None, record: bool = False) -> BeamResult:
    m, n = params.B, params.N  # beams, expansions per beam
    b, feat = z.shape[0], z.shape[1:]
    inj = noise if noise is not None else InjectedNoise()
    x = backend.init_latents(z)
    dev = x.device
    rows = torch.arange(b, device=dev)
    beams = x.unsqueeze(0).expand((m,) + x.shape)  # [M, B, ...], M copies
    picks = []
    for i in range(backend.num_steps):
        beams_flat = beams.reshape((m * b,) + feat)
        aux = backend.base_step(beams_flat, i)
        eps = (inj.beam_noise[i].to(dev, torch.float32).reshape((n, m * b) + feat)
               if inj.beam_noise is not None
               else rng.normal(key, (_SALT_BEAM, i), (n, m * b) + feat, dev))
        x_next, images = backend.expand(beams_flat, i, aux, eps)  # [N, M*B, ...]
        scores = backend.score(images).reshape(n * m, b)
        top = torch.sort(scores.T, dim=1, descending=True, stable=True)[1][:, :m]  # [B, M]
        beams = x_next.reshape((n * m, b) + feat)[top.T, rows]
        if record:
            picks.append(top)

    # the best of the M beams (pipeline:1156-1170)
    scores = backend.score(backend.final_images(beams.reshape((m * b,) + feat))).reshape(m, b)
    best = torch.argmax(scores, dim=0)
    return BeamResult(x=beams[best, rows], score=scores.max(dim=0).values,
                      picks=torch.stack(picks) if record else None)


__all__ = ["beam_search", "BeamResult"]
