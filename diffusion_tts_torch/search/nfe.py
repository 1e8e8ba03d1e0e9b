"""Analytic NFE accounting for the search methods (counterpart of
diffusion_tts_tpu/search/nfe.py): denoiser forwards per sample for a
(method, steps, params). The EDM Heun pair costs 2 NFE per step, the final
step included (its second forward runs and is masked off)."""
from __future__ import annotations

from diffusion_tts_torch.utils.config import SearchParams


def nfe_per_sample(method: str, steps: int, p: SearchParams, backend: str = "edm") -> int:
    per_step = 2 if backend == "edm" else 1  # Heun pair vs one eps-model call
    if method == "naive":
        return steps * per_step
    if method == "rejection":
        return p.N * steps * per_step
    if method in ("zero_order", "eps_greedy"):
        if backend == "edm":
            # the commit reuses the winning candidate's expand result, so
            # K>=1 pays only the expansions
            return steps * (p.K * p.N + (1 if p.K == 0 else 0)) * per_step
        # SD: 1 base UNet + per (K,N) one lookahead UNet; commit reuses base
        return steps * (1 + p.K * p.N)
    if method == "beam":
        if backend == "edm":
            return steps * p.B * p.N * per_step
        return steps * p.B * (1 + p.N)
    if method == "mcts":
        # per timestep: root expansion (<=N children) + S rollouts x (leaf
        # expansion <=N + zero-noise simulation over all steps)
        sim = steps * per_step if backend == "edm" else steps
        exp = p.N * per_step if backend == "edm" else p.N
        return steps * (exp + p.S * (exp + sim))
    raise ValueError(f"unknown method {method!r}")


__all__ = ["nfe_per_sample"]
