"""Typed search hyperparameters (counterpart of
diffusion_tts_tpu/utils/config.py::SearchParams)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Search hyperparameters; the typed SamplingParams (edm/main.py:35-43).

    N: candidates per expansion; K: local-search iterations per timestep;
    B: beam width / batch copies; S: MCTS iterations per timestep;
    lambda_: zero-order perturbation scale; eps: eps-greedy explore prob.
    Defaults follow the unified CLI (main.py:90-95).
    """

    N: int = 4
    K: int = 20
    B: int = 2
    S: int = 8
    lambda_: float = 0.15
    eps: float = 0.4

    def replace(self, **kwargs) -> "SearchParams":
        return dataclasses.replace(self, **kwargs)


__all__ = ["SearchParams"]
