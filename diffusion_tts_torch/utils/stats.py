"""Training statistics: moment accumulation between ticks (counterpart of
diffusion_tts_tpu/utils/stats.py).

Counterpart of the reference's training_stats
(edm/torch_utils/training_stats.py:55-266): every report accumulates
[count, sum, sum-of-squares] per metric; a collector turns the moments into
mean/std. Training runs in one process until distributed training is
ported, so ``report0`` is ``report`` and ``sync`` (the reference's
cross-process all_reduce) does nothing. The jsonl format matches the
reference's stats.jsonl (training_loop.py:195-201).
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Any

import numpy as np


class Collector:
    """Accumulates [num, sum, sum^2] moments per metric between ticks."""

    def __init__(self):
        self._moments: dict[str, np.ndarray] = defaultdict(lambda: np.zeros(3))

    def report(self, name: str, value) -> None:
        v = np.asarray(value, np.float64).reshape(-1)
        v = v[np.isfinite(v)]
        if v.size:
            self._moments[name] += np.array([v.size, v.sum(), np.square(v).sum()])

    def report0(self, name: str, value) -> None:
        """Rank-0-only report (training_stats.py:102-108)."""
        self.report(name, value)

    def mean(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        mean = m[1] / m[0]
        var = max(m[2] / m[0] - mean**2, 0.0)
        return float(np.sqrt(var))

    def sync(self) -> None:
        """Sum the moments across processes: one process, nothing to do."""

    def as_dict(self) -> dict[str, dict[str, float]]:
        return {
            k: {"num": int(m[0]), "mean": self.mean(k), "std": self.std(k)}
            for k, m in self._moments.items()
        }

    def reset(self) -> None:
        self._moments.clear()


class JsonlLogger:
    """stats.jsonl writer in the reference's format: one JSON object per
    tick with {metric: {num, mean, std}} plus a timestamp."""

    def __init__(self, path: str):
        self._f = open(path, "at")

    def write(self, collector: Collector, **extra: Any) -> None:
        rec = dict(collector.as_dict(), timestamp=time.time(), **extra)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


__all__ = ["Collector", "JsonlLogger"]
