"""Training statistics: moment accumulation between ticks (counterpart of
diffusion_tts_tpu/utils/stats.py).

Counterpart of the reference's training_stats
(edm/torch_utils/training_stats.py:55-266): every report accumulates
[count, sum, sum-of-squares] per metric; a collector turns the moments into
mean/std. ``Collector.sync()`` is the reference's ``Collector.update()``
all_reduce (training_stats.py:233-266): it sums the per-metric moment
vectors across the ranks of the process group (one process: nothing to
do). The jsonl format matches the reference's stats.jsonl
(training_loop.py:195-201).
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from diffusion_tts_torch.parallel.distributed import rank, world_size


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
        """Rank-0-only report (training_stats.py:102-108): only rank 0
        contributes a value, but every rank registers the name (the
        reference reports an empty list on the others), so that sync()'s
        same-name-set contract holds."""
        if rank() == 0:
            self.report(name, value)
        else:
            self._moments[name] += 0.0

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
        """Sum the moment vectors across the ranks, in sorted-name order, in
        one all_reduce. Every rank must have reported the same names since
        the last sync, the contract of the reference's per-name
        all_reduce."""
        names = sorted(self._moments)
        if world_size() == 1 or not names:
            return
        stacked = torch.from_numpy(np.stack([self._moments[n] for n in names]))
        if dist.get_backend() == "nccl":  # NCCL reduces device tensors only
            stacked = stacked.to(torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(stacked)
        for name, row in zip(names, stacked.cpu().numpy()):
            self._moments[name] = row

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
