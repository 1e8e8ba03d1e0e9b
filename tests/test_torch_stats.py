"""The port's training statistics (diffusion_tts_torch/utils/stats.py)
against the JAX package's (diffusion_tts_tpu/utils/stats.py).

A rank whose pending losses are all NaN or inf reports no finite value; the
collector still registers the name, so that every rank holds the same names
when sync() all-reduces their moments (tests/_torch_dist_worker.py's
``stats_nonfinite`` case, two gloo ranks). One process's ticks give the
JAX collector's as_dict() exactly: names without a value are left out.
"""
import numpy as np
import pytest
import torch

from diffusion_tts_torch.utils.stats import Collector
from diffusion_tts_tpu.utils.stats import Collector as JCollector

from _torch_port import rank_results, start_ranks

torch.set_num_threads(1)

NAN, INF = float("nan"), float("inf")
# Ticks of (name, values, rank-0-only); the second tick's losses are all
# non-finite, the third's gradient norm is partly so.
TICKS = [
    [("Loss/loss", [0.5, 1.5, 2.0], False), ("Timing/sec_per_kimg", 3.0, True)],
    [("Loss/loss", [NAN, NAN, INF, -INF], False), ("Timing/sec_per_kimg", 2.5, True)],
    [("Loss/loss", [4.0], False), ("Grad/norm", [NAN, 7.0], False),
     ("Timing/sec_per_kimg", [NAN], True)],
]


def test_a_rank_with_only_nonfinite_losses_syncs(tmp_path):
    """Rank 0 reports 4 x NaN, rank 1 [1.0, 2.0]; both then report0 a
    timing and sync: both return, with the loss over the finite values."""
    outs = rank_results("stats_nonfinite", 2, tmp_path,
                        start_ranks("stats_nonfinite", 2, tmp_path, {}))
    for out in outs:
        loss, timing = out["stats"]["Loss/loss"], out["stats"]["Timing/sec_per_kimg"]
        assert loss["num"] == 2 and loss["mean"] == 1.5 and loss["std"] == 0.5
        assert timing["num"] == 1 and timing["mean"] == 3.0
    assert outs[0]["stats"] == outs[1]["stats"]


@pytest.mark.parametrize("tick", range(len(TICKS)))
def test_one_process_ticks_match_jax(tick):
    """Tick by tick, as the loop reports and resets: as_dict() equals the
    JAX collector's, a name that saw no finite value left out."""
    mine, ref = Collector(), JCollector()
    for ticks in TICKS[:tick + 1]:
        mine.reset(), ref.reset()
        for name, values, rank0 in ticks:
            for col in (mine, ref):
                (col.report0 if rank0 else col.report)(name, values)
        mine.sync(), ref.sync()
    got, want = mine.as_dict(), ref.as_dict()
    assert got.keys() == want.keys()
    for name in want:
        assert got[name]["num"] == want[name]["num"]
        np.testing.assert_equal((got[name]["mean"], got[name]["std"]),
                                (want[name]["mean"], want[name]["std"]))
    if tick == 1:
        assert "Loss/loss" not in got and mine.mean("Loss/loss") != mine.mean("Loss/loss")
