"""Search decisions of the port (diffusion_tts_torch/search) against the
JAX package, on the tiny DhariwalUNet in fp32 with the same weights and one
fully populated InjectedNoise, so no draw of either package's own is used
and bf16 near-ties cannot flip an argmax."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.samplers.edm import EDMHeunSampler
from diffusion_tts_torch.scorers import BrightnessScorer
from diffusion_tts_torch.search import EDMSearchBackend, InjectedNoise, run_search
from diffusion_tts_torch.search.nfe import nfe_per_sample
from diffusion_tts_torch.utils import rng as t_rng
from diffusion_tts_torch.utils.config import SearchParams
from diffusion_tts_tpu.samplers.edm import EDMHeunSampler as JEDMHeunSampler
from diffusion_tts_tpu.search import zero_order as j_zero_order
from diffusion_tts_tpu.scorers.brightness import BrightnessScorer as JBrightnessScorer
from diffusion_tts_tpu.search.api import run_search as j_run_search
from diffusion_tts_tpu.search.backend import EDMSearchBackend as JEDMSearchBackend
from diffusion_tts_tpu.search.noise import record_zero_order_draws
from diffusion_tts_tpu.utils.config import SearchParams as JSearchParams

from _torch_port import tiny_pair

STEPS, N, K, B = 3, 2, 2, 2
CHURN = dict(num_steps=STEPS, S_churn=40.0, S_min=0.05, S_max=50.0, S_noise=1.003)


@pytest.fixture(scope="module")
def rig():
    j_net, variables, t_net = tiny_pair(seed=11)
    g = np.random.default_rng(12)
    z = g.standard_normal((B, 16, 16, 3)).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[np.arange(B)]
    t_labels = torch.from_numpy(labels)

    j_backend = JEDMSearchBackend(
        sampler=JEDMHeunSampler(
            denoise=lambda x, s: j_net.apply(variables, x, s,
                                             jnp.tile(labels, (x.shape[0] // B, 1))),
            **CHURN),
        scorer=JBrightnessScorer())
    t_backend = EDMSearchBackend(
        sampler=EDMHeunSampler(
            denoise=lambda x, s: t_net(x, s, t_labels.repeat(x.shape[0] // B, 1)), **CHURN),
        scorer=BrightnessScorer())
    draws = record_zero_order_draws(jax.random.key(7), STEPS, JSearchParams(N=N, K=K), z.shape)
    return dict(z=z, j_backend=j_backend, t_backend=t_backend, draws=draws)


@pytest.mark.parametrize("method", ["eps_greedy", "zero_order"])
def test_search_decisions_match_jax(rig, method):
    draws = rig["draws"]
    if method == "eps_greedy":  # both kinds of candidate slot occur
        explore = np.asarray(draws.explore01) < SearchParams().eps
        assert explore.any() and not explore.all()
    j = j_run_search(method, rig["j_backend"], jnp.asarray(rig["z"]), jax.random.key(99),
                     JSearchParams(N=N, K=K), noise=draws, record_noises=True)
    inj = InjectedNoise(**{f: torch.from_numpy(np.array(getattr(draws, f)))
                           for f in ("pivots", "directions", "fresh", "scales01", "explore01")})
    t = run_search(method, rig["t_backend"], torch.from_numpy(rig["z"]), 99,
                   SearchParams(N=N, K=K), noise=inj, record_noises=True)
    # Selected pivots per (step, k): another choice would move a pivot by O(1).
    assert t.best_noises.shape == (STEPS, K, B, 16, 16, 3)
    np.testing.assert_allclose(t.best_noises.numpy(), np.asarray(j.best_noises), atol=1e-5)
    # fp32 rounding of the first Heun step at sigma 80 (|x_hat| ~ 300, its
    # update scaled by |h / t_next| ~ 31) carries ulp-level differences to
    # at most 1.7e-4 on latents of magnitude 10 (ROADMAP.md Queue 3).
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), atol=3e-4, rtol=1e-4)
    # One uint8 level at a pixel moves the brightness by at most 1/(255*256).
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score), atol=1e-4)
    assert t.images.min() >= 0 and t.images.max() <= 1


def test_latent_gap_survives_identical_unit_directions(rig, monkeypatch):
    """The terminal-latent gap above (up to 1.64e-4, ROADMAP.md Queue 3) is
    not unit_normalize's summation order: given the same unit directions
    (the JAX draws normalized once, in float64, by numpy) and no
    normalization of their own, the two packages still differ by more than
    1e-5. Its cause is the first Heun step's fp32 conditioning
    (tests/test_torch_samplers.py::test_first_step_gap_is_fp32_conditioning)."""
    d = np.asarray(rig["draws"].directions, np.float64)  # [steps, K, N, B, *feat]
    unit = d / np.sqrt(np.sum(d * d, axis=tuple(range(4, d.ndim)), keepdims=True))
    draws = rig["draws"]._replace(directions=jnp.asarray(unit.astype(np.float32)))
    monkeypatch.setattr(j_zero_order, "unit_normalize", lambda x: x)
    monkeypatch.setattr(t_rng, "unit_normalize", lambda x: x)
    # a new backend object: the JAX package caches compiled searches per backend
    j_backend = JEDMSearchBackend(sampler=rig["j_backend"].sampler, scorer=JBrightnessScorer())
    j = j_run_search("eps_greedy", j_backend, jnp.asarray(rig["z"]), jax.random.key(99),
                     JSearchParams(N=N, K=K), noise=draws)
    inj = InjectedNoise(**{f: torch.from_numpy(np.array(getattr(draws, f)))
                           for f in ("pivots", "directions", "fresh", "scales01", "explore01")})
    t = run_search("eps_greedy", rig["t_backend"], torch.from_numpy(rig["z"]), 99,
                   SearchParams(N=N, K=K), noise=inj)
    gap = np.abs(t.x.numpy() - np.asarray(j.x)).max()
    assert 1e-5 < gap <= 3e-4, gap


def test_own_draws_and_nfe(rig):
    """Without injection the port draws its own noise, reproducibly per
    seed; every forward of the search is accounted for by nfe_per_sample."""
    calls = []
    be = rig["t_backend"]
    counting = EDMSearchBackend(
        sampler=EDMHeunSampler(denoise=lambda x, s: calls.append(x.shape[0])
                               or be.sampler.denoise(x, s), **CHURN),
        scorer=BrightnessScorer())
    z = torch.from_numpy(rig["z"])
    p = SearchParams(N=N, K=K)
    a = run_search("eps_greedy", counting, z, 5, p)
    assert sum(calls) == B * nfe_per_sample("eps_greedy", STEPS, p)
    b = run_search("eps_greedy", be, z, 5, p)
    c = run_search("eps_greedy", be, z, 6, p)
    torch.testing.assert_close(a.x, b.x, atol=0, rtol=0)
    assert not torch.allclose(a.x, c.x)
    naive = run_search("naive", be, z, 5, p)
    assert naive.x.shape == z.shape and torch.isfinite(naive.score).all()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        run_search("mcts", be, z, 5, p)
