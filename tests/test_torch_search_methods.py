"""Rejection, beam and MCTS search of the port (diffusion_tts_torch/search)
against the JAX package on the EDM backend: the tiny DhariwalUNet in fp32
with the same weights, 3 steps, 2 samples, and the same injected noise
(MCTS: the same expansion table, and the child picks and fresh-expansion
noise patched in from the JAX package's key paths), so neither package
draws noise of its own.

Tolerances, as tests/test_torch_search.py's: choices exact (beam's kept
ids, rejection's chosen candidate, MCTS's arena); terminal latents atol
3e-4 / rtol 1e-4 (the first Heun step's fp32 conditioning, ROADMAP.md
Queue 3); scores atol 1e-4, and MCTS's rewards 1e-4 per visit (a node's
reward sums its rollouts' scores; one uint8 level at one pixel moves the
brightness by up to 1/(255*256) = 1.5e-5, and the latent gap flips one
now and then: 1.3e-5 seen on a node of one visit); arena states within
1e-5 of their largest magnitude (the sigma-80 states, about 300)."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffusion_tts_torch import main as cli
from diffusion_tts_torch.samplers.edm import EDMHeunSampler
from diffusion_tts_torch.scorers import BrightnessScorer
from diffusion_tts_torch.search import (
    EDMSearchBackend,
    InjectedNoise,
    record_mcts_table,
    record_step_draws,
    record_zero_order_draws,
    replay_trajectory,
    run_search,
)
from diffusion_tts_torch.search.nfe import nfe_per_sample
from diffusion_tts_torch.utils.config import SearchParams
from diffusion_tts_tpu.samplers.edm import EDMHeunSampler as JEDMHeunSampler
from diffusion_tts_tpu.scorers.brightness import BrightnessScorer as JBrightnessScorer
from diffusion_tts_tpu.search import replay_trajectory as j_replay_trajectory
from diffusion_tts_tpu.search.api import run_search as j_run_search
from diffusion_tts_tpu.search.backend import EDMSearchBackend as JEDMSearchBackend
from diffusion_tts_tpu.search.noise import InjectedNoise as JInjectedNoise
from diffusion_tts_tpu.utils.config import SearchParams as JSearchParams

from _torch_port import assert_mcts_arenas_match, patch_mcts_draws, tiny_pair

STEPS, N, B = 3, 3, 2
FEAT = (16, 16, 3)
CHURN = dict(num_steps=STEPS, S_churn=40.0, S_min=0.05, S_max=50.0, S_noise=1.003)


@pytest.fixture(scope="module")
def rig():
    j_net, variables, t_net = tiny_pair(seed=11)
    g = np.random.default_rng(31)
    z = g.standard_normal((B,) + FEAT).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[[2, 7]]
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
    return dict(z=z, g=g, j_backend=j_backend, t_backend=t_backend)


def _assert_close(t, j):
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), atol=3e-4, rtol=1e-4)
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score), atol=1e-4)
    assert t.images.shape == (B,) + FEAT and 0 <= t.images.min() <= t.images.max() <= 1


@torch.no_grad()
def _chosen(backend, z, noise, x):
    """The candidate each sample's x came from: the nearest of the N
    replayed trajectories [steps, N, B, ...]."""
    tiled = torch.from_numpy(np.tile(z, (N, 1, 1, 1)))
    every = replay_trajectory(backend, tiled, torch.from_numpy(noise).flatten(1, 2))
    dist = (every.reshape((N, B, -1)) - torch.from_numpy(np.array(x)).reshape(1, B, -1)).abs()
    return dist.amax(dim=2).argmin(dim=0).tolist()


def test_rejection_matches_jax(rig):
    noise = rig["g"].standard_normal((STEPS, N, B) + FEAT).astype(np.float32)
    p = dict(N=N)
    j = j_run_search("rejection", rig["j_backend"], jnp.asarray(rig["z"]), jax.random.key(99),
                     JSearchParams(**p), noise=JInjectedNoise(step_noise=jnp.asarray(noise)))
    t = run_search("rejection", rig["t_backend"], torch.from_numpy(rig["z"]), 99,
                   SearchParams(**p), noise=InjectedNoise(step_noise=torch.from_numpy(noise)))
    _assert_close(t, j)
    chosen = _chosen(rig["t_backend"], rig["z"], noise, t.x)
    assert chosen == _chosen(rig["t_backend"], rig["z"], noise, j.x)
    assert len(set(chosen)) > 1 or chosen[0] != 0, chosen  # not the first candidate throughout


@pytest.mark.parametrize("beams", [1, 2])
def test_beam_matches_jax(rig, beams):
    noise = rig["g"].standard_normal((STEPS, N, beams, B) + FEAT).astype(np.float32)
    p = dict(N=N, B=beams)
    j = j_run_search("beam", rig["j_backend"], jnp.asarray(rig["z"]), jax.random.key(99),
                     JSearchParams(**p), noise=JInjectedNoise(beam_noise=jnp.asarray(noise)),
                     record_noises=True)
    t = run_search("beam", rig["t_backend"], torch.from_numpy(rig["z"]), 99, SearchParams(**p),
                   noise=InjectedNoise(beam_noise=torch.from_numpy(noise)), record_noises=True)
    assert t.best_noises.shape == (STEPS, B, beams)
    np.testing.assert_array_equal(t.best_noises.numpy(), np.asarray(j.best_noises))
    assert len(np.unique(np.asarray(j.best_noises))) > 1  # the kept ids vary
    _assert_close(t, j)


@pytest.mark.parametrize("rollout_batch,fresh", [(None, False), (1, True)])
def test_mcts_arena_matches_jax(rig, monkeypatch, rollout_batch, fresh):
    """One phase of S rollouts with the per-depth table, and two phases of
    one rollout (a masked fill expansion each) with fresh expansion noise."""
    j_key = jax.random.key(5)
    patch_mcts_draws(monkeypatch, j_key)
    table = rig["g"].standard_normal((STEPS, B, 2) + FEAT).astype(np.float32)
    p = dict(N=2, S=2)
    tx, jx = assert_mcts_arenas_match(
        lambda _: rig["j_backend"], None, rig["t_backend"], rig["z"], SearchParams(**p),
        JSearchParams(**p), table, rollout_batch=rollout_batch, fresh=fresh, j_key=j_key,
        state_tol=1e-5, reward_tol=1e-4)
    np.testing.assert_allclose(tx, jx, atol=3e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def j_rollout(rig):
    """The JAX backend's rollout, compiled once for a [B] start index (a
    scalar index, broadcast to [B], masks the same lanes)."""
    return jax.jit(rig["j_backend"].rollout)


@pytest.mark.parametrize("start", [[0, STEPS - 1, 1, STEPS - 1], 1])
@torch.no_grad()
def test_rollout_matches_jax(rig, j_rollout, start):
    """Per-sample start indices that include 0 and steps - 1 (a lane that
    runs the Euler step alone), and a scalar index; four lanes, each at its
    start's noise level."""
    sigma = rig["t_backend"].sampler.t_steps.numpy()[np.broadcast_to(start, (4,))]
    x = (np.random.default_rng(33).standard_normal((4,) + FEAT)
         * sigma.reshape(4, 1, 1, 1)).astype(np.float32)
    j = np.asarray(j_rollout(jnp.asarray(x), jnp.broadcast_to(jnp.asarray(start), (4,))))
    t = rig["t_backend"].rollout(torch.from_numpy(x), torch.as_tensor(start)).numpy()
    assert t.shape == (4,) + FEAT
    # images on the uint8 grid: at most one level apart where latents round apart
    assert np.abs(t - j).max() <= 1 / 255 + 1e-6 and np.mean(np.abs(t - j) > 1e-6) < 1e-2


@torch.no_grad()
def test_replay_matches_jax(rig):
    noise = rig["g"].standard_normal((STEPS, B) + FEAT).astype(np.float32)
    j = j_replay_trajectory(rig["j_backend"], jnp.asarray(rig["z"]), jnp.asarray(noise))
    t = replay_trajectory(rig["t_backend"], torch.from_numpy(rig["z"]), torch.from_numpy(noise))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-4, rtol=1e-4)


@pytest.mark.parametrize("method", ["naive", "rejection", "eps_greedy", "mcts"])
def test_recorders_round_trip(rig, method):
    """search(key=6, noise=record(key=5)) == search(key=5): each recorder
    draws what the search draws. MCTS with one child per node, whose pick
    is forced, so the table is its only draw."""
    be, z = rig["t_backend"], torch.from_numpy(rig["z"])
    p = SearchParams(N=1 if method == "mcts" else N, K=2, S=2)
    if method == "naive":
        rec = record_step_draws(5, STEPS, z.shape)
    elif method == "rejection":
        rec = record_step_draws(5, STEPS, (N * B,) + FEAT)
    elif method == "eps_greedy":
        rec = record_zero_order_draws(5, STEPS, p, z.shape)
    else:
        rec = record_mcts_table(5, STEPS, B, p.N, FEAT)
    ref = run_search(method, be, z, 5, p)
    again = run_search(method, be, z, 6, p, noise=rec)
    torch.testing.assert_close(again.x, ref.x, atol=0, rtol=0)
    assert not torch.equal(run_search(method, be, z, 6, p).x, ref.x)


@pytest.mark.parametrize("method", ["rejection", "beam", "mcts"])
def test_forwards_match_nfe(rig, method):
    """Every denoiser forward is accounted for by nfe_per_sample, MCTS's
    masked expansions and rollout steps included, and the calls by batch
    are chip_smoke.method_calls's, which the card run's launch counts rest
    on."""
    calls = collections.Counter()
    be = rig["t_backend"]
    counting = EDMSearchBackend(
        sampler=EDMHeunSampler(denoise=lambda x, s: calls.update([x.shape[0]])
                               or be.sampler.denoise(x, s), **CHURN),
        scorer=BrightnessScorer())
    p = SearchParams(N=2, B=2, S=3)
    run_search(method, counting, torch.from_numpy(rig["z"]), 5, p)
    assert sum(b * n for b, n in calls.items()) == B * nfe_per_sample(method, STEPS, p)
    assert calls == chip_smoke.method_calls(method, "edm", STEPS, p, B)[0]


@pytest.mark.parametrize("method", ["rejection", "beam", "mcts"])
def test_cli_runs_each_method_on_the_cpu(tmp_path, method):
    out = tmp_path / "grid.png"
    cli.main(["--backend", "edm", "--scorer", "brightness", "--arch", "tiny_adm", "--device",
              "cpu", "--method", method, "--N", "2", "--B", "2", "--S", "2", "--num-steps", "2",
              "--output", str(out)])
    assert out.exists()
