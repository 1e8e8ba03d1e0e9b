"""Rejection, beam and MCTS search of the port on the SD backend against the
JAX package's: the golden-geometry UNet/VAE with the same random weights,
in fp32, two prompts, guidance 7.5, 3 steps, and the same injected noise
(MCTS: the same expansion table, and the child picks and fresh-expansion
noise patched in from the JAX package's key paths).

Rejection and beam run the JAX package's whole-search program; MCTS steps
its compiled timestep, as dispatch="per_step" does.

Tolerances, as tests/test_torch_sd_search.py's: choices exact (beam's kept
ids, the MCTS arena's integers); scores within 1e-5 and MCTS rewards
within 1e-5 per visit (one uint8 level at one pixel moves the brightness by
1/(255 * 1024) = 3.8e-6; a node's reward sums its rollouts' scores);
latents within 1e-4 of their largest magnitude."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffusion_tts_torch import main as cli
from diffusion_tts_torch.pipelines import StableDiffusionSearchPipeline
from diffusion_tts_torch.scorers import BrightnessScorer
from diffusion_tts_torch.search import InjectedNoise, replay_trajectory, run_search
from diffusion_tts_torch.search.nfe import nfe_per_sample
from diffusion_tts_torch.utils.config import SearchParams
from diffusion_tts_tpu.pipelines import StableDiffusionSearchPipeline as JPipeline
from diffusion_tts_tpu.scorers.brightness import BrightnessScorer as JBrightnessScorer
from diffusion_tts_tpu.search import replay_trajectory as j_replay_trajectory
from diffusion_tts_tpu.search.api import run_search as j_run_search
from diffusion_tts_tpu.search.noise import InjectedNoise as JInjectedNoise
from diffusion_tts_tpu.utils.config import SearchParams as JSearchParams

from _torch_port import assert_mcts_arenas_match, patch_mcts_draws, tiny_sd_pair

STEPS, N, PROMPTS = 3, 2, 2
FEAT = (16, 16, 4)


@pytest.fixture(scope="module")
def rig():
    j_unet, up, j_vae, vp, t_unet, t_vae = tiny_sd_pair(seed=41)
    g = np.random.default_rng(42)
    cond = g.standard_normal((PROMPTS, 7, 32)).astype(np.float32)
    z = g.standard_normal((PROMPTS,) + FEAT).astype(np.float32)
    j_pipe = JPipeline(unet=j_unet, unet_params={"params": up}, vae=j_vae,
                       vae_params={"params": vp})
    bargs = {"unet": j_pipe.unet_params, "vae": j_pipe.vae_params, "cond": cond,
             "uncond": np.zeros_like(cond)}
    j_factory = lambda ba: j_pipe.make_backend(ba, JBrightnessScorer(),
                                               num_inference_steps=STEPS, batch=PROMPTS)
    pipe = StableDiffusionSearchPipeline(unet=t_unet, vae=t_vae)
    t_cond = torch.from_numpy(cond)
    t_backend = pipe.make_backend(t_cond, torch.zeros_like(t_cond), BrightnessScorer(),
                                  num_inference_steps=STEPS)
    return dict(z=z, g=g, bargs=bargs, j_factory=j_factory, pipe=pipe, t_backend=t_backend,
                t_cond=t_cond)


def _run_both(rig, method, params, j_noise, t_noise):
    j = j_run_search(method, rig["j_factory"], jnp.asarray(rig["z"]), jax.random.key(99),
                     JSearchParams(**params), backend_args=rig["bargs"], noise=j_noise,
                     record_noises=True)
    t = run_search(method, rig["t_backend"], torch.from_numpy(rig["z"]), 99,
                   SearchParams(**params), noise=t_noise, record_noises=True)
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score), atol=1e-5)
    _assert_latents(t.x.numpy(), np.asarray(j.x))
    assert t.images.shape == (PROMPTS, 32, 32, 3) and 0 <= t.images.min() <= t.images.max() <= 1
    return j, t


def _assert_latents(t, j):
    assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max()


def test_rejection_matches_jax(rig):
    noise = rig["g"].standard_normal((STEPS, 3, PROMPTS) + FEAT).astype(np.float32)
    _, t = _run_both(rig, "rejection", dict(N=3), JInjectedNoise(step_noise=jnp.asarray(noise)),
                     InjectedNoise(step_noise=torch.from_numpy(noise)))
    # the chosen candidate: the nearest of the replayed trajectories
    with torch.no_grad():
        every = replay_trajectory(rig["t_backend"], torch.from_numpy(np.tile(rig["z"], (3, 1, 1, 1))),
                                  torch.from_numpy(noise).flatten(1, 2))
    dist = (every.reshape(3, PROMPTS, -1) - t.x.reshape(1, PROMPTS, -1)).abs().amax(dim=2)
    assert dist.min(dim=0).values.max() <= 1e-6 * every.abs().max()


@pytest.mark.parametrize("beams", [1, 2])
def test_beam_matches_jax(rig, beams):
    noise = rig["g"].standard_normal((STEPS, N, beams, PROMPTS) + FEAT).astype(np.float32)
    j, t = _run_both(rig, "beam", dict(N=N, B=beams),
                     JInjectedNoise(beam_noise=jnp.asarray(noise)),
                     InjectedNoise(beam_noise=torch.from_numpy(noise)))
    assert t.best_noises.shape == (STEPS, PROMPTS, beams)
    np.testing.assert_array_equal(t.best_noises.numpy(), np.asarray(j.best_noises))
    assert len(np.unique(np.asarray(j.best_noises))) > 1  # the kept ids vary


@pytest.mark.parametrize("rollout_batch,fresh", [(None, False), (1, True)])
def test_mcts_arena_matches_jax(rig, monkeypatch, rollout_batch, fresh):
    j_key = jax.random.key(6)
    patch_mcts_draws(monkeypatch, j_key)
    table = rig["g"].standard_normal((STEPS, PROMPTS, N) + FEAT).astype(np.float32)
    p = dict(N=N, S=2)
    tx, jx = assert_mcts_arenas_match(
        rig["j_factory"], rig["bargs"], rig["t_backend"], rig["z"], SearchParams(**p),
        JSearchParams(**p), table, rollout_batch=rollout_batch, fresh=fresh, j_key=j_key,
        state_tol=1e-4, reward_tol=1e-5)
    _assert_latents(tx, jx)


@pytest.fixture(scope="module")
def j_rollout(rig):
    """The JAX backend's rollout, compiled once for a [B] start index (a
    scalar index, broadcast to [B], masks the same lanes)."""
    return jax.jit(lambda ba, x, i: rig["j_factory"](ba).rollout(
        x, i))


@pytest.mark.parametrize("start", [[0, STEPS - 1, 1, STEPS - 1], 1])
@torch.no_grad()
def test_rollout_matches_jax(rig, j_rollout, start):
    """Per-sample start indices that include 0 and steps - 1, and a scalar
    index; four lanes (two per prompt)."""
    x = np.random.default_rng(43).standard_normal((4,) + FEAT).astype(np.float32)
    j = j_rollout(rig["bargs"], jnp.asarray(x), jnp.broadcast_to(jnp.asarray(start), (4,)))
    t = rig["t_backend"].rollout(torch.from_numpy(x), torch.as_tensor(start)).numpy()
    j = np.asarray(j)
    assert t.shape == (4, 32, 32, 3)
    # images on the uint8 grid: at most one level apart where latents round apart
    assert np.abs(t - j).max() <= 1 / 255 + 1e-6 and np.mean(np.abs(t - j) > 1e-6) < 1e-2


@torch.no_grad()
def test_replay_matches_jax(rig):
    noise = rig["g"].standard_normal((STEPS, PROMPTS) + FEAT).astype(np.float32)
    j = jax.jit(lambda ba, zz, nz: j_replay_trajectory(rig["j_factory"](ba), zz, nz))(
        rig["bargs"], jnp.asarray(rig["z"]), jnp.asarray(noise))
    t = replay_trajectory(rig["t_backend"], torch.from_numpy(rig["z"]), torch.from_numpy(noise))
    _assert_latents(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("method", ["rejection", "beam", "mcts"])
def test_pipeline_call_matches_nfe(rig, method):
    """__call__ runs each method on its own draws, reproducibly per seed,
    and every UNet forward is accounted for: each CFG-doubled, adding up to
    nfe_per_sample sample-forwards per prompt."""
    pipe, cond = rig["pipe"], rig["t_cond"]
    calls = []
    forward = pipe.unet.forward
    pipe.unet.forward = lambda x, *a: calls.append(x.shape[0]) or forward(x, *a)
    p = SearchParams(N=N, B=2, S=2)
    run = lambda seed: pipe(prompt_embeds=cond, num_inference_steps=2,
                            score_function=BrightnessScorer(), method=method, params=p,
                            seed=seed)
    try:
        images, scores = run(5)
    finally:
        del pipe.unet.forward
    assert sum(calls) == 2 * PROMPTS * nfe_per_sample(method, 2, p, backend="sd")
    assert images.shape == (PROMPTS, 32, 32, 3) and torch.isfinite(scores).all()
    torch.testing.assert_close(run(5)[0], images, atol=0, rtol=0)
    assert not torch.equal(run(6)[0], images)


@pytest.mark.parametrize("method", ["rejection", "beam", "mcts"])
def test_chip_smoke_counts_and_hooks(rig, method):
    """The UNet calls and VAE decodes by batch are chip_smoke.method_calls's,
    which the card run's launch counts rest on, and chip_smoke's shape
    recorder (forward hooks, conv stand-ins) leaves the search's result as
    it is."""
    pipe, cond = rig["pipe"], rig["t_cond"]
    unet, decodes = collections.Counter(), collections.Counter()
    forward, decode = pipe.unet.forward, pipe.vae.decode
    pipe.unet.forward = lambda x, *a: unet.update([x.shape[0]]) or forward(x, *a)
    pipe.vae.decode = lambda z: decodes.update([z.shape[0]]) or decode(z)
    p = SearchParams(N=N, B=2, S=2)
    run = lambda: pipe(prompt_embeds=cond, num_inference_steps=2,
                       score_function=BrightnessScorer(), method=method, params=p, seed=5)[0]
    try:
        images = run()
    finally:
        del pipe.unet.forward, pipe.vae.decode
    assert (unet, decodes) == chip_smoke.method_calls(method, "sd", 2, p, PROMPTS)
    shapes = chip_smoke.KernelShapes(pipe)
    try:
        recorded = run()
    finally:
        shapes.remove()
    assert sum(shapes.counts["attention"].values()) > 0
    torch.testing.assert_close(recorded, images, atol=0, rtol=0)


@pytest.mark.parametrize("method", ["rejection", "beam", "mcts"])
def test_cli_runs_each_method_on_the_cpu(tmp_path, method):
    out = tmp_path / "sd.png"
    cli.main(["--backend", "sd", "--scorer", "brightness", "--device", "cpu", "--method", method,
              "--N", "2", "--B", "2", "--S", "2", "--num-steps", "2", "--output", str(out)])
    from PIL import Image

    assert Image.open(out).size == (32, 32)
