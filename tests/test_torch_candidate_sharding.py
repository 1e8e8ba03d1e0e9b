"""Candidate-sharded search in the port (parallel/mesh.py::CandidateShards)
against the JAX package's ``candidate_sharding`` on the 8 virtual CPU
devices, under one injected noise.

The port's searches run on 2 gloo ranks in subprocesses
(tests/_torch_dist_worker.py, case "search"): each rank runs the denoiser
forwards of its half of the flattened [N*B] candidates and gathers the
rest. EDM: eps-greedy (N=4, K=2), beam (N=2 x 2 beams) and MCTS (N=2, S=2)
on the tiny ADM, 3 steps, 2 samples: 8 candidate lanes, one per JAX device
(tests/test_parallel.py:98-120's cases). MCTS's expansion steps through
``advance``, which neither package shards, so its case holds the sharded
backend's other paths. SD: eps-greedy (N=4, K=2, two prompts: 8 lanes) at
the goldens' geometry. MCTS's random child picks come from the JAX
package's key paths, as in tests/test_torch_search_methods.py.

Tolerances, those of tests/test_torch_search_methods.py (EDM) and
tests/test_torch_sd_search.py (SD): choices exact (beam's kept ids, MCTS's
arena through its terminal latents), selected pivots within 1e-5, EDM
latents atol 3e-4 / rtol 1e-4 and scores atol 1e-4, SD scores 1e-5 and
latents 1e-4 of their largest magnitude. Within the port, sharded and
unsharded runs agree to round-off of the batch split.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from diffusion_tts_torch.models.torch_import import state_dict_from_flax
from diffusion_tts_tpu.parallel.mesh import make_mesh
from diffusion_tts_tpu.pipelines import StableDiffusionSearchPipeline as JPipeline
from diffusion_tts_tpu.samplers.edm import EDMHeunSampler as JEDMHeunSampler
from diffusion_tts_tpu.scorers.brightness import BrightnessScorer as JBrightnessScorer
from diffusion_tts_tpu.search.api import run_search as j_run_search
from diffusion_tts_tpu.search.backend import EDMSearchBackend as JEDMSearchBackend
from diffusion_tts_tpu.search.noise import SALT_MCTS_PICK
from diffusion_tts_tpu.search.noise import InjectedNoise as JInjectedNoise
from diffusion_tts_tpu.search.noise import record_zero_order_draws
from diffusion_tts_tpu.utils.config import SearchParams as JSearchParams
from diffusion_tts_tpu.utils.rng import fold_in_path

from _torch_port import (
    SD_UNET_KW,
    SD_VAE_KW,
    TINY_ADM_KW,
    rank_results,
    start_ranks,
    tiny_pair,
    tiny_sd_pair,
)

torch.set_num_threads(1)

STEPS, B = 3, 2
FEAT = (16, 16, 3)
CHURN = dict(num_steps=STEPS, S_churn=40.0, S_min=0.05, S_max=50.0, S_noise=1.003)
EDM_RUNS = (("eps_greedy", dict(N=4, K=2)), ("beam", dict(N=2, B=2)), ("mcts", dict(N=2, S=2)))
SD_STEPS, SD_PARAMS, SD_LATENT = 2, dict(N=4, K=2), (2, 16, 16, 4)


def _np(noise) -> dict:
    return {f: np.array(getattr(noise, f)) for f in noise._fields
            if getattr(noise, f) is not None}


def _mcts_picks(key, p):
    """The JAX package's child picks (search/mcts.py:286-296) at every
    (step, phase, iteration) of one-phase MCTS."""
    return {(i, 0, q): np.asarray(jax.random.randint(
        fold_in_path(key, SALT_MCTS_PICK, jnp.int32(i), jnp.int32(0), jnp.int32(q - 1)),
        (B,), 0, p["N"])) for i in range(STEPS) for q in range(p["S"] + 1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("search")
    j_net, variables, _ = tiny_pair(seed=11)
    g = np.random.default_rng(31)
    z = g.standard_normal((B,) + FEAT).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[[2, 7]]
    j_key = jax.random.key(5)
    draws = {
        "eps_greedy": _np(record_zero_order_draws(jax.random.key(7), STEPS,
                                                  JSearchParams(**EDM_RUNS[0][1]), z.shape)),
        "beam": {"beam_noise": g.standard_normal((STEPS, 2, 2, B) + FEAT).astype(np.float32)},
        "mcts": {"mcts_table": g.standard_normal((STEPS, B, 2) + FEAT).astype(np.float32)},
    }
    j_unet, up, j_vae, vp, t_unet, t_vae = tiny_sd_pair(seed=21)
    cond = g.standard_normal((2, 7, 32)).astype(np.float32)
    sd_z = g.standard_normal(SD_LATENT).astype(np.float32)
    sd_draws = record_zero_order_draws(jax.random.key(9), SD_STEPS, JSearchParams(**SD_PARAMS),
                                       SD_LATENT)
    inputs = dict(net_kw=TINY_ADM_KW, state_dict=state_dict_from_flax(variables["params"]),
                  labels=labels, z=z, steps=STEPS,
                  edm_runs=[(m, p, draws[m]) for m, p in EDM_RUNS],
                  mcts_picks=_mcts_picks(j_key, EDM_RUNS[2][1]),
                  unet_kw=SD_UNET_KW, vae_kw=SD_VAE_KW, unet=t_unet.state_dict(),
                  vae=t_vae.state_dict(), sd_cond=cond, sd_z=sd_z, sd_steps=SD_STEPS,
                  sd_params=SD_PARAMS, sd_draws=_np(sd_draws))
    fut = start_ranks("search", 2, workdir, inputs)

    sharding = NamedSharding(make_mesh({"data": 8}), P("data"))
    j_backend = JEDMSearchBackend(
        sampler=JEDMHeunSampler(denoise=lambda x, s: j_net.apply(
            variables, x, s, jnp.tile(labels, (x.shape[0] // B, 1))), **CHURN),
        scorer=JBrightnessScorer(), candidate_sharding=sharding)
    jax_runs = {}
    for method, p in EDM_RUNS:
        noise = JInjectedNoise(**{k: jnp.asarray(v) for k, v in draws[method].items()})
        jax_runs[method] = j_run_search(method, j_backend, jnp.asarray(z), j_key,
                                        JSearchParams(**p), noise=noise,
                                        record_noises=method != "mcts")
    j_pipe = JPipeline(unet=j_unet, unet_params={"params": up}, vae=j_vae,
                       vae_params={"params": vp})
    bargs = {"unet": j_pipe.unet_params, "vae": j_pipe.vae_params, "cond": cond,
             "uncond": np.zeros_like(cond)}
    factory = lambda ba: j_pipe.make_backend(ba, JBrightnessScorer(),
                                             num_inference_steps=SD_STEPS, batch=2,
                                             candidate_sharding=sharding)
    jax_runs["sd"] = j_run_search("eps_greedy", factory, jnp.asarray(sd_z), jax.random.key(99),
                                  JSearchParams(**SD_PARAMS), backend_args=bargs,
                                  noise=sd_draws, record_noises=True, dispatch="per_step")
    return dict(port=rank_results("search", 2, workdir, fut), jax=jax_runs)


@pytest.mark.parametrize("method", [m for m, _ in EDM_RUNS])
def test_edm_sharded_search_matches_jax(runs, method):
    j = runs["jax"][method]
    for out in runs["port"]:
        t = out[method]
        if method == "beam":
            np.testing.assert_array_equal(t["best_noises"].numpy(), np.asarray(j.best_noises))
        elif method == "eps_greedy":
            np.testing.assert_allclose(t["best_noises"].numpy(), np.asarray(j.best_noises),
                                       atol=1e-5)
        np.testing.assert_allclose(t["x"].numpy(), np.asarray(j.x), atol=3e-4, rtol=1e-4)
        np.testing.assert_allclose(t["score"].numpy(), np.asarray(j.score), atol=1e-4)
        assert t["images"].shape == (B,) + FEAT


@pytest.mark.parametrize("method", [m for m, _ in EDM_RUNS] + ["odd"])
def test_edm_sharded_equals_unsharded(runs, method):
    """The same search with and without the sharding, in the port: the
    same choices, latents to the round-off of a batch split, and both
    ranks' results bit for bit alike (each scores the gathered set).
    "odd": eps-greedy at N=3 (the port's own draws), so that rank 1's 3
    lanes start inside a pair of samples and its class labels must follow
    the lanes (``candidate_rows``)."""
    a, b = runs["port"]
    for key in a[method]:
        assert torch.equal(a[method][key], b[method][key]), key
    t, u = a[method], a[f"{method}_plain"]
    if "best_noises" in t:
        torch.testing.assert_close(t["best_noises"], u["best_noises"], atol=1e-6, rtol=0)
    torch.testing.assert_close(t["x"], u["x"], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(t["score"], u["score"], atol=1e-5, rtol=0)


def test_sd_sharded_search_matches_jax(runs):
    j = runs["jax"]["sd"]
    jx = np.asarray(j.x)
    for out in runs["port"]:
        t = out["sd"]
        np.testing.assert_allclose(t["best_noises"].numpy(), np.asarray(j.best_noises),
                                   atol=1e-5)
        np.testing.assert_allclose(t["score"].numpy(), np.asarray(j.score), atol=1e-5)
        assert np.abs(t["x"].numpy() - jx).max() <= 1e-4 * np.abs(jx).max()
        assert t["images"].shape == (2, 32, 32, 3)


def test_sd_pipeline_call_passes_the_sharding_through(runs):
    """__call__(candidate_sharding=...) against the unsharded call from one
    seed: the same images to the round-off of the batch split, on both
    ranks alike."""
    a, b = runs["port"]
    for key in ("sd_call", "sd_call_plain"):
        for x, y in zip(a[key], b[key]):
            assert torch.equal(x, y)
    (img, score), (img0, score0) = a["sd_call"], a["sd_call_plain"]
    assert img.shape == (2, 32, 32, 3)
    torch.testing.assert_close(img, img0, atol=1 / 255 + 1e-6, rtol=0)
    torch.testing.assert_close(score, score0, atol=1e-5, rtol=0)


def test_indivisible_candidates_raise_before_any_forward(runs):
    """N*B = 3 lanes over 2 ranks: ValueError, and the denoiser never ran."""
    for out in runs["port"]:
        message, calls = out["refusal"]
        assert "3 candidate lanes do not divide over 2 ranks" in message and calls == []
