"""The SD slice end to end: the port's pipeline backend and search against
the JAX package's, on the golden-geometry UNet/VAE with the same random
weights, in fp32, from one fully populated InjectedNoise (3 steps, N = 2,
K = 2, guidance 7.5, one prompt), so neither package draws noise of its own.

The JAX search runs one compiled timestep per step (dispatch="per_step",
the same results as one whole-search program, which takes the CPU compiler
far longer).

Tolerances: selected pivots within 1e-5 (another selection would move a
pivot by O(1)); scores within 1e-5 (one uint8 level at one pixel moves the
brightness by 1/(255 * 1024) = 3.8e-6); terminal latents within 1e-4 of
their largest magnitude (fp32 forwards summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.pipelines import StableDiffusionSearchPipeline
from diffusion_tts_torch.scorers import BrightnessScorer
from diffusion_tts_torch.search import InjectedNoise, run_search
from diffusion_tts_torch.search.nfe import nfe_per_sample
from diffusion_tts_torch.utils.config import SearchParams
from diffusion_tts_tpu.pipelines import StableDiffusionSearchPipeline as JPipeline
from diffusion_tts_tpu.scorers.brightness import BrightnessScorer as JBrightnessScorer
from diffusion_tts_tpu.search.api import run_search as j_run_search
from diffusion_tts_tpu.search.nfe import nfe_per_sample as j_nfe_per_sample
from diffusion_tts_tpu.search.noise import InjectedNoise as JInjectedNoise
from diffusion_tts_tpu.search.noise import record_zero_order_draws
from diffusion_tts_tpu.utils.config import SearchParams as JSearchParams

from _torch_port import tiny_sd_pair

STEPS, N, K = 3, 2, 2
LATENT = (1, 16, 16, 4)


@pytest.fixture(scope="module")
def rig():
    j_unet, up, j_vae, vp, t_unet, t_vae = tiny_sd_pair(seed=21)
    g = np.random.default_rng(22)
    cond = g.standard_normal((1, 7, 32)).astype(np.float32)
    z = g.standard_normal(LATENT).astype(np.float32)
    j_pipe = JPipeline(unet=j_unet, unet_params={"params": up}, vae=j_vae,
                       vae_params={"params": vp})
    bargs = {"unet": j_pipe.unet_params, "vae": j_pipe.vae_params, "cond": cond,
             "uncond": np.zeros_like(cond)}
    j_factory = lambda ba: j_pipe.make_backend(ba, JBrightnessScorer(),
                                               num_inference_steps=STEPS, batch=1)
    pipe = StableDiffusionSearchPipeline(unet=t_unet, vae=t_vae)
    t_cond = torch.from_numpy(cond)
    t_backend = pipe.make_backend(t_cond, torch.zeros_like(t_cond), BrightnessScorer(),
                                  num_inference_steps=STEPS)
    draws = record_zero_order_draws(jax.random.key(7), STEPS, JSearchParams(N=N, K=K), LATENT)
    return dict(z=z, bargs=bargs, j_factory=j_factory, pipe=pipe, t_backend=t_backend,
                t_cond=t_cond, draws=draws)


def _run_both(rig, method, draws):
    params = dict(N=N, K=K)
    j = j_run_search(method, rig["j_factory"], jnp.asarray(rig["z"]), jax.random.key(99),
                     JSearchParams(**params), backend_args=rig["bargs"], noise=draws,
                     record_noises=method != "naive", dispatch="per_step")
    inj = InjectedNoise(**{f: torch.from_numpy(np.array(getattr(draws, f)))
                           for f in InjectedNoise._fields if getattr(draws, f) is not None})
    t = run_search(method, rig["t_backend"], torch.from_numpy(rig["z"]), 99,
                   SearchParams(**params), noise=inj, record_noises=method != "naive")
    return j, t


def _assert_close(j, t):
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score), atol=1e-5)
    jx = np.asarray(j.x)
    assert np.abs(t.x.numpy() - jx).max() <= 1e-4 * np.abs(jx).max()
    assert t.images.shape == (1, 32, 32, 3) and 0 <= t.images.min() <= t.images.max() <= 1


@pytest.mark.parametrize("method", ["eps_greedy", "zero_order"])
def test_search_decisions_match_jax(rig, method):
    draws = rig["draws"]
    if method == "eps_greedy":  # both kinds of candidate slot occur
        explore = np.asarray(draws.explore01) < SearchParams().eps
        assert explore.any() and not explore.all()
    j, t = _run_both(rig, method, draws)
    assert t.best_noises.shape == (STEPS, K) + LATENT
    np.testing.assert_allclose(t.best_noises.numpy(), np.asarray(j.best_noises), atol=1e-5)
    _assert_close(j, t)


def test_naive_matches_jax(rig):
    noise = np.random.default_rng(23).standard_normal((STEPS,) + LATENT).astype(np.float32)
    j, t = _run_both(rig, "naive", JInjectedNoise(step_noise=jnp.asarray(noise)))
    _assert_close(j, t)


def test_pipeline_call_and_nfe(rig):
    """__call__ draws its own latents and noise from ``seed``
    (reproducibly), and every UNet forward of the search is accounted for:
    one base and K lookahead forwards per step, each CFG-doubled, adding up
    to nfe_per_sample sample-forwards."""
    pipe, cond = rig["pipe"], rig["t_cond"]
    calls = []
    forward = pipe.unet.forward
    pipe.unet.forward = lambda x, *a: calls.append(x.shape[0]) or forward(x, *a)
    p = SearchParams(N=N, K=K)
    try:
        images, scores = pipe(prompt_embeds=cond, num_inference_steps=STEPS,
                              score_function=BrightnessScorer(), method="eps_greedy",
                              params=p, seed=5)
    finally:
        del pipe.unet.forward
    assert len(calls) == STEPS * (1 + K)
    assert sum(calls) == 2 * nfe_per_sample("eps_greedy", STEPS, p, backend="sd")
    again, _ = pipe(prompt_embeds=cond, num_inference_steps=STEPS,
                    score_function=BrightnessScorer(), method="eps_greedy", params=p, seed=5)
    other, _ = pipe(prompt_embeds=cond, num_inference_steps=STEPS,
                    score_function=BrightnessScorer(), method="eps_greedy", params=p, seed=6)
    assert images.shape == (1, 32, 32, 3) and torch.isfinite(scores).all()
    torch.testing.assert_close(images, again, atol=0, rtol=0)
    assert not torch.equal(images, other)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        pipe(prompt="a photo")


@pytest.mark.parametrize("backend", ["edm", "sd"])
def test_nfe_matches_jax(backend):
    """The port's NFE accounting is the JAX package's, for every method."""
    for method in ("naive", "rejection", "zero_order", "eps_greedy", "beam", "mcts"):
        for kw in (dict(N=4, K=2, B=2, S=3), dict(N=3, K=0, B=1, S=1)):
            assert nfe_per_sample(method, 6, SearchParams(**kw), backend=backend) == \
                j_nfe_per_sample(method, 6, JSearchParams(**kw), backend=backend), (method, kw)
