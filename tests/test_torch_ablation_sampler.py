"""The port's ablation sampler (diffusion_tts_torch/samplers/edm.py::
AblationSampler) against the JAX package on the CPU: its tables over every
option, the reference goldens with the analytic denoiser, tiny nets under
the VP, VE and iDDPM preconditioners, and eps-greedy through the search
backend under one injected noise."""
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.backends import edm_entry
from diffusion_tts_torch.models.preconds import VEPrecond, VPPrecond, iDDPMPrecond
from diffusion_tts_torch.models.torch_import import (
    flax_buffers_from_state_dict,
    flax_from_state_dict,
    load_into,
    random_state_dict,
)
from diffusion_tts_torch.samplers.edm import AblationSampler
from diffusion_tts_torch.scorers import BrightnessScorer
from diffusion_tts_torch.search import EDMSearchBackend, InjectedNoise, run_search
from diffusion_tts_torch.utils.config import SearchParams
from diffusion_tts_tpu.models import preconds as j_preconds
from diffusion_tts_tpu.samplers.edm import AblationSampler as JAblationSampler
from diffusion_tts_tpu.scorers.brightness import BrightnessScorer as JBrightnessScorer
from diffusion_tts_tpu.search.api import run_search as j_run_search
from diffusion_tts_tpu.search.backend import EDMSearchBackend as JEDMSearchBackend
from diffusion_tts_tpu.search.noise import record_zero_order_draws
from diffusion_tts_tpu.utils.config import SearchParams as JSearchParams

from _torch_port import GOLDENS

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)


def t_denoise(x, sigma):
    return x / (1.0 + sigma.reshape(-1, 1, 1, 1).float() ** 2)


def j_denoise(x, sigma):
    return x / (1.0 + jnp.reshape(sigma, (-1, 1, 1, 1)).astype(jnp.float32) ** 2)


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


OPTIONS = list(itertools.product(("vp", "ve", "iddpm", "edm"), ("vp", "ve", "linear"),
                                 ("vp", "none"), ("euler", "heun")))
EXTRAS = {
    "churn": dict(discretization="edm", schedule="linear", scaling="none", S_churn=30.0,
                  S_min=0.1, S_max=30.0, S_noise=1.007),
    "alpha": dict(discretization="vp", schedule="vp", scaling="vp", alpha=0.7),
    "net_clamps": dict(discretization="iddpm", schedule="linear", scaling="none",
                       net_sigma_min=0.01, net_sigma_max=40.0, S_churn=10.0),
    "vp_clamps_churn": dict(discretization="vp", schedule="ve", scaling="vp",
                            net_sigma_min=0.05, net_sigma_max=60.0, S_churn=20.0, S_max=10.0),
}


def _assert_tables_match(kw):
    t = AblationSampler(denoise=t_denoise, **kw)
    j = JAblationSampler(denoise=j_denoise, **kw)
    t_tab = t.tables(torch.device("cpu"))
    assert sorted(t_tab) == sorted(j._tab)
    for name, value in j._tab.items():
        np.testing.assert_allclose(t_tab[name].numpy(), np.asarray(value), rtol=1e-7, atol=0,
                                   err_msg=name)
    assert t._x0_scale == pytest.approx(j._x0_scale, rel=1e-12)


@pytest.mark.parametrize("disc,sched,scaling,solver", OPTIONS)
def test_tables_match_jax(disc, sched, scaling, solver):
    """All 48 combinations at 18 steps: every table of the port equals the
    JAX package's ``_tab`` within 1e-7 relative."""
    _assert_tables_match(dict(num_steps=18, discretization=disc, schedule=sched,
                              scaling=scaling, solver=solver))


@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_tables_match_jax_with_churn_alpha_and_clamps(name):
    _assert_tables_match(dict(num_steps=12, solver="heun", **EXTRAS[name]))


def test_unknown_option_raises():
    with pytest.raises(ValueError, match="discretization"):
        AblationSampler(denoise=t_denoise, discretization="karras")


# tests/test_samplers.py::ABL_CASES
ABL_CASES = {
    "abl_euler_vp_vp_vp": dict(solver="euler", discretization="vp", schedule="vp", scaling="vp"),
    "abl_heun_ve_ve_none": dict(solver="heun", discretization="ve", schedule="ve",
                                scaling="none"),
    "abl_heun_iddpm_lin_none": dict(solver="heun", discretization="iddpm", schedule="linear",
                                    scaling="none"),
    "abl_heun_edm_lin_none_churn": dict(solver="heun", discretization="edm", schedule="linear",
                                        scaling="none", S_churn=30.0, S_min=0.1, S_max=30.0,
                                        S_noise=1.007),
    "abl_euler_edm_lin_vp_alpha": dict(solver="heun", discretization="edm", schedule="linear",
                                       scaling="vp", alpha=0.7),
}


@pytest.mark.parametrize("name", sorted(ABL_CASES))
def test_ablation_golden_and_jax(name):
    """The reference's ablation_sampler goldens at tests/test_samplers.py's
    1e-3, and the JAX package's sample on the same inputs at 1e-5."""
    with np.load(os.path.join(GOLDENS, f"sampler_{name}.npz")) as f:
        d = {k: f[k] for k in f.files}
    z = _nhwc(d["latents"])
    eps = (np.stack([_nhwc(n) for n in d["noise"]]) if d["noise"].ndim > 1
           else np.zeros((12,) + z.shape, np.float32))
    out = AblationSampler(denoise=t_denoise, num_steps=12, **ABL_CASES[name]).sample(
        torch.from_numpy(z), torch.from_numpy(eps)).numpy()
    np.testing.assert_allclose(out, _nhwc(d["out"]), atol=1e-3, rtol=1e-3)
    j_out = JAblationSampler(denoise=j_denoise, num_steps=12, **ABL_CASES[name]).sample(
        jnp.asarray(z), jnp.asarray(eps))
    np.testing.assert_allclose(out, np.asarray(j_out), atol=1e-5, rtol=1e-5)


def test_heun_costs_two_forwards_a_step_euler_one():
    calls = []

    def counting(x, sigma):
        calls.append(x.shape[0])
        return t_denoise(x, sigma)

    z = torch.zeros((2, 4, 4, 3))
    for solver, want in (("heun", 2 * 5), ("euler", 5)):
        calls.clear()
        AblationSampler(denoise=counting, num_steps=5, solver=solver).sample(
            z, torch.zeros((5,) + z.shape))
        assert len(calls) == want, solver


def test_per_sample_step_index_matches_scalar_steps():
    """A per-sample [B] index (MCTS expands nodes at several depths in one
    call) gives each sample its own step's result."""
    s = AblationSampler(denoise=t_denoise, num_steps=6, discretization="vp", schedule="vp",
                        scaling="vp", S_churn=10.0)
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal((3, 4, 4, 3)).astype(np.float32) * 5)
    eps = torch.from_numpy(g.standard_normal((3, 4, 4, 3)).astype(np.float32))
    idx = [0, 3, 5]
    got, den = s.step(x, torch.tensor(idx), eps)
    for b, i in enumerate(idx):
        want, want_den = s.step(x[b:b + 1], i, eps[b:b + 1])
        torch.testing.assert_close(got[b:b + 1], want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(den[b:b + 1], want_den, rtol=1e-6, atol=1e-6)


# ------------------------------------------------ tiny nets under the preconds

# The EDM paper's three original samplers (edm/generate.py:270-283), each on
# a net of its family at test width: (port precond, JAX precond name, the
# net's config, sampler options).
NCSNPP_TINY = dict(edm_entry.TINY_SMOKE, model_kwargs=dict(
    edm_entry.TINY_SMOKE["model_kwargs"], embedding_type="fourier", encoder_type="residual",
    decoder_type="standard", channel_mult_noise=2, resample_filter=(1, 3, 3, 1)))
NET_SAMPLERS = {
    "vp": (VPPrecond, "VPPrecond", edm_entry.TINY_SMOKE,
           dict(solver="euler", discretization="vp", schedule="vp", scaling="vp")),
    "ve": (VEPrecond, "VEPrecond", NCSNPP_TINY,
           dict(solver="euler", discretization="ve", schedule="ve", scaling="none")),
    "iddpm": (iDDPMPrecond, "iDDPMPrecond", edm_entry.TINY_ADM,
              dict(solver="euler", discretization="iddpm", schedule="linear", scaling="none")),
}
B, STEPS = 2, 3


def _net_pair(name, seed):
    """(port net, JAX denoise, port denoise, sampler kwargs with the net's
    sigma range): one set of random weights, made in the port and carried
    to the JAX package."""
    precond, j_name, cfg, opts = NET_SAMPLERS[name]
    t_net = load_into(precond(**cfg), random_state_dict(precond(**cfg), seed)).eval()
    state = t_net.state_dict()
    variables = {"params": flax_from_state_dict(state)}
    buffers = flax_buffers_from_state_dict(state)
    if buffers:
        variables["buffers"] = buffers
    j_net = getattr(j_preconds, j_name)(**cfg)
    labels = np.eye(10, dtype=np.float32)[[2, 7]]
    t_labels = torch.from_numpy(labels)
    j_den = lambda x, s: j_net.apply(variables, x, s, jnp.tile(labels, (x.shape[0] // B, 1)))
    t_den = lambda x, s: t_net(x, s, t_labels.repeat(x.shape[0] // B, 1))
    kw = dict(opts, num_steps=STEPS, net_sigma_min=float(t_net.sigma_min),
              net_sigma_max=float(t_net.sigma_max))
    return t_net, j_den, t_den, kw


@pytest.mark.parametrize("name", sorted(NET_SAMPLERS))
def test_tiny_net_sampler_matches_jax(name):
    """VP on DDPM++, VE on NCSN++ and iDDPM on the ADM, each at test width,
    3 steps on the same z and eps: the final x within 1e-4 of its largest
    magnitude."""
    _, j_den, t_den, kw = _net_pair(name, seed=21)
    g = np.random.default_rng(22)
    z = g.standard_normal((B, 16, 16, 3)).astype(np.float32)
    eps = g.standard_normal((STEPS, B, 16, 16, 3)).astype(np.float32)
    j_out = np.asarray(JAblationSampler(denoise=j_den, **kw).sample(jnp.asarray(z),
                                                                     jnp.asarray(eps)))
    with torch.no_grad():
        t_out = AblationSampler(denoise=t_den, **kw).sample(torch.from_numpy(z),
                                                            torch.from_numpy(eps)).numpy()
    scale = np.abs(j_out).max()
    assert np.isfinite(t_out).all() and scale > 0.1
    np.testing.assert_allclose(t_out / scale, j_out / scale, atol=1e-4, rtol=0)


def test_eps_greedy_through_the_iddpm_sampler_matches_jax():
    """eps-greedy with the iDDPM ablation sampler through EDMSearchBackend,
    the tiny ADM under iDDPMPrecond, fp32, one fully populated
    InjectedNoise: the same selections, scores within 1e-5."""
    _, j_den, t_den, kw = _net_pair("iddpm", seed=23)
    n, k = 2, 2
    z = np.random.default_rng(24).standard_normal((B, 16, 16, 3)).astype(np.float32)
    j_backend = JEDMSearchBackend(sampler=JAblationSampler(denoise=j_den, **kw),
                                  scorer=JBrightnessScorer())
    t_backend = EDMSearchBackend(sampler=AblationSampler(denoise=t_den, **kw),
                                 scorer=BrightnessScorer())
    draws = record_zero_order_draws(jax.random.key(25), STEPS, JSearchParams(N=n, K=k), z.shape)
    j = j_run_search("eps_greedy", j_backend, jnp.asarray(z), jax.random.key(99),
                     JSearchParams(N=n, K=k), noise=draws, record_noises=True)
    inj = InjectedNoise(**{f: torch.from_numpy(np.array(getattr(draws, f)))
                           for f in ("pivots", "directions", "fresh", "scales01", "explore01")})
    with torch.no_grad():
        t = run_search("eps_greedy", t_backend, torch.from_numpy(z), 99, SearchParams(N=n, K=k),
                       noise=inj, record_noises=True)
    assert t.best_noises.shape == (STEPS, k, B, 16, 16, 3)
    np.testing.assert_allclose(t.best_noises.numpy(), np.asarray(j.best_noises), atol=1e-5)
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score), atol=1e-5)
