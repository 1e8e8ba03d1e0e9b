"""The port's EDM Heun sampler (diffusion_tts_torch/samplers) against the
reference golden and the JAX package's step, with an analytic denoiser."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.samplers.edm import EDMHeunSampler
from diffusion_tts_tpu.samplers.edm import EDMHeunSampler as JEDMHeunSampler

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
CHURN = dict(num_steps=18, sigma_min=0.002, sigma_max=80.0, rho=7.0,
             S_churn=40.0, S_min=0.05, S_max=50.0, S_noise=1.003)


def t_denoise(x, sigma):
    return x / (1.0 + sigma.reshape(-1, 1, 1, 1).float() ** 2)


def j_denoise(x, sigma):
    return x / (1.0 + jnp.reshape(sigma, (-1, 1, 1, 1)).astype(jnp.float32) ** 2)


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


def test_edm_heun_golden():
    """Same golden and tolerance as tests/test_samplers.py::test_edm_heun_parity."""
    with np.load(os.path.join(GOLDENS, "sampler_edm_heun.npz")) as f:
        d = {k: f[k] for k in f.files}
    s = EDMHeunSampler(denoise=t_denoise, **CHURN)
    z = torch.from_numpy(_nhwc(d["latents"]))
    eps = torch.from_numpy(np.stack([_nhwc(n) for n in d["noise"]]))
    out, _ = s.sample(z, eps)
    np.testing.assert_allclose(out.numpy(), _nhwc(d["out"]), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("index", ["scalar", "per_sample"])
def test_step_matches_jax(index):
    g = np.random.default_rng(0)
    x = g.standard_normal((3, 4, 4, 3)).astype(np.float32) * 5
    eps = g.standard_normal((3, 4, 4, 3)).astype(np.float32)
    s_t = EDMHeunSampler(denoise=t_denoise, **CHURN)
    s_j = JEDMHeunSampler(denoise=j_denoise, **CHURN)
    np.testing.assert_array_equal(s_t.t_steps.numpy(), np.asarray(s_j.t_steps))
    # the last step (17) takes the Euler select
    steps = [0, 9, 17] if index == "scalar" else [np.array([0, 9, 17], np.int32)]
    for i in steps:
        it = torch.from_numpy(i) if isinstance(i, np.ndarray) else i
        xt, dt = s_t.step(torch.from_numpy(x), it, torch.from_numpy(eps))
        xj, dj = s_j.step(jnp.asarray(x), jnp.asarray(i), jnp.asarray(eps))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5, rtol=1e-5)
    z = torch.from_numpy(x)
    np.testing.assert_allclose(s_t.init_latents(z).numpy(),
                               np.asarray(s_j.init_latents(jnp.asarray(x))), rtol=1e-6)


def test_first_step_gap_is_fp32_conditioning():
    """Why the search tests hold terminal latents to 3e-4 (ROADMAP.md Queue
    3): the first churn + Heun step at sigma_max is ill-conditioned in fp32.
    |x_hat| reaches about 300 (ulp 3e-5) and the Heun update scales the
    error of d_prime by |h / t_next|, about 31. With an analytic denoiser
    (no network, no search) each package's x_next lies within
    |h / t_next| * ulp(max |x_hat|) of a float64 evaluation of the same
    formula, and the two differ from each other by more than 1e-4."""
    den = lambda x, s, lib: x / (1.0 + lib.reshape(s, (-1, 1, 1, 1)) ** 2) + 0.3 * lib.sin(x)
    kw = dict(num_steps=3, S_churn=40.0, S_min=0.05, S_max=50.0, S_noise=1.003)
    s_t = EDMHeunSampler(denoise=lambda x, s: den(x, s, torch), **kw)
    s_j = JEDMHeunSampler(denoise=lambda x, s: den(x, s, jnp), **kw)
    g = np.random.default_rng(0)
    x = (g.standard_normal((4, 16, 16, 3)) * 80).astype(np.float32)
    eps = g.standard_normal((4, 16, 16, 3)).astype(np.float32)
    got_t = s_t.step(torch.from_numpy(x), 0, torch.from_numpy(eps))[0].numpy()
    got_j = np.asarray(jax.jit(lambda a, e: s_j.step(a, jnp.int32(0), e)[0])(x, eps))

    tab = {k: v.double().numpy() for k, v in s_t.tables(torch.device("cpu")).items()}
    t_hat, t_next, h = tab["t_hat"][0], tab["t_steps"][1], tab["h"][0]
    x_hat = x.astype(np.float64) + tab["noise_scale"][0] * eps.astype(np.float64)
    d_cur = (x_hat - den(x_hat, np.float64(t_hat), np)) / t_hat
    x_eul = x_hat + h * d_cur
    d_prime = (x_eul - den(x_eul, np.float64(t_next), np)) / t_next
    exact = x_hat + h * (0.5 * d_cur + 0.5 * d_prime)

    bound = abs(h / t_next) * np.spacing(np.float32(np.abs(x_hat).max()))
    assert abs(h / t_next) > 30
    assert np.abs(got_t - exact).max() <= bound
    assert np.abs(got_j - exact).max() <= bound
    assert np.abs(got_t - got_j).max() > 1e-4
