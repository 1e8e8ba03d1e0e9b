"""The port's step schedules (diffusion_tts_torch/ops/schedules.py) against
the JAX package's and the reference goldens of tests/test_schedules.py."""
import numpy as np
import pytest

from diffusion_tts_torch.ops import schedules
from diffusion_tts_tpu.ops import schedules as j_schedules

# (function name, keyword ranges beside the defaults)
CASES = {
    "karras_sigmas": [{}, dict(sigma_min=0.01, sigma_max=50.0, rho=5.0)],
    "vp_sigmas": [{}, dict(beta_d=12.0, beta_min=0.3, epsilon_s=1e-2)],
    "vp_ablation_sigmas": [{}, dict(sigma_min=0.05, sigma_max=40.0, epsilon_s=2e-3)],
    "ve_sigmas": [{}, dict(sigma_min=0.1, sigma_max=30.0)],
    "iddpm_sigmas": [{}, dict(sigma_min=0.01, sigma_max=20.0, M=500, C_1=0.002, C_2=0.01)],
}


@pytest.mark.parametrize("append_zero", [True, False])
@pytest.mark.parametrize("num_steps", [1, 2, 18])
@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_jax(name, num_steps, append_zero):
    """Equal in float32 to the JAX function, defaults and another range."""
    for kw in CASES[name]:
        got = getattr(schedules, name)(num_steps, append_zero=append_zero, **kw)
        want = np.asarray(getattr(j_schedules, name)(num_steps, append_zero=append_zero, **kw))
        assert got.dtype == np.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


def test_vp_betas_for_range_matches_jax():
    for args in ((0.002, 80.0), (0.05, 40.0, 2e-3)):
        assert schedules.vp_betas_for_range(*args) == j_schedules.vp_betas_for_range(*args)


def test_dtype_is_kept():
    assert schedules.karras_sigmas(4, dtype=np.float64).dtype == np.float64


# tests/test_schedules.py's golden values (the reference's formulas in
# torch float64, tools/make_goldens.py), at its tolerances
GOLDENS = {
    "karras": (lambda: schedules.karras_sigmas(18, 0.002, 80.0, 7.0), 1e-6,
               {0: 80.0, 1: 57.58598472124816, 8: 3.256821519765537,
                16: 0.0075280199627840785, 17: 0.002000000000000003, 18: 0.0}),
    "vp_ablation": (lambda: schedules.vp_ablation_sigmas(18, append_zero=False), 1e-5,
                    {0: 152.16697028394634, 1: 86.0101642851572, 16: 0.20588813378928178,
                     17: 0.010485992786706403}),
    "ve": (lambda: schedules.ve_sigmas(18, 0.02, 100.0, append_zero=False), 1e-6,
           {0: 100.0, 1: 60.59175464093021, 16: 0.033007791437169975, 17: 0.02}),
    "iddpm": (lambda: schedules.iddpm_sigmas(18, 0.002, 81.0, append_zero=False), 1e-5,
              {0: 80.20367617799776, 1: 9.687848103884503, 16: 0.10403644724603973,
               17: 0.0064224695811984575}),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_schedule_goldens(name):
    make, rtol, golden = GOLDENS[name]
    t = np.asarray(make(), np.float64)
    for i, v in golden.items():
        np.testing.assert_allclose(t[i], v, rtol=rtol)
    assert np.all(np.diff(t) < 0)
