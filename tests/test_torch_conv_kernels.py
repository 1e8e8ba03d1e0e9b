"""The plain twins of the conv path's CUDA kernels (group_norm_stats,
conv3x3_same, conv3x3_up2) against the Pallas kernels they replace, run in
interpret mode on the CPU (as tests/test_pallas_conv.py and
tests/test_pallas_groupnorm.py run them), on the same numpy inputs. The
port's functions are NCHW with ``nn.Conv2d`` weights, the JAX package's NHWC
with HWIO kernels: the tests transpose. On the CPU the port's wrappers take
the twins; the kernels themselves are held against the twins on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances are relative to the output's largest magnitude: fp32 1e-4 (a
1152- to 2304-deep sum taken in another order), bf16 2e-2 (one rounding of
the output, taken at another point); the statistics 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.ops.kernels import conv3x3 as t_conv
from diffusion_tts_torch.ops.kernels import groupnorm as t_gn
from diffusion_tts_tpu.ops.pallas.conv3x3 import conv3x3_same, conv3x3_up2
from diffusion_tts_tpu.ops.pallas.groupnorm import _gn_stats_fwd_only

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SHAPES = [(2, 16, 16, 128, 128), (1, 8, 16, 256, 128), (2, 32, 8, 128, 256)]  # b, h, w, c, k
CASES = ["plain", "bias_residual", "prologue_bias", "prologue_bias_residual",
         "prologue_bias_shortcut"]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _nchw(a):
    return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))


def _rel_err(got, want):
    """got: a port tensor [B, K, H, W]; want: a JAX array [B, H, W, K]."""
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _conv_inputs(shape, case, seed):
    """numpy NHWC / HWIO inputs of one conv3x3_same call."""
    b, h, w, c, k = shape
    cres = 256
    a = {"x": _rand((b, h, w, c), seed), "kernel": _rand((3, 3, c, k), seed + 1, 0.05)}
    if case != "plain":
        a["bias"] = _rand((k,), seed + 2)
    if case.endswith("residual"):
        a["residual"] = _rand((b, h, w, k), seed + 3)
    if case.startswith("prologue"):
        a["gn_scale"] = _rand((b, c), seed + 4, 0.5) + 1.0
        a["gn_shift"] = _rand((b, c), seed + 5, 0.1)
    if case.endswith("shortcut"):
        a["sc_x"] = _rand((b, h, w, cres), seed + 6)
        a["sc_w"] = _rand((cres, k), seed + 7, 0.05)
    return a


def _run_both(a, dtype):
    """(port output [B, K, H, W], Pallas interpret-mode output [B, H, W, K])."""
    td, jd = DTYPES[dtype]
    t = lambda v: torch.from_numpy(v).to(td)
    j = lambda v: jnp.asarray(v, jd)
    opt = lambda name, f: f(a[name]) if name in a else None
    got = t_conv.conv3x3_same(
        t(_nchw(a["x"])), t(np.ascontiguousarray(np.transpose(a["kernel"], (3, 2, 0, 1)))),
        opt("bias", t), opt("residual", lambda v: t(_nchw(v))),
        gn_scale=opt("gn_scale", torch.from_numpy), gn_shift=opt("gn_shift", torch.from_numpy),
        shortcut=(t(_nchw(a["sc_x"])), t(np.ascontiguousarray(a["sc_w"].T)))
        if "sc_x" in a else None)
    want = conv3x3_same(
        j(a["x"]), j(a["kernel"]), opt("bias", j), opt("residual", j),
        gn_scale=opt("gn_scale", jnp.asarray), gn_shift=opt("gn_shift", jnp.asarray),
        shortcut=(j(a["sc_x"]), j(a["sc_w"])) if "sc_x" in a else None, interpret=True)
    assert got.dtype == td
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_same_twin_matches_pallas(shape, case, dtype):
    got, want = _run_both(_conv_inputs(shape, case, seed=sum(shape)), dtype)
    assert _rel_err(got, want) <= TOL[dtype]


def test_conv3x3_same_pads_after_the_prologue():
    """SAME padding pads the normalized input. With a large shift,
    silu(shift) is far from 0: a twin that padded x before normalizing would
    add 9 * silu(6) * sum|w| at the border pixels. The border rows and
    columns agree with the Pallas kernel as closely as the interior, and
    differ from the pad-first result by much more than the tolerance."""
    a = _conv_inputs((1, 8, 16, 128, 128), "prologue_bias", seed=40)
    a["gn_shift"] = np.full_like(a["gn_shift"], 6.0)
    got, want = _run_both(a, "float32")
    got = got.permute(0, 2, 3, 1).numpy()
    want = np.asarray(want)
    border = np.ones(got.shape[1:3], bool)
    border[1:-1, 1:-1] = False
    scale = np.abs(want).max()
    assert np.abs(got - want)[:, border].max() / scale <= TOL["float32"]
    assert np.abs(got - want)[:, ~border].max() / scale <= TOL["float32"]
    # the wrong order of the two, for scale: normalize a zero-padded x
    x = torch.from_numpy(_nchw(a["x"]))
    sc, sh = (torch.from_numpy(a[n])[:, :, None, None] for n in ("gn_scale", "gn_shift"))
    padded = torch.nn.functional.silu(torch.nn.functional.pad(x, (1, 1, 1, 1)) * sc + sh)
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(a["kernel"], (3, 2, 0, 1))))
    wrong = torch.nn.functional.conv2d(padded, w, torch.from_numpy(a["bias"]))
    wrong = wrong.permute(0, 2, 3, 1).numpy()
    assert np.abs(wrong - want)[:, border].max() / scale > 100 * TOL["float32"]
    assert np.abs(wrong - want)[:, ~border].max() / scale <= TOL["float32"]


def test_conv3x3_same_refuses_residual_with_shortcut():
    a = _conv_inputs((1, 8, 16, 128, 128), "prologue_bias_shortcut", seed=3)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    with pytest.raises(ValueError, match="exclude each other"):
        t_conv.conv3x3_same(t(_nchw(a["x"])), t(np.transpose(a["kernel"], (3, 2, 0, 1))),
                            residual=torch.zeros(1, 128, 8, 16),
                            shortcut=(t(_nchw(a["sc_x"])), t(a["sc_w"].T)))
    with pytest.raises(ValueError, match="together"):
        t_conv.conv3x3_same(t(_nchw(a["x"])), t(np.transpose(a["kernel"], (3, 2, 0, 1))),
                            gn_scale=t(a["gn_scale"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 128, 128), (1, 8, 16, 256, 128),
                                   # the shapes the wgmma route masks: K = 40 in one
                                   # 64-channel block, an odd H in 2-row tiles, W = 24 in a
                                   # 64-column tile, C = 48; K = 136 over three blocks at
                                   # H = 9 and W = 72 in one 128-column tile
                                   (1, 7, 24, 48, 40), (1, 9, 72, 32, 136)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_up2_twin_matches_pallas(shape, with_bias, dtype):
    b, h, w, c, k = shape
    td, jd = DTYPES[dtype]
    x, ker = _rand((b, h, w, c), 50), _rand((3, 3, c, k), 51, 0.05)
    bias = _rand((k,), 52) if with_bias else None
    want = conv3x3_up2(jnp.asarray(x, jd), jnp.asarray(ker, jd),
                       None if bias is None else jnp.asarray(bias, jd), interpret=True)
    got = t_conv.conv3x3_up2(
        torch.from_numpy(_nchw(x)).to(td),
        torch.from_numpy(np.ascontiguousarray(np.transpose(ker, (3, 2, 0, 1)))).to(td),
        None if bias is None else torch.from_numpy(bias).to(td))
    assert got.dtype == td and got.shape == (b, k, 2 * h, 2 * w)
    assert _rel_err(got, want) <= TOL[dtype]


def test_conv3x3_up2_twin_is_upsample_then_conv():
    """The phased form is conv3x3(nearest_up2(x)) up to the fp32 tap folds."""
    x = torch.from_numpy(_rand((2, 128, 6, 5), 60))
    w = torch.from_numpy(_rand((128, 128, 3, 3), 61, 0.05))
    bias = torch.from_numpy(_rand((128,), 62))
    up = torch.nn.functional.interpolate(x, scale_factor=2, mode="nearest")
    want = torch.nn.functional.conv2d(up, w, bias, padding=1)
    got = t_conv.conv3x3_up2(x, w, bias)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [128, 256])
def test_group_norm_stats_twin_matches_pallas(c, dtype):
    td, jd = DTYPES[dtype]
    x = _rand((2, 8, 16, c), 70 + c, 2.0) + 0.5
    mean_j, rstd_j = _gn_stats_fwd_only(jnp.asarray(x, jd), groups=32, eps=1e-5, interpret=True)
    mean_t, rstd_t = t_gn.group_norm_stats(torch.from_numpy(_nchw(x)).to(td), groups=32, eps=1e-5)
    assert mean_t.dtype == rstd_t.dtype == torch.float32 and mean_t.shape == (2, c)
    for got, want in ((mean_t, mean_j), (rstd_t, rstd_j)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 1e-5


def test_group_norm_stats_clamps_the_variance():
    """A constant input has raw-moment variance 0 up to rounding: the clamp
    keeps rstd finite at rsqrt(eps)."""
    x = torch.full((1, 64, 4, 4), 1000.1)
    mean, rstd = t_gn.group_norm_stats(x, groups=32, eps=1e-6)
    assert torch.isfinite(rstd).all() and (rstd <= 1e3 * 1.0001).all()
    torch.testing.assert_close(mean, torch.full((1, 64), 1000.1))
