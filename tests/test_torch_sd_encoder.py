"""The port's SD VAE encoder (diffusion_tts_torch/models/sd_vae.py: Encoder,
EncoderOutput, quant_conv, AutoencoderKL.encode and forward) against the
reference golden and the JAX package, in fp32 on the CPU, and its routed
calls with the conv kernels' spatial thresholds lowered.

Tolerances: the golden's mean and logvar at atol = rtol = 3e-4 (the JAX
package's own bound, tests/test_sd_models_parity.py); port vs JAX under the
same weights within 1e-5 of the output's largest magnitude at the golden
geometry (fp32 in both) and 1e-4 for the 128/256-wide routed encoder (its
convs summed in another order on the folded routes, as
tests/test_torch_sd_routing.py holds the decoder).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.models import sd_vae as t_vae
from diffusion_tts_torch.models.sd_import import load_diffusers, state_dict_from_flax_sd
from diffusion_tts_torch.ops.kernels import conv3x3 as t_conv
from diffusion_tts_torch.ops.kernels import groupnorm as t_gn
from diffusion_tts_tpu.models.sd_import import convert_diffusers_state_dict
from diffusion_tts_tpu.models.sd_vae import AutoencoderKL as JVAE

from _torch_port import SD_VAE_KW, golden, random_flax_params

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

_J_ENCODE = jax.jit(lambda p, x: JVAE(**SD_VAE_KW).apply(p, x, method=JVAE.encode))


def _nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def vae_golden():
    state, data = golden("sd_vae")
    return state, data, load_diffusers(t_vae.AutoencoderKL(**SD_VAE_KW), state).eval()


def test_every_key_of_the_golden_loads(vae_golden):
    state, _, vae = vae_golden
    assert set(state) == set(vae.state_dict())
    assert any(k.startswith("encoder.") for k in state) and "quant_conv.weight" in state
    assert not hasattr(t_vae.AutoencoderKL, "UNPORTED_PREFIXES")
    with pytest.raises(ValueError, match="extra=.'encoder.extra.weight'"):  # none is skipped
        load_diffusers(t_vae.AutoencoderKL(**SD_VAE_KW),
                       dict(state, **{"encoder.extra.weight": np.zeros(1, np.float32)}))


def test_encode_matches_golden_and_jax(vae_golden):
    state, d, vae = vae_golden
    with torch.no_grad():
        post = vae.encode(torch.from_numpy(d["in::img"]))
    assert isinstance(post, t_vae.EncoderOutput)
    np.testing.assert_allclose(post.mean.numpy(), d["out::mean"], atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(post.logvar.numpy(), d["out::logvar"], atol=3e-4, rtol=3e-4)
    want = _J_ENCODE(convert_diffusers_state_dict(state), _nhwc(d["in::img"]))
    assert _rel_err(post.mean.numpy(), _nchw(want.mean)) <= 1e-5
    assert _rel_err(post.logvar.numpy(), _nchw(want.logvar)) <= 1e-5


def test_sample_and_round_trip_match_jax(vae_golden):
    """sample with JAX's noise (logvar clamped to [-30, 20]) and forward's
    encode -> sample -> decode against the JAX __call__ under one key."""
    state, d, vae = vae_golden
    params = convert_diffusers_state_dict(state)
    key = jax.random.key(5)
    j_vae = JVAE(**SD_VAE_KW)
    post_j = _J_ENCODE(params, _nhwc(d["in::img"]))
    noise = np.array(jax.random.normal(key, post_j.mean.shape, post_j.mean.dtype))
    z_j = post_j.sample(key)
    out_j = j_vae.apply(params, _nhwc(d["in::img"]), key)
    x = torch.from_numpy(d["in::img"])
    with torch.no_grad():
        z = vae.encode(x).sample(noise=torch.from_numpy(_nchw(noise)))
        out = vae(x, noise=torch.from_numpy(_nchw(noise)))
    assert _rel_err(z.numpy(), _nchw(z_j)) <= 1e-5
    assert _rel_err(out.numpy(), _nchw(out_j)) <= 1e-5
    clamped = t_vae.EncoderOutput(mean=torch.zeros(2), logvar=torch.tensor([-100.0, 100.0]))
    torch.testing.assert_close(clamped.sample(noise=torch.ones(2)),
                               torch.exp(0.5 * torch.tensor([-30.0, 20.0])))


def test_sample_draws_from_its_generator(vae_golden):
    _, d, vae = vae_golden
    with torch.no_grad():
        post = vae.encode(torch.from_numpy(d["in::img"]))
    a, b, c = (post.sample(torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c) and a.shape == post.mean.shape


def test_from_flax_carries_the_encoder():
    """state_dict_from_flax_sd of the JAX VAE's params names the encoder's
    and quant_conv's parameters as diffusers does; all of them load."""
    j_vae = JVAE(**SD_VAE_KW)
    shapes = jax.eval_shape(lambda: j_vae.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)), jax.random.key(1)))
    state = state_dict_from_flax_sd(random_flax_params(shapes["params"], 4))
    assert "encoder.down_blocks.0.downsamplers.0.conv.weight" in state
    assert state["quant_conv.weight"].shape == (8, 8, 1, 1)
    vae = load_diffusers(t_vae.AutoencoderKL(**SD_VAE_KW), state)
    assert set(state) == set(vae.state_dict())


# ------------------------------------------------------- the routed encoder

WIDTHS = (128, 256)


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of the routed functions while a test runs."""
    counts = collections.Counter()

    def counting(module, name):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            counts[name] += 1
            if kwargs.get("shortcut") is not None:
                counts["shortcut"] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    for name in ("conv3x3_same", "conv3x3_up2"):
        counting(t_conv, name)
    for name in ("group_norm_stats", "group_norm_silu"):
        counting(t_gn, name)
    return counts


def _encoder_pair(seed=0):
    j_vae = JVAE(block_out_channels=WIDTHS, layers_per_block=1)
    shapes = jax.eval_shape(lambda: j_vae.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)), jax.random.key(1)))
    params = random_flax_params(shapes["params"], seed)
    t_mod = load_diffusers(t_vae.AutoencoderKL(block_out_channels=WIDTHS, layers_per_block=1),
                           state_dict_from_flax_sd(params)).eval()
    return (lambda x: j_vae.apply({"params": params}, x, method=JVAE.encode)), t_mod.encode


def test_routed_encoder_matches_jax(monkeypatch, calls):
    """Widths (128, 256), one layer per block, 32x32 images, the conv
    threshold lowered to 16: the 32x32 resnet (128 -> 128, the skip), the
    16x16 one (128 -> 256, the 1x1 shortcut folded) and the mid block's two
    take the conv function with their GroupNorms folded in (8 calls); the
    attention's GroupNorm and conv_norm_out stay standalone; conv_in
    (3 channels), the downsampler (stride 2) and conv_out (8 channels) stay
    cuDNN."""
    monkeypatch.setattr(t_conv, "MIN_SPATIAL", 16)
    j_enc, t_enc = _encoder_pair()
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = j_enc(jnp.asarray(x))
    with torch.no_grad():
        got = t_enc(torch.from_numpy(np.ascontiguousarray(_nchw(x))))
    assert _rel_err(got.mean.numpy(), _nchw(want.mean)) <= 1e-4
    assert _rel_err(got.logvar.numpy(), _nchw(want.logvar)) <= 1e-4
    assert calls["conv3x3_same"] == calls["group_norm_stats"] == 8
    assert calls["shortcut"] == 1 and calls["conv3x3_up2"] == 0
    assert calls["group_norm_silu"] == 2


def test_unrouted_encoder_is_the_same_function(monkeypatch, calls):
    _, t_enc = _encoder_pair()
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 3, 32, 32))
                         .astype(np.float32))
    with torch.no_grad():
        plain = t_enc(x).mean
    assert calls["conv3x3_same"] == calls["group_norm_stats"] == 0
    assert calls["group_norm_silu"] == 10  # 8 resnet norms, the attention's, conv_norm_out
    monkeypatch.setattr(t_conv, "MIN_SPATIAL", 16)
    with torch.no_grad():
        routed = t_enc(x).mean
    assert calls["conv3x3_same"] == 8
    assert ((routed - plain).abs().max() / plain.abs().max()).item() <= 1e-5
