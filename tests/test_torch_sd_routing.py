"""Routing of the port's SD modules to the conv kernels' functions
(diffusion_tts_torch/models/sd_layers.py, ops/kernels/conv3x3.py), on the
CPU, where the routed functions run their plain twins.

The spatial thresholds (96 and 64 pixels) are lowered by monkeypatch so that
a small decoder takes the fused routes; the 128-channel rule stays. The JAX
modules get the same flax-initialised weights and take their XLA branch on
the CPU, the same function. Tolerance: 1e-4 of the output's largest
magnitude (fp32 in both, summed in another order).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.models import sd_layers as t_layers
from diffusion_tts_torch.models import sd_vae as t_vae
from diffusion_tts_torch.models.sd_import import load_diffusers, state_dict_from_flax_sd
from diffusion_tts_torch.ops.kernels import conv3x3 as t_conv
from diffusion_tts_torch.ops.kernels import groupnorm as t_gn
from diffusion_tts_tpu.models.sd_layers import ResnetBlock2D as JResnet
from diffusion_tts_tpu.models.sd_vae import AutoencoderKL as JVAE

from _torch_port import random_flax_params

WIDTHS = (128, 256)


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of the four routed functions while a test runs."""
    counts = collections.Counter()

    def counting(module, name):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            counts[name] += 1
            if kwargs.get("shortcut") is not None:
                counts["shortcut"] += 1
            if len(args) > 3 and args[3] is not None:
                counts["residual"] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    counting(t_conv, "conv3x3_same")
    counting(t_conv, "conv3x3_up2")
    counting(t_gn, "group_norm_stats")
    counting(t_gn, "group_norm_silu")
    return counts


def _lower_thresholds(monkeypatch, same=16, up2=8):
    monkeypatch.setattr(t_conv, "MIN_SPATIAL", same)
    monkeypatch.setattr(t_conv, "UP2_MIN_SPATIAL", up2)


def _rel_err(got_nchw, want_nhwc):
    got = got_nchw.permute(0, 2, 3, 1).numpy()
    want = np.asarray(want_nhwc)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _flax_params(module, *inputs, seed):
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.key(0)}, *inputs))
    return random_flax_params(shapes["params"], seed)


def _decoder_pair(seed=0):
    """The VAE at widths (128, 256), one layer per block, in both packages
    with the same random weights: (JAX decode function, port decode)."""
    j_vae = JVAE(block_out_channels=WIDTHS, layers_per_block=1)
    shapes = jax.eval_shape(lambda: j_vae.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 3)), jax.random.key(1)))
    params = random_flax_params(shapes["params"], seed)
    t_mod = t_vae.AutoencoderKL(block_out_channels=WIDTHS, layers_per_block=1)
    state = {k: v for k, v in state_dict_from_flax_sd(params).items()
             if not k.startswith(t_mod.UNPORTED_PREFIXES)}
    assert set(state) == set(t_mod.state_dict())  # no new key for the fused routes
    load_diffusers(t_mod, state).eval()
    return (lambda z: j_vae.apply({"params": params}, z, method=JVAE.decode)), t_mod.decode


def test_routing_predicates(monkeypatch):
    assert t_conv.conv3_shape_eligible(128, 128, 512, 512)
    assert t_conv.conv3_shape_eligible(512, 512, 256, 128)
    assert not t_conv.conv3_shape_eligible(64, 64, 512, 512)     # UNet and mid-block sizes
    assert not t_conv.conv3_shape_eligible(128, 128, 320, 320)   # not 128-channel multiples
    assert not t_conv.conv3_shape_eligible(512, 512, 128, 3)     # conv_out
    assert t_conv.conv3_shape_eligible(97, 101, 128, 128)        # no tiling rule on H, W
    x = torch.zeros(1, 512, 64, 64)
    w = torch.zeros(512, 512, 3, 3)
    assert t_conv.up2_eligible(x, w) and not t_conv.conv3_eligible(x, w)
    assert not t_conv.up2_eligible(x[:, :, :32, :32], w)         # the UNet's upsamplers
    assert not t_conv.up2_eligible(torch.zeros(1, 192, 64, 64), torch.zeros(192, 192, 3, 3))
    assert not t_conv.conv3_eligible(torch.zeros(1, 128, 128, 128), torch.zeros(128, 128, 1, 1))
    assert t_conv.shortcut_eligible(512) and not t_conv.shortcut_eligible(320)
    monkeypatch.setattr(t_conv, "_NO_CONV_KERNELS", True)
    assert not t_conv.conv3_shape_eligible(128, 128, 512, 512)
    assert not t_conv.up2_eligible(x, w)


def test_routed_decoder_matches_jax(monkeypatch, calls):
    """Widths (128, 256), one layer per block, 8x8 latents: the last up
    block's two resnets at 16x16 (256 -> 128 with the 1x1 shortcut, 128 ->
    128 with the skip) take the conv function with the GroupNorm folded in,
    the 8x8 -> 16x16 upsampler takes the up-conv function; the 8x8 convs and
    norms stay where they were."""
    _lower_thresholds(monkeypatch)
    j_dec, t_dec = _decoder_pair()
    z = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = j_dec(jnp.asarray(z))
    with torch.no_grad():
        got = t_dec(torch.from_numpy(np.ascontiguousarray(z.transpose(0, 3, 1, 2))))
    assert _rel_err(got, want) <= 1e-4
    assert calls["conv3x3_same"] == 4 and calls["group_norm_stats"] == 4
    assert calls["shortcut"] == 1 and calls["residual"] == 1 and calls["conv3x3_up2"] == 1
    # mid block 4 + attention 1 + up block 0 (2 resnets) 4 + conv_norm_out 1
    assert calls["group_norm_silu"] == 10


def test_unrouted_decoder_is_the_same_function(monkeypatch, calls):
    """Default thresholds: nothing at 16x16 is routed; the output agrees
    with the routed decoder's to fp32 rounding."""
    _, t_dec = _decoder_pair()
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4, 8, 8)).astype(np.float32))
    with torch.no_grad():
        plain = t_dec(z)
    assert calls["conv3x3_same"] == calls["conv3x3_up2"] == calls["group_norm_stats"] == 0
    assert calls["group_norm_silu"] == 14
    _lower_thresholds(monkeypatch)
    with torch.no_grad():
        routed = t_dec(z)
    assert calls["conv3x3_same"] == 4
    assert ((routed - plain).abs().max() / plain.abs().max()).item() <= 1e-5


def test_switch_turns_the_routes_off(monkeypatch, calls):
    _lower_thresholds(monkeypatch)
    monkeypatch.setattr(t_conv, "_NO_CONV_KERNELS", True)
    _, t_dec = _decoder_pair()
    with torch.no_grad():
        t_dec(torch.zeros(1, 4, 8, 8))
    assert calls["conv3x3_same"] == calls["conv3x3_up2"] == calls["group_norm_stats"] == 0


@pytest.mark.parametrize("in_ch,fused", [(256, "shortcut"), (128, "residual"), (320, "residual")],
                         ids=["shortcut", "skip", "standalone_shortcut"])
def test_routed_resnet_matches_jax(monkeypatch, calls, in_ch, fused):
    """128 output channels at 16x16. 256 -> 128: both convs fused, the 1x1
    shortcut inside conv2. 128 -> 128: the skip inside conv2. 320 -> 128:
    conv1 is not eligible (its norm runs standalone), conv2 is, and the 1x1
    shortcut of 320 channels runs standalone and joins as the residual."""
    _lower_thresholds(monkeypatch)
    j_res = JResnet(out_channels=128, use_temb=False, groups=32, eps=1e-6, dtype=jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 16, 16, in_ch)).astype(np.float32)
    params = _flax_params(j_res, jnp.asarray(x), seed=in_ch)
    t_res = load_diffusers(t_layers.ResnetBlock2D(in_ch, 128, None, groups=32, eps=1e-6),
                           state_dict_from_flax_sd(params)).eval()
    want = j_res.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = t_res(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert _rel_err(got, want) <= 1e-4
    n_fused = 1 if in_ch == 320 else 2
    assert calls["conv3x3_same"] == calls["group_norm_stats"] == n_fused
    assert calls[fused] == 1 and calls["group_norm_silu"] == 2 - n_fused


def test_group_norm_scale_shift_fold():
    """x * scale + shift then SiLU is the module's own output (the contract
    the conv prologue relies on)."""
    g = torch.Generator().manual_seed(0)
    norm = t_layers.GroupNorm(64, 32, 1e-5, apply_silu=True)
    with torch.no_grad():
        norm.weight.add_(0.3 * torch.randn(64, generator=g))
        norm.bias.add_(0.3 * torch.randn(64, generator=g))
        x = torch.randn(2, 64, 4, 4, generator=g) * 2 + 1
        scale, shift = norm(x, return_scale_shift=True)
        got = torch.nn.functional.silu(x * scale[:, :, None, None] + shift[:, :, None, None])
        torch.testing.assert_close(got, norm(x), atol=1e-5, rtol=1e-5)
    assert scale.shape == shift.shape == (2, 64) and scale.dtype == torch.float32


def test_conv3x3_fallback_takes_gn_and_shortcut():
    """Off the kernel route (8x8) Conv3x3.forward computes the same function
    from separate ops: prologue, cuDNN-style conv, + 1x1 shortcut."""
    g = torch.Generator().manual_seed(3)
    conv = t_layers.Conv3x3(128, 128, torch.float32)
    x, sc_x = torch.randn(1, 128, 8, 8, generator=g), torch.randn(1, 256, 8, 8, generator=g)
    sc_w = torch.randn(128, 256, 1, 1, generator=g) * 0.05
    sc_b = torch.randn(128, generator=g)
    gn = (1 + 0.5 * torch.randn(1, 128, generator=g), 0.1 * torch.randn(1, 128, generator=g))
    with torch.no_grad():
        got = conv(x, gn=gn, shortcut=(sc_x, sc_w, sc_b))
        want = t_conv.conv3x3_same_plain(x, conv.weight, conv.bias + sc_b, gn_scale=gn[0],
                                         gn_shift=gn[1], shortcut=(sc_x, sc_w[:, :, 0, 0]))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
