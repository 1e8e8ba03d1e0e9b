"""The port's EDM nets (diffusion_tts_torch/models) against the reference
goldens and against the JAX package's forward on the same weights."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.models.edm_nets import DhariwalUNet
from diffusion_tts_torch.models.preconds import EDMPrecond
from diffusion_tts_torch.models.torch_import import (
    load_into,
    load_reference_state_dict,
    state_dict_from_flax,
)
from diffusion_tts_torch.ops.resample import nn_upsample2x_conv3x3
from diffusion_tts_tpu.ops.resample import nn_upsample2x_conv3x3 as j_upsample

from _torch_port import tiny_pair

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
GOLDEN_ADM_KW = dict(model_channels=64, channel_mult=(1,), num_blocks=1,
                     attn_resolutions=(16,), dropout=0.0)


def _golden(name):
    with np.load(os.path.join(GOLDENS, f"{name}.npz")) as f:
        data = {k: f[k] for k in f.files}
    state = {k[4:]: v for k, v in data.items() if k.startswith("sd::")}
    inputs = {k[4:]: v for k, v in data.items() if k.startswith("in::")}
    return state, inputs, data["out::y"]


def test_dhariwal_golden():
    state, inputs, golden = _golden("dhariwal")
    net = load_into(DhariwalUNet(img_resolution=16, in_channels=3, out_channels=3,
                                 label_dim=10, **GOLDEN_ADM_KW),
                    load_reference_state_dict(state)).eval()
    with torch.no_grad():
        y = net(torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["noise_labels"]),
                torch.from_numpy(inputs["class_labels"]))
    np.testing.assert_allclose(y.numpy(), golden, atol=2e-4, rtol=2e-4)


def test_precond_edm_golden():
    state, inputs, golden = _golden("precond_edm")
    net = load_into(EDMPrecond(img_resolution=16, img_channels=3, label_dim=10,
                               model_kwargs=GOLDEN_ADM_KW),
                    load_reference_state_dict(state)).eval()
    x = torch.from_numpy(inputs["x"]).permute(0, 2, 3, 1)  # NCHW -> NHWC
    with torch.no_grad():
        y = net(x, torch.from_numpy(inputs["sigma"]), torch.from_numpy(inputs["class_labels"]))
    np.testing.assert_allclose(y.permute(0, 3, 1, 2).numpy(), golden, atol=2e-4, rtol=2e-4)


def test_reference_state_dict_must_match_model():
    state, _, _ = _golden("dhariwal")
    net = DhariwalUNet(img_resolution=16, in_channels=3, out_channels=3, label_dim=10,
                       **GOLDEN_ADM_KW)
    converted = load_reference_state_dict(state)
    with pytest.raises(ValueError, match="missing"):
        load_into(net, {k: v for k, v in converted.items() if "qkv" not in k})


def test_tiny_dhariwal_from_flax_matches_jax():
    j_net, variables, t_net = tiny_pair(seed=3)
    g = np.random.default_rng(4)
    x = g.standard_normal((2, 16, 16, 3)).astype(np.float32)
    sigma = np.array([0.5, 12.0], np.float32)
    labels = np.eye(10, dtype=np.float32)[[1, 7]]
    y_j = j_net.apply(variables, x, sigma, labels)
    with torch.no_grad():
        y_t = t_net(torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(labels))
    # the net's own term matters: the output is not just c_skip * x
    c_skip = 0.25 / (sigma[:, None, None, None] ** 2 + 0.25)
    assert np.abs(np.asarray(y_j) - c_skip * x).max() > 0.1
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-4, rtol=2e-4)


def test_tiny_dhariwal_bf16_runs_close_to_fp32():
    """The bf16 forward keeps the fp32 cast points (GN statistics, softmax):
    it stays within bf16 rounding of the fp32 forward of the same net."""
    _, _, t32 = tiny_pair(seed=5)
    _, _, t16 = tiny_pair(seed=5, dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 16, 16, 3)).astype(np.float32))
    sigma = torch.tensor([0.5, 12.0])
    with torch.no_grad():
        y32, y16 = t32(x, sigma), t16(x, sigma)
    assert y16.dtype == torch.float32 and torch.isfinite(y16).all()
    np.testing.assert_allclose(y16.numpy(), y32.numpy(), atol=0.1, rtol=0.05)


def test_upsample_conv_phase_form_matches_jax_and_nearest_up():
    g = np.random.default_rng(7)
    x = g.standard_normal((2, 5, 4, 6)).astype(np.float32)  # NCHW
    w = g.standard_normal((7, 5, 3, 3)).astype(np.float32)  # OIHW
    y = nn_upsample2x_conv3x3(torch.from_numpy(x), torch.from_numpy(w))
    y_j = j_upsample(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    up = torch.from_numpy(x).repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    ref = torch.nn.functional.conv2d(up, torch.from_numpy(w), padding=1)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
