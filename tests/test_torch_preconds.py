"""The port's VP, VE and iDDPM preconditioners (diffusion_tts_torch/models/
preconds.py) against the reference goldens and the JAX package on the CPU:
their forwards, their noise-level maps and the iDDPM u-table."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.backends import edm_entry
from diffusion_tts_torch.models.preconds import EDMPrecond, VEPrecond, VPPrecond, iDDPMPrecond
from diffusion_tts_torch.models.torch_import import (
    load_into,
    load_reference_state_dict,
    state_dict_from_flax,
)
from diffusion_tts_torch.ops.schedules import iddpm_sigma_table
from diffusion_tts_tpu.models import preconds as j_preconds
from diffusion_tts_tpu.ops.schedules import iddpm_sigma_table as j_iddpm_sigma_table

from _torch_port import GOLDENS, random_flax_params

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

# tests/test_edm_nets_parity.py's geometries
SONG_KW = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,),
               dropout=0.0)
ADM_KW = dict(model_channels=64, channel_mult=(1,), num_blocks=1, attn_resolutions=(16,),
              dropout=0.0)
CASES = {
    "precond_vp": ("VPPrecond", "SongUNet", SONG_KW),
    "precond_ve": ("VEPrecond", "SongUNet", SONG_KW),
    "precond_iddpm": ("iDDPMPrecond", "DhariwalUNet", ADM_KW),
}
PORT = {"VPPrecond": VPPrecond, "VEPrecond": VEPrecond, "iDDPMPrecond": iDDPMPrecond}


def _kw(name):
    _, model_type, model_kw = CASES[name]
    return dict(img_resolution=16, img_channels=3, label_dim=10, model_type=model_type,
                model_kwargs=model_kw)


def _port(name, **kw):
    return PORT[CASES[name][0]](**_kw(name), **kw)


def _jax(name):
    return getattr(j_preconds, CASES[name][0])(**_kw(name))


@pytest.mark.parametrize("name", sorted(CASES))
def test_precond_golden(name):
    """The reference's forward on its own weights (tools/make_goldens.py;
    iDDPM's state dict carries its ``u`` buffer, which the port recomputes),
    at the JAX parity test's tolerance."""
    with np.load(os.path.join(GOLDENS, f"{name}.npz")) as f:
        data = {k: f[k] for k in f.files}
    state = {k[4:]: v for k, v in data.items() if k.startswith("sd::")}
    net = load_into(_port(name), load_reference_state_dict(state)).eval()
    x = torch.from_numpy(data["in::x"]).permute(0, 2, 3, 1)  # NCHW -> NHWC
    with torch.no_grad():
        y = net(x, torch.from_numpy(data["in::sigma"]), torch.from_numpy(data["in::class_labels"]))
    np.testing.assert_allclose(y.permute(0, 3, 1, 2).numpy(), data["out::y"], atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_precond_from_flax_matches_jax(name):
    """Random weights in every layer carried across from flax: the port
    against apply at 2e-4 over sigmas from 0.01 to 80, and the net's term is
    not negligible (the output is not just x)."""
    j_net = _jax(name)
    shapes = jax.eval_shape(lambda: j_net.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)),
        jnp.zeros((1, 10))))
    params = random_flax_params(shapes["params"], 31)
    t_net = load_into(_port(name), state_dict_from_flax(params)).eval()
    g = np.random.default_rng(32)
    sigma = np.array([0.01, 0.4, 5.0, 80.0], np.float32)
    x = (g.standard_normal((4, 16, 16, 3)) * np.sqrt(1 + sigma[:, None, None, None] ** 2)
         ).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[[0, 3, 5, 9]]
    y_j = np.asarray(j_net.apply({"params": params}, x, sigma, labels))
    with torch.no_grad():
        y_t = t_net(torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(labels))
    assert np.abs(y_j - x).max() > 0.1
    scale = np.abs(y_j).max(axis=(1, 2, 3), keepdims=True)  # the samples span 0.01 ... 80
    np.testing.assert_allclose(y_t.numpy() / scale, y_j / scale, atol=2e-4, rtol=2e-4)


SIGMAS = np.array([0.002, 0.0132, 0.5, 1.0, 7.3, 80.0, 157.0], np.float32)


def test_vp_noise_levels_match_jax():
    t_net, j_net = _port("precond_vp"), _jax("precond_vp")
    bound = j_net.bind({})
    t = np.array([1e-5, 0.01, 0.3, 1.0], np.float32)
    np.testing.assert_allclose(t_net.sigma(torch.from_numpy(t)).numpy(),
                               np.asarray(bound.sigma(t)), rtol=1e-6)
    np.testing.assert_allclose(t_net.sigma_inv(torch.from_numpy(SIGMAS)).numpy(),
                               np.asarray(bound.sigma_inv(SIGMAS)), rtol=1e-6)
    np.testing.assert_array_equal(t_net.round_sigma(torch.from_numpy(SIGMAS)).numpy(),
                                  np.asarray(bound.round_sigma(SIGMAS)))
    assert t_net.sigma_min == pytest.approx(bound.sigma_min, rel=1e-6)
    assert t_net.sigma_max == pytest.approx(bound.sigma_max, rel=1e-6)


def test_ve_noise_levels_match_jax():
    t_net, j_net = _port("precond_ve"), _jax("precond_ve")
    assert (t_net.sigma_min, t_net.sigma_max) == (j_net.sigma_min, j_net.sigma_max)
    np.testing.assert_array_equal(t_net.round_sigma(torch.from_numpy(SIGMAS)).numpy(),
                                  np.asarray(j_net.bind({}).round_sigma(SIGMAS)))


def test_iddpm_noise_levels_match_jax():
    """The u-table bit for bit, round_sigma's index and value, and the
    sigma range; ``u`` stays out of the state dict (it follows from M, C_1
    and C_2)."""
    np.testing.assert_array_equal(iddpm_sigma_table(), j_iddpm_sigma_table())
    np.testing.assert_array_equal(iddpm_sigma_table(M=100, C_1=0.002, C_2=0.01),
                                  j_iddpm_sigma_table(M=100, C_1=0.002, C_2=0.01))
    t_net = _port("precond_iddpm")
    bound = _jax("precond_iddpm").bind({})
    sigma = torch.from_numpy(SIGMAS.reshape(7, 1))
    for index in (True, False):
        got = t_net.round_sigma(sigma, return_index=index)
        want = np.asarray(bound.round_sigma(SIGMAS.reshape(7, 1), return_index=index))
        assert got.shape == (7, 1)
        np.testing.assert_array_equal(got.numpy(), want)
    assert t_net.sigma_min == bound.sigma_min and t_net.sigma_max == bound.sigma_max
    assert "u" not in t_net.state_dict()


def test_load_network_takes_every_precond():
    """edm_entry.load_network(..., precond=...) as in the JAX package: each
    preconditioner over the tiny SongUNet, random weights from the seed."""
    x = torch.randn((2, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    outs = {}
    for precond, cls in edm_entry.PRECONDS.items():
        net = edm_entry.load_network("tiny", precond=precond, device="cpu", seed=3)
        assert type(net) is cls and not net.training
        with torch.no_grad():
            outs[precond] = net(x, torch.tensor([0.5, 2.0]), torch.eye(10)[:2])
        assert outs[precond].shape == x.shape and torch.isfinite(outs[precond]).all()
    assert set(edm_entry.PRECONDS) == {"edm", "vp", "ve", "iddpm"}
    assert not torch.equal(outs["vp"], outs["ve"])
    assert isinstance(edm_entry.load_network("tiny_adm", device="cpu"), EDMPrecond)
