"""The port's SD modules (diffusion_tts_torch: DDIM sampler, UNet, VAE
decoder, weight import, pipeline loading) against the reference goldens
and the JAX package, in fp32 on the CPU.

Tolerances: the goldens at atol = rtol = 3e-4 for the models (the JAX
package's own bound, tests/test_sd_models_parity.py) and 2e-4 for the DDIM
trajectory (tests/test_samplers.py); port vs JAX under the same weights
within 1e-4 of the output's largest magnitude (fp32 in both, summed in
another order).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.models.sd_import import load_diffusers, state_dict_from_flax_sd
from diffusion_tts_torch.models.sd_unet import UNet2DConditionModel
from diffusion_tts_torch.models.sd_vae import AutoencoderKL
from diffusion_tts_torch.pipelines import StableDiffusionSearchPipeline
from diffusion_tts_torch.samplers.ddim import StochasticDDIMSampler
from diffusion_tts_torch.scorers import BrightnessScorer
from diffusion_tts_tpu.models.sd_import import convert_diffusers_state_dict
from diffusion_tts_tpu.models.sd_unet import UNet2DConditionModel as JUNet
from diffusion_tts_tpu.models.sd_vae import AutoencoderKL as JVAE
from diffusion_tts_tpu.pipelines import StableDiffusionSearchPipeline as JPipeline
from diffusion_tts_tpu.samplers.ddim import StochasticDDIMSampler as JDDIM

from _torch_port import SD_UNET_KW, SD_VAE_KW, golden, tiny_sd_pair, write_safetensors


def _nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


# one compiled program per model, shared by the tests that run it
_J_UNET = jax.jit(JUNet(**SD_UNET_KW).apply)
_J_DECODE = jax.jit(lambda p, z: JVAE(**SD_VAE_KW).apply(p, z, method=JVAE.decode))


def _rel_err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


@pytest.fixture(scope="module")
def unet_golden():
    state, data = golden("sd_unet")
    return state, data, load_diffusers(UNet2DConditionModel(**SD_UNET_KW), state).eval()


@pytest.fixture(scope="module")
def vae_golden():
    state, data = golden("sd_vae")
    return state, data, load_diffusers(AutoencoderKL(**SD_VAE_KW), state).eval()


def test_ddim_sampler_golden():
    """Same golden, eps model and tolerance as tests/test_samplers.py::test_ddim_parity."""
    _, d = golden("sampler_ddim")
    s = StochasticDDIMSampler(eps_model=lambda x, t: 0.3 * x + 0.05, num_steps=20, eta=1.0)
    np.testing.assert_array_equal(s.timesteps.numpy(), d["timesteps"])
    out, pred_x0 = s.sample(torch.from_numpy(_nhwc(d["latents"])),
                            torch.from_numpy(np.stack([_nhwc(n) for n in d["noise"]])))
    np.testing.assert_allclose(out.numpy(), _nhwc(d["out"]), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(pred_x0.numpy(), _nhwc(d["pred_x0_last"]), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("index", ["scalar", "per_sample"])
def test_ddim_step_math_matches_jax(index):
    g = np.random.default_rng(0)
    x, mo, eps = (g.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(3))
    s_t = StochasticDDIMSampler(eps_model=None, num_steps=10)
    s_j = JDDIM(eps_model=None, num_steps=10)
    np.testing.assert_array_equal(s_t.timesteps.numpy(), np.asarray(s_j.timesteps))
    steps = [0, 5, 9] if index == "scalar" else [np.array([0, 5, 9])]
    for i in steps:
        for noise in (eps, None):
            got = s_t.step_math(torch.from_numpy(x), torch.as_tensor(i), torch.from_numpy(mo),
                                None if noise is None else torch.from_numpy(noise))
            want = s_j.step_math(jnp.asarray(x), jnp.asarray(i), jnp.asarray(mo), noise)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)


def test_unet_matches_golden_and_jax(unet_golden):
    state, d, net = unet_golden
    with torch.no_grad():
        y = net(torch.from_numpy(d["in::x"]), torch.from_numpy(d["in::t"]),
                torch.from_numpy(d["in::ctx"])).numpy()
    np.testing.assert_allclose(y, d["out::y"], atol=3e-4, rtol=3e-4)
    y_j = _J_UNET(convert_diffusers_state_dict(state), _nhwc(d["in::x"]), d["in::t"],
                  d["in::ctx"])
    assert _rel_err(y, _nchw(y_j)) <= 1e-4


def test_vae_decode_matches_golden_and_jax(vae_golden):
    state, d, vae = vae_golden
    with torch.no_grad():
        dec = vae.decode(torch.from_numpy(d["in::lat"])).numpy()
    np.testing.assert_allclose(dec, d["out::dec"], atol=3e-4, rtol=3e-4)
    dec_j = _J_DECODE(convert_diffusers_state_dict(state), _nhwc(d["in::lat"]))
    assert _rel_err(dec, _nchw(dec_j)) <= 1e-4


def test_lookahead_chain_golden(unet_golden, vae_golden):
    """expand() reproduces the reference's candidate evaluation: step ->
    lookahead UNet at the same t -> step -> VAE decode -> uint8 grid
    (pipeline_stable_diffusion.py:1384-1420); the JAX package's test and
    tolerances (tests/test_sd_pipeline.py::test_sd_lookahead_chain_parity)."""
    _, d = golden("sd_lookahead")
    pipe = StableDiffusionSearchPipeline(unet=unet_golden[2], vae=vae_golden[2])
    ctx = torch.from_numpy(d["ctx"])
    # the golden runs the conditional UNet alone: guidance 1
    backend = pipe.make_backend(ctx, torch.zeros_like(ctx), BrightnessScorer(),
                                num_inference_steps=10, guidance_scale=1.0)
    x = torch.from_numpy(_nhwc(d["latents"]))
    i = int(d["step_index"])
    with torch.no_grad():
        lat, images = backend.expand(x, i, backend.base_step(x, i),
                                     torch.from_numpy(_nhwc(d["cand"]))[None])
    np.testing.assert_allclose(lat[0].numpy(), _nhwc(d["lat_cand"]), atol=5e-4, rtol=5e-4)
    ref = _nhwc(d["image"]).astype(np.float32) / 255.0
    assert (np.abs(images.numpy() - ref) <= 1.0 / 255.0 + 1e-6).mean() > 0.999


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_weight_round_trip():
    """flax params -> port (diffusers names) -> port state dict -> flax
    params again, exactly: the folded conv_shortcut and the FF's net_0/proj
    and net_2 names included."""
    _, up, _, vp, t_unet, t_vae = tiny_sd_pair(seed=3)
    for params, module in ((up, t_unet), (vp, t_vae)):
        state = {k: v.numpy() for k, v in module.state_dict().items()}
        back = dict(_flatten(convert_diffusers_state_dict(state)["params"]))
        orig = {k: v.astype(np.float32) for k, v in _flatten(params)}
        assert back.keys() == orig.keys()
        for k in orig:
            np.testing.assert_array_equal(back[k], orig[k], err_msg=str(k))
    names = state_dict_from_flax_sd(up)
    assert "down_blocks.0.resnets.0.conv_shortcut.weight" not in names  # 32 -> 32
    assert names["up_blocks.0.resnets.0.conv_shortcut.weight"].shape[2:] == (1, 1)
    assert "down_blocks.0.attentions.1.transformer_blocks.0.ff.net.0.proj.weight" in names
    assert "down_blocks.0.attentions.1.transformer_blocks.0.ff.net.2.bias" in names
    assert "time_embedding.linear_1.weight" in names


def test_from_pretrained_matches_jax(tmp_path, unet_golden, vae_golden):
    """A diffusers-layout directory (config.json and .safetensors for unet/
    and vae/) written from the goldens loads into both packages, which then
    agree on one UNet forward and one VAE decode."""
    unet_cfg = dict(SD_UNET_KW, down_block_types=list(SD_UNET_KW["down_block_types"]),
                    up_block_types=list(SD_UNET_KW["up_block_types"]),
                    block_out_channels=list(SD_UNET_KW["block_out_channels"]))
    vae_cfg = dict(block_out_channels=[32, 64], layers_per_block=1, latent_channels=4,
                   scaling_factor=0.18215)
    for sub, cfg, state in (("unet", unet_cfg, unet_golden[0]), ("vae", vae_cfg, vae_golden[0])):
        os.makedirs(tmp_path / sub)
        (tmp_path / sub / "config.json").write_text(json.dumps(cfg))
        write_safetensors(tmp_path / sub / "diffusion_pytorch_model.safetensors", state)
    pipe = StableDiffusionSearchPipeline.from_pretrained(str(tmp_path), device="cpu")
    j_pipe = JPipeline.from_pretrained(str(tmp_path))
    d = unet_golden[1]
    with torch.no_grad():
        y = pipe.unet(torch.from_numpy(d["in::x"]), torch.from_numpy(d["in::t"]),
                      torch.from_numpy(d["in::ctx"])).numpy()
        lat = vae_golden[1]["in::lat"]
        dec = pipe.vae.decode(torch.from_numpy(lat)).numpy()
    assert j_pipe.unet == JUNet(**SD_UNET_KW)  # so the compiled programs apply
    y_j = _J_UNET(j_pipe.unet_params, _nhwc(d["in::x"]), d["in::t"], d["in::ctx"])
    dec_j = _J_DECODE(j_pipe.vae_params, _nhwc(lat))
    assert _rel_err(y, _nchw(y_j)) <= 1e-4
    assert _rel_err(dec, _nchw(dec_j)) <= 1e-4
    assert pipe.vae.scaling_factor == j_pipe.vae.scaling_factor
