"""Shared helpers of the tests of the PyTorch port (tests/test_torch_*.py):
the flagship's architecture and the SD UNet/VAE at test width, in both
packages, with the same random weights."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffusion_tts_torch.models.preconds import EDMPrecond
from diffusion_tts_torch.models.sd_import import load_diffusers, state_dict_from_flax_sd
from diffusion_tts_torch.models.sd_unet import UNet2DConditionModel
from diffusion_tts_torch.models.sd_vae import AutoencoderKL
from diffusion_tts_torch.models.torch_import import load_into, state_dict_from_flax
from diffusion_tts_tpu.models import preconds as j_preconds
from diffusion_tts_tpu.models.sd_unet import UNet2DConditionModel as JUNet
from diffusion_tts_tpu.models.sd_vae import AutoencoderKL as JVAE

# The suite runs one xdist worker per core; torch's default of one thread
# per core in every worker oversubscribes the CPU several times over.
torch.set_num_threads(1)

# __graft_entry__._flagship(tiny=True): the flagship's architecture at test width
TINY_ADM_KW = dict(model_channels=32, channel_mult=(1, 2), num_blocks=1,
                   attn_resolutions=(8,), dropout=0.0)


def random_flax_params(tree, seed):
    """Every leaf random (the flax init zero-inits conv1/proj/out_conv,
    which would hide those layers): N(0, 1/fan_in) kernels, 1 + N(0, 0.1^2)
    norm scales, N(0, 0.1^2) biases. Returns numpy leaves."""
    g = np.random.default_rng(seed)

    def draw(path, leaf):
        n = g.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if len(leaf.shape) >= 2:
            return n / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.1 * n if "scale" in name else 0.1 * n

    return jax.tree_util.tree_map_with_path(draw, tree)


def tiny_flax_precond(dtype=jnp.float32):
    return j_preconds.EDMPrecond(img_resolution=16, img_channels=3, label_dim=10,
                                 model_type="DhariwalUNet", model_kwargs=TINY_ADM_KW,
                                 dtype=dtype)


def tiny_pair(seed=0, dtype=torch.float32):
    """The tiny EDMPrecond in both packages with the same random weights:
    (flax module, flax variables, port module)."""
    j_net = tiny_flax_precond()
    shapes = jax.eval_shape(lambda: j_net.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)),
        jnp.zeros((1, 10))))
    params = random_flax_params(shapes["params"], seed)
    t_net = load_into(EDMPrecond(img_resolution=16, img_channels=3, label_dim=10,
                                 model_kwargs=TINY_ADM_KW, dtype=dtype),
                      state_dict_from_flax(params)).eval()
    return j_net, {"params": params}, t_net


GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
# The SD goldens' geometry (tests/test_sd_pipeline.py:42-51)
SD_UNET_KW = dict(sample_size=16, in_channels=4, out_channels=4,
                  down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                  up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                  block_out_channels=(32, 64), layers_per_block=2, attention_head_dim=8,
                  cross_attention_dim=32)
SD_VAE_KW = dict(block_out_channels=(32, 64), layers_per_block=1)


def golden(name):
    """({diffusers state dict}, {other arrays}) of tests/goldens/<name>.npz."""
    with np.load(os.path.join(GOLDENS, f"{name}.npz")) as f:
        data = {k: f[k] for k in f.files}
    return ({k[4:]: v for k, v in data.items() if k.startswith("sd::")},
            {k: v for k, v in data.items() if not k.startswith("sd::")})


def tiny_sd_pair(seed=0):
    """The golden-geometry SD UNet and VAE in both packages with the same
    random weights: (flax unet, unet params, flax vae, vae params, port
    unet, port vae); params are numpy trees without the "params" wrapper."""
    j_unet, j_vae = JUNet(**SD_UNET_KW), JVAE(**SD_VAE_KW)
    ushape = jax.eval_shape(lambda: j_unet.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 7, 32))))
    vshape = jax.eval_shape(lambda: j_vae.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)), jax.random.key(1)))
    up = random_flax_params(ushape["params"], seed)
    vp = random_flax_params(vshape["params"], seed + 1)
    t_unet = load_diffusers(UNet2DConditionModel(**SD_UNET_KW), state_dict_from_flax_sd(up))
    t_vae = load_diffusers(AutoencoderKL(**SD_VAE_KW), state_dict_from_flax_sd(vp))
    return j_unet, up, j_vae, vp, t_unet.eval(), t_vae.eval()


def write_safetensors(path, state):
    """A .safetensors file of float32 arrays, written with numpy."""
    header, offset, blobs = {}, 0, []
    for name, value in state.items():
        blob = np.ascontiguousarray(value, np.float32).tobytes()
        header[name] = {"dtype": "F32", "shape": list(np.shape(value)),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + b"".join(blobs))
