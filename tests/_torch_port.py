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


def patch_mcts_draws(monkeypatch, j_key):
    """Make the port's MCTS take its child picks and fresh-expansion noise
    from the JAX package's key paths (diffusion_tts_tpu/search/mcts.py:
    286-296), the two draws a caller cannot inject."""
    from diffusion_tts_torch.search import mcts as t_mcts
    from diffusion_tts_tpu.search.noise import SALT_MCTS_EXPAND, SALT_MCTS_PICK
    from diffusion_tts_tpu.utils.rng import fold_in_path

    def path(salt, *ints):  # the int32 scalars the JAX scan folds in
        return fold_in_path(j_key, salt, *(jnp.int32(v) for v in ints))

    def pick(key, i, phase, q, bsz, b_exp, device):
        draw = jax.random.randint(path(SALT_MCTS_PICK, i, phase, q - 1), (bsz,), 0, b_exp)
        return torch.from_numpy(np.asarray(draw).astype(np.int64)).to(device)

    def fresh(key, i, phase, q, shape, device):
        draw = jax.random.normal(path(SALT_MCTS_EXPAND, i, phase, q), shape, jnp.float32)
        return torch.from_numpy(np.array(draw)).to(device)

    monkeypatch.setattr(t_mcts, "pick_draw", pick)
    monkeypatch.setattr(t_mcts, "fresh_expansion_draw", fresh)


def assert_mcts_arenas_match(j_make, bargs, t_backend, z, params, j_params, table, *,
                             rollout_batch, fresh, j_key, state_tol, reward_tol):
    """Step both packages' MCTS one timestep at a time from the same z and
    expansion table, and hold the arenas equal after each: children,
    visits, root, parent, depth and the slot count exactly, rewards within
    ``reward_tol`` per visit (a node's reward sums its visits' scores),
    states within ``state_tol`` of their largest magnitude. The JAX
    backend is ``j_make(bargs)``, built inside each compiled program.
    Returns both terminal latents."""
    from diffusion_tts_torch.search import InjectedNoise
    from diffusion_tts_torch.search import mcts as t_mcts
    from diffusion_tts_tpu.search import mcts as j_mcts
    from diffusion_tts_tpu.search.noise import InjectedNoise as JInjectedNoise

    kw = dict(rollout_batch=rollout_batch)
    j_tree, j_tab = jax.jit(lambda ba, zz, tab: j_mcts.mcts_init(
        j_make(ba), zz, j_key, j_params, noise=JInjectedNoise(mcts_table=tab), **kw))(
            bargs, jnp.asarray(z), jnp.asarray(table))
    j_step = jax.jit(lambda ba, tree, tab, i: j_mcts.mcts_timestep(
        j_make(ba), tree, tab, j_key, i, j_params, fresh_expansion=fresh, **kw))
    with torch.no_grad():
        t_tree, t_tab = t_mcts.mcts_init(t_backend, torch.from_numpy(z), 99, params,
                                         noise=InjectedNoise(mcts_table=torch.from_numpy(table)),
                                         **kw)
    for i in range(t_backend.num_steps):
        j_tree = j_step(bargs, j_tree, j_tab, jnp.int32(i))
        with torch.no_grad():
            t_tree = t_mcts.mcts_timestep(t_backend, t_tree, t_tab, 99, i, params,
                                          fresh_expansion=fresh, **kw)
        assert t_tree.count == int(j_tree.count), i
        for name in ("children", "visits", "root", "parent", "depth", "n_children"):
            np.testing.assert_array_equal(getattr(t_tree, name).numpy(),
                                          np.asarray(getattr(j_tree, name)), err_msg=f"{name} {i}")
        gap = np.abs(t_tree.reward.numpy() - np.asarray(j_tree.reward))
        assert (gap <= reward_tol * np.maximum(t_tree.visits.numpy(), 1)).all(), (i, gap.max())
        js = np.asarray(j_tree.states)
        assert np.abs(t_tree.states.numpy() - js).max() <= state_tol * np.abs(js).max(), i
    return t_mcts.mcts_result(t_tree).x.numpy(), np.asarray(j_mcts.mcts_result(j_tree).x)
