"""Shared helpers of the tests of the PyTorch port (tests/test_torch_*.py):
the flagship's architecture at test width, in both packages, with the same
random weights."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffusion_tts_torch.models.preconds import EDMPrecond
from diffusion_tts_torch.models.torch_import import load_into, state_dict_from_flax
from diffusion_tts_tpu.models import preconds as j_preconds

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
