"""The port's FLOP count (diffusion_tts_torch/utils/roofline.py) against the
JAX package's ``analyze_fn`` under ``canonical_formulation()``: the
flagship ADM at test and full width, the SongUNet families whose resample
filters are grouped convs, and the SD UNet and VAE decode and encode."""
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_tts_torch.backends import edm_entry
from diffusion_tts_torch.models import layers
from diffusion_tts_torch.ops.kernels import conv3x3
from diffusion_tts_torch.ops.kernels import qkv_attention as qk
from diffusion_tts_torch.utils import roofline
from diffusion_tts_tpu.models import preconds as j_preconds
from diffusion_tts_tpu.models.sd_unet import UNet2DConditionModel as JUNet
from diffusion_tts_tpu.models.sd_vae import AutoencoderKL as JVAE
from diffusion_tts_tpu.utils import roofline as j_roofline

from _torch_port import SD_UNET_KW, SD_VAE_KW

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

NCSNPP_TINY = dict(edm_entry.TINY_SMOKE, model_kwargs=dict(
    edm_entry.TINY_SMOKE["model_kwargs"], embedding_type="fourier", encoder_type="residual",
    decoder_type="skip", channel_mult_noise=2, resample_filter=(1, 3, 3, 1)))
NETS = {
    "tiny_adm": (edm_entry.TINY_ADM, 152_971_776),  # __graft_entry__._flagship(tiny=True)
    "imagenet64": (edm_entry.IMAGENET64_ADM, 219_315_105_792),  # _flagship(): per image
    "tiny_ddpmpp": (edm_entry.TINY_SMOKE, None),
    "tiny_ncsnpp": (NCSNPP_TINY, None),
}


def _jax_denoiser_flops(cfg, batch=1):
    net = j_preconds.EDMPrecond(**cfg)
    res, ch, ld = cfg["img_resolution"], cfg["img_channels"], cfg["label_dim"]
    x = jax.ShapeDtypeStruct((batch, res, res, ch), jnp.float32)
    s = jax.ShapeDtypeStruct((batch,), jnp.float32)
    lab = jax.ShapeDtypeStruct((batch, ld), jnp.float32)
    shapes = jax.eval_shape(lambda xx, ss, ll: net.init({"params": jax.random.key(0)}, xx, ss,
                                                        ll), x, s, lab)
    with j_roofline.canonical_formulation():
        return j_roofline.analyze_fn(lambda v, xx, ss, ll: net.apply(v, xx, ss, ll), shapes, x,
                                     s, lab)


def _by_op(ops):
    out = {}
    for key, flops in ops:
        key = key if key[0] == "conv" else ("dot", tuple(sorted(key[1:4])), key[4])
        out[key] = out.get(key, 0) + int(flops)  # whole numbers, held as floats by JAX
    return out


@pytest.mark.parametrize("name", sorted(NETS))
def test_denoiser_count_matches_jax(name):
    cfg, known = NETS[name]
    got = roofline.denoiser_flops(cfg)
    want = _jax_denoiser_flops(cfg)
    assert got["total_flops"] == pytest.approx(want["total_flops"], rel=1e-9, abs=0)
    # op by op, by the JAX walker's keys; a product's (m, k, n) is sorted, as
    # the two packages may write one product with its operands swapped
    assert _by_op(got["ops"]) == _by_op((k, f) for k, f, _, _ in want["ops"])
    if known is not None:
        assert got["total_flops"] == known


def test_count_scales_with_the_batch():
    one = roofline.denoiser_flops(edm_entry.TINY_ADM)["total_flops"]
    assert roofline.denoiser_flops(edm_entry.TINY_ADM, batch=3)["total_flops"] == 3 * one


def test_grouped_resample_convs_are_skipped():
    """The NCSN++ net's (1, 3, 3, 1) filters run as depthwise convs: the
    count leaves them out, as the JAX walker does."""
    ops = dict(roofline.denoiser_flops(NCSNPP_TINY)["ops"])
    assert all(key[0] in ("conv", "dot") for key in ops)
    seen = []

    class Spy(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket is torch.ops.aten.convolution and args[8] > 1:
                seen.append(args[8])
            return func(*args, **(kwargs or {}))

    with Spy():
        roofline.denoiser_flops(NCSNPP_TINY)
    assert seen  # the net does run grouped convs, and none of them is counted


def test_canonical_formulation_is_undone():
    saved = (conv3x3._NO_CONV_KERNELS, layers.nn_upsample2x_conv3x3, qk.qkv_self_attention,
             qk.attention)
    with roofline.canonical_formulation():
        assert conv3x3._NO_CONV_KERNELS
        assert layers.nn_upsample2x_conv3x3 is roofline.nearest_upsample2x_conv3x3
        assert qk.qkv_self_attention is qk.qkv_self_attention_plain
        assert qk.attention is qk.attention_plain
    assert (conv3x3._NO_CONV_KERNELS, layers.nn_upsample2x_conv3x3, qk.qkv_self_attention,
            qk.attention) == saved


def test_phased_up_conv_counts_as_the_upsampled_conv():
    """The count follows the architecture (nearest 2x, then the 3x3 conv),
    not the phase decomposition the port runs."""
    up = layers.EDMConv(8, 5, 3, bias=False, up=True)  # filter (1, 1): the phased route
    got = roofline.analyze_fn(up, torch.zeros((1, 8, 4, 4)))["total_flops"]
    assert got == 2 * 1 * 8 * 8 * 8 * 9 * 5


def test_sd_unet_count_matches_jax():
    """The golden-geometry UNet at batch 2 (a CFG forward of one sample)."""
    got = roofline.sd_unet_flops(SD_UNET_KW, 2, ctx_len=7)["total_flops"]
    want = j_roofline.sd_unet_flops(JUNet(**SD_UNET_KW), 2, ctx_len=7)["total_flops"]
    assert got == pytest.approx(want, rel=1e-9, abs=0) and got > 0


def test_sd_vae_decode_count_matches_jax():
    """The golden-geometry VAE decode of 2 latents of 16 x 16 (128 x 128
    images: its upsamplers reach the conv kernels' sizes, so the canonical
    formulation has routes to turn off)."""
    got = roofline.sd_vae_decode_flops(SD_VAE_KW, 2, latent_res=16)["total_flops"]
    want = j_roofline.sd_vae_decode_flops(JVAE(**SD_VAE_KW), 2, latent_res=16)["total_flops"]
    assert got == pytest.approx(want, rel=1e-9, abs=0) and got > 0


def test_sd_vae_encode_count_matches_jax():
    """The golden-geometry VAE encode of 2 images of 128 x 128 (its first
    block reaches the conv kernels' sizes), quant_conv included."""
    got = roofline.sd_vae_encode_flops(SD_VAE_KW, 2, res=128)["total_flops"]
    vae = JVAE(**SD_VAE_KW)
    x = jax.ShapeDtypeStruct((2, 128, 128, 3), jnp.float32)
    shapes = jax.eval_shape(lambda xx: vae.init({"params": jax.random.key(0)}, xx,
                                                jax.random.key(0)), x)
    with j_roofline.canonical_formulation():
        want = j_roofline.analyze_fn(lambda v, xx: vae.apply(v, xx, method=JVAE.encode), shapes,
                                     x)["total_flops"]
    assert got == pytest.approx(want, rel=1e-9, abs=0) and got > 0
