"""The port's noisy-ImageNet classifier (diffusion_tts_torch/models/
classifier.py) and ImageNetScorer against the golden reference outputs and
the JAX package, in fp32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.models.classifier import (
    EncoderUNetModel,
    GDResBlock,
    state_dict_from_flax_classifier,
)
from diffusion_tts_torch.models.torch_import import load_into
from diffusion_tts_torch.scorers import ImageNetScorer, quantize_to_uint8_grid
from diffusion_tts_tpu.models.classifier import EncoderUNetModel as JEncoderUNetModel
from diffusion_tts_tpu.models.classifier import GDResBlock as JGDResBlock
from diffusion_tts_tpu.models.classifier import convert_classifier_state_dict
from diffusion_tts_tpu.scorers.imagenet import ImageNetScorer as JImageNetScorer

from _torch_port import golden, random_flax_params

# tests/goldens/classifier.npz's geometry (tests/test_classifier_parity.py)
GOLDEN_KW = dict(image_size=16, in_channels=3, model_channels=32, out_channels=10,
                 num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                 num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True)
GEOMETRIES = {
    "golden": GOLDEN_KW,
    # two attention levels (2 and 4 heads), three resblock downsamplings
    "two_attention_levels": dict(image_size=32, model_channels=32, out_channels=7,
                                 num_res_blocks=1, attention_resolutions=(2, 4),
                                 channel_mult=(1, 2, 4, 4), num_head_channels=32,
                                 resblock_updown=True),
    # average-pool downsampling, additive (not scale-shift) conditioning
    "pool_no_scale_shift": dict(image_size=16, model_channels=32, out_channels=5,
                                num_res_blocks=2, attention_resolutions=(2,),
                                channel_mult=(1, 2), num_head_channels=32,
                                resblock_updown=False, use_scale_shift_norm=False),
}


def _state(sd):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def test_golden_forward():
    sd, data = golden("classifier")
    model = load_into(EncoderUNetModel(**GOLDEN_KW), _state(sd)).eval()
    with torch.no_grad():
        y = model(torch.from_numpy(data["in::x"]), torch.from_numpy(data["in::t"]))
    np.testing.assert_allclose(y.numpy(), data["out::y"], atol=3e-4, rtol=3e-4)


def test_flax_tree_round_trip():
    """The flax tree of convert_classifier_state_dict maps back onto the
    guided-diffusion names and values exactly."""
    sd, _ = golden("classifier")
    back = state_dict_from_flax_classifier(convert_classifier_state_dict(sd)["params"])
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def _jax_pair(kw, seed):
    j_model = JEncoderUNetModel(**kw)
    size = kw["image_size"]
    shapes = jax.eval_shape(lambda: j_model.init({"params": jax.random.key(0)},
                                                 jnp.zeros((1, size, size, 3)), jnp.zeros((1,))))
    params = random_flax_params(shapes["params"], seed)
    t_model = load_into(EncoderUNetModel(**kw), state_dict_from_flax_classifier(params)).eval()
    return j_model, {"params": params}, t_model


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_forward_matches_jax(geometry):
    kw = GEOMETRIES[geometry]
    j_model, variables, t_model = _jax_pair(kw, seed=3)
    g = np.random.default_rng(4)
    size = kw["image_size"]
    x = g.uniform(0, 1, (3, size, size, 3)).astype(np.float32)
    t = np.array([0.0, 17.0, 640.0], np.float32)
    y_ref = np.asarray(j_model.apply(variables, x, t))
    with torch.no_grad():
        y = t_model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t)).numpy()
    assert y.shape == y_ref.shape == (3, kw["out_channels"])
    assert np.abs(y - y_ref).max() <= 1e-5 * np.abs(y_ref).max()


@pytest.mark.parametrize("mode", ["up", "down"])
def test_resblock_resampling_matches_jax(mode):
    """Resblock up/down (nearest-2x / 2x2 average on both h and the skip);
    the encoder takes only down, so the up path is held here alone."""
    kw = dict(up=mode == "up", down=mode == "down")
    j_block = JGDResBlock(out_channels=64, emb_channels=128, **kw)
    g = np.random.default_rng(9)
    x = g.standard_normal((2, 8, 8, 32)).astype(np.float32)
    emb = g.standard_normal((2, 128)).astype(np.float32)
    shapes = jax.eval_shape(lambda: j_block.init({"params": jax.random.key(0)}, x, emb))
    params = random_flax_params(shapes["params"], 6)
    prefix = "input_blocks.1.0."
    state = {k[len(prefix):]: v for k, v in
             state_dict_from_flax_classifier({"input_blocks_1_0": params}).items()}
    t_block = load_into(GDResBlock(32, 128, 64, **kw), state).eval()
    y_ref = np.asarray(j_block.apply({"params": params}, x, emb))
    with torch.no_grad():
        y = t_block(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(emb))
    y = y.permute(0, 2, 3, 1).numpy()
    side = 16 if mode == "up" else 4
    assert y.shape == y_ref.shape == (2, side, side, 64)
    assert np.abs(y - y_ref).max() <= 1e-5 * np.abs(y_ref).max()


@pytest.fixture(scope="module")
def scorers():
    sd, _ = golden("classifier")
    j = JImageNetScorer(variables=convert_classifier_state_dict(sd), **GOLDEN_KW)
    t = ImageNetScorer(_state(sd), device="cpu", **GOLDEN_KW)
    g = np.random.default_rng(5)
    x = g.normal(0, 0.6, (4, 16, 16, 3)).astype(np.float32)
    images = quantize_to_uint8_grid(torch.from_numpy(x))
    return j, t, images


@pytest.mark.parametrize("labels", ["one_hot", "int"])
def test_scorer_matches_jax(scorers, labels):
    j, t, images = scorers
    cls = np.array([3, 0, 9, 3])
    cond = np.eye(10, dtype=np.float32)[cls] if labels == "one_hot" else cls.astype(np.int32)
    want = np.asarray(j(jnp.asarray(images.numpy()), cond))
    got = t(images, torch.from_numpy(cond))
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # explicit timesteps: the same as the default zeros at 0, else another score
    zero = t(images, torch.from_numpy(cond), torch.zeros(4))
    np.testing.assert_array_equal(zero.numpy(), got.numpy())
    noisy = t(images, torch.from_numpy(cond), torch.full((4,), 500.0))
    want_noisy = np.asarray(j(jnp.asarray(images.numpy()), cond, jnp.full((4,), 500.0)))
    np.testing.assert_allclose(noisy.numpy(), want_noisy, atol=1e-6)


def test_scorer_needs_labels(scorers):
    _, t, images = scorers
    with pytest.raises(ValueError, match="needs class labels"):
        t(images)


def test_from_torch_checkpoint(scorers, tmp_path):
    j, t, images = scorers
    sd, _ = golden("classifier")
    path = tmp_path / "classifier.pt"
    torch.save(_state(sd), path)
    loaded = ImageNetScorer.from_torch_checkpoint(str(path), device="cpu", **GOLDEN_KW)
    labels = torch.tensor([1, 2, 3, 4])
    torch.testing.assert_close(loaded(images, labels), t(images, labels), atol=0, rtol=0)


def test_random_weights_from_a_seed():
    """Random init is numpy-seeded: the same seed gives the same scorer."""
    a, b = (ImageNetScorer(seed=7, device="cpu", **GOLDEN_KW) for _ in range(2))
    c = ImageNetScorer(seed=8, device="cpu", **GOLDEN_KW)
    images = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([0, 1])
    torch.testing.assert_close(a(images, labels), b(images, labels), atol=0, rtol=0)
    assert not torch.equal(a(images, labels), c(images, labels))
