"""The port's CLIP towers (diffusion_tts_torch/models/clip.py) and CLIP
scorer against transformers' Flax CLIP and the JAX package's CLIPScorer,
on tiny weights drawn by transformers' torch CLIPModel (torch's global RNG
seeded), saved with save_pretrained and loaded by both sides: the port
through its own HF-directory loader, Flax through ``from_pt``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_tts_torch.models import clip as t_clip
from diffusion_tts_torch.scorers import CLIPScorer, quantize_to_uint8_grid
from diffusion_tts_torch.scorers.clip import TINY_CLIP, preprocess_images
from diffusion_tts_tpu.scorers.clip import CLIPScorer as JCLIPScorer
from diffusion_tts_tpu.scorers.clip import preprocess_images as j_preprocess_images

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

TEXT = dict(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_hidden_layers=2,
            max_position_embeddings=77, vocab_size=1000)
VISION = dict(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_hidden_layers=2,
              image_size=32, patch_size=8)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    from transformers import CLIPConfig, CLIPModel, FlaxCLIPModel

    torch.manual_seed(0)  # CLIPModel draws its init from torch's global RNG
    hf = CLIPModel(CLIPConfig(text_config=TEXT, vision_config=VISION, projection_dim=16)).eval()
    path = tmp_path_factory.mktemp("clip")
    hf.save_pretrained(path)
    flax_model = FlaxCLIPModel.from_pretrained(str(path), from_pt=True)
    j = JCLIPScorer(flax_model, flax_model.params, image_size=32)
    t = CLIPScorer.from_pretrained(str(path), device="cpu")
    g = np.random.default_rng(0)
    images = quantize_to_uint8_grid(torch.from_numpy(
        g.normal(0, 0.6, (3, 64, 64, 3)).astype(np.float32)))
    ids = g.integers(1, 1000, (3, 12)).astype(np.int64)
    return dict(hf=hf, path=path, j=j, t=t, images=images, ids=ids)


def test_features_match_flax(rig):
    j, t = rig["j"], rig["t"]
    pix = preprocess_images(rig["images"], 32)
    with torch.no_grad():
        img = t.model.get_image_features(pix).numpy()
        txt = t.model.get_text_features(torch.from_numpy(rig["ids"])).numpy()
    j_img = np.asarray(j.model.get_image_features(pixel_values=jnp.asarray(pix.numpy()),
                                                  params=j.params))
    j_txt = np.asarray(j.model.get_text_features(input_ids=jnp.asarray(rig["ids"]),
                                                 params=j.params))
    assert img.shape == (3, 16) and txt.shape == (3, 16)
    np.testing.assert_allclose(img, j_img, atol=1e-5)
    np.testing.assert_allclose(txt, j_txt, atol=1e-5)
    np.testing.assert_allclose(t.text_features(rig["ids"]).numpy(),
                               np.asarray(j.text_features(rig["ids"])), atol=1e-5)


@pytest.mark.parametrize("case", ["none", "ids", "features", "broadcast"])
def test_scorer_matches_jax(rig, case):
    j, t, images, ids = rig["j"], rig["t"], rig["images"], rig["ids"]
    if case == "none":
        t_cond = j_cond = None
    elif case == "ids":
        t_cond, j_cond = torch.from_numpy(ids), ids
    else:
        feats = np.array(j.text_features(ids))
        feats = feats[:1] if case == "broadcast" else feats
        t_cond, j_cond = torch.from_numpy(feats), feats
    got = t(images, t_cond)
    want = np.asarray(j(jnp.asarray(images.numpy()), j_cond))
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if case == "none":
        assert not got.any()
    else:
        assert np.ptp(want) > 1e-3


def test_text_features_cache(rig):
    t, ids = rig["t"], rig["ids"]
    first = t.text_features(ids)
    assert t.text_features(torch.from_numpy(ids)) is first
    assert t.text_features(ids[:1]) is not first


@pytest.mark.parametrize("size,out", [(512, 224), (64, 32)])
def test_preprocess_matches_jax(size, out):
    x = torch.rand(2, size, size, 3, generator=torch.Generator().manual_seed(size))
    got = preprocess_images(x, out)
    want = np.asarray(j_preprocess_images(jnp.asarray(x.numpy()), out))
    assert got.shape == (2, 3, out, out)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the trap: torch's bicubic without antialiasing is another filter
    plain = F.interpolate(x.permute(0, 3, 1, 2), size=(out, out), mode="bicubic",
                          align_corners=False).clamp(0, 1)
    mean = torch.tensor([0.48145466, 0.4578275, 0.40821073]).view(1, 3, 1, 1)
    std = torch.tensor([0.26862954, 0.26130258, 0.27577711]).view(1, 3, 1, 1)
    assert np.abs(((plain - mean) / std).numpy() - want).max() > 1e-2


@pytest.mark.parametrize("eos_token_id", [2, 49407])
def test_text_tower_matches_flax(tmp_path, eos_token_id):
    """SD's text encoder: last_hidden_state against FlaxCLIPTextModel, and
    the pooled output at the EOS token by either of transformers' rules."""
    from transformers import CLIPTextConfig, CLIPTextModel, FlaxCLIPTextModel

    torch.manual_seed(1)
    hf = CLIPTextModel(CLIPTextConfig(**TEXT, eos_token_id=eos_token_id)).eval()
    hf.save_pretrained(tmp_path, safe_serialization=False)  # pytorch_model.bin
    assert (tmp_path / "pytorch_model.bin").exists()
    flax_model = FlaxCLIPTextModel.from_pretrained(str(tmp_path), from_pt=True)
    port = t_clip.CLIPTextModel.from_pretrained(str(tmp_path))
    assert port.config.eos_token_id == eos_token_id
    g = np.random.default_rng(eos_token_id)
    ids = g.integers(1, 999, (2, 77)).astype(np.int64)
    ids[0, 5] = 999  # the largest id, and a first EOS
    ids[1, 9:] = eos_token_id if eos_token_id < 1000 else 998
    out = flax_model(input_ids=ids)
    with torch.no_grad():
        hidden, pooled = port.text_model(torch.from_numpy(ids))
        last = port(torch.from_numpy(ids))
    np.testing.assert_allclose(last.numpy(), np.asarray(out.last_hidden_state), atol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(out.pooler_output), atol=1e-5)
    np.testing.assert_array_equal(hidden.numpy(), last.numpy())


def _shapes(module, drop=()):
    return {k: tuple(v.shape) for k, v in module.state_dict().items() if k not in drop}


def test_full_width_configs_match_transformers():
    """CLIP_VIT_L14 and SD15_TEXT hold the parameters, by HF name and shape,
    of transformers' models at openai/clip-vit-large-patch14's and SD-1.5's
    text_encoder's configs (built on the meta device)."""
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPTextModel

    text = dict(hidden_size=768, intermediate_size=3072, num_attention_heads=12,
                num_hidden_layers=12)
    vision = dict(hidden_size=1024, intermediate_size=4096, num_attention_heads=16,
                  num_hidden_layers=24, image_size=224, patch_size=14)
    drop = t_clip._IGNORED
    with torch.device("meta"):
        hf = CLIPModel(CLIPConfig(text_config=text, vision_config=vision, projection_dim=768))
        port = t_clip.CLIPModel(t_clip.CLIP_VIT_L14)
        hf_text = CLIPTextModel(CLIPTextConfig(**text))
        port_text = t_clip.CLIPTextModel(t_clip.SD15_TEXT)
    assert _shapes(port) == _shapes(hf, drop)
    assert _shapes(port_text) == _shapes(hf_text, drop)
    assert sum(p.numel() for p in port.parameters()) == 427616512  # 427.6M, less logit_scale


def test_loader_refuses_unknown_keys(rig, tmp_path):
    state = dict(rig["hf"].state_dict(), **{"text_model.extra.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="extra"):
        t_clip._load_hf(t_clip.CLIPModel(TINY_CLIP), state)


def test_random_init_is_seeded():
    a, b, c = (CLIPScorer.random_init(s, device="cpu") for s in (0, 0, 1))
    x = torch.rand(2, 40, 40, 3, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[5, 9, 999, 3]])
    torch.testing.assert_close(a(x, ids), b(x, ids), atol=0, rtol=0)
    assert not torch.equal(a(x, ids), c(x, ids))
    assert a.model.config == TINY_CLIP and a.image_size == 32
