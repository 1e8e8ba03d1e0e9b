"""The port's standalone SD example (diffusion_tts_torch/examples/sd_all_scorers.py)
against the JAX example (examples/sd_all_scorers.py).

Both examples run at ``--tiny`` with their pipeline's ``__call__`` replaced
by a recorder (no search runs) and CLIP's ``text_features`` recorded (the
JAX side's tiny pipeline and CLIP are stand-ins without weights: flax
initialises them eagerly in about a minute). They must make the same calls
(scorer order and types, compressibility's max_size, MASTER_PARAMS, steps,
method, the condition shapes and the token ids' shape and range) and write
the same files. Then one real run of the port on the CPU."""
import dataclasses
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from diffusion_tts_torch.examples import sd_all_scorers

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record(monkeypatch, pipeline_cls, clip_cls, blank):
    """Replace ``pipeline_cls.__call__`` by a recorder returning ``blank()``
    and wrap ``clip_cls.text_features``; returns (calls, token id arrays)."""
    calls, ids = [], []

    def call(self, **kw):
        sf, cond = kw["score_function"], kw.get("scorer_cond")
        calls.append(dict(
            scorer=type(sf).__name__, max_size=getattr(sf, "max_size", None),
            params=dataclasses.asdict(kw["params"]), steps=kw["num_inference_steps"],
            method=kw["method"], cond=None if cond is None else tuple(cond.shape),
            embeds=tuple(kw["prompt_embeds"].shape)))
        return blank()

    features = clip_cls.text_features

    def text_features(self, input_ids, *args):
        ids.append(np.asarray(input_ids))
        return features(self, input_ids, *args)

    monkeypatch.setattr(pipeline_cls, "__call__", call)
    monkeypatch.setattr(clip_cls, "text_features", text_features)
    return calls, ids


def _jax_stand_ins(monkeypatch, ids):
    """The JAX example's tiny pipeline with its modules and no weights, and
    a tiny CLIP whose text features are zeros of the JAX tiny CLIP's
    projection width (diffusion_tts_tpu/scorers/clip.py:66-71), the ids
    recorded."""
    import jax.numpy as jnp

    from diffusion_tts_tpu.models.sd_unet import UNet2DConditionModel as JUNet
    from diffusion_tts_tpu.models.sd_vae import AutoencoderKL as JVAE
    from diffusion_tts_tpu.pipelines.sd_pipeline import StableDiffusionSearchPipeline as JPipe
    from diffusion_tts_tpu.scorers import clip as j_clip

    unet = JUNet(sample_size=16, block_out_channels=(32, 64), layers_per_block=1,
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), attention_head_dim=4,
                 cross_attention_dim=32)
    vae = JVAE(block_out_channels=(32, 64), layers_per_block=1)
    monkeypatch.setattr(JPipe, "tiny_random", lambda: JPipe(unet=unet, unet_params=None,
                                                            vae=vae, vae_params=None))

    def text_features(self, input_ids):
        ids.append(np.asarray(input_ids))
        return jnp.zeros((input_ids.shape[0], 16))

    clip = type("CLIPScorer", (j_clip.CLIPScorer,), {"__init__": lambda self: None,
                                                     "text_features": text_features})
    monkeypatch.setattr(j_clip.CLIPScorer, "random_init", lambda: clip())


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_sd_all_scorers", os.path.join(ROOT, "examples", "sd_all_scorers.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_same_calls_as_the_jax_example(monkeypatch, tmp_path, capsys):
    from diffusion_tts_torch.pipelines.sd_pipeline import StableDiffusionSearchPipeline
    from diffusion_tts_torch.scorers.clip import CLIPScorer
    from diffusion_tts_tpu.pipelines.sd_pipeline import StableDiffusionSearchPipeline as JPipe
    from diffusion_tts_tpu.scorers.clip import CLIPScorer as JCLIPScorer
    from diffusion_tts_tpu.utils import cache

    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
    j_calls, j_ids = _record(monkeypatch, JPipe, JCLIPScorer,
                             lambda: (np.zeros((1, 32, 32, 3), np.float32), np.zeros(1)))
    _jax_stand_ins(monkeypatch, j_ids)
    _jax_example().main(["--tiny", "--outdir", str(tmp_path / "jax")])
    j_out = capsys.readouterr().out
    calls, ids = _record(monkeypatch, StableDiffusionSearchPipeline, CLIPScorer,
                         lambda: (torch.zeros((1, 32, 32, 3)), torch.zeros(1)))
    best = sd_all_scorers.main(["--tiny", "--device", "cpu", "--outdir", str(tmp_path / "port")])
    out = capsys.readouterr().out

    assert calls == j_calls
    assert [c["scorer"] for c in calls] == ["BrightnessScorer", "CompressibilityScorer",
                                           "CLIPScorer"]
    assert calls[1]["max_size"] == 150000.0
    assert calls[0]["params"] == dict(N=4, K=20, B=2, S=8, lambda_=0.15, eps=0.4)
    assert {(c["steps"], c["method"], c["embeds"]) for c in calls} == {(18, "eps_greedy",
                                                                        (1, 7, 32))}
    assert [c["cond"] for c in calls] == [None, None, (1, 16)]
    for got in (ids, j_ids):
        assert len(got) == 1 and got[0].shape == (1, 8)
        assert 0 <= got[0].min() and got[0].max() < 999
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        f"sd_eps_greedy_{name}.png" for name in ("brightness", "clip", "compressibility")]
    strip = lambda text: re.sub(r"saved \S+/", "saved ", text)
    assert strip(out) == strip(j_out) and best == dict.fromkeys(best, 0.0)


def test_tiny_run_on_the_cpu(tmp_path, capsys):
    """Three PNGs and three lines in the JAX example's format."""
    from PIL import Image

    best = sd_all_scorers.main(["--tiny", "--device", "cpu", "--steps", "2",
                                "--outdir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert list(best) == ["brightness", "compressibility", "clip"]
    assert len(lines) == 3
    for line, (name, score) in zip(lines, best.items()):
        path = tmp_path / f"sd_eps_greedy_{name}.png"
        assert line == f"[{name}] saved {path}  best score: {score:.5f}"
        assert Image.open(path).size == (32, 32) and np.isfinite(score)
    assert 0.0 <= best["brightness"] <= 1.0 and 0.0 <= best["compressibility"] <= 1.0
    assert -1.0 <= best["clip"] <= 1.0


@pytest.mark.parametrize("name", ["brightness", "compressibility", "clip"])
def test_png_truncates_as_the_jax_example(name, tmp_path, monkeypatch):
    """``(images[0] * 255).astype(uint8)``: the cast truncates (0.999 ->
    254), as the JAX example's does."""
    from diffusion_tts_torch.pipelines.sd_pipeline import StableDiffusionSearchPipeline
    from PIL import Image

    value = {"brightness": 0.999, "compressibility": 0.5, "clip": 0.0}[name]
    monkeypatch.setattr(StableDiffusionSearchPipeline, "__call__",
                        lambda self, **kw: (torch.full((1, 32, 32, 3), value), torch.zeros(1)))
    sd_all_scorers.main(["--tiny", "--device", "cpu", "--outdir", str(tmp_path)])
    png = np.asarray(Image.open(tmp_path / f"sd_eps_greedy_{name}.png"))
    assert (png == int(value * 255)).all()
