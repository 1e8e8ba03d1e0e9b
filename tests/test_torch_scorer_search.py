"""The three rewards of this slice inside the port's search, against the JAX
package under one fully populated InjectedNoise (eps-greedy, 3 steps, N=2,
K=2, fp32): the ImageNet classifier and compressibility on the tiny ADM,
CLIP on the golden-geometry SD pipeline; SD's prompt encoding in both
packages; and the CLI with every new scorer and flag on the CPU.

Tolerances: selected pivots within 1e-5 (another selection moves a pivot by
O(1)); scores within 1e-5; terminal latents as tests/test_torch_search.py
and tests/test_torch_sd_search.py hold them (EDM: atol 3e-4, rtol 1e-4, the
first Heun step's fp32 conditioning; SD: 1e-4 of the largest magnitude).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tts_torch import main as cli
from diffusion_tts_torch.pipelines import StableDiffusionSearchPipeline
from diffusion_tts_torch.samplers.edm import EDMHeunSampler
from diffusion_tts_torch.scorers import CLIPScorer, CompressibilityScorer, ImageNetScorer
from diffusion_tts_torch.search import EDMSearchBackend, InjectedNoise, run_search
from diffusion_tts_torch.utils.config import SearchParams
from diffusion_tts_tpu.models.classifier import convert_classifier_state_dict
from diffusion_tts_tpu.pipelines import StableDiffusionSearchPipeline as JPipeline
from diffusion_tts_tpu.samplers.edm import EDMHeunSampler as JEDMHeunSampler
from diffusion_tts_tpu.scorers.clip import CLIPScorer as JCLIPScorer
from diffusion_tts_tpu.scorers.compressibility import CompressibilityScorer as JCompressibility
from diffusion_tts_tpu.scorers.imagenet import ImageNetScorer as JImageNetScorer
from diffusion_tts_tpu.search.api import run_search as j_run_search
from diffusion_tts_tpu.search.backend import EDMSearchBackend as JEDMSearchBackend
from diffusion_tts_tpu.search.noise import record_zero_order_draws
from diffusion_tts_tpu.utils.config import SearchParams as JSearchParams

from _torch_port import golden, tiny_pair, tiny_sd_pair, write_safetensors

STEPS, N, K, B = 3, 2, 2, 2
CHURN = dict(num_steps=STEPS, S_churn=40.0, S_min=0.05, S_max=50.0, S_noise=1.003)
# tests/goldens/classifier.npz's geometry: 16x16 images, 10 classes
CLASSIFIER_KW = dict(image_size=16, model_channels=32, out_channels=10, num_res_blocks=1,
                     attention_resolutions=(2,), channel_mult=(1, 2))
# pooled at the byte-level tokenizer's <|endoftext|> (write_tokenizer)
TEXT = dict(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_hidden_layers=2,
            max_position_embeddings=77, vocab_size=1000, eos_token_id=513)
# the vision tower at 16x16, so that the SD pipeline's 32x32 images are resized
VISION = dict(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_hidden_layers=2,
              image_size=16, patch_size=4)


def _injected(draws):
    return InjectedNoise(**{f: torch.from_numpy(np.array(getattr(draws, f)))
                            for f in InjectedNoise._fields if getattr(draws, f) is not None})


def _assert_same_search(j, t):
    np.testing.assert_allclose(t.best_noises.numpy(), np.asarray(j.best_noises), atol=1e-5)
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score), atol=1e-5)


# ---------------------------------------------------------------------- EDM


def _classifier_pair():
    sd, _ = golden("classifier")
    state = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    return (JImageNetScorer(variables=convert_classifier_state_dict(sd), **CLASSIFIER_KW),
            ImageNetScorer(state, device="cpu", **CLASSIFIER_KW))


@pytest.fixture(scope="module")
def edm_rig():
    j_net, variables, t_net = tiny_pair(seed=11)
    g = np.random.default_rng(41)
    z = g.standard_normal((B, 16, 16, 3)).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[[4, 9]]
    t_labels = torch.from_numpy(labels)
    j_sampler = JEDMHeunSampler(
        denoise=lambda x, s: j_net.apply(variables, x, s, jnp.tile(labels, (x.shape[0] // B, 1))),
        **CHURN)
    t_sampler = EDMHeunSampler(
        denoise=lambda x, s: t_net(x, s, t_labels.repeat(x.shape[0] // B, 1)), **CHURN)
    draws = record_zero_order_draws(jax.random.key(17), STEPS, JSearchParams(N=N, K=K), z.shape)
    explore = np.asarray(draws.explore01) < SearchParams().eps
    assert explore.any() and not explore.all()  # both kinds of candidate slot occur
    return dict(z=z, labels=labels, j_sampler=j_sampler, t_sampler=t_sampler, draws=draws)


EDM_SCORERS = {
    "imagenet": _classifier_pair,
    "compressibility_dct": lambda: (JCompressibility(mode="dct", max_size=3000.0),
                                    CompressibilityScorer(mode="dct", max_size=3000.0)),
    "compressibility_jpeg": lambda: (JCompressibility(mode="jpeg", max_size=3000.0),
                                     CompressibilityScorer(mode="jpeg", max_size=3000.0)),
}


@pytest.mark.parametrize("name", sorted(EDM_SCORERS))
def test_edm_eps_greedy_matches_jax(edm_rig, name):
    j_scorer, t_scorer = EDM_SCORERS[name]()
    cond = edm_rig["labels"] if name == "imagenet" else None
    j_backend = JEDMSearchBackend(sampler=edm_rig["j_sampler"], scorer=j_scorer,
                                  scorer_cond=None if cond is None else jnp.asarray(cond))
    t_backend = EDMSearchBackend(sampler=edm_rig["t_sampler"], scorer=t_scorer,
                                 scorer_cond=None if cond is None else torch.from_numpy(cond))
    j = j_run_search("eps_greedy", j_backend, jnp.asarray(edm_rig["z"]), jax.random.key(99),
                     JSearchParams(N=N, K=K), noise=edm_rig["draws"], record_noises=True)
    t = run_search("eps_greedy", t_backend, torch.from_numpy(edm_rig["z"]), 99,
                   SearchParams(N=N, K=K), noise=_injected(edm_rig["draws"]),
                   record_noises=True)
    assert t.best_noises.shape == (STEPS, K, B, 16, 16, 3)
    _assert_same_search(j, t)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), atol=3e-4, rtol=1e-4)
    assert 0 <= t.images.min() <= t.images.max() <= 1
    assert float(t.score.min()) > 0  # the reward is live, not the zero scorer's


# ----------------------------------------------------------------------- SD


def write_tokenizer(path):
    """A CLIPTokenizer directory with a byte-level vocabulary and no merges
    (every character a token): ids 0-511, <|startoftext|> 512,
    <|endoftext|> 513, 77 positions."""
    from transformers.models.clip.tokenization_clip import bytes_to_unicode

    os.makedirs(path, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars] + ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({tok: i for i, tok in enumerate(vocab)}, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": 77}, f)


def save_tiny_clip(path, text_only=False, seed=0):
    """A tiny transformers CLIP (or CLIP text model) saved to ``path``."""
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig
    from transformers import CLIPTextModel as HFCLIPTextModel

    torch.manual_seed(seed)  # transformers draws its init from torch's global RNG
    if text_only:
        model = HFCLIPTextModel(CLIPTextConfig(**TEXT))
    else:
        model = CLIPModel(CLIPConfig(text_config=TEXT, vision_config=VISION, projection_dim=16))
    model.save_pretrained(path)


@pytest.fixture(scope="module")
def sd_dir(tmp_path_factory):
    """A diffusers-layout SD directory: the golden-geometry UNet and VAE
    with random weights, a tiny text encoder and the byte-level tokenizer."""
    from _torch_port import SD_UNET_KW

    path = tmp_path_factory.mktemp("sd")
    j_unet, up, j_vae, vp, t_unet, t_vae = tiny_sd_pair(seed=21)
    unet_cfg = {k: list(v) if isinstance(v, tuple) else v for k, v in SD_UNET_KW.items()}
    vae_cfg = dict(block_out_channels=[32, 64], layers_per_block=1, latent_channels=4,
                   scaling_factor=0.18215)
    for sub, cfg, module in (("unet", unet_cfg, t_unet), ("vae", vae_cfg, t_vae)):
        os.makedirs(path / sub)
        (path / sub / "config.json").write_text(json.dumps(cfg))
        write_safetensors(path / sub / "diffusion_pytorch_model.safetensors",
                          {k: v.numpy() for k, v in module.state_dict().items()})
    save_tiny_clip(path / "text_encoder", text_only=True, seed=3)
    write_tokenizer(str(path / "tokenizer"))
    return path


@pytest.fixture(scope="module")
def sd_pipes(sd_dir):
    t_pipe = StableDiffusionSearchPipeline.from_pretrained(str(sd_dir), device="cpu")
    j_pipe = JPipeline.from_pretrained(str(sd_dir))
    assert t_pipe.tokenizer is not None and t_pipe.text_encoder is not None
    return j_pipe, t_pipe


def test_encode_prompt_matches_jax(sd_pipes):
    j_pipe, t_pipe = sd_pipes
    prompts = ["a photo of a cat", "an astronaut riding a horse on the moon"]
    for neg in (None, "blurry", ["low quality", ""]):
        j_un, j_co = j_pipe.encode_prompt(prompts, neg)
        t_un, t_co = t_pipe.encode_prompt(prompts, neg)
        assert t_un.shape == t_co.shape == (2, 77, 32)
        np.testing.assert_allclose(t_co.numpy(), np.asarray(j_co), atol=1e-5)
        np.testing.assert_allclose(t_un.numpy(), np.asarray(j_un), atol=1e-5)
    single = t_pipe.encode_prompt("a photo of a cat")[1]
    np.testing.assert_array_equal(single.numpy(), t_co[:1].numpy())


def test_pipeline_prompt_is_encoded(sd_pipes):
    """__call__(prompt=...) searches on encode_prompt's embeddings; without a
    tokenizer it raises ValueError, as the JAX pipeline does."""
    _, t_pipe = sd_pipes
    kw = dict(num_inference_steps=2, score_function=CompressibilityScorer(
        mode="dct", max_size=150000.0), method="eps_greedy", params=SearchParams(N=2, K=1),
        seed=3)
    uncond, cond = t_pipe.encode_prompt(["a red apple"])
    by_text = t_pipe(prompt=["a red apple"], **kw)
    by_embeds = t_pipe(prompt_embeds=cond, negative_prompt_embeds=uncond, **kw)
    for a, b in zip(by_text, by_embeds):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    bare = StableDiffusionSearchPipeline(unet=t_pipe.unet, vae=t_pipe.vae)
    with pytest.raises(ValueError, match="no tokenizer/text encoder"):
        bare.encode_prompt("a red apple")


def test_sd_eps_greedy_with_clip_matches_jax(sd_pipes, tmp_path):
    from transformers import FlaxCLIPModel

    j_pipe, t_pipe = sd_pipes
    save_tiny_clip(tmp_path, seed=5)
    flax_clip = FlaxCLIPModel.from_pretrained(str(tmp_path), from_pt=True)
    j_scorer = JCLIPScorer(flax_clip, flax_clip.params, image_size=16)
    t_scorer = CLIPScorer.from_pretrained(str(tmp_path), device="cpu")
    ids = j_pipe.tokenizer(["a watercolor fox"], padding="max_length", truncation=True,
                           max_length=77, return_tensors="np")["input_ids"]
    j_feats, t_feats = j_scorer.text_features(ids), t_scorer.text_features(ids)
    np.testing.assert_allclose(t_feats.numpy(), np.asarray(j_feats), atol=1e-5)
    g = np.random.default_rng(22)
    cond = g.standard_normal((1, 7, 32)).astype(np.float32)
    z = g.standard_normal((1, 16, 16, 4)).astype(np.float32)
    bargs = {"unet": j_pipe.unet_params, "vae": j_pipe.vae_params, "cond": cond,
             "uncond": np.zeros_like(cond)}
    j_factory = lambda ba: j_pipe.make_backend(ba, j_scorer, scorer_cond=j_feats,
                                               num_inference_steps=STEPS, batch=1)
    t_cond = torch.from_numpy(cond)
    t_backend = t_pipe.make_backend(t_cond, torch.zeros_like(t_cond), t_scorer,
                                    scorer_cond=t_feats, num_inference_steps=STEPS)
    draws = record_zero_order_draws(jax.random.key(7), STEPS, JSearchParams(N=N, K=K), z.shape)
    j = j_run_search("eps_greedy", j_factory, jnp.asarray(z), jax.random.key(99),
                     JSearchParams(N=N, K=K), backend_args=bargs, noise=draws,
                     record_noises=True, dispatch="per_step")
    t = run_search("eps_greedy", t_backend, torch.from_numpy(z), 99, SearchParams(N=N, K=K),
                   noise=_injected(draws), record_noises=True)
    _assert_same_search(j, t)
    jx = np.asarray(j.x)
    assert np.abs(t.x.numpy() - jx).max() <= 1e-4 * np.abs(jx).max()
    assert float(t.score.abs().min()) > 0


# ---------------------------------------------------------------------- CLI


EDM_CLI = {
    "imagenet": ["--scorer", "imagenet"],
    "compressibility_jpeg": ["--scorer", "compressibility"],
    "compressibility_dct": ["--scorer", "compressibility", "--compressibility-mode", "dct"],
}


@pytest.mark.parametrize("case", sorted(EDM_CLI))
def test_cli_edm(case, tmp_path, capsys):
    out = tmp_path / "grid.png"
    cli.main(["--backend", "edm", "--arch", "tiny_adm", "--device", "cpu", "--method",
              "eps_greedy", "--N", "2", "--K", "1", "--num-steps", "2", "--output", str(out)]
             + EDM_CLI[case])
    assert Image.open(out).size == (16, 16)
    score = float(capsys.readouterr().out.split("Average score:")[1].split()[0])
    assert 0 < score <= 1


def test_cli_edm_classifier_weights(tmp_path, capsys, monkeypatch):
    """--classifier-weights loads a guided-diffusion state dict (the golden's
    sd:: keys) and the search scores with it."""
    sd, _ = golden("classifier")
    path = tmp_path / "classifier.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    made = []
    real = cli.get_scorer
    monkeypatch.setattr(cli, "get_scorer", lambda *a: made.append(real(*a)) or made[-1])
    cli.main(["--backend", "edm", "--arch", "tiny_adm", "--device", "cpu", "--scorer",
              "imagenet", "--classifier-weights", str(path), "--method", "eps_greedy",
              "--N", "2", "--K", "1", "--num-steps", "2", "--output", str(tmp_path / "g.png")])
    assert "random weights" not in capsys.readouterr().out
    scorer, needs_cond = made[0]
    assert needs_cond
    want = torch.from_numpy(sd["input_blocks.0.0.weight"])
    torch.testing.assert_close(scorer.model.input_blocks[0][0].weight.detach(), want,
                               atol=0, rtol=0)


@pytest.mark.parametrize("scorer", ["clip", "compressibility"])
def test_cli_sd_tiny(scorer, tmp_path, capsys):
    """The tiny random pipeline has no tokenizer: random prompt embeddings,
    and CLIP, with nothing to score against, scores 0 with a warning."""
    clip_dir = tmp_path / "clip"
    save_tiny_clip(clip_dir)
    out = tmp_path / "sd.png"
    cli.main(["--backend", "sd", "--scorer", scorer, "--device", "cpu", "--method",
              "eps_greedy", "--N", "2", "--K", "1", "--num-steps", "2", "--prompt-repeat", "2",
              "--clip-path", str(clip_dir), "--output", str(out)])
    text = capsys.readouterr().out
    assert Image.open(out).size == Image.open(tmp_path / "sd_p1.png").size == (32, 32)
    assert "2 prompt(s)" in text and "no --clip-path" not in text
    scores = [float(s) for s in text.split("Best score(s):")[1].split()[0:2]
              for s in [s.rstrip(",")]]
    if scorer == "clip":
        assert "CLIP has no text to score against" in text and scores == [0.0, 0.0]
    else:
        assert all(0 < s <= 1 for s in scores)


def test_cli_sd_prompts_condition_clip(sd_dir, tmp_path, capsys, monkeypatch):
    """With --sd-path holding a tokenizer and text encoder the prompts are
    encoded, and CLIP scores against their tokenized text features."""
    clip_dir = tmp_path / "clip"
    save_tiny_clip(clip_dir, seed=5)
    calls = []
    real = StableDiffusionSearchPipeline.__call__

    def spy(self, *args, **kwargs):
        calls.append(kwargs)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(StableDiffusionSearchPipeline, "__call__", spy)
    cli.main(["--backend", "sd", "--scorer", "clip", "--sd-path", str(sd_dir), "--clip-path",
              str(clip_dir), "--device", "cpu", "--prompt", "a fox || a red barn",
              "--prompt-repeat", "2", "--method", "eps_greedy", "--N", "2", "--K", "1",
              "--num-steps", "2", "--output", str(tmp_path / "sd.png")])
    kwargs = calls[0]
    assert kwargs["prompt"] == ["a fox", "a red barn", "a fox", "a red barn"]
    assert "prompt_embeds" not in kwargs
    feats = kwargs["scorer_cond"]
    assert feats.shape == (4, 16) and torch.allclose(feats.norm(dim=-1), torch.ones(4))
    torch.testing.assert_close(feats[0], feats[2], atol=0, rtol=0)
    assert not torch.equal(feats[0], feats[1])
    text = capsys.readouterr().out
    assert "4 prompt(s)" in text and "CLIP has no text" not in text
    assert all(s != 0.0 for s in (float(v.rstrip(","))
                                  for v in text.split("Best score(s):")[1].split()[:4]))


def test_chip_smoke_eps_greedy_calls(edm_rig, sd_pipes, monkeypatch):
    """The denoiser calls, UNet calls and VAE decodes by batch of an
    eps-greedy search with a reward are chip_smoke.method_calls's, which the
    card run's launch counts rest on, and the reward's calls pass through
    chip_smoke.TimedScorer unchanged."""
    import collections

    import chip_smoke

    p = SearchParams(N=N, K=K)
    calls = collections.Counter()
    sampler = edm_rig["t_sampler"]
    counting = EDMHeunSampler(denoise=lambda x, s: calls.update([x.shape[0]])
                              or sampler.denoise(x, s), **CHURN)
    scorer = CompressibilityScorer(mode="dct")
    backend = EDMSearchBackend(sampler=counting, scorer=scorer)
    z = torch.from_numpy(edm_rig["z"])
    plain = run_search("eps_greedy", backend, z, 5, p)
    assert calls == chip_smoke.method_calls("eps_greedy", "edm", STEPS, p, B)[0]
    timed = chip_smoke.TimedScorer(scorer)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)  # no card here
    again = run_search("eps_greedy", EDMSearchBackend(sampler=sampler, scorer=timed), z, 5, p)
    torch.testing.assert_close(again.score, plain.score, atol=0, rtol=0)
    assert timed.seconds > 0

    _, t_pipe = sd_pipes
    unet, decodes = collections.Counter(), collections.Counter()
    forward, decode = t_pipe.unet.forward, t_pipe.vae.decode
    t_pipe.unet.forward = lambda x, *a: unet.update([x.shape[0]]) or forward(x, *a)
    t_pipe.vae.decode = lambda lat: decodes.update([lat.shape[0]]) or decode(lat)
    try:
        t_pipe(prompt=["a fox"], num_inference_steps=2, score_function=scorer,
               method="eps_greedy", params=p, seed=5)
    finally:
        del t_pipe.unet.forward, t_pipe.vae.decode
    assert (unet, decodes) == chip_smoke.method_calls("eps_greedy", "sd", 2, p, 1)
