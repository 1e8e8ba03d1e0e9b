"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the CPU only when asked to."""
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import json, pkgutil, sys
before = set(sys.modules)
import diffusion_tts_torch
names = [m.name for m in pkgutil.walk_packages(diffusion_tts_torch.__path__,
                                              "diffusion_tts_torch.")]
for name in names:
    __import__(name)
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                                  "diffusion_tts_tpu"))
print(json.dumps([names, bad]))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad = json.loads(out.stdout.strip().splitlines()[-1])
    n_modules = len(names)
    assert n_modules >= 30 and bad == [], out.stdout
    assert "diffusion_tts_torch.training.loop" in names and "diffusion_tts_torch.train" in names
    assert {"diffusion_tts_torch.training.augment", "diffusion_tts_torch.tools.train_bench",
            "diffusion_tts_torch.analysis.dmap", "diffusion_tts_torch.tools.reward_curve",
            "diffusion_tts_torch.tools.sd_bench",
            "diffusion_tts_torch.examples.sd_all_scorers"} <= set(names)


_RUN_TRAINING_SIDE = """
import json, sys
import torch
from diffusion_tts_torch.analysis import dmap
from diffusion_tts_torch.models.sd_vae import AutoencoderKL
from diffusion_tts_torch.tools import train_bench
from diffusion_tts_torch.training.augment import edm_augment_pipe
images, labels = edm_augment_pipe(1.0)(torch.zeros((2, 8, 8, 3)), torch.Generator().manual_seed(0))
vae = AutoencoderKL(block_out_channels=(32, 64), layers_per_block=1).eval()
with torch.no_grad():
    post = vae.encode(torch.zeros((1, 3, 16, 16)))
norms = dmap.noise_norms(torch.zeros((2, 2, 1, 4, 4, 3)))
row = train_bench.main(["--device", "cpu", "--arch", "tiny", "--batch", "2", "--steps", "1"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "diffusion_tts_tpu"))
print(json.dumps([list(labels.shape), list(post.mean.shape), list(norms.shape), row["batch"], bad]))
"""


def test_augment_encoder_dmap_and_train_bench_run_without_jax():
    """The augmentation pipe, the VAE encoder, the dmap analysis and the
    train-bench twin run on the CPU with no module of JAX or the JAX
    package in sys.modules."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _RUN_TRAINING_SIDE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    labels, mean, norms, batch, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert labels == [2, 9] and mean == [1, 4, 8, 8] and norms == [2, 2] and batch == 2
    assert bad == [], out.stdout


_RUN_SCORERS = """
import json, sys
import numpy as np
import torch
from diffusion_tts_torch.models.clip import CLIPTextConfig, CLIPTextModel
from diffusion_tts_torch.models.torch_import import load_into, random_state_dict
from diffusion_tts_torch.pipelines import StableDiffusionSearchPipeline
from diffusion_tts_torch.scorers import (BrightnessScorer, CLIPScorer, CompressibilityScorer,
                                         ImageNetScorer)


class StubTokenizer:
    model_max_length = 77

    def __call__(self, texts, padding, truncation, max_length, return_tensors):
        ids = np.full((len(texts), max_length), 999, np.int64)
        for i, text in enumerate(texts):
            ids[i, :len(text)] = [ord(c) % 900 for c in text]
        return {"input_ids": ids}


images = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
tiny = dict(image_size=16, model_channels=32, out_channels=10, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2))
scores = [BrightnessScorer()(images), CompressibilityScorer()(images),
          CompressibilityScorer(mode="dct")(images),
          ImageNetScorer(device="cpu", **tiny)(images, torch.tensor([1, 2])),
          CLIPScorer.random_init(device="cpu")(images, torch.tensor([[5, 7, 999]]))]
text = CLIPTextModel(CLIPTextConfig(hidden_size=32, intermediate_size=64, num_attention_heads=4,
                                    num_hidden_layers=2, vocab_size=1000))
pipe = StableDiffusionSearchPipeline.tiny_random(device="cpu")
pipe.text_encoder = load_into(text, random_state_dict(text, 0)).eval()
pipe.tokenizer = StubTokenizer()
uncond, cond = pipe.encode_prompt(["a cat", "a dog"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "tensorflow", "diffusion_tts_tpu"))
print(json.dumps([[s.shape[0] for s in scores], list(cond.shape), bad]))
"""


def test_scorers_and_prompt_encoding_import_no_jax():
    """Building and running all four scorers and encoding a prompt leave no
    module of JAX, Flax, TensorFlow or the JAX package in sys.modules
    (transformers' torch CLIP model would pull them in where installed)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _RUN_SCORERS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    sizes, cond_shape, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert sizes == [2] * 5 and cond_shape == [2, 77, 32] and bad == [], out.stdout


def test_scorers_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from diffusion_tts_torch import main as cli
    from diffusion_tts_torch.scorers import CLIPScorer, ImageNetScorer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ImageNetScorer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLIPScorer.random_init()
    for backend, scorer in (("edm", "imagenet"), ("edm", "compressibility"),
                            ("sd", "clip"), ("sd", "compressibility")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--backend", backend, "--scorer", scorer, "--arch", "tiny_adm",
                      "--output", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()
    assert CLIPScorer.random_init(device="cpu").device.type == "cpu"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from diffusion_tts_torch import main as cli
    from diffusion_tts_torch.backends import edm_entry
    from diffusion_tts_torch.pipelines import StableDiffusionSearchPipeline
    from diffusion_tts_torch.scorers import BrightnessScorer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        edm_entry.load_network("tiny_adm")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        edm_entry.generate_image_grid(arch="tiny_adm", scorer=BrightnessScorer())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--backend", "edm", "--scorer", "brightness", "--arch", "tiny_adm"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--backend", "sd", "--scorer", "brightness"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StableDiffusionSearchPipeline.tiny_random()

    net = edm_entry.load_network("tiny_adm", device="cpu")
    assert next(net.parameters()).device.type == "cpu"
    out = tmp_path / "grid.png"
    cli.main(["--backend", "edm", "--scorer", "brightness", "--arch", "tiny_adm",
              "--device", "cpu", "--method", "eps_greedy", "--N", "2", "--K", "1",
              "--num-steps", "2", "--output", str(out)])
    assert out.exists()
    sd_out = tmp_path / "sd.png"
    cli.main(["--backend", "sd", "--scorer", "brightness", "--device", "cpu",
              "--method", "eps_greedy", "--N", "2", "--K", "1", "--num-steps", "2",
              "--output", str(sd_out)])
    from PIL import Image

    assert Image.open(sd_out).size == (32, 32)
