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
bad = sorted(m for m in new if m == "jax" or m.startswith(("jax.", "jaxlib", "flax",
                                                           "diffusion_tts_tpu")))
print(json.dumps([len(names), bad]))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert n_modules >= 20 and bad == [], out.stdout


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
