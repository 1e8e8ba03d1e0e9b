"""The port's compressibility reward (diffusion_tts_torch/scorers/
compressibility.py) and its native JPEG loader against PIL and the JAX
package: exact JPEG sizes in the ``jpeg`` mode, the DCT proxy within fp32
round-off in the ``dct`` mode."""
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tts_torch.scorers import CompressibilityScorer, quantize_to_uint8_grid
from diffusion_tts_torch.scorers import compressibility as t_comp
from diffusion_tts_torch.scorers import native
from diffusion_tts_tpu.scorers import compressibility as j_comp
from diffusion_tts_tpu.scorers.compressibility import CompressibilityScorer as JScorer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)


def _images(size, n=5, channels=3, seed=0):
    """[n, size, size, C] on the uint8 grid, from blocky (noise upsampled by
    1, 2, 4, 8) to flat, as images01 in [0, 1]."""
    g = np.random.default_rng(seed)
    out = []
    for i in range(n - 1):
        s = 2 ** (i % 4)
        x = g.uniform(0, 255, (size // s, size // s, channels))
        out.append(np.kron(x, np.ones((s, s, 1))))
    out.append(np.full((size, size, channels), 128.0))
    return np.floor(np.stack(out)).astype(np.float32) / np.float32(255.0)


def _pil_sizes(u8, quality):
    sizes = []
    for im in u8:
        buf = io.BytesIO()
        Image.fromarray(im[..., 0] if im.shape[-1] == 1 else im).save(
            buf, format="JPEG", quality=quality)
        sizes.append(len(buf.getvalue()))
    return sizes


@pytest.mark.parametrize("quality", [50, 80, 95])
def test_native_loader_matches_pil(quality):
    assert native.native_available()
    u8 = np.round(_images(64) * 255).astype(np.uint8)
    assert native.jpeg_sizes(u8, quality).tolist() == _pil_sizes(u8, quality)
    gray = u8[..., :1]
    assert native.jpeg_sizes(gray, quality, n_threads=1).tolist() == _pil_sizes(gray, quality)


def test_native_loader_rejects_bad_shapes():
    with pytest.raises(ValueError, match="expected"):
        native.jpeg_sizes(np.zeros((2, 8, 8, 4), np.uint8))


_LOADER_ALONE = """
import json, sys
import numpy as np
from diffusion_tts_torch.scorers import native
sizes = native.jpeg_sizes(np.full((2, 16, 16, 3), 7, np.uint8), 80).tolist()
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "tensorflow", "diffusion_tts_tpu"))
print(json.dumps([native.native_available(), sizes, bad]))
"""


def test_native_loader_stands_alone():
    """The port's loader imports nothing of the JAX package (whose
    scorers/__init__ imports JAX) and loads the repo's library."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _LOADER_ALONE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    available, sizes, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert available and bad == [] and sizes[0] == sizes[1] > 0


CASES = {"64_on_grid": (64, 3000.0, 0.0), "64_above": (64, 3000.0, 1e-6),
         "64_below": (64, 3000.0, -1e-6), "512_on_grid": (512, 150000.0, 0.0),
         "512_above": (512, 150000.0, 1e-6), "512_below": (512, 150000.0, -1e-6)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jpeg_mode_matches_jax_exactly(case):
    size, max_size, shift = CASES[case]
    x = _images(size, n=5 if size == 64 else 3, seed=size) + np.float32(shift)
    u8 = np.asarray(np.round(x * 255.0), np.uint8)
    np.testing.assert_array_equal(t_comp._host_jpeg_sizes(u8, 80), j_comp._host_jpeg_sizes(u8, 80))
    got = CompressibilityScorer(max_size=max_size)(torch.from_numpy(x))
    want = np.asarray(JScorer(max_size=max_size)(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and (got > 0).any() and (got < 1).any()


def test_jpeg_mode_grayscale_and_pil_fallback(monkeypatch):
    x = _images(64, channels=1, seed=1)
    got = CompressibilityScorer()(torch.from_numpy(x))
    want = np.asarray(JScorer()(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    u8 = np.asarray(np.round(x * 255.0), np.uint8)
    native_sizes = t_comp._host_jpeg_sizes(u8, 80)
    monkeypatch.setattr(native, "native_available", lambda: False)
    np.testing.assert_array_equal(t_comp._host_jpeg_sizes(u8, 80), native_sizes)
    np.testing.assert_array_equal(CompressibilityScorer()(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("size,channels", [(64, 3), (512, 3), (64, 1)])
def test_dct_mode_matches_jax(size, channels):
    x = quantize_to_uint8_grid(torch.from_numpy(
        np.random.default_rng(size + channels).normal(0, 0.5, (3, size, size, channels))
        .astype(np.float32)))
    x = torch.cat([x, torch.from_numpy(_images(size, n=3, channels=channels))])
    bits = t_comp.jpeg_proxy_bits(x).numpy()
    want = np.asarray(j_comp.jpeg_proxy_bits(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(bits, want, rtol=1e-4)
    max_size = 3000.0 if size == 64 else 150000.0
    got = CompressibilityScorer(mode="dct", max_size=max_size)(x)
    want_s = np.asarray(JScorer(mode="dct", max_size=max_size)(jnp.asarray(x.numpy())))
    # Gray on the uint8 grid gives Y = v exactly, and luma coefficients on
    # exact .5 ties of coef / q, which fp32 sums in another order round the
    # other way (5 of the 24576 here): each tie moves the bits by at most 1,
    # a score at 64x64 by 0.1849 / 3000 = 6.2e-5 (ROADMAP.md Queue 3).
    np.testing.assert_allclose(got.numpy(), want_s, atol=1e-5 if channels == 3 else 2e-4)
    assert np.ptp(want_s) > 1e-2  # the scores are not all clipped to one value


def test_scorer_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        CompressibilityScorer(mode="png")
