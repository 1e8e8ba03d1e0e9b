"""JPEG-compressibility reward (counterpart of
diffusion_tts_tpu/scorers/compressibility.py; reference edm/scorers.py:
176-244, sd/scorers.py:78-147): encode to JPEG at quality 80, score =
1 - clip((size - min) / (max - min), 0, 1); max_size is 3000 bytes for EDM
64x64 and 150000 for SD 512x512.

Two modes:
  * mode="jpeg": the exact size. The images are copied to the host, rounded
    to uint8 and encoded by the native libjpeg batch encoder (or PIL, which
    gives the same bytes). Each call waits for the device.
  * mode="dct": an on-device proxy, in tensor ops: 8x8 block DCT, the
    Annex-K quantization tables and an entropy surrogate
    sum(log2(1 + |q|)), calibrated to bytes.
"""
from __future__ import annotations

import functools
import io

import numpy as np
import torch

from diffusion_tts_torch.scorers import native

# Standard Annex-K JPEG quantization tables.
_LUMA_Q = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)
_CHROMA_Q = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.float32)


def _scaled_q(table: np.ndarray, quality: int) -> np.ndarray:
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    q = np.floor((table * scale + 50.0) / 100.0)
    return np.clip(q, 1.0, 255.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct_matrix() -> np.ndarray:
    n = 8
    k = np.arange(n)
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


def _rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    """JPEG YCbCr from [0, 255] RGB."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return torch.stack([y, cb, cr], dim=-1)


def _block_dct(channel: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, H/8 * W/8, 8, 8] DCT-II coefficients."""
    b, h, w = channel.shape
    x = channel.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)
    m = torch.from_numpy(_dct_matrix()).to(channel.device)
    return torch.einsum("ij,bnjk,lk->bnil", m, x, m)


def jpeg_proxy_bits(images01: torch.Tensor, quality: int = 80) -> torch.Tensor:
    """Entropy surrogate for the JPEG size, in 'bit units': the sum over
    quantized coefficients of log2(1 + |q|). [B, H, W, C] -> [B]."""
    x = images01.float() * 255.0
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    ycc = _rgb_to_ycbcr(x) - 128.0
    lq = torch.from_numpy(_scaled_q(_LUMA_Q, quality)).to(x.device)
    cq = torch.from_numpy(_scaled_q(_CHROMA_Q, quality)).to(x.device)
    bits = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for c, q in ((0, lq), (1, cq), (2, cq)):
        qc = torch.round(_block_dct(ycc[..., c].contiguous()) / q)
        bits = bits + torch.log2(1.0 + qc.abs()).sum(dim=(1, 2, 3))
    return bits


def _host_jpeg_sizes(images_uint8: np.ndarray, quality: int) -> np.ndarray:
    """Exact JPEG sizes [N] (float32): the native libjpeg batch encoder
    (native/jpeg_scorer.cpp, the same bytes as PIL, threaded), else PIL."""
    if native.native_available():
        return native.jpeg_sizes(images_uint8, quality).astype(np.float32)
    from PIL import Image

    sizes = np.zeros(images_uint8.shape[0], np.float32)
    for i, img in enumerate(images_uint8):
        buf = io.BytesIO()
        Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img).save(
            buf, format="JPEG", quality=quality)
        sizes[i] = len(buf.getvalue())
    return sizes


class CompressibilityScorer:
    """score = 1 - clip((size - min) / (max - min), 0, 1); higher is more
    compressible (reference edm/scorers.py:240-244)."""

    # The dct mode's affine bits -> bytes calibration, the JAX package's
    # (least squares on 64x64 images of varying smoothness at quality 80;
    # the intercept is the JPEG header and Huffman-table overhead)
    PROXY_BYTES_PER_BIT = 0.1849
    PROXY_HEADER_BYTES = 942.0

    def __init__(self, quality: int = 80, min_size: float = 0.0, max_size: float = 3000.0,
                 mode: str = "jpeg"):
        if mode not in ("jpeg", "dct"):
            raise ValueError(f"mode must be 'jpeg' or 'dct', got {mode!r}")
        self.quality = quality
        self.min_size = min_size
        self.max_size = max_size
        self.mode = mode
        if mode == "jpeg":
            native.native_available()  # build and load the library now, not in the first score

    def __call__(self, images01: torch.Tensor, cond=None, timesteps=None) -> torch.Tensor:
        if self.mode == "dct":
            sizes = (jpeg_proxy_bits(images01, self.quality) * self.PROXY_BYTES_PER_BIT
                     + self.PROXY_HEADER_BYTES)
        else:
            host = images01.detach().float().cpu().numpy()
            arr = np.asarray(np.round(host * 255.0), np.uint8)
            sizes = torch.from_numpy(_host_jpeg_sizes(arr, self.quality)).to(images01.device)
        norm = (sizes - self.min_size) / (self.max_size - self.min_size)
        return 1.0 - torch.clamp(norm, 0.0, 1.0)


__all__ = ["CompressibilityScorer", "jpeg_proxy_bits"]
