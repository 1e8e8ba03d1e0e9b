"""EDM backend entry point: load a network, run noise-trajectory search,
save the image grid (counterpart of diffusion_tts_tpu/backends/edm_entry.py).

The unified CLI calls this with the ImageNet-64 ADM config (18 steps,
S_churn=40, S_min=0.05, S_max=50, S_noise=1.003; reference main.py:197-213)
or, with ``--arch cifar10``, the CIFAR-10 DDPM++ SongUNet; ``tiny`` and
``tiny_adm`` are the two families at test width. Weights come from an
exported reference state dict (.npz) or are random, made with numpy from a
seed. Everything runs on ``device``: the card by default, the CPU only when
asked for.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from diffusion_tts_torch.models.preconds import EDMPrecond, VEPrecond, VPPrecond, iDDPMPrecond
from diffusion_tts_torch.models.torch_import import (
    load_into,
    load_reference_state_dict,
    random_state_dict,
)
from diffusion_tts_torch.samplers.edm import EDMHeunSampler
from diffusion_tts_torch.search.api import SearchResult, run_search
from diffusion_tts_torch.search.backend import EDMSearchBackend
from diffusion_tts_torch.utils import rng
from diffusion_tts_torch.utils.config import SearchParams
from diffusion_tts_torch.utils.device import resolve_device

PRECONDS = {"edm": EDMPrecond, "vp": VPPrecond, "ve": VEPrecond, "iddpm": iDDPMPrecond}

IMAGENET64_ADM = dict(
    img_resolution=64, img_channels=3, label_dim=1000, model_type="DhariwalUNet",
    model_kwargs=dict(model_channels=192, channel_mult=(1, 2, 3, 4), num_blocks=3,
                      attn_resolutions=(32, 16, 8), dropout=0.0),
)
# The reference's CIFAR-10 DDPM++ (edm-cifar10-32x32-cond-vp.pkl's network,
# reference train.py:116-119 with 4 blocks and attention at 16x16).
CIFAR10_DDPMPP = dict(
    img_resolution=32, img_channels=3, label_dim=10, model_type="SongUNet",
    model_kwargs=dict(model_channels=128, channel_mult=(2, 2, 2), num_blocks=4,
                      attn_resolutions=(16,), dropout=0.0, embedding_type="positional",
                      encoder_type="standard", decoder_type="standard",
                      resample_filter=(1, 1), channel_mult_noise=1),
)
# The SongUNet at test width (the JAX package's TINY_SMOKE).
TINY_SMOKE = dict(
    img_resolution=16, img_channels=3, label_dim=10, model_type="SongUNet",
    model_kwargs=dict(model_channels=16, channel_mult=(1, 2), num_blocks=1,
                      attn_resolutions=(8,), dropout=0.0),
)
# The flagship's architecture at test width (__graft_entry__._flagship(tiny=True)).
TINY_ADM = dict(
    img_resolution=16, img_channels=3, label_dim=10, model_type="DhariwalUNet",
    model_kwargs=dict(model_channels=32, channel_mult=(1, 2), num_blocks=1,
                      attn_resolutions=(8,), dropout=0.0),
)
NET_CONFIGS = {"imagenet64": IMAGENET64_ADM, "cifar10": CIFAR10_DDPMPP, "tiny": TINY_SMOKE,
               "tiny_adm": TINY_ADM}
# The ImageNet scorer's classifier (models/classifier.py::EncoderUNetModel)
# for each arch's images and labels: the 64x64 classifier's defaults, and at
# 16x16 with 10 classes the geometry of tests/goldens/classifier.npz.
CLASSIFIER_CONFIGS = {
    "imagenet64": {},
    "tiny_adm": dict(image_size=16, model_channels=32, out_channels=10, num_res_blocks=1,
                     attention_resolutions=(2,), channel_mult=(1, 2)),
}


def load_network(arch: str = "imagenet64", weights: str | None = None, precond: str = "edm",
                 dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda",
                 seed: int = 0) -> torch.nn.Module:
    """The ``arch`` net under ``precond`` (a key of PRECONDS) on ``device``
    in eval mode. weights: an .npz reference state dict
    (tools/export_edm_checkpoint.py), or None for random weights from
    ``seed``."""
    dev = resolve_device(device)
    net = PRECONDS[precond](dtype=dtype, **NET_CONFIGS[arch])
    if weights is None:
        state = random_state_dict(net, seed)
    else:
        with np.load(weights) as f:
            state = load_reference_state_dict({k: f[k] for k in f.files})
    return load_into(net, state).to(dev).eval()


def generate_image_grid(
    *,
    arch: str = "imagenet64",
    weights: str | None = None,
    dest_path: str | None = None,
    scorer: Any,
    scorer_needs_labels: bool = False,
    method: str = "eps_greedy",
    params: SearchParams | None = None,
    seed: int = 0,
    gridw: int = 1,
    gridh: int = 1,
    num_steps: int = 18,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    S_churn: float = 40.0,
    S_min: float = 0.05,
    S_max: float = 50.0,
    S_noise: float = 1.003,
    class_idx: int | None = None,
    dtype: torch.dtype = torch.float32,
    record_noises: bool = False,
    device: torch.device | str = "cuda",
    net: torch.nn.Module | None = None,
) -> SearchResult:
    """Run search and (optionally) save a gridh x gridw PNG. ``net`` is a
    network from ``load_network`` for ``arch``; when None it is loaded here
    from ``weights`` (or made random from ``seed``) in ``dtype``."""
    dev = resolve_device(device)
    if net is None:
        net = load_network(arch, weights, dtype=dtype, device=dev, seed=seed)
    cfg = NET_CONFIGS[arch]
    res, ch, label_dim = cfg["img_resolution"], cfg["img_channels"], cfg["label_dim"]
    n_img = gridw * gridh

    labels = None
    if label_dim:
        if class_idx is None:
            cls = torch.randint(0, label_dim, (n_img,), device=dev,
                                generator=rng.generator(seed, 1, device=dev))
        else:
            cls = torch.full((n_img,), class_idx, device=dev)
        labels = torch.eye(label_dim, device=dev)[cls]

    def denoise(x, sigma):
        lab = labels.repeat(x.shape[0] // n_img, 1) if labels is not None else None
        return net(x, sigma, lab)

    sampler = EDMHeunSampler(denoise=denoise, num_steps=num_steps, sigma_min=sigma_min,
                             sigma_max=sigma_max, rho=rho, S_churn=S_churn, S_min=S_min,
                             S_max=S_max, S_noise=S_noise)
    backend = EDMSearchBackend(sampler=sampler, scorer=scorer,
                               scorer_cond=labels if scorer_needs_labels else None)
    z = rng.normal(seed, (0,), (n_img, res, res, ch), dev)
    result = run_search(method, backend, z, seed, params or SearchParams(),
                        record_noises=record_noises)
    print(f"Average score: {float(result.score.mean())}")

    if dest_path:
        img = (result.images.cpu().numpy() * 255.0).astype(np.uint8)
        grid = img.reshape(gridh, gridw, res, res, ch)
        grid = grid.transpose(0, 2, 1, 3, 4).reshape(gridh * res, gridw * res, ch)
        from PIL import Image

        Image.fromarray(grid.squeeze(), "RGB" if ch == 3 else "L").save(dest_path)
        print(f'Saved image grid to "{dest_path}"')
    return result


__all__ = ["generate_image_grid", "load_network", "NET_CONFIGS", "CLASSIFIER_CONFIGS",
           "PRECONDS"]
