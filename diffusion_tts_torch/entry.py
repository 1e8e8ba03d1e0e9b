"""The flagship's forward as an entry point (counterpart of the repo's
__graft_entry__.py::entry and ::_flagship).

    from diffusion_tts_torch.entry import entry
    fn, args = entry()      # on the card; entry(device="cpu") on the CPU
    out = fn(*args)         # [4, 64, 64, 3] fp32 (EDMPrecond mixes in fp32)

``entry()`` returns one forward of the flagship (the full-width ImageNet-64
ADM under EDMPrecond, bf16, the reference's headline class-conditional
config, main.py:197-213) at batch 4 with zero weights, and its example
arguments. ``dryrun_multichip`` waits for the port's parallel slice.
"""
from __future__ import annotations

import torch

from diffusion_tts_torch.backends.edm_entry import IMAGENET64_ADM, TINY_ADM
from diffusion_tts_torch.models.preconds import EDMPrecond
from diffusion_tts_torch.utils.device import resolve_device

BATCH = 4


def _flagship(tiny: bool = False) -> tuple[dict, int, int]:
    """(the EDMPrecond config, resolution, label count) of the flagship, or
    of its architecture at test width."""
    cfg = TINY_ADM if tiny else IMAGENET64_ADM
    return cfg, cfg["img_resolution"], cfg["label_dim"]


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): ``fn(net, x, sigma, labels)`` is one denoiser
    forward; the net holds zeros in every parameter (made on the meta
    device, then zeroed on ``device``: no init is drawn; the ADM has no
    buffers)."""
    dev = resolve_device(device)
    cfg, res, label_dim = _flagship()
    with torch.device("meta"):
        net = EDMPrecond(dtype=torch.bfloat16, **cfg)
    net = net.to_empty(device=dev).eval()
    for p in net.parameters():
        p.detach().zero_()
    x = torch.zeros((BATCH, res, res, cfg["img_channels"]), device=dev)
    sigma = torch.full((BATCH,), 10.0, device=dev)
    labels = torch.eye(label_dim, device=dev)[torch.arange(BATCH, device=dev) % label_dim]

    @torch.no_grad()
    def fn(net, x, sigma, labels):
        return net(x, sigma, labels)

    return fn, (net, x, sigma, labels)


__all__ = ["entry", "BATCH"]
