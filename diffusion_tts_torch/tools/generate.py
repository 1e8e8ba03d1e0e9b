"""Seed-sharded image generation (counterpart of the repo's tools/generate.py).

The reference's torchrun generator (edm/generate.py:238-305): the seeds are
split into batches strided over the ranks (:254-257), every seed's noise
comes from its own generators (StackedRandomGenerator, :182-196), and each
image is written as one PNG named after its seed, so an image depends on
its seed only, never on the batch or rank that made it. Each seed's z, class
and churn noise are drawn on the JAX tool's paths 0, 1 and 2.

    python -m diffusion_tts_torch.tools.generate --seeds 0-63 --outdir out \\
        [--arch imagenet64] [--weights ckpt.npz] [--steps 18] [--batch 64]
    torchrun --standalone --nproc_per_node 2 -m diffusion_tts_torch.tools.generate \\
        --seeds 0-63 --outdir out --device cpu --dist-backend gloo
"""
from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

from diffusion_tts_torch.utils import rng


def parse_seeds(spec: str) -> list[int]:
    """'0-63' / '1,2,5-7' (reference generate.py:216-231)."""
    out: list[int] = []
    for part in spec.split(","):
        m = re.fullmatch(r"(\d+)-(\d+)", part)
        if m:
            out.extend(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            out.append(int(part))
    return out


def rank_batches(seeds: list[int], max_batch: int, rank: int, world: int) -> list[list[int]]:
    """This rank's batches: the seeds split into a multiple of ``world``
    batches of at most ``max_batch``, strided over the ranks
    (generate.py:254-257)."""
    num = ((len(seeds) - 1) // (max_batch * world) + 1) * world
    return [b.tolist() for b in torch.as_tensor(seeds).tensor_split(num)[rank::world]]


@torch.no_grad()
def sample_images(net: torch.nn.Module, z: torch.Tensor, eps: torch.Tensor,
                  labels: torch.Tensor | None, steps: int, churn: float) -> torch.Tensor:
    """The EDM Heun sampler from z [B, H, W, C] with churn noise eps [steps,
    B, H, W, C]; uint8 images, clipped as the JAX tool does."""
    from diffusion_tts_torch.samplers.edm import EDMHeunSampler

    sampler = EDMHeunSampler(denoise=lambda x, s: net(x, s, labels), num_steps=steps,
                             S_churn=churn)
    x, _ = sampler.sample(z, eps)
    return (x * 127.5 + 128).clamp(0, 255).to(torch.uint8)


def seed_inputs(seeds: list[int], shape: tuple[int, int, int], steps: int, label_dim: int,
                class_idx: int | None, device: torch.device):
    """(z, eps, labels) of a batch of seeds, each from its seed's generators."""
    z = rng.stacked_normal(rng.per_seed_generators(seeds, device, 0), shape)
    eps = rng.stacked_normal(rng.per_seed_generators(seeds, device, 2),
                             (steps,) + shape).transpose(0, 1)
    labels = None
    if label_dim:
        if class_idx is None:
            cls = torch.cat([torch.randint(label_dim, (1,), generator=g, device=device)
                             for g in rng.per_seed_generators(seeds, device, 1)])
        else:
            cls = torch.full((len(seeds),), class_idx, device=device)
        labels = torch.eye(label_dim, device=device)[cls]
    return z, eps, labels


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", default="0-7")
    p.add_argument("--outdir", required=True)
    p.add_argument("--arch", default="imagenet64")
    p.add_argument("--weights", default=None, help=".npz reference state dict; random if none")
    p.add_argument("--steps", type=int, default=18)
    p.add_argument("--batch", type=int, default=64, help="max seeds per batch of one rank")
    p.add_argument("--class-idx", type=int, default=None)
    p.add_argument("--churn", type=float, default=0.0, help="S_churn (generate.py default 0)")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default="nccl",
                   help="torch.distributed backend under torchrun (gloo: ranks may share a "
                        "card, or run on the CPU)")
    args = p.parse_args(argv)

    from diffusion_tts_torch.parallel.distributed import process_group

    with process_group(args.dist_backend, device=args.device):
        return _generate(args)


def _generate(args) -> list[str]:
    import torch.distributed as dist
    from PIL import Image

    from diffusion_tts_torch.backends.edm_entry import NET_CONFIGS, load_network
    from diffusion_tts_torch.parallel.distributed import rank, rank_device, world_size
    from diffusion_tts_torch.utils.device import resolve_device
    from diffusion_tts_torch.utils.logging_utils import print0

    dev = rank_device(resolve_device(args.device))
    cfg = NET_CONFIGS[args.arch]
    shape = (cfg["img_resolution"], cfg["img_resolution"], cfg["img_channels"])
    net = load_network(args.arch, args.weights, device=dev)
    seeds = parse_seeds(args.seeds)
    os.makedirs(args.outdir, exist_ok=True)
    written = []
    for batch in rank_batches(seeds, args.batch, rank(), world_size()):
        if not batch:
            continue
        z, eps, labels = seed_inputs(batch, shape, args.steps, cfg["label_dim"],
                                     args.class_idx, dev)
        images = sample_images(net, z, eps, labels, args.steps, args.churn).cpu().numpy()
        for seed, img in zip(batch, images):
            path = os.path.join(args.outdir, f"{seed:06d}.png")
            Image.fromarray(np.squeeze(img)).save(path)
            written.append(path)
    if dist.is_initialized():
        dist.barrier()
    print0(f"wrote {len(seeds)} images to {args.outdir}")
    return written


if __name__ == "__main__":
    main()
