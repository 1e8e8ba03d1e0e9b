"""Where the time of one model call goes on the card (PyTorch port).

    python3 tools/torch_forward_profile.py [--model edm|sd] [--batch 8] [--reps 5]

``--model edm`` (default): the full-width ImageNet-64 EDMPrecond/
DhariwalUNet of ``diffusion_tts_torch`` in bf16 (random weights from numpy
seed 0) at the eps-greedy expansion batch (N * samples = 8).
``--model sd``: the full-width SD-1.5 UNet in bf16 (random weights from
numpy seed 0) at the eps-greedy expansion batch (2 * N * prompts = 8, the
CFG halves included, 77-token context), and the VAE decode to 512x512 at
batch N * prompts = 4. The decode runs at the default routing (the conv
kernels from 128x128 up); with ``DTTS_NO_CONV_KERNELS=1`` in the environment
every conv is cuDNN and every GroupNorm standalone, for comparison. The
statistics calls' moments launches share ``gn_moments_kernel`` with the
standalone GroupNorm and are counted with it under ``group_norm_kernel``.

For each model call it reports the wall time (host clock around work
ending in a synchronize), the host time to enqueue it, the device busy
time (sum of kernel durations from ``torch.profiler``), the idle share,
and the device time by kernel class. Prints one JSON line last. Needs an
NVIDIA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLASSES = (  # (class, substrings of the kernel name), first match wins
    ("attention_kernel", ("attention_kernel",)),
    ("group_norm_kernel", ("gn_moments_kernel", "gn_apply_kernel", "gn_stats_finalize_kernel")),
    ("geglu_kernel", ("geglu_gate_kernel", "geglu_out_kernel")),
    ("conv3x3_kernel", ("conv3_kernel",)),
    ("conv", ("conv", "xmma", "implicit", "cudnn", "sm90", "nhwc", "nchw")),
    ("group_norm", ("group_norm", "GroupNorm", "welford", "Welford")),
    ("gemm", ("gemm", "Gemm", "cutlass")),
    ("copy_layout", ("copy", "Copy", "cat", "Cat", "permute", "contiguous")),
)


def classify(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "elementwise_other"


def profile(fwd, reps: int) -> dict:
    """Wall, enqueue and device time of one call of ``fwd``, averaged over
    ``reps`` calls after 3 warm-up calls."""
    with torch.no_grad():
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fwd()
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fwd()
            torch.cuda.synchronize()

    by_class: dict[str, float] = {}
    launches = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = evt.time_range.end - evt.time_range.start  # microseconds
        by_class[classify(evt.name)] = by_class.get(classify(evt.name), 0.0) + dur / 1e3
        launches += 1
    busy_ms = sum(by_class.values()) / reps
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    return {
        "wall_ms": wall_ms, "host_enqueue_ms": enqueue_ms,
        "device_busy_ms": busy_ms if launches else None,
        "device_idle_share": (1 - busy_ms / wall_ms) if launches else None,
        "kernels": launches / reps,
        "device_ms_by_class": {k: v / reps for k, v in sorted(by_class.items())},
    }


def edm_calls(batch: int) -> dict:
    from diffusion_tts_torch.backends.edm_entry import load_network

    net = load_network("imagenet64", dtype=torch.bfloat16, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((batch, 64, 64, 3), device="cuda", generator=g) * 10
    sigma = torch.full((batch,), 10.0, device="cuda")
    labels = torch.eye(1000, device="cuda")[torch.arange(batch, device="cuda")]
    return {f"forward[{batch}]": lambda: net(x, sigma, labels)}


def sd_calls(batch: int) -> dict:
    from diffusion_tts_torch.pipelines.sd_pipeline import (
        SD15_UNET,
        SD15_VAE,
        StableDiffusionSearchPipeline,
    )

    pipe = StableDiffusionSearchPipeline.random(SD15_UNET, SD15_VAE, seed=0,
                                                dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((batch, 4, 64, 64), device="cuda", generator=g)
    t = torch.full((batch,), 501, device="cuda")
    ctx = torch.randn((batch, 77, 768), device="cuda", generator=g)
    z = torch.randn((batch // 2, 4, 64, 64), device="cuda", generator=g) / 0.18215
    return {f"unet[{batch}]": lambda: pipe.unet(x, t, ctx),
            f"vae_decode[{batch // 2}]": lambda: pipe.vae.decode(z)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["edm", "sd"], default="edm")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_forward_profile: needs an NVIDIA card")
    tag = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    calls = (sd_calls if args.model == "sd" else edm_calls)(args.batch)
    out = {"gpu": tag, "model": args.model, "dtype": "bfloat16",
           "conv_kernels": os.environ.get("DTTS_NO_CONV_KERNELS", "") in ("", "0")}
    for name, fwd in calls.items():
        out[name] = profile(fwd, args.reps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
