"""Where the time of one flagship forward goes on the card (PyTorch port).

    python3 tools/torch_forward_profile.py [--batch 8] [--reps 5]

Runs the full-width ImageNet-64 EDMPrecond/DhariwalUNet of
``diffusion_tts_torch`` in bf16 (random weights from numpy seed 0) at the
eps-greedy expansion batch (N * samples = 8) and reports, per forward:
the wall time (host clock around work ending in a synchronize), the host
time to enqueue it, the device busy time (sum of kernel durations from
``torch.profiler``), the idle share, and the device time by kernel class.
Prints one JSON line last. Needs an NVIDIA card; imports nothing of JAX.
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
    ("attention_kernel", ("qkv_attention_kernel",)),
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_forward_profile: needs an NVIDIA card")
    from diffusion_tts_torch.backends.edm_entry import load_network

    tag = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    net = load_network("imagenet64", dtype=torch.bfloat16, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((args.batch, 64, 64, 3), device="cuda", generator=g) * 10
    sigma = torch.full((args.batch,), 10.0, device="cuda")
    labels = torch.eye(1000, device="cuda")[torch.arange(args.batch, device="cuda")]
    fwd = lambda: net(x, sigma, labels)

    with torch.no_grad():
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fwd()
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / args.reps
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.reps):
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
    busy_ms = sum(by_class.values()) / args.reps
    out = {
        "gpu": tag, "batch": args.batch, "dtype": "bfloat16",
        "wall_ms_per_forward": wall_ms,
        "host_enqueue_ms_per_forward": enqueue_ms,
        "device_busy_ms_per_forward": busy_ms if launches else None,
        "device_idle_share": (1 - busy_ms / wall_ms) if launches else None,
        "kernels_per_forward": launches / args.reps,
        "device_ms_per_forward_by_class": {k: v / args.reps for k, v in sorted(by_class.items())},
    }
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
