"""Where the time of one model call goes on the card (PyTorch port).

    python3 tools/torch_forward_profile.py [--model edm|sd|edm-train] [--batch 8] [--reps 5]
        [--dtype bf16|fp32] [--search]

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
``--model edm-train``: one training step of the same EDM net (bf16 compute,
fp32 parameters, dropout 0.10, EDM loss, Adam, EMA) through
``training/train_step.py::train_step``, ``--batch`` images as 2 accumulation
rounds (run it with ``--batch 32``: the micro-batch of 16 of chip_smoke.py's
training phase). The foreach kernels of Adam, the EMA and the gradient
scaling are counted under ``optimizer_foreach``.

``--dtype fp32`` builds the nets in fp32 (the CLIs' default dtype) with
TF32 off for cuBLAS and cuDNN, as chip_smoke.py runs its fp32 checks (edm
and sd). ``--search`` (sd): the calls of chip_smoke.py's short eps-greedy
search (6 steps, N = 4, K = 2, one prompt): the UNet at batches 8 (12
calls) and 2 (6), the decode at batches 4 (12) and 1 (1), each profiled,
and their device time by class summed over the search with each class's
share (``search``).

For each model call it reports the wall time (host clock around work
ending in a synchronize), the host time to enqueue it, the device busy
time (sum of kernel durations from ``torch.profiler``), the idle share,
the device time by kernel class, and the device time by the port's kernel
(``device_ms_by_kernel``: the TPU kernel each CUDA kernel replaces, #1-#8
of PERF.md's table; conv3x3_same and conv3x3_up2 share their v1 and ring
kernels, whose launches are told apart by the order of the wrappers' calls
on the one stream; GroupNorm's moments kernel counts as the statistics'
(#5), which holds where every standalone GroupNorm runs on the slab, as on
the SD paths). Prints one JSON line last. Needs an NVIDIA card; imports
nothing of JAX.
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
    ("attention_bwd_kernel", ("dq_kernel", "dkv_kernel", "dq_mma_kernel", "dkv_mma_kernel")),
    ("attention_kernel", ("attention_kernel", "attention_mma_kernel", "attention_wgmma_kernel",
                          "attention_tf32_kernel")),
    ("group_norm_kernel", ("gn_slab_kernel", "gn_moments_kernel", "gn_apply_kernel",
                           "gn_stats_finalize_kernel")),
    ("geglu_kernel", ("geglu_gate_kernel", "geglu_out_kernel", "geglu_mma_kernel",
                      "geglu_wgmma_kernel", "geglu_tf32_kernel")),
    ("conv3x3_kernel", ("conv3_kernel", "conv3_ring_kernel", "conv3_wgmma_kernel",
                        "conv3_up2_wgmma_kernel")),
    ("optimizer_foreach", ("multi_tensor_apply",)),
    ("conv", ("conv", "xmma", "implicit", "cudnn", "sm90", "nhwc", "nchw")),
    ("group_norm", ("group_norm", "GroupNorm", "welford", "Welford")),
    ("gemm", ("gemm", "Gemm", "cutlass")),
    ("copy_layout", ("copy", "Copy", "cat", "Cat", "permute", "contiguous")),
)


PORT_KERNELS = (  # (the port's kernel, substrings of its CUDA kernels' names), first match wins
    ("#3 attention_bwd", ("dq_kernel", "dkv_kernel", "dq_mma_kernel", "dkv_mma_kernel",
                          "dq_wgmma_kernel", "dkv_wgmma_kernel", "dq_wide_kernel",
                          "dkv_wide_kernel")),
    ("#1/#2 attention", ("attention_kernel", "attention_mma_kernel", "attention_wgmma_kernel",
                         "attention_tf32_kernel")),
    ("#4 group_norm_silu", ("gn_slab_kernel", "gn_apply_kernel")),
    ("#5 group_norm_stats", ("gn_moments_kernel", "gn_stats_finalize_kernel")),
    ("#8 geglu_ff", ("geglu_gate_kernel", "geglu_out_kernel", "geglu_mma_kernel",
                     "geglu_wgmma_kernel", "geglu_tf32_kernel")),
    ("#7 conv3x3_up2", ("conv3_up2_wgmma_kernel",)),
    ("#6 conv3x3_same", ("conv3_wgmma_kernel",)),
)
SHARED_CONV = ("conv3_kernel", "conv3_ring_kernel")  # #6's and #7's v1 and ring routes


def classify(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "elementwise_other"


def port_kernel(name: str) -> str | None:
    for kernel, keys in PORT_KERNELS:
        if any(k in name for k in keys):
            return kernel
    return None


class ConvCalls:
    """While in use, records which of conv3x3_same ("#6 conv3x3_same") and
    conv3x3_up2 ("#7 conv3x3_up2") each call that launched a v1 or ring
    kernel was, in the order of the calls (the wrappers' route counters say
    which route a call took)."""

    def __init__(self):
        from diffusion_tts_torch.ops.kernels import conv3x3 as cv

        self.cv, self.order = cv, []
        self.saved = (cv.conv3x3_same, cv.conv3x3_up2)

    def _wrap(self, fn, routes, kind):
        def call(*args, **kwargs):
            before = routes["v1"] + routes["ring"]
            out = fn(*args, **kwargs)
            self.order += [kind] * (routes["v1"] + routes["ring"] - before)
            return out
        return call

    def __enter__(self):
        same, up2 = self.saved
        self.cv.conv3x3_same = self._wrap(same, self.cv.SAME_ROUTE_LAUNCHES, "#6 conv3x3_same")
        self.cv.conv3x3_up2 = self._wrap(up2, self.cv.UP2_ROUTE_LAUNCHES, "#7 conv3x3_up2")
        return self

    def __exit__(self, *exc):
        self.cv.conv3x3_same, self.cv.conv3x3_up2 = self.saved


def profile(fwd, reps: int, grad: bool = False) -> dict:
    """Wall, enqueue and device time of one call of ``fwd``, averaged over
    ``reps`` calls after 3 warm-up calls; autograd is on only for a call that
    trains."""
    with torch.set_grad_enabled(grad):
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
        with ConvCalls() as conv_calls, torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fwd()
            torch.cuda.synchronize()

    by_class: dict[str, float] = {}
    by_kernel: dict[str, float] = {}
    shared = []
    launches = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.is_user_annotation:
            continue
        dur = evt.time_range.end - evt.time_range.start  # microseconds
        by_class[classify(evt.name)] = by_class.get(classify(evt.name), 0.0) + dur / 1e3
        kernel = port_kernel(evt.name)
        if kernel is None and any(f"::{k}<" in evt.name for k in SHARED_CONV):
            shared.append((evt.time_range.start, dur))
        elif kernel is not None:
            by_kernel[kernel] = by_kernel.get(kernel, 0.0) + dur / 1e3
        launches += 1
    if len(shared) != len(conv_calls.order):
        raise RuntimeError(f"{len(shared)} v1/ring conv launches for {len(conv_calls.order)} "
                           "recorded calls: cannot tell #6 from #7")
    for (_, dur), kernel in zip(sorted(shared), conv_calls.order):
        by_kernel[kernel] = by_kernel.get(kernel, 0.0) + dur / 1e3
    busy_ms = sum(by_class.values()) / reps
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    return {
        "wall_ms": wall_ms, "host_enqueue_ms": enqueue_ms,
        "device_busy_ms": busy_ms if launches else None,
        "device_idle_share": (1 - busy_ms / wall_ms) if launches else None,
        "kernels": launches / reps,
        "device_ms_by_class": {k: v / reps for k, v in sorted(by_class.items())},
        "device_ms_by_kernel": {k: v / reps for k, v in sorted(by_kernel.items())},
    }


# (UNet batch, calls), (decode batch, calls) of chip_smoke.py's short SD search
SD_SEARCH_CALLS = (((8, 12), (2, 6)), ((4, 12), (1, 1)))


def edm_calls(batch: int, dtype: torch.dtype, search: bool = False) -> dict:
    from diffusion_tts_torch.backends.edm_entry import load_network

    net = load_network("imagenet64", dtype=dtype, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((batch, 64, 64, 3), device="cuda", generator=g) * 10
    sigma = torch.full((batch,), 10.0, device="cuda")
    labels = torch.eye(1000, device="cuda")[torch.arange(batch, device="cuda")]
    return {f"forward[{batch}]": lambda: net(x, sigma, labels)}


def sd_calls(batch: int, dtype: torch.dtype, search: bool = False) -> dict:
    from diffusion_tts_torch.pipelines.sd_pipeline import (
        SD15_UNET,
        SD15_VAE,
        StableDiffusionSearchPipeline,
    )

    pipe = StableDiffusionSearchPipeline.random(SD15_UNET, SD15_VAE, seed=0, dtype=dtype,
                                                device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    unets, decodes = SD_SEARCH_CALLS if search else (((batch, 1),), ((batch // 2, 1),))
    calls = {}
    for b, _ in unets:
        x = torch.randn((b, 4, 64, 64), device="cuda", generator=g)
        t = torch.full((b,), 501, device="cuda")
        ctx = torch.randn((b, 77, 768), device="cuda", generator=g)
        calls[f"unet[{b}]"] = lambda x=x, t=t, ctx=ctx: pipe.unet(x, t, ctx)
    for b, _ in decodes:
        z = torch.randn((b, 4, 64, 64), device="cuda", generator=g) / 0.18215
        calls[f"vae_decode[{b}]"] = lambda z=z: pipe.vae.decode(z)
    return calls


def search_total(out: dict) -> dict:
    """Device ms by class and by the port's kernel over chip_smoke.py's short
    SD search (each call's profile times its count), each one's share of the
    search's device busy ms, and that."""
    total = {"device_ms_by_class": {}, "device_ms_by_kernel": {}}
    for kind, pairs in zip(("unet", "vae_decode"), SD_SEARCH_CALLS):
        for b, n in pairs:
            for key, sums in total.items():
                for name, ms in out[f"{kind}[{b}]"][key].items():
                    sums[name] = sums.get(name, 0.0) + n * ms
    busy = sum(total["device_ms_by_class"].values())
    return {"device_busy_ms": busy, **total,
            "share_by_class": {k: v / busy for k, v in total["device_ms_by_class"].items()},
            "share_by_kernel": {k: v / busy for k, v in total["device_ms_by_kernel"].items()}}


def train_calls(batch: int, dtype: torch.dtype, search: bool = False) -> dict:
    from diffusion_tts_torch.backends.edm_entry import IMAGENET64_ADM
    from diffusion_tts_torch.models.preconds import EDMPrecond
    from diffusion_tts_torch.models.torch_import import load_into, random_state_dict
    from diffusion_tts_torch.training.loss import EDMLoss
    from diffusion_tts_torch.training.train_step import TrainConfig, TrainState, train_step

    cfg = dict(IMAGENET64_ADM, model_kwargs=dict(IMAGENET64_ADM["model_kwargs"], dropout=0.10))
    net = EDMPrecond(dtype=dtype, param_dtype=torch.float32, **cfg)
    load_into(net, random_state_dict(net, 0)).to("cuda")
    train_cfg = TrainConfig(lr=1e-4, lr_rampup_kimg=0.0, grad_accum_rounds=2, total_batch=batch)
    state = TrainState.create(net, train_cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand((2, batch // 2, 64, 64, 3), device="cuda", generator=g) * 2 - 1
    labels = torch.eye(1000, device="cuda")[
        torch.randint(0, 1000, (2, batch // 2), device="cuda", generator=g)]
    return {f"train_step[{batch}=2x{batch // 2}]":
            lambda: train_step(state, images, labels, EDMLoss(), train_cfg, g)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["edm", "sd", "edm-train"], default="edm")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    ap.add_argument("--search", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_forward_profile: needs an NVIDIA card")
    if args.search and args.model != "sd":
        sys.exit("torch_forward_profile: --search profiles the SD search's calls (--model sd)")
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[args.dtype]
    if dtype == torch.float32:  # fp32 in full: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tag = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    calls = {"sd": sd_calls, "edm": edm_calls, "edm-train": train_calls}[args.model](
        args.batch, dtype, args.search)
    out = {"gpu": tag, "model": args.model, "dtype": str(dtype).split(".")[-1],
           "conv_kernels": os.environ.get("DTTS_NO_CONV_KERNELS", "") in ("", "0")}
    for name, fwd in calls.items():
        out[name] = profile(fwd, args.reps, grad=args.model == "edm-train")
    if args.search:
        out["search"] = search_total(out)
        print("search device ms by class: " + ", ".join(
            f"{k} {v:.2f} ({out['search']['share_by_class'][k]:.1%})"
            for k, v in sorted(out["search"]["device_ms_by_class"].items(), key=lambda kv: -kv[1])))
        print("search device ms by the port's kernel: " + ", ".join(
            f"{k} {v:.2f} ({out['search']['share_by_kernel'][k]:.1%})"
            for k, v in sorted(out["search"]["device_ms_by_kernel"].items(),
                               key=lambda kv: -kv[1])))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
