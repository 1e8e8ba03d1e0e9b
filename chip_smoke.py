"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--kernels-json PATH]

Phases, each of which raises on failure (nothing is caught):

  1. environment: the card's name and power limit, torch and CUDA versions;
     fails without a card;
  2. build: every CUDA kernel of the main paths, from csrc/, with nvcc (one
     process per source, all at once);
  3. EDM kernels: the qkv attention kernel against its plain PyTorch
     version at the EDM path's shapes (and the flagship's [16, T, 3C]
     shapes), bf16 within 2e-2 and fp32 within 1e-4 with TF32 off; kernel,
     plain and library (scaled_dot_product_attention, timed only here)
     times beside the least time the card could take; each row names the
     route its predicate gave (bf16: "mma", the tensor cores; fp32: "fma")
     and, at bf16, times the CUDA-core "fma" route too (``fma_ms``: the
     first design, from the same run), with the achieved TFLOP/s;
  4. EDM main path: the full-width ImageNet-64 EDMPrecond/DhariwalUNet in
     bf16 with random weights from a numpy seed, one forward held against
     the same weights in fp32 on the CPU, then eps-greedy search (18 steps,
     2 samples, N=4, K=2) through the entry point, with every kernel's
     launches counted, each on the route its predicate gives (every one on
     "mma");
  5. training (the EDM backend's): the attention backward kernels against
     their plain version at the flagship's [16, T, 3C] training shapes (bf16,
     each of dq, dk, dv within 2e-2 of its largest magnitude; one shape in
     fp32 within 1e-4; one [2, 4096, 8, 40] call through ``attention``), with
     kernel, plain, library (autograd of scaled_dot_product_attention, timed
     only) and bound times, each row's route (bf16: "mma", fp32: "fma"), the
     "fma" route's time at bf16 (``fma_ms``, the first design) and the
     TFLOP/s on the 14*B*H*T^2*d operations the kernels run; the gradient
     of every forward-only kernel's wrapper against its twin's at one small
     shape each; one full-width training forward + backward (batch 2, draws
     from a seed) in fp32 on the card against fp32 on the CPU and in bf16
     compute with fp32 parameters;
     then ``training_loop`` at full width in bf16 on an in-memory dataset:
     batch 32 as 2 rounds of 16, dropout 0.10, 1 warm step and 4 timed steps,
     the forward and backward launches counted (all of them on "mma"), a
     snapshot and a state dump written, read back and held equal;
  6. SD main path: the full-width SD-1.5 UNet and VAE decoder (random
     weights from a numpy seed) at the default routing (the VAE decoder's
     convs from 128x128 up through the conv kernels, their GroupNorms folded
     into the conv prologue), one UNet forward (batch 2, 77-token context)
     and one VAE decode in fp32 and bf16 on the card held against fp32 on
     the CPU (which runs the same route through the plain versions), then
     the pipeline's bf16 eps-greedy search (6 steps, N=4, K=2, one prompt,
     brightness) twice, with every kernel's launches counted, held against
     the counts the architecture and the routing predicates give (attention
     and GEGLU all on "mma"), and every kernel call's shape recorded;
  7. SD kernels: attention, GroupNorm(+SiLU), GEGLU, GroupNorm statistics,
     conv3x3_same (every prologue/epilogue variant that occurred) and
     conv3x3_up2 against their plain versions at every shape the SD search
     gave them (bf16) and at one shape each in fp32, within 2e-2 / 1e-4 of
     the output's largest magnitude (statistics: of the largest mean and of
     the largest rstd), with kernel, plain, library and bound times (5
     repetitions instead of 20 at the 512x512 shapes); attention and GEGLU
     rows as in phase 3 (route, ``fma_ms``, TFLOP/s);
  8. one JSON line of kernel numbers, then the result line.

With --kernels-json, the per-shape rows also go to that file. The script
imports nothing of JAX; it needs the repository beside it.
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import torch
import torch.nn.functional as F

from diffusion_tts_torch import train as train_cli
from diffusion_tts_torch.backends.edm_entry import (
    IMAGENET64_ADM,
    generate_image_grid,
    load_network,
)
from diffusion_tts_torch.models.preconds import EDMPrecond
from diffusion_tts_torch.models.torch_import import load_into, random_state_dict
from diffusion_tts_torch.models import sd_layers, sd_vae
from diffusion_tts_torch.models.sd_unet import UNet2DConditionModel
from diffusion_tts_torch.ops.kernels import build
from diffusion_tts_torch.ops.kernels import conv3x3 as cv
from diffusion_tts_torch.ops.kernels import geglu_ff as gg
from diffusion_tts_torch.ops.kernels import groupnorm as gn
from diffusion_tts_torch.ops.kernels import qkv_attention as qk
from diffusion_tts_torch.pipelines.sd_pipeline import (
    SD15_UNET,
    SD15_VAE,
    StableDiffusionSearchPipeline,
)
from diffusion_tts_torch.scorers import BrightnessScorer
from diffusion_tts_torch.search.nfe import nfe_per_sample
from diffusion_tts_torch.training import checkpoints
from diffusion_tts_torch.training.dataset import ImageDataset, batch_iterator
from diffusion_tts_torch.training.loop import LoopConfig, training_loop
from diffusion_tts_torch.training.loss import EDMLoss
from diffusion_tts_torch.training.train_step import TrainConfig, TrainState
from diffusion_tts_torch.utils.config import SearchParams

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
# The flagship's attention sites: (T, heads, sites per forward).
SITES = ((1024, 6, 7), (256, 9, 7), (64, 12, 8))
STEPS, SAMPLES, N, K = 18, 2, 4, 2
# The short SD search (bench.py --sd on the CPU): 6 steps, N=4, K=2, one prompt.
SD_STEPS, SD_N, SD_K, SD_PROMPTS, CLIP_TOKENS = 6, 4, 2, 1, 77
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Training: batch 32 as 2 accumulation rounds of micro-batch 16, 1 warm + 4 timed steps.
TRAIN_BATCH, TRAIN_ROUNDS, TRAIN_STEPS = 32, 2, 5


def reset_launches() -> None:
    qk.LAUNCHES = qk.BWD_LAUNCHES = gn.LAUNCHES = gn.STATS_LAUNCHES = gg.LAUNCHES = 0
    cv.SAME_LAUNCHES = cv.UP2_LAUNCHES = 0
    for routes in (qk.ROUTE_LAUNCHES, qk.BWD_ROUTE_LAUNCHES, gg.ROUTE_LAUNCHES):
        routes.update(dict.fromkeys(routes, 0))


def read_routes() -> dict:
    return {"attention": dict(qk.ROUTE_LAUNCHES), "attention_bwd": dict(qk.BWD_ROUTE_LAUNCHES),
            "geglu_ff": dict(gg.ROUTE_LAUNCHES)}


def check_routes(path: str, got: dict, want: dict) -> None:
    """Every launch of ``want``'s kernels on ``path`` took the mma route:
    ``got`` from read_routes(), ``want`` {kernel name: launches}."""
    for name, n in want.items():
        if got[name] != {"fma": 0, "mma": n}:
            raise AssertionError(f"{name} on the {path} path: routes {got[name]}, "
                                 f"expected all {n} launches on mma")
    print(f"  routes on the {path} path: " + ", ".join(f"{k} {got[k]}" for k in want))


def read_launches() -> dict:
    return {"attention": qk.LAUNCHES, "attention_bwd": qk.BWD_LAUNCHES,
            "group_norm_silu": gn.LAUNCHES, "geglu_ff": gg.LAUNCHES,
            "group_norm_stats": gn.STATS_LAUNCHES, "conv3x3_same": cv.SAME_LAUNCHES,
            "conv3x3_up2": cv.UP2_LAUNCHES}


def gpu_tag() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_in_turns(fn, other, reps: int = 20) -> tuple[float, float]:
    """(ms of fn, ms of other), each the lesser of two timings taken in
    turns (fn, other, other, fn): at a host-bound shape one timing alone
    reads the host's noise as much as the device."""
    a1, b1, b2, a2 = (time_ms(f, reps) for f in (fn, other, other, fn))
    return min(a1, a2), min(b1, b2)


def route_columns(row: dict, route: str, flops: float, fma) -> None:
    """The row's route, the CUDA-core route's time (timed here unless the
    row is on it) and the TFLOP/s of its kernel time."""
    row["route"] = route
    row["fma_ms"] = time_ms(fma) if route == "mma" else row["ms"]
    row["tflops"] = flops / row["ms"] / 1e9


def bound(flops: float, moved_bytes: float, dtype: torch.dtype) -> tuple[float, str]:
    """The least time for the work in ms and what sets it: the operations at
    the dtype's peak or the bytes at the memory rate."""
    ops, mem = flops / PEAK_FLOPS[dtype], moved_bytes / PEAK_BYTES
    return max(ops, mem) * 1e3, "operations" if ops >= mem else "bytes"


def attention_bound_ms(b: int, t: int, heads: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one call: 4*B*H*T^2*d operations at the dtype's peak,
    or reading [B, T, 3C] and writing [B, T, C] at the memory rate."""
    d = 64
    ops = 4 * b * heads * t * t * d / PEAK_FLOPS[dtype]
    moved = b * t * 4 * heads * d * torch.finfo(dtype).bits // 8 / PEAK_BYTES
    return max(ops, moved) * 1e3, "operations" if ops >= moved else "bytes"


def check_attention(b: int, t: int, heads: int, dtype: torch.dtype, tag: str) -> dict:
    g = torch.Generator(device="cuda").manual_seed(1000 * t + b)
    qkv = torch.randn((b, t, 3 * heads * 64), device="cuda", generator=g).to(dtype)
    out = qk.qkv_self_attention(qkv, heads)
    ref = qk.qkv_self_attention_plain(qkv, heads)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    max_abs = diff.max().item()
    max_rel = max_abs / ref.float().abs().max().item()  # relative to the largest output
    tol = TOL[dtype]
    ok = bool(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol))
    q, k, v = (x.reshape(b, t, heads, 64).transpose(1, 2).contiguous()
               for x in qkv.chunk(3, dim=-1))
    row = dict(shape=[b, t, 3 * heads * 64], heads=heads, dtype=str(dtype).split(".")[-1],
               max_abs_err=max_abs, max_rel_err=max_rel,
               ms=time_ms(lambda: qk.qkv_self_attention(qkv, heads)),
               plain_ms=time_ms(lambda: qk.qkv_self_attention_plain(qkv, heads), reps=5),
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)))
    row["bound_ms"], row["bound_by"] = attention_bound_ms(b, t, heads, dtype)
    route_columns(row, qk.forward_route(dtype, 64), 4 * b * heads * t * t * 64,
                  lambda: qk.qkv_self_attention(qkv, heads, route="fma"))
    print(f"  qkv_attention {row['shape']} {row['dtype']:>8} heads={heads:2d}: "
          f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} (tol {tol}) route={row['route']} "
          f"kernel_ms={row['ms']:.4f} ({row['tflops']:.1f} TFLOP/s) fma_ms={row['fma_ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) [{tag}]")
    if not ok:
        raise AssertionError(f"qkv_attention disagrees with its plain version: {row}")
    return row


def edm_phases(tag: str) -> dict:
    """Phases 3 and 4: the EDM kernel checks and the EDM main path."""
    print("EDM kernels vs plain:")
    main_rows, rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (N * SAMPLES, 16):
            for t, heads, _ in SITES:
                row = check_attention(b, t, heads, dtype, tag)
                rows.append(row)
                if b == N * SAMPLES and dtype == torch.bfloat16:
                    main_rows.append(row)
    q, k, v = (torch.randn((8, 1024, 6, 64), device="cuda").bfloat16() for _ in range(3))
    err = (qk.attention(q, k, v).float() - qk.attention_plain(q, k, v).float()).abs().max().item()
    print(f"  attention [8,1024,6,64] bfloat16 ([B,T,H,D] strides, route "
          f"{qk.forward_route(q.dtype, 64)}): max_abs={err:.3e}")
    if err > TOL[torch.bfloat16]:
        raise AssertionError(f"attention ([B,T,H,D]) disagrees with its plain version: {err}")

    t0 = time.perf_counter()
    net = load_network("imagenet64", dtype=torch.bfloat16, device="cuda", seed=0)
    load_s = time.perf_counter() - t0
    ref_cpu = load_network("imagenet64", dtype=torch.float32, device="cpu", seed=0)
    net32 = load_network("imagenet64", dtype=torch.float32, device="cuda", seed=0)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 64, 64, 3), generator=g) * torch.tensor([80.0, 0.5]).view(2, 1, 1, 1)
    sigma, labels = torch.tensor([80.0, 0.5]), torch.eye(1000)[[3, 977]]
    with torch.no_grad():
        y_ref = ref_cpu(x, sigma, labels)
        y32 = net32(x.cuda(), sigma.cuda(), labels.cuda()).cpu()
        y16 = net(x.cuda(), sigma.cuda(), labels.cuda()).cpu()
    del ref_cpu, net32
    scale = y_ref.abs().max().item()
    e32, e16 = ((y - y_ref).abs().max().item() / scale for y in (y32, y16))
    print(f"EDM forward [2,64,64,3] vs fp32 on the CPU (max abs err / max abs): "
          f"fp32 card {e32:.3e}, bf16 card {e16:.3e}")
    if not (e32 < 1e-3 and e16 < 5e-2 and torch.isfinite(y16).all()):
        raise AssertionError(f"full-width forward disagrees with the CPU: fp32 {e32}, bf16 {e16}")

    params = SearchParams(N=N, K=K)
    search = lambda: generate_image_grid(
        arch="imagenet64", scorer=BrightnessScorer(), method="eps_greedy", params=params,
        seed=0, gridw=SAMPLES, num_steps=STEPS, dtype=torch.bfloat16, device="cuda", net=net)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = search()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, routes = qk.LAUNCHES, read_routes()
    others = {k: v for k, v in read_launches().items() if k != "attention" and v}
    if others:
        raise AssertionError(f"the EDM main path launched kernels it does not route to: {others}")
    t0 = time.perf_counter()
    search()  # the same request again: steady state, not counted
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    expected = sum(n for _, _, n in SITES) * 2 * STEPS * K
    nfe = nfe_per_sample("eps_greedy", STEPS, params) * SAMPLES
    print(f"EDM main path: eps_greedy 18 steps B={SAMPLES} N={N} K={K} bf16: load {load_s:.2f} s, "
          f"search {first_s:.3f} s first / {again_s:.3f} s again, {nfe} NFE, "
          f"{nfe / first_s:.2f} / {nfe / again_s:.2f} NFE/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"scores {result.score.tolist()}, launches {{'qkv_attention': {launches}}} [{tag}]")
    if launches != expected:
        raise AssertionError(f"qkv_attention launched {launches} times on the EDM main path, "
                             f"expected {expected}")
    check_routes("EDM", routes, {"attention": expected})
    if not (torch.isfinite(result.score).all() and torch.isfinite(result.x).all()
            and result.images.shape == (SAMPLES, 64, 64, 3)
            and 0 <= result.images.min() <= result.images.max() <= 1):
        raise AssertionError("EDM main path output is not finite images in [0, 1]")
    del net
    torch.cuda.empty_cache()

    per_forward = lambda key: sum(r[key] * n for r, (_, _, n) in zip(main_rows, SITES))
    return {
        "name": "qkv_attention", "route": "cuda",
        "source": "diffusion_tts_torch/csrc/qkv_attention.cu",
        "replaces": "diffusion_tts_tpu/ops/pallas/attention.py:713",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times: the 22 attention sites of one bf16 forward at the main
        # path's batch (N * samples), summed
        "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": max(main_rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": per_forward("library_ms"), "fma_ms": per_forward("fma_ms"),
        "shapes": rows,
    }


# ----------------------------------------------------------------------- SD


def sd_pipeline_like(ref: StableDiffusionSearchPipeline, dtype: torch.dtype):
    """The same weights as ``ref`` on the card in ``dtype``."""
    with torch.device("cuda"):
        unet = UNet2DConditionModel(**SD15_UNET, dtype=dtype)
        vae = sd_vae.AutoencoderKL(**SD15_VAE, dtype=dtype)
    unet.load_state_dict(ref.unet.state_dict())
    vae.load_state_dict(ref.vae.state_dict())
    return StableDiffusionSearchPipeline(unet=unet.eval(), vae=vae.eval())


class KernelShapes:
    """Counts every kernel call of the SD modules by its shape while a search
    runs. Forward hooks on the modules: attention [B, T, H, D], GroupNorm
    (x shape, groups, eps, silu) or, when the module was asked for its
    folded statistics, group_norm_stats (x shape, groups, eps), GEGLU
    (M, C, F). Recording stand-ins for the two conv functions, which the
    modules reach only where the routing predicates send them: conv3x3_same
    (x shape, K, prologue, bias, "residual" / "shortcut" / "none", Cres),
    conv3x3_up2 (x shape, K, bias)."""

    NAMES = ("attention", "group_norm_silu", "geglu_ff", "group_norm_stats", "conv3x3_same",
             "conv3x3_up2")

    def __init__(self, pipe: StableDiffusionSearchPipeline):
        self.counts = {name: collections.Counter() for name in self.NAMES}
        self.handles = []
        for m in list(pipe.unet.modules()) + list(pipe.vae.modules()):
            if isinstance(m, sd_layers.GroupNorm):
                hook = self.group_norm
            elif isinstance(m, sd_layers.CrossAttention):
                hook = lambda mod, a, out: len(a) == 1 and self.counts["attention"].update(
                    [(a[0].shape[0], a[0].shape[1], mod.heads, mod.dim_head)])
            elif isinstance(m, sd_vae.VAEAttention):
                hook = lambda mod, a, out: self.counts["attention"].update(
                    [(a[0].shape[0], a[0].shape[2] * a[0].shape[3], 1, a[0].shape[1])])
            elif isinstance(m, sd_layers.FeedForward):
                hook = lambda mod, a, out: self.counts["geglu_ff"].update(
                    [(a[0].numel() // a[0].shape[-1], a[0].shape[-1],
                      mod.net[2].weight.shape[1])])
            else:
                continue
            self.handles.append(m.register_forward_hook(hook))
        self.same, self.up2 = cv.conv3x3_same, cv.conv3x3_up2
        cv.conv3x3_same, cv.conv3x3_up2 = self.conv_same, self.conv_up2

    def group_norm(self, mod, a, out) -> None:
        if isinstance(out, tuple):  # (scale, shift): the statistics call
            self.counts["group_norm_stats"].update([(tuple(a[0].shape), mod.groups, mod.eps)])
        else:
            self.counts["group_norm_silu"].update(
                [(tuple(a[0].shape), mod.groups, mod.eps, mod.apply_silu)])

    def conv_same(self, x, weight, bias=None, residual=None, *, gn_scale=None, gn_shift=None,
                  shortcut=None):
        tail = "residual" if residual is not None else "shortcut" if shortcut is not None \
            else "none"
        self.counts["conv3x3_same"].update(
            [(tuple(x.shape), weight.shape[0], gn_scale is not None, bias is not None, tail,
              shortcut[0].shape[1] if shortcut is not None else 0)])
        return self.same(x, weight, bias, residual, gn_scale=gn_scale, gn_shift=gn_shift,
                         shortcut=shortcut)

    def conv_up2(self, x, weight, bias=None):
        self.counts["conv3x3_up2"].update([(tuple(x.shape), weight.shape[0], bias is not None)])
        return self.up2(x, weight, bias)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        cv.conv3x3_same, cv.conv3x3_up2 = self.same, self.up2


def rel_err(out, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max abs reference); for tuples of
    tensors, the largest of each over the pairs."""
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(out, ref)]
    return max(errs), max(e / r.float().abs().max().item() for e, r in zip(errs, ref))


def kernel_row(name: str, shape, dtype, out, ref, kernel, plain, library, flops_bytes,
               tag: str, reps: int = 20, route=None) -> dict:
    """One kernel's check and times at one shape. ``route``: (the route the
    predicate gave, a call of the same kernel on the "fma" route) for the
    kernels with two routes."""
    torch.cuda.synchronize()
    max_abs, max_rel = rel_err(out, ref)
    finite = all(torch.isfinite(o).all() for o in ((out,) if isinstance(out, torch.Tensor) else out))
    row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1], max_abs_err=max_abs,
               max_rel_err=max_rel, ms=time_ms(kernel, reps), plain_ms=time_ms(plain, 3),
               library_ms=time_ms(library, reps))
    row["bound_ms"], row["bound_by"] = bound(*flops_bytes, dtype)
    routed = ""
    if route is not None:
        route_columns(row, route[0], flops_bytes[0], route[1])
        routed = (f" route={row['route']} ({row['tflops']:.1f} TFLOP/s) "
                  f"fma_ms={row['fma_ms']:.4f}")
    print(f"  {name} {row['shape']} {row['dtype']:>8}: max_abs={max_abs:.3e} "
          f"max_rel={max_rel:.3e} (tol {TOL[dtype]}) kernel_ms={row['ms']:.4f}{routed} "
          f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) [{tag}]")
    if not (max_rel <= TOL[dtype] and finite):
        raise AssertionError(f"{name} disagrees with its plain version: {row}")
    return row


def check_sd_attention(key, dtype, tag):
    b, t, h, d = key
    g = torch.Generator(device="cuda").manual_seed(t + d)
    q, k, v = (torch.randn((b, t, h, d), device="cuda", generator=g).to(dtype)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    item = torch.finfo(dtype).bits // 8
    return kernel_row("attention", key, dtype, qk.attention(q, k, v), qk.attention_plain(q, k, v),
                      lambda: qk.attention(q, k, v), lambda: qk.attention_plain(q, k, v),
                      lambda: F.scaled_dot_product_attention(qt, kt, vt),
                      (4 * b * h * t * t * d, 4 * b * t * h * d * item), tag,
                      route=(qk.forward_route(dtype, d), lambda: qk.attention(q, k, v, route="fma")))


def check_group_norm(key, dtype, tag):
    shape, groups, eps, silu = key
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    c = shape[1]
    w = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    b = 0.1 * torch.randn(c, device="cuda", generator=g)
    kernel = lambda: gn.group_norm_silu(x, w, b, groups=groups, eps=eps, apply_silu=silu)
    plain = lambda: gn.group_norm_silu_plain(x, w, b, groups=groups, eps=eps, apply_silu=silu)

    def library():
        y = F.group_norm(x, groups, w.to(dtype), b.to(dtype), eps)
        return F.silu(y) if silu else y

    return kernel_row("group_norm_silu", shape, dtype, kernel(), plain(), kernel, plain, library,
                      (0, 2 * x.numel() * x.element_size()), tag)


def check_geglu(key, dtype, tag):
    m, c, f = key
    g = torch.Generator(device="cuda").manual_seed(m + c)
    r = lambda shape, s: (torch.randn(shape, device="cuda", generator=g) * s).to(dtype)
    x, w0, b0, w2, b2 = r((m, c), 1), r((2 * f, c), c ** -0.5), r((2 * f,), 0.1), \
        r((c, f), f ** -0.5), r((c,), 0.1)
    kernel = lambda: gg.geglu_ff(x, w0, b0, w2, b2)
    plain = lambda: gg.geglu_ff_plain(x, w0, b0, w2, b2)

    def library():
        h, gate = F.linear(x, w0, b0).chunk(2, dim=-1)
        return F.linear(h * F.gelu(gate), w2, b2)

    item = torch.finfo(dtype).bits // 8
    return kernel_row("geglu_ff", key, dtype, kernel(), plain(), kernel, plain, library,
                      (6 * m * c * f, (2 * m * c + 3 * c * f) * item), tag, reps=10,
                      route=(gg.route(dtype, c, f),
                             lambda: gg.geglu_ff(x, w0, b0, w2, b2, route="fma")))


def reps_for(shape) -> int:
    """Timing repetitions of the conv kernels' checks: fewer at 512x512."""
    return 5 if shape[-1] >= 512 else 20


def check_group_norm_stats(key, dtype, tag):
    shape, groups, eps = key
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    kernel = lambda: gn.group_norm_stats(x, groups=groups, eps=eps)
    plain = lambda: gn.group_norm_stats_plain(x, groups=groups, eps=eps)
    library = lambda: torch.var_mean(x.reshape(shape[0], groups, -1), dim=-1)
    return kernel_row("group_norm_stats", shape, dtype, kernel(), plain(), kernel, plain, library,
                      (0, x.numel() * x.element_size()), tag, reps=reps_for(shape))


def check_conv_same(key, dtype, tag):
    """Library: F.conv2d in the working dtype on an input taken as already
    normalized, with the bias and no skip: it leaves the prologue and the
    rest of the epilogue out."""
    shape, k, has_gn, has_bias, tail, cres = key
    b, c, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(c + k + h)
    r = lambda sh, s=1.0: (torch.randn(sh, device="cuda", generator=g) * s).to(dtype)
    x, weight = r(shape), r((k, c, 3, 3), (9 * c) ** -0.5)
    kw = {"bias": r((k,), 0.1) if has_bias else None}
    if has_gn:
        kw["gn_scale"] = 1 + 0.5 * torch.randn((b, c), device="cuda", generator=g)
        kw["gn_shift"] = 0.1 * torch.randn((b, c), device="cuda", generator=g)
    if tail == "residual":
        kw["residual"] = r((b, k, h, w))
    if tail == "shortcut":
        kw["shortcut"] = (r((b, cres, h, w)), r((k, cres), cres ** -0.5))
    kernel = lambda: cv.conv3x3_same(x, weight, **kw)
    plain = lambda: cv.conv3x3_same_plain(x, weight, **kw)
    library = lambda: F.conv2d(x, weight, kw["bias"], padding=1)
    item = x.element_size()
    moved = (x.numel() + weight.numel() + b * k * h * w * (2 if tail == "residual" else 1)
             + (b * cres * h * w + k * cres)) * item
    name = f"conv3x3_same[{'gn+' if has_gn else ''}{'bias+' if has_bias else ''}{tail}]"
    row = kernel_row(name, (b, c, h, w, k), dtype, kernel(), plain(), kernel, plain, library,
                     (2 * b * h * w * (9 * c + cres) * k, moved), tag, reps=reps_for(shape))
    row["variant"] = dict(prologue=has_gn, bias=has_bias, epilogue=tail, cres=cres)
    return row


def check_conv_up2(key, dtype, tag):
    shape, k, has_bias = key
    b, c, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(c + k + h)
    r = lambda sh, s=1.0: (torch.randn(sh, device="cuda", generator=g) * s).to(dtype)
    x, weight, bias = r(shape), r((k, c, 3, 3), (9 * c) ** -0.5), r((k,), 0.1) if has_bias else None
    kernel = lambda: cv.conv3x3_up2(x, weight, bias)
    plain = lambda: cv.conv3x3_up2_plain(x, weight, bias)
    library = lambda: F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), weight, bias,
                               padding=1)
    moved = (x.numel() + weight.numel() + 4 * b * k * h * w) * x.element_size()
    return kernel_row("conv3x3_up2", (b, c, h, w, k), dtype, kernel(), plain(), kernel, plain,
                      library, (32 * b * h * w * c * k, moved), tag, reps=reps_for((2 * w,)))


# ----------------------------------------------------------------- training


def check_attention_bwd(b: int, t: int, heads: int, dtype: torch.dtype, tag: str) -> dict:
    """The backward kernels through qkv_self_attention's backward() at
    [B, T, 3C] against the plain version; each of dq, dk, dv within the
    dtype's tolerance of that gradient's largest magnitude. ``ms`` times the
    wrapper's backward function called directly (the row term delta and the
    two launches), ``autograd_ms`` the same through ``torch.autograd.grad``,
    as the library's backward is timed: at the small sites both are the
    autograd engine's dispatch, not the device. ``fma_ms`` times the same
    call on the "fma" route (the first design) where the row is on "mma",
    in turns with ``ms``; ``tflops`` counts the 14*B*H*T^2*d operations the
    two kernels run (S and dP in each)."""
    d, c = 64, heads * 64
    gen = torch.Generator(device="cuda").manual_seed(7000 + t + b)
    qkv = torch.randn((b, t, 3 * c), device="cuda", generator=gen).to(dtype).requires_grad_(True)
    g = torch.randn((b, t, c), device="cuda", generator=gen).to(dtype)
    out = qk.qkv_self_attention(qkv, heads)
    via_autograd = lambda: torch.autograd.grad(out, qkv, g, retain_graph=True)[0]
    got = via_autograd()
    lse = out.grad_fn.saved_tensors[2]
    backward = lambda route=None: qk.qkv_self_attention_bwd(qkv.detach(), out.detach(), g,
                                                            heads, lse, route=route)
    if not torch.equal(backward(), got):
        raise AssertionError("attention_bwd: two runs on the same inputs differ")
    split = lambda x: x.detach().reshape(b, t, -1, d)
    q, k, v = (split(x) for x in qkv.chunk(3, dim=-1))
    plain = lambda: qk.attention_bwd_plain(q, k, v, split(out), split(g))
    ref = plain()
    torch.cuda.synchronize()
    errs = [rel_err(a.reshape(b, t, heads, d), r) for a, r in zip(got.chunk(3, dim=-1), ref)]
    max_abs, max_rel = max(e[0] for e in errs), max(e[1] for e in errs)
    lq, lk, lv = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    lo, lg = F.scaled_dot_product_attention(lq, lk, lv), split(g).transpose(1, 2).contiguous()
    row = dict(shape=[b, t, 3 * c], heads=heads, dtype=str(dtype).split(".")[-1],
               max_abs_err=max_abs, max_rel_err=max_rel,
               autograd_ms=time_ms(via_autograd), plain_ms=time_ms(plain, reps=3),
               library_ms=time_ms(lambda: torch.autograd.grad(lo, (lq, lk, lv), lg,
                                                              retain_graph=True)))
    # the least any implementation needs: S, dP, dV, dQ, dK; q, k, v, o, g read
    # once and dq, dk, dv written once
    row["bound_ms"], row["bound_by"] = bound(10 * b * heads * t * t * d,
                                             8 * b * t * c * torch.finfo(dtype).bits // 8, dtype)
    row["route"] = qk.backward_route(dtype, d)
    if row["route"] == "mma":
        row["ms"], row["fma_ms"] = time_in_turns(backward, lambda: backward("fma"))
    else:
        row["ms"] = row["fma_ms"] = time_ms(backward)
    row["tflops"] = 14 * b * heads * t * t * d / row["ms"] / 1e9
    print(f"  attention_bwd {row['shape']} {row['dtype']:>8} heads={heads:2d}: "
          f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} (tol {TOL[dtype]}) route={row['route']} "
          f"kernel_ms={row['ms']:.4f} ({row['tflops']:.1f} TFLOP/s; through autograd "
          f"{row['autograd_ms']:.4f}) fma_ms={row['fma_ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) [{tag}]")
    if not (max_rel <= TOL[dtype] and torch.isfinite(got).all()):
        raise AssertionError(f"attention_bwd disagrees with its plain version: {row}")
    return row


def check_twin_gradients() -> None:
    """backward() through each forward-only kernel's wrapper on the card
    reaches every input and weight and equals the twin's gradient within the
    forward's tolerance (bf16, one small shape each)."""
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(99)
    r = lambda shape, s=1.0, dt=dtype: (torch.randn(shape, device="cuda", generator=gen) * s).to(dt)
    f32 = torch.float32
    x, cx = r((2, 64, 12, 12)), r((2, 16, 10, 12))
    cases = {
        "group_norm_silu": (lambda x, w, b: gn.group_norm_silu(x, w, b, groups=8),
                            lambda x, w, b: gn.group_norm_silu_plain(x, w, b, groups=8),
                            (x, 1 + r((64,), 0.1, f32), r((64,), 0.1, f32))),
        "group_norm_silu_prebias": (
            lambda x, w, b, p: gn.group_norm_silu_prebias(x, w, b, p, groups=8),
            lambda x, w, b, p: gn.group_norm_silu_plain(x, w, b, groups=8, pre=p),
            (x, 1 + r((64,), 0.1, f32), r((64,), 0.1, f32), r((2, 64), 1.0, f32))),
        "group_norm_stats": (lambda x: gn.group_norm_stats(x, groups=8),
                             lambda x: gn.group_norm_stats_plain(x, groups=8), (x,)),
        "geglu_ff": (gg.geglu_ff, gg.geglu_ff_plain,
                     (r((48, 32)), r((128, 32), 32 ** -0.5), r((128,), 0.1),
                      r((32, 64), 64 ** -0.5), r((32,), 0.1))),
        "conv3x3_same": (
            lambda x, w, b, s, t, sx, sw: cv.conv3x3_same(x, w, b, gn_scale=s, gn_shift=t,
                                                          shortcut=(sx, sw)),
            lambda x, w, b, s, t, sx, sw: cv.conv3x3_same_plain(x, w, b, gn_scale=s, gn_shift=t,
                                                                shortcut=(sx, sw)),
            (cx, r((24, 16, 3, 3), 1 / 12), r((24,)), 1 + r((2, 16), 0.3, f32),
             r((2, 16), 0.1, f32), r((2, 8, 10, 12)), r((24, 8), 0.3))),
        "conv3x3_up2": (cv.conv3x3_up2, cv.conv3x3_up2_plain,
                        (cx, r((24, 16, 3, 3), 1 / 12), r((24,)))),
    }
    for name, (kernel, plain, tensors) in cases.items():
        grads = []
        for fn in (kernel, plain):
            leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
            out = fn(*leaves)
            outs = (out,) if isinstance(out, torch.Tensor) else out
            if fn is kernel:
                cot = [r(o.shape, 1.0, o.dtype) for o in outs]
            grads.append(torch.autograd.grad(outs, leaves, cot))
        worst = max(rel_err(a, b)[1] for a, b in zip(*grads))
        print(f"  {name}: backward() through the kernel's wrapper vs its twin, "
              f"{len(tensors)} gradients, max_rel={worst:.3e} (tol {TOL[dtype]})")
        if not (worst <= TOL[dtype] and all(torch.isfinite(a).all() for a in grads[0])):
            raise AssertionError(f"{name}: the wrapper's gradient disagrees with its twin's")


def training_net(dtype: torch.dtype, device: str, dropout: float = 0.0) -> EDMPrecond:
    """The full-width ImageNet-64 ADM as the training CLI builds it (fp32
    parameters, compute in ``dtype``), with random weights in every layer:
    from the architecture's init, which zeroes conv1, proj and out_conv, no
    gradient would reach an attention site in the first step."""
    cfg = dict(IMAGENET64_ADM, model_kwargs=dict(IMAGENET64_ADM["model_kwargs"], dropout=dropout))
    net = EDMPrecond(dtype=dtype, param_dtype=torch.float32, **cfg)
    return load_into(net, random_state_dict(net, 0)).to(device)


def loss_and_grads(net: EDMPrecond, images, labels, draws) -> tuple[float, dict]:
    dev = next(net.parameters()).device
    net.train().zero_grad(set_to_none=True)
    loss = EDMLoss()(lambda x, s, lab, al: net(x, s, lab, al), images.to(dev), labels.to(dev),
                     **{k: v.to(dev) for k, v in draws.items()}).mean()
    loss.backward()
    missing = [n for n, p in net.named_parameters() if p.grad is None]
    if missing:
        raise AssertionError(f"{len(missing)} parameters got no gradient: {missing[:4]}")
    return loss.item(), {n: p.grad.detach().float().cpu() for n, p in net.named_parameters()}


def check_training_forward_backward() -> None:
    """One full-width EDM loss forward + backward, batch 2, dropout off, the
    draws from a seed: fp32 on the card against fp32 on the CPU, then bf16
    compute with fp32 parameters on the card."""
    g = torch.Generator().manual_seed(21)
    images = torch.rand((2, 64, 64, 3), generator=g) * 2 - 1
    labels = torch.eye(1000)[[3, 977]]
    draws = dict(u=torch.randn((2, 1, 1, 1), generator=g),
                 noise=torch.randn((2, 64, 64, 3), generator=g))
    t0 = time.perf_counter()
    loss_ref, grads_ref = loss_and_grads(training_net(torch.float32, "cpu"), images, labels, draws)
    cpu_s = time.perf_counter() - t0
    loss32, grads32 = loss_and_grads(training_net(torch.float32, "cuda"), images, labels, draws)
    loss16, grads16 = loss_and_grads(training_net(torch.bfloat16, "cuda"), images, labels, draws)
    worst = max((grads32[n] - r).abs().max().item() / r.abs().max().item()
                for n, r in grads_ref.items())
    # in float64: fp32 sums over 296M elements are off by percents
    flat = lambda grads: torch.cat([grads[n].reshape(-1) for n in grads_ref]).double()
    cosine = F.cosine_similarity(flat(grads16), flat(grads_ref), dim=0).item()
    rel32, rel16 = (abs(x - loss_ref) / abs(loss_ref) for x in (loss32, loss16))
    print(f"training forward + backward [2,64,64,3], {len(grads_ref)} parameters, vs fp32 on the "
          f"CPU ({cpu_s:.1f} s): loss {loss_ref:.6f}; fp32 card loss rel err {rel32:.3e} (limit "
          f"1e-4), worst gradient err / max {worst:.3e} (limit 1e-3); bf16 compute + fp32 "
          f"parameters loss rel err {rel16:.3e} (limit 5e-2), gradient cosine {cosine:.5f} "
          f"(limit 0.99)")
    if not (rel32 <= 1e-4 and worst <= 1e-3 and rel16 <= 5e-2 and cosine >= 0.99):
        raise AssertionError("the full-width training forward + backward disagrees with the CPU")
    torch.cuda.empty_cache()


def check_training_loop(tag: str, fwd_rows: list[dict], bwd_rows: list[dict]) -> dict:
    """TRAIN_STEPS steps through training_loop, the function the training CLI
    calls, at full width in bf16: every step its own tick, so that
    stats.jsonl times each (the tick's drain waits for the device)."""
    g = np.random.default_rng(0)
    labels = g.integers(0, 1000, 256)
    labels[0] = 999  # the largest label sets the one-hot width
    data = ImageDataset(g.integers(0, 256, (256, 64, 64, 3), dtype=np.uint8), labels)
    net = training_net(torch.bfloat16, "cuda", dropout=0.10)
    before = {n: p.detach().cpu().clone() for n, p in net.named_parameters()}
    micro = TRAIN_BATCH // TRAIN_ROUNDS
    train_cfg = TrainConfig(lr=1e-4, lr_rampup_kimg=2 * TRAIN_BATCH / 1000,
                            grad_accum_rounds=TRAIN_ROUNDS, total_batch=TRAIN_BATCH)
    with tempfile.TemporaryDirectory() as run_dir:
        loop_cfg = LoopConfig(run_dir=run_dir, total_kimg=1000, kimg_per_tick=TRAIN_BATCH / 1000,
                              snapshot_ticks=TRAIN_STEPS, state_dump_ticks=TRAIN_STEPS, seed=0,
                              batch_size=TRAIN_BATCH, batch_gpu=micro)
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = training_loop(
            net=net, net_config=dict(IMAGENET64_ADM, precond="edm"),
            data_iter=batch_iterator(data, TRAIN_BATCH, seed=0), loss_fn=EDMLoss(),
            train_cfg=train_cfg, loop_cfg=loop_cfg, device="cuda", max_ticks=TRAIN_STEPS)
        torch.cuda.synchronize()
        launches, routes = read_launches(), read_routes()
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(run_dir, "stats.jsonl")) as f:
            ticks = [json.loads(line) for line in f]
        kimg = state.nimg // 1000
        ema, config = checkpoints.load_snapshot(
            os.path.join(run_dir, f"network-snapshot-{kimg:06d}.pt"))
        fresh = training_net(torch.bfloat16, "cuda", dropout=0.10)
        back = checkpoints.load_state(
            os.path.join(run_dir, f"training-state-{kimg:06d}.pt"),
            like=TrainState.create(fresh, train_cfg))
    losses = [t["Loss/loss"]["mean"] for t in ticks]
    step_ms = [t["Timing/sec_per_kimg"]["mean"] * TRAIN_BATCH for t in ticks]
    timed = sorted(step_ms[1:])
    median = (timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    sites = sum(n for _, _, n in SITES)
    want = {"attention": sites * TRAIN_ROUNDS * TRAIN_STEPS,
            "attention_bwd": sites * qk.BWD_LAUNCHES_PER_CALL * TRAIN_ROUNDS * TRAIN_STEPS}
    per_micro = lambda rows: sum(r["ms"] * n for r, (_, _, n) in zip(rows, SITES))
    fwd_ms, bwd_ms = per_micro(fwd_rows) * TRAIN_ROUNDS, per_micro(bwd_rows) * TRAIN_ROUNDS
    print(f"training main path: training_loop, ImageNet-64 ADM bf16 compute / fp32 parameters, "
          f"batch {TRAIN_BATCH} as {TRAIN_ROUNDS} x {micro}, dropout 0.10, Adam: step ms "
          f"{[round(m, 1) for m in step_ms]} (first is the warm step), median of the timed "
          f"{median:.1f} ms = {TRAIN_BATCH / median * 1e3:.2f} img/s, peak memory {peak:.2f} GiB, "
          f"losses {[round(x, 4) for x in losses]}, attention kernels per step (timed alone at "
          f"batch {micro}, summed over the {sites} sites and {TRAIN_ROUNDS} rounds): forward "
          f"{fwd_ms:.1f} ms = {fwd_ms / median:.1%}, backward {bwd_ms:.1f} ms = "
          f"{bwd_ms / median:.1%} of a step, launches {launches} [{tag}]")
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{name} launched {n} times in training, expected "
                                 f"{want.get(name, 0)}")
    check_routes("training", routes, want)
    if not (len(losses) == TRAIN_STEPS and all(np.isfinite(losses))):
        raise AssertionError(f"training losses are not finite: {losses}")
    if state.nimg != TRAIN_BATCH * TRAIN_STEPS or back.nimg != state.nimg:
        raise AssertionError(f"nimg is {state.nimg} / {back.nimg} after {TRAIN_STEPS} steps")
    moved = [(p.detach().cpu() - before[n]).abs().max().item()
             for n, p in state.net.named_parameters()]
    ema_moved = [(p.detach().cpu() - before[n]).abs().max().item()
                 for n, p in state.ema.named_parameters()]
    if not (min(moved) > 0 and max(ema_moved) > 0
            and all(torch.isfinite(p).all() for p in state.net.parameters())):
        raise AssertionError("training left a parameter or the EMA where it was, or not finite")
    if config["ckpt_format_version"] != checkpoints.CKPT_FORMAT_VERSION or not all(
            torch.equal(ema[n], p.detach().cpu()) for n, p in state.ema.state_dict().items()):
        raise AssertionError("the snapshot read back differs from the EMA")
    same = all(torch.equal(a, b) for mod in ("net", "ema") for a, b in zip(
        getattr(back, mod).parameters(), getattr(state, mod).parameters()))
    same = same and all(
        torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
        and a["step"] == b["step"]
        for a, b in zip(back.opt.state.values(), state.opt.state.values()))
    if not same:
        raise AssertionError("the state dump read back differs from the training state")
    print(f"  snapshot and state dump written, read back and equal; parameters moved by "
          f"{min(moved):.2e} ... {max(moved):.2e}, EMA by up to {max(ema_moved):.2e}; "
          f"nimg {state.nimg}")
    del state, back, net, fresh
    torch.cuda.empty_cache()
    return {"launches": launches["attention_bwd"], "forward_launches": launches["attention"],
            "routes": routes["attention_bwd"], "step_ms": step_ms,
            "img_per_s": TRAIN_BATCH / median * 1e3, "peak_gib": peak}


def training_phases(tag: str, edm_line: dict) -> dict:
    """Phase 5: the training path of the EDM backend."""
    print("attention backward kernels vs plain:")
    micro = TRAIN_BATCH // TRAIN_ROUNDS
    main_rows = [check_attention_bwd(micro, t, heads, torch.bfloat16, tag) for t, heads, _ in SITES]
    rows = main_rows + [check_attention_bwd(micro, 256, 9, torch.float32, tag)]
    gen = torch.Generator(device="cuda").manual_seed(40)
    q, k, v, g = (torch.randn((2, 4096, 8, 40), device="cuda", generator=gen).bfloat16()
                  for _ in range(4))
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    out = qk.attention(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    ref = qk.attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(), g)
    err = max(rel_err(a, r)[1] for a, r in zip(got, ref))
    print(f"  attention_bwd [2,4096,8,40] bfloat16 through attention's backward(): "
          f"max_rel={err:.3e} (tol {TOL[torch.bfloat16]})")
    if err > TOL[torch.bfloat16]:
        raise AssertionError(f"attention's backward disagrees with its plain version: {err}")
    del q, k, v, g, leaves, out, got, ref
    print("gradients through the forward-only kernels' wrappers:")
    check_twin_gradients()
    check_training_forward_backward()

    if importlib.util.find_spec("PIL") is not None:
        from PIL import Image

        with tempfile.TemporaryDirectory() as tmp:
            data = os.path.join(tmp, "data")
            os.makedirs(data)
            for i in range(2):
                Image.fromarray(np.full((64, 64, 3), 40 * i, np.uint8)).save(
                    os.path.join(data, f"img{i}.png"))
            train_cli.main(["--outdir", os.path.join(tmp, "runs"), "--data", data, "--arch",
                            "adm", "--augment", "0", "--bf16", "1", "--dry-run"])
    else:
        print("training CLI dry run left out: it reads a PNG folder and PIL is not installed")

    fwd_rows = [r for r in edm_line["shapes"]
                if r["shape"][0] == micro and r["dtype"] == "bfloat16"]
    run = check_training_loop(tag, fwd_rows, main_rows)
    per_backward = lambda key: sum(r[key] * n for r, (_, _, n) in zip(main_rows, SITES))
    edm_line["training_launches"] = run["forward_launches"]
    return {
        "name": "attention_bwd", "route": "cuda",
        "source": "diffusion_tts_torch/csrc/attention_bwd.cu",
        "replaces": "diffusion_tts_tpu/ops/pallas/attention.py:303",
        "launches": run["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times: the 22 attention sites of one bf16 backward at the training
        # micro-batch (16), summed; each call is its two launches plus the
        # row term delta. "route" names the language (CUDA); "routes" counts
        # the training run's launches per design ("mma": the tensor cores),
        # and fma_ms times the first design on the same inputs
        "ms": per_backward("ms"), "plain_ms": per_backward("plain_ms"),
        "bound_ms": per_backward("bound_ms"),
        "bound_by": max(main_rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": per_backward("library_ms"), "fma_ms": per_backward("fma_ms"),
        "routes": run["routes"],
        "train_step_ms": run["step_ms"], "train_img_per_s": run["img_per_s"],
        "train_peak_gib": run["peak_gib"], "shapes": rows,
    }


def decode_routing(vae: sd_vae.AutoencoderKL, hw: int) -> dict:
    """Kernel calls of one VAE decode of hw x hw latents, from the decoder's
    modules in forward order and the routing predicates."""
    n = collections.Counter()
    dec = vae.decoder

    def resnet(block: sd_layers.ResnetBlock2D, hw: int) -> None:
        cin, cout = block.conv1.in_channels, block.conv1.out_channels
        for c in (cin, cout):  # conv1 is cin -> cout, conv2 cout -> cout
            fused = cv.conv3_shape_eligible(hw, hw, c, cout)
            n["conv3x3_same"] += fused
            n["group_norm_stats" if fused else "group_norm_silu"] += 1

    def up2(conv: sd_layers.Conv3x3, hw: int) -> bool:
        return cv.up2_eligible(torch.empty((1, conv.in_channels, hw, hw), device="meta"),
                               conv.weight)

    for conv in (dec.conv_in, dec.conv_out):  # neither has 128-multiple channels on both sides
        if cv.conv3_shape_eligible(8 * hw, 8 * hw, conv.in_channels, conv.out_channels):
            raise AssertionError("conv_in / conv_out are not expected on the kernel route")
    for block in dec.mid_block.resnets:
        resnet(block, hw)
    n["group_norm_silu"] += sum(isinstance(m, sd_layers.GroupNorm)
                                for m in dec.mid_block.attentions.modules())
    for block in dec.up_blocks:
        for res in block.resnets:
            resnet(res, hw)
        if hasattr(block, "upsamplers"):
            n["conv3x3_up2"] += up2(block.upsamplers[0].conv, hw)
            hw *= 2
    n["group_norm_silu"] += 1  # conv_norm_out
    return dict(n)


def sd_forward_checks(ref, pipe32, pipe16) -> None:
    """One UNet forward (CFG-shaped batch 2, 77-token context) and one VAE
    decode (batch 1) on the card in fp32 and bf16 against fp32 on the CPU,
    which runs the same route through the plain versions."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 4, 64, 64), generator=g)
    t = torch.tensor([981, 501])
    ctx = torch.randn((2, CLIP_TOKENS, 768), generator=g)
    z = torch.randn((1, 4, 64, 64), generator=g) / ref.vae.scaling_factor
    with torch.no_grad():
        want = {"unet": ref.unet(x, t, ctx), "decode": ref.vae.decode(z)}
        for name, pipe, limit in (("fp32", pipe32, 1e-3), ("bf16", pipe16, 5e-2)):
            got = {"unet": pipe.unet(x.cuda(), t.cuda(), ctx.cuda()).cpu(),
                   "decode": pipe.vae.decode(z.cuda()).cpu()}
            for part in ("unet", "decode"):
                err = rel_err(got[part], want[part])[1]
                print(f"SD {part} {list(got[part].shape)} {name} card vs fp32 CPU "
                      f"(max abs err / max abs): {err:.3e} (limit {limit})")
                if not (err <= limit and torch.isfinite(got[part]).all()):
                    raise AssertionError(f"SD {part} in {name} disagrees with the CPU: {err}")



def sd_phases(tag: str) -> list[dict]:
    """Phases 5 and 6: the SD main path, then the SD kernels at its shapes."""
    t0 = time.perf_counter()
    ref = StableDiffusionSearchPipeline.random(SD15_UNET, SD15_VAE, seed=0, dtype=torch.float32,
                                               device="cpu")
    pipe16 = sd_pipeline_like(ref, torch.bfloat16)
    load_s = time.perf_counter() - t0
    pipe32 = sd_pipeline_like(ref, torch.float32)
    sd_forward_checks(ref, pipe32, pipe16)
    del ref, pipe32
    torch.cuda.empty_cache()

    # calls per UNet forward and per VAE decode, from the architecture and the
    # routing predicates (the UNet never exceeds 64x64: none of its convs is
    # routed, every GroupNorm module of it is one standalone call)
    count = lambda mod, cls: sum(isinstance(m, cls) for m in mod.modules())
    zero = {"attention_bwd": 0, "group_norm_stats": 0, "conv3x3_same": 0, "conv3x3_up2": 0}
    per_unet = {"attention": count(pipe16.unet, sd_layers.BasicTransformerBlock),
                "group_norm_silu": count(pipe16.unet, sd_layers.GroupNorm),
                "geglu_ff": count(pipe16.unet, sd_layers.FeedForward), **zero}
    per_decode = {"attention": count(pipe16.vae, sd_vae.VAEAttention), "attention_bwd": 0,
                  "geglu_ff": 0, **decode_routing(pipe16.vae, SD15_UNET["sample_size"])}
    if per_unet != {"attention": 16, "group_norm_silu": 61, "geglu_ff": 16, **zero} or \
            per_decode != {"attention": 1, "attention_bwd": 0, "geglu_ff": 0, "group_norm_silu": 12,
                           "group_norm_stats": 18, "conv3x3_same": 18, "conv3x3_up2": 3}:
        raise AssertionError(f"unexpected SD-1.5 architecture or routing: {per_unet} {per_decode}")
    if count(pipe16.vae, sd_layers.GroupNorm) != 30:
        raise AssertionError("the VAE decoder should hold 30 GroupNorm modules")
    per_call = {"attention": 1, "attention_bwd": qk.BWD_LAUNCHES_PER_CALL,
                "group_norm_silu": gn.LAUNCHES_PER_CALL,
                "geglu_ff": gg.LAUNCHES_PER_CALL, "group_norm_stats": gn.LAUNCHES_PER_CALL,
                "conv3x3_same": 1, "conv3x3_up2": 1}
    forwards, decodes = SD_STEPS * (1 + SD_K), SD_STEPS * SD_K + 1

    params = SearchParams(N=SD_N, K=SD_K)
    g = torch.Generator(device="cuda").manual_seed(11)
    emb = torch.randn((SD_PROMPTS, CLIP_TOKENS, 768), device="cuda", generator=g)
    search = lambda: pipe16(prompt_embeds=emb, num_inference_steps=SD_STEPS,
                            score_function=BrightnessScorer(), method="eps_greedy",
                            params=params, seed=0)
    shapes = KernelShapes(pipe16)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images, scores = search()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, routes = read_launches(), read_routes()
    shapes.remove()
    t0 = time.perf_counter()
    search()  # the same request again: steady state, not counted
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    nfe = nfe_per_sample("eps_greedy", SD_STEPS, params, backend="sd") * SD_PROMPTS
    print(f"SD main path: eps_greedy {SD_STEPS} steps B={SD_PROMPTS} N={SD_N} K={SD_K} bf16 "
          f"512x512: load {load_s:.2f} s, search {first_s:.3f} s first / {again_s:.3f} s again, "
          f"{nfe} NFE, {nfe / first_s:.2f} / {nfe / again_s:.2f} NFE/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"scores {scores.tolist()}, launches {launches} [{tag}]")
    for name, n in launches.items():
        want = (per_unet[name] * forwards + per_decode[name] * decodes) * per_call[name]
        if n != want:
            raise AssertionError(f"{name} launched {n} times on the SD main path, "
                                 f"expected {want}")
    check_routes("SD", routes, {"attention": launches["attention"],
                                "geglu_ff": launches["geglu_ff"]})
    if not (torch.isfinite(scores).all() and torch.isfinite(images).all()
            and images.shape == (SD_PROMPTS, 512, 512, 3)
            and 0 <= images.min() <= images.max() <= 1):
        raise AssertionError("SD main path output is not finite images in [0, 1]")
    del pipe16, images
    torch.cuda.empty_cache()

    print("SD kernels vs plain, at every shape of the search:")
    checks = {"attention": check_sd_attention, "group_norm_silu": check_group_norm,
              "geglu_ff": check_geglu, "group_norm_stats": check_group_norm_stats,
              "conv3x3_same": check_conv_same, "conv3x3_up2": check_conv_up2}
    fp32_shape = {"attention": (2, 1024, 8, 80),
                  "group_norm_silu": ((2, 640, 32, 32), 32, 1e-5, True),
                  "geglu_ff": (2048, 1280, 5120),
                  "group_norm_stats": ((2, 256, 128, 128), 32, 1e-6),
                  "conv3x3_same": ((2, 128, 128, 128), 128, True, True, "shortcut", 256),
                  "conv3x3_up2": ((2, 128, 64, 64), 128, True)}
    pallas = "diffusion_tts_tpu/ops/pallas/"
    sources = {"attention": ("qkv_attention.cu", pallas + "attention.py:424"),
               "group_norm_silu": ("groupnorm.cu", pallas + "groupnorm.py:144"),
               "geglu_ff": ("geglu_ff.cu", pallas + "geglu_ff.py:251"),
               "group_norm_stats": ("groupnorm.cu", pallas + "groupnorm.py:346"),
               "conv3x3_same": ("conv3x3.cu", pallas + "conv3x3.py:497"),
               "conv3x3_up2": ("conv3x3.cu", pallas + "conv3x3.py:811")}
    lines = []
    for name, check in checks.items():
        rows = []
        for key, calls in sorted(shapes.counts[name].items(), key=str):
            row = check(key, torch.bfloat16, tag)
            row["calls_per_search"] = calls
            rows.append(row)
        if sum(r["calls_per_search"] for r in rows) * per_call[name] != launches[name]:
            raise AssertionError(f"{name}: the recorded calls do not add up to its launches")
        rows.append(check(fp32_shape[name], torch.float32, tag))
        total = lambda k: sum(r[k] * r.get("calls_per_search", 0) for r in rows)
        lines.append({
            "name": name, "route": "cuda", "source": f"diffusion_tts_torch/csrc/{sources[name][0]}",
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # times: summed over every call of one SD search (bf16, by shape)
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": max(rows, key=lambda r: r["bound_ms"] * r.get("calls_per_search", 0))[
                "bound_by"],
            "library_ms": total("library_ms"), "shapes": rows,
        })
        if "fma_ms" in rows[0]:
            lines[-1]["fma_ms"] = total("fma_ms")
    return lines


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-json", default=None,
                        help="also write every kernel's per-shape rows to this file")
    args = parser.parse_args()
    # -- 1. environment
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card")
    tag = gpu_tag()
    print(tag)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built) or 'nothing (cached)'}")
    for name, (secs, log) in built.items():
        print(f"  {name}: nvcc {secs:.2f} s\n" + "\n".join("    " + ln for ln in log.splitlines()))

    # -- 3, 4. EDM; 5. training; 6, 7. SD
    edm_line = edm_phases(tag)
    kernels = [edm_line, training_phases(tag, edm_line)] + sd_phases(tag)

    # -- 8. the kernel line, then the result line
    if args.kernels_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.kernels_json)), exist_ok=True)
        with open(args.kernels_json, "w") as f:
            json.dump({"gpu": tag, "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in kern.items() if k != "shapes"}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
