"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

  1. environment: the card's name and power limit, torch and CUDA versions;
     fails without a card;
  2. build: every CUDA kernel of the main path, from csrc/, with nvcc;
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the main path gives it (and the flagship's [16, T, 3C] shapes), bf16
     within 2e-2 and fp32 within 1e-4 with TF32 off; kernel, plain and
     library (scaled_dot_product_attention, timed only here) times beside
     the least time the card could take;
  4. main path: the full-width ImageNet-64 EDMPrecond/DhariwalUNet in bf16
     with random weights from a numpy seed, one forward held against the
     same weights in fp32 on the CPU, then eps-greedy search (18 steps,
     2 samples, N=4, K=2) through the entry point, with every kernel's
     launches counted;
  5. one JSON line of kernel numbers, then the result line.

The script imports nothing of JAX; it needs the repository beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from diffusion_tts_torch.backends.edm_entry import generate_image_grid, load_network
from diffusion_tts_torch.ops.kernels import build
from diffusion_tts_torch.ops.kernels import qkv_attention as qk
from diffusion_tts_torch.scorers import BrightnessScorer
from diffusion_tts_torch.search.nfe import nfe_per_sample
from diffusion_tts_torch.utils.config import SearchParams

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
# The flagship's attention sites: (T, heads, sites per forward).
SITES = ((1024, 6, 7), (256, 9, 7), (64, 12, 8))
STEPS, SAMPLES, N, K = 18, 2, 4, 2
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


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


def attention_bound_ms(b: int, t: int, heads: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one call: 4*B*H*T^2*d operations at the dtype's peak,
    or reading [B, T, 3C] and writing [B, T, C] at the memory rate."""
    d = 64
    ops = 4 * b * heads * t * t * d / PEAK_FLOPS[dtype]
    moved = b * t * 4 * heads * d * torch.finfo(dtype).bits // 8 / PEAK_BYTES
    return max(ops, moved) * 1e3, "operations" if ops >= moved else "bytes"


def check_attention(b: int, t: int, heads: int, dtype: torch.dtype, tag: str) -> dict:
    import torch.nn.functional as F

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
    print(f"  qkv_attention {row['shape']} {row['dtype']:>8} heads={heads:2d}: "
          f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} (tol {tol}) "
          f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
          f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
          f"({row['bound_by']}) [{tag}]")
    if not ok:
        raise AssertionError(f"qkv_attention disagrees with its plain version: {row}")
    return row


def main() -> None:
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

    # -- 3. kernels against their plain versions
    print("kernels vs plain:")
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
    print(f"  attention [8,1024,6,64] bfloat16 ([B,T,H,D] strides): max_abs={err:.3e}")
    if err > TOL[torch.bfloat16]:
        raise AssertionError(f"attention ([B,T,H,D]) disagrees with its plain version: {err}")

    # -- 4. main path
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
    print(f"forward [2,64,64,3] vs fp32 on the CPU (max abs err / max abs): "
          f"fp32 card {e32:.3e}, bf16 card {e16:.3e}")
    if not (e32 < 1e-3 and e16 < 5e-2 and torch.isfinite(y16).all()):
        raise AssertionError(f"full-width forward disagrees with the CPU: fp32 {e32}, bf16 {e16}")

    params = SearchParams(N=N, K=K)
    search = lambda: generate_image_grid(
        arch="imagenet64", scorer=BrightnessScorer(), method="eps_greedy", params=params,
        seed=0, gridw=SAMPLES, num_steps=STEPS, dtype=torch.bfloat16, device="cuda", net=net)
    qk.LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = search()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"qkv_attention": qk.LAUNCHES}
    t0 = time.perf_counter()
    search()  # the same request again: steady state, not counted
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    expected = sum(n for _, _, n in SITES) * 2 * STEPS * K
    nfe = nfe_per_sample("eps_greedy", STEPS, params) * SAMPLES
    print(f"main path: eps_greedy 18 steps B={SAMPLES} N={N} K={K} bf16: load {load_s:.2f} s, "
          f"search {first_s:.3f} s first / {again_s:.3f} s again, {nfe} NFE, "
          f"{nfe / first_s:.2f} / {nfe / again_s:.2f} NFE/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"scores {result.score.tolist()}, launches {launches} [{tag}]")
    if launches["qkv_attention"] != expected:
        raise AssertionError(f"qkv_attention launched {launches['qkv_attention']} times on the "
                             f"main path, expected {expected}")
    if not (torch.isfinite(result.score).all() and torch.isfinite(result.x).all()
            and result.images.shape == (SAMPLES, 64, 64, 3)
            and 0 <= result.images.min() <= result.images.max() <= 1):
        raise AssertionError("main path output is not finite images in [0, 1]")

    # -- 5. the kernel line, then the result line
    per_forward = lambda key: sum(r[key] * n for r, (_, _, n) in zip(main_rows, SITES))
    kernel = {
        "name": "qkv_attention", "route": "cuda",
        "source": "diffusion_tts_torch/csrc/qkv_attention.cu",
        "replaces": "diffusion_tts_tpu/ops/pallas/attention.py:713",
        "launches": launches["qkv_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times: the 22 attention sites of one bf16 forward at the main
        # path's batch (N * samples), summed
        "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": max(main_rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": per_forward("library_ms"),
        "shapes": rows,
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
