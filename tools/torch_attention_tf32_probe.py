"""What bounds the attention forward's fp32 route, tf32x3, on the card (PyTorch port).

    python3 tools/torch_attention_tf32_probe.py [--shapes 8x1024x6x64,8x256x9x64,8x64x12x64]
        [--flavours kernel,ctas1,products,no_splits,one_pass] [--reps 50] [--json PATH]
    python3 tools/torch_attention_tf32_probe.py --shapes 8x256x1x256,8x64x1x256,32x256x1x256 \\
        --flavours kernel,split1,split2,split4,products,no_splits,one_pass

Builds ``diffusion_tts_torch/csrc/qkv_attention.cu`` with nvcc into
``build/probe_tf32/`` once per flavour, each a copy of the source with one
edit, and times the C entry's tf32x3 route (route code 3, fp32) on raw
launches with CUDA events at each ``[B, T, H, D]`` shape (the layout of
``attention``), and by CUDA-graph replay (20 launches captured once: the
device time, without the host's launch rate), beside the fma route (the
first design) and ``scaled_dot_product_attention`` (TF32 off) on the same
inputs. Flavours:
  kernel       the source as it is (checked bit for bit against the wrapper),
               at the plan the wrapper picks (``qk.tf32x3_plan``);
  split1, split2, split4  the source as it is with d = 256's key split
               forced;
  ctas1        (d = 64) one block an SM instead of two;
  products     the softmax skipped: P is S, O is never rescaled; the loads,
               the splits and the products stay;
  no_splits    K's and V^T's hi and lo never written: the tiles the products
               read hold what the last call left;
  one_pass     each product one tf32 product (hi.hi) instead of three.
The stripped flavours (products, no_splits, one_pass) give wrong outputs by
design; the others are held against ``attention_plain`` within 1e-4 of the
largest output. Prints the card's name and power limit, ptxas's registers
and spills of each flavour's tf32x3 kernels, one line per (flavour, shape),
and one JSON object last. Needs an NVIDIA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffusion_tts_torch.ops.kernels import _launch, build  # noqa: E402
from diffusion_tts_torch.ops.kernels import qkv_attention as qk  # noqa: E402

OUT_DIR = build.BUILD_DIR.parent / "probe_tf32"
SOURCE = build.CSRC / "qkv_attention.cu"
CTAS_LINE = "static constexpr int kCtas = D > 128 ? 1 : 2;    // blocks an SM"
SOFTMAX_LINE = "auto softmax = [&](float (&sc)[BK / 2], int j, float (&alpha)[2]) {"
K_SPLIT = "split_tile(k_raw, k_hi, k_lo, C::kTileBytes / 16);"
V_SPLIT = "        split_v();\n"
LO_PRODUCTS = ("wgmma_rs_tf32<D>(acc, pl[s], vh + off);",
               "wgmma_rs_tf32<D>(acc, ph[s], vl + off);",
               "wgmma_ss_tf32<BK>(sc, qh + qo, kl + ko, 1);")
SS_LO = "wgmma_ss_tf32<BK>(sc, ql + qo, kh + ko, kk > 0);"
SS_HI = "wgmma_ss_tf32<BK>(sc, qh + qo, kh + ko, 1);"
SPLITS = {"split1": 1, "split2": 2, "split4": 4}
D64_ONLY = ("ctas1",)
STRIPPED = ("products", "no_splits", "one_pass")


def edit(src: str, flavour: str) -> str:
    """The source with the flavour's edit; raises if the edited line moved."""
    def sub(text: str, old: str, new: str) -> str:
        if text.count(old) != 1:
            raise RuntimeError(f"{flavour}: expected one {old!r} in {SOURCE.name}")
        return text.replace(old, new)

    if flavour == "kernel" or flavour in SPLITS:
        return src
    if flavour == "ctas1":
        return sub(src, CTAS_LINE, "static constexpr int kCtas = 1;")
    if flavour == "products":
        return sub(src, SOFTMAX_LINE,
                   SOFTMAX_LINE + "\n      alpha[0] = alpha[1] = 1.f;\n      return;")
    if flavour == "no_splits":
        return sub(sub(src, K_SPLIT, ""), V_SPLIT, "")
    if flavour == "one_pass":
        for line in LO_PRODUCTS:
            src = sub(src, line, "")
        return sub(sub(src, SS_LO, ""), SS_HI, "wgmma_ss_tf32<BK>(sc, qh + qo, kh + ko, kk > 0);")
    raise ValueError(f"unknown flavour {flavour}")


def build_flavours(flavours, source=SOURCE) -> dict:
    """{flavour: (ctypes function, ptxas lines of its tf32x3 kernels)}, all
    built at once from ``source``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = Path(source).read_text()
    procs = {}
    for fl in flavours:
        cu = OUT_DIR / f"qkv_attention_{Path(source).stem}_{fl}.cu"
        cu.write_text(edit(text, fl))
        lib = OUT_DIR / f"lib_{Path(source).stem}_{fl}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(cu)]
        procs[fl] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    out = {}
    for fl, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {fl}:\n{log}")
        fn = ctypes.CDLL(str(lib)).dtts_attention
        fn.restype, fn.argtypes = ctypes.c_int, list(qk._ARGTYPES)
        lines, cur = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                cur = re.search(r"attention_tf32_kernelILi(\d+)ELi(\d)", line)
            elif cur and ("Used" in line or "spill" in line):
                lines.append(f"D={cur.group(1)} split={cur.group(2)}: {line.strip()}")
        out[fl] = (fn, lines)
    return out


def launch(fn, q, k, v, o, split: int) -> None:
    """One raw launch of the tf32x3 route with ``split`` CTAs a work tile."""
    b, t, h, d = q.shape
    s = (t * h * d, h * d, d)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 0, d, b, h, t, *s, *s,
             qk._LOG2E / d ** 0.5, None, qk.ROUTE_CODES["tf32x3"], split, 1, _launch.stream(o))
    if err:
        raise RuntimeError(f"launch failed: {err}")


def time_ms(fn, reps: int) -> float:
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


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device ms of one call of ``fn``: ``calls`` calls captured once in a
    CUDA graph, timed by replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="8x1024x6x64,8x256x9x64,8x64x12x64")
    ap.add_argument("--flavours", default="kernel,ctas1,products,no_splits,one_pass")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--source", default=str(SOURCE),
                    help="the CUDA source to edit (another design, or the parent's)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    limits = qk.card_limits(torch.device("cuda"))
    print(f"SMs and clusters of the d = 256 kernel the card holds at once, by key split: "
          f"{limits}", flush=True)
    flavours = args.flavours.split(",")
    built = build_flavours(flavours, args.source)
    for fl in flavours:
        print(f"ptxas, {fl}: " + "; ".join(built[fl][1]))
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in args.shapes.split(","):
        b, t, h, d = (int(x) for x in shape.split("x"))
        q, k, v = (torch.randn((b, t, h, d), device="cuda", generator=gen) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ref = qk.attention_plain(q, k, v)
        want = qk.attention(q, k, v)
        flops = 4 * b * h * t * t * d
        fma = lambda: qk.attention(q, k, v, route="fma")
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        fma_ms, sdpa_ms = time_ms(fma, args.reps), time_ms(sdpa, args.reps)
        fma_dev, sdpa_dev = graph_ms(fma), graph_ms(sdpa)
        for fl in flavours:
            if (fl in SPLITS and d != 256) or (fl in D64_ONLY and d != 64):
                continue
            fn = built[fl][0]
            split = qk.tf32x3_plan(d, b, h, t, *limits, split=SPLITS.get(fl))[0]
            o = torch.empty_like(q)
            launch(fn, q, k, v, o, split)
            torch.cuda.synchronize()
            err = (o - ref).abs().max().item() / ref.abs().max().item()
            if fl == "kernel" and args.source == str(SOURCE) and not torch.equal(o, want):
                raise AssertionError("the probe's kernel build differs from the wrapper's")
            if fl not in STRIPPED and err > 1e-4:
                raise AssertionError(f"{fl} {shape} disagrees with the plain version: {err}")
            ms = time_ms(lambda: launch(fn, q, k, v, o, split), args.reps)
            dev = graph_ms(lambda: launch(fn, q, k, v, o, split))
            row = dict(flavour=fl, shape=[b, t, h, d], split=split, ms=ms, device_ms=dev,
                       tflops=flops / ms / 1e9, device_tflops=flops / dev / 1e9, fma_ms=fma_ms,
                       sdpa_ms=sdpa_ms, fma_device_ms=fma_dev, sdpa_device_ms=sdpa_dev,
                       rel_err=err)
            rows.append(row)
            print(f"  {fl:10s} [{b},{t},{h},{d}] split {split}: {ms:.4f} ms, device "
                  f"{dev:.4f} ms {row['device_tflops']:.1f} TFLOP/s (fma {fma_ms:.4f} / device "
                  f"{fma_dev:.4f}, sdpa {sdpa_ms:.4f} / device {sdpa_dev:.4f}) rel_err {err:.2e}",
                  flush=True)
    result = dict(gpu=gpu, rows=rows, ptxas={fl: built[fl][1] for fl in flavours})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(dict(gpu=gpu, rows=rows)))


if __name__ == "__main__":
    main()
