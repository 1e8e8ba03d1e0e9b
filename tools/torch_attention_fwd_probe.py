"""What bounds the attention forward's wgmma route on the card (PyTorch port).

    python3 tools/torch_attention_fwd_probe.py [--shapes 8x4096x8x40,8x1024x8x80,8x1024x6x64]
        [--flavours kernel,no_exp,no_pv,no_pingpong,nc1,bk64,stages2] [--reps 50]
        [--json PATH]
    python3 tools/torch_attention_fwd_probe.py --shapes 8x256x1x256,8x64x1x256,128x256x1x256 \
        --flavours kernel,split1,split2,split4,products,no_exp
    python3 tools/torch_attention_fwd_probe.py --shapes 4x4096x1x512,1x4096x1x512 \
        --flavours kernel,products,no_exp,whole_s,no_xchg,no_loads,no_s,no_pv

Builds ``diffusion_tts_torch/csrc/qkv_attention.cu`` with nvcc into
``build/probe_fwd/`` once per flavour, each a copy of the source with one
edit, and times the C entry's wgmma route (route code 2) on raw launches
with CUDA events at each ``[B, T, H, D]`` shape (the [B, T, H, D] layout of
``attention``), and by CUDA-graph replay (20 launches captured once: the
device time, without the host's launch rate). Flavours:
  kernel       the source as it is (checked bit for bit against the wrapper),
               at the plan the wrapper picks (``qk.wgmma_plan``: key split,
               consumer warpgroups);
  split1, split2, split4  the source as it is with the key split forced
               (d = 256 only; split1 is the kernel without the cluster merge);
  products     the softmax skipped: P is S rounded, O is never rescaled; the
               loads, both products and (split) the merge stay;
  no_dsmem     (split) the merge reads no other CTA's partial: its cluster
               barriers and its weights stay;
  no_exp       the softmax's exp2 replaced by its argument: no MUFU work;
  no_pv        no P.V product (the softmax and its row sums stay);
  no_pingpong  the consumer warpgroups issue their products without taking
               turns;
  whole_s      (d = 512) each of the two column warpgroups computes the whole
               S over the full depth, 1.5x the products, instead of its half
               of the depth and the exchange (the mma.sync design's choice);
  no_xchg      (d = 512) the halves of S are not exchanged: each warpgroup's
               softmax runs on its own half, no named barrier;
  nc1          the source as it is with one consumer warpgroup (64-row q
               tiles) at every shape but d = 512 (two on every plan);
  onetile      one block per work tile instead of one persistent block per
               SM;
  bk64, bk192  K/V tiles of 64 or 192 keys instead of the route's (past
               T = 64; at T <= 64 the route takes 64);
  stages2, stages3, stages4  a K/V ring of 2, 3 or 4 stages at every width
               (the route's: 2 at d = 40 and 80, 3 at 64 and 160);
  no_loads     K/V tiles loaded only into the ring's first round, then
               reused: no TMA traffic past the first tiles;
  no_s         no Q.K^T product (S set to constants);
  bw32, bw64   TMA boxes 32 or 64 columns wide (64- or 128-byte rows) at
               every width, the columns past d zero-filled and multiplied
               in P.V.
The stripped flavours (no_exp, no_pv, no_loads, no_s, products, no_dsmem, no_xchg) give
wrong outputs by design; the
others are held against ``attention_plain`` within 2e-2 of the largest
output. Each row also has the time of the mma route and of
``scaled_dot_product_attention`` on the same inputs, from the same run.
Prints the card's name and power limit, ptxas's registers and spills of each
flavour's wgmma kernels, one line per (flavour, shape), and one JSON object
last. Needs an NVIDIA card; imports nothing of JAX.
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

OUT_DIR = build.BUILD_DIR.parent / "probe_fwd"
SOURCE = build.CSRC / "qkv_attention.cu"
BK_LINE = "template <int D, int BK = (D > 256 ? 32 : D > 128 ? 64 : 128)>"
STAGES_LINE = "static constexpr int kStages = D == 40 || D == 80 ? 2 : 3;"
EXP_LINE = "sc[i] = ex2(fmaf(sc[i], scale_log2e, neg[(i >> 1) & 1]));"
PV_LINE = "wgmma_rs<C::kDW>(acc, p[kk], dv + (kk * 16 * RB >> 4));"
TURN = "if constexpr (kPingPong) asm volatile(\"bar."
BW_LINE = "static constexpr int kBW = D == 64 || D >= 256 ? 64 : D == 160 ? 32 : 16;"
HALVES_LINE = "constexpr bool kDepthHalves = kColumns;"
XCHG_LINE = "        if constexpr (kDepthHalves) {\n          constexpr int kV = BK / 8;"
SOFTMAX_LINE = "auto softmax = [&](int j, float (&alpha)[2]) {"
SPLITS = {"split1": 1, "split2": 2, "split4": 4}
DSMEM_LINE = ("x[k][i] = dtts::ld_dsmem_f32x4(dtts::dsmem_addr(xo + 4u * (row * C::kXPitch + col),"
              " i));")
K_LOAD = "for (int bx = 0; bx < C::kBoxes; ++bx)\n            tma_load_4d(k_s"
V_LOAD = "for (int bx = 0; bx < C::kBoxes; ++bx)\n            tma_load_4d(v_s"
GRID_LINE = "const int blocks = work < sm_count() ? work : sm_count();"
S_LINE = ("wgmma_ss<BK>(sc, da + ((bx * 64 * RB + off) >> 4), db + ((bx * BK * RB + off) >> 4),\n"
          "                       kk > 0);")
# wgmma_ss / wgmma_rs specializations the source does not instantiate go in
# namespace dtts (csrc/hopper.cuh) right after the includes.
RS_ANCHOR = '#include "mma_bf16.cuh"\n'
STRIPPED = ("no_exp", "no_pv", "no_loads", "no_s", "products", "no_dsmem", "no_xchg")


def wgmma_ss(n: int) -> str:
    """The S product's m64n{n}k16 specialization, for a tile width the
    source does not instantiate."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"template <>\n__device__ __forceinline__ void wgmma_ss<{n}>(float (&d)[{r}], "
            f"uint64_t da, uint64_t db, int scale_d) {{\n  asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{{regs}}}, '
            f'%{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
            f'      : {outs}\n      : "l"(da), "l"(db), "r"(scale_d));\n}}\n\n')


def wgmma_rs(n: int) -> str:
    """The P.V product's m64n{n}k16 specialization (A from registers, B
    MN-major), for a width the source does not instantiate."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"template <>\n__device__ __forceinline__ void wgmma_rs<{n}>(float (&d)[{r}], "
            f"const uint32_t (&a)[4], uint64_t db) {{\n  asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{{regs}}}, '
            f'{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"\n'
            f'      : {outs}\n      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), '
            f'"r"(1));\n}}\n\n')


def specializations(text: str) -> str:
    """RS_ANCHOR followed by ``text`` in namespace dtts, where the primary
    templates live."""
    return f"{RS_ANCHOR}namespace dtts {{\n{text}}}  // namespace dtts\n"


def edit(src: str, flavour: str) -> str:
    """The source with the flavour's edit; raises if the edited line moved."""
    def sub(old: str, new: str, count: int = 1) -> str:
        if src.count(old) != count:
            raise RuntimeError(f"{flavour}: expected {count} of {old!r} in {SOURCE.name}")
        return src.replace(old, new)

    if flavour in ("kernel", "nc1") or flavour in SPLITS:
        return src
    if flavour == "no_dsmem":
        return sub(DSMEM_LINE, "x[k][i] = make_float4(1.f, 1.f, 1.f, 1.f);")
    if flavour == "products":
        return sub(SOFTMAX_LINE,
                   SOFTMAX_LINE + "\n      alpha[0] = alpha[1] = 1.f;\n      return;")
    if flavour == "no_exp":
        return sub(EXP_LINE, "sc[i] = fmaf(sc[i], scale_log2e, neg[(i >> 1) & 1]);")
    if flavour == "no_pv":
        return sub(PV_LINE, "(void)dv;")
    if flavour == "no_pingpong":
        return sub(TURN, "if constexpr (false) asm volatile(\"bar.", count=2)
    if flavour == "whole_s":
        return sub(HALVES_LINE, "constexpr bool kDepthHalves = false;")
    if flavour == "no_xchg":
        return sub(XCHG_LINE, XCHG_LINE.replace("(kDepthHalves)", "(false)"))
    if flavour.startswith("bk"):
        n = int(flavour[2:])
        src = sub(BK_LINE, f"template <int D, int BK = (D > 256 ? 32 : D > 128 ? 64 : {n})>")
        if n not in (64, 128):
            src = sub(RS_ANCHOR, specializations(wgmma_ss(n)))
        return src
    if flavour == "no_loads":
        src = sub("mbar_expect_tx(k_full(s), C::kTileBytes);",
                  "mbar_expect_tx(k_full(s), j < S ? C::kTileBytes : 0);")
        src = sub("mbar_expect_tx(v_full(s), C::kTileBytes);",
                  "mbar_expect_tx(v_full(s), j < S ? C::kTileBytes : 0);")
        src = sub(K_LOAD, K_LOAD.replace("bx < C::kBoxes", "bx < (j < S ? C::kBoxes : 0)"))
        return sub(V_LOAD, V_LOAD.replace("bx < C::kBoxes", "bx < (j < S ? C::kBoxes : 0)"))
    if flavour == "no_s":
        return sub(S_LINE, "if (kk == 0) {\n#pragma unroll\n for (int i = 0; i < BK / 2; ++i) "
                           "sc[i] = (float)(i & 7);\n}")
    if flavour in ("bw32", "bw64"):
        src = sub(BW_LINE, "static constexpr int kBW = D == 64 || D >= 256 ? 64 : "
                           f"{flavour[2:]};")
        extra = {"bw32": (96,), "bw64": (128, 192)}[flavour]
        return sub(RS_ANCHOR, specializations("".join(wgmma_rs(n) for n in extra)))
    if flavour == "onetile":
        return sub(GRID_LINE, "const int blocks = work;")
    if flavour.startswith("stages"):
        return sub(STAGES_LINE, f"static constexpr int kStages = {int(flavour[6:])};")
    raise ValueError(f"unknown flavour {flavour}")


def build_flavours(flavours, source=SOURCE) -> dict:
    """{flavour: (ctypes function, ptxas lines of its wgmma kernels)}, all
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
                cur = re.search(r"attention_wgmma_kernelILi(\d+)ELi(\d)ELi(\d+)ELi(\d)", line)
            elif cur and ("Used" in line or "spill" in line):
                lines.append(f"D={cur.group(1)} NC={cur.group(2)} BK={cur.group(3)} "
                             f"split={cur.group(4)}: {line.strip()}")
        out[fl] = (fn, lines)
    return out


def launch(fn, q, k, v, o, plan: tuple[int, int]) -> None:
    """One raw launch of the wgmma route at ``plan`` (key split, consumer
    warpgroups)."""
    b, t, h, d = q.shape
    s = (t * h * d, h * d, d)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, d, b, h, t, *s, *s,
             qk._LOG2E / d ** 0.5, None, 2, *plan, _launch.stream(o))
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
    ap.add_argument("--shapes", default="8x4096x8x40,8x1024x8x80,8x1024x6x64")
    ap.add_argument("--flavours", default="kernel,no_exp,no_pv,no_pingpong,nc1,bk64,stages2")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--source", default=str(SOURCE),
                    help="the CUDA source to edit (another design, or the parent's)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs an NVIDIA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    print(f"SMs and clusters of the d = 256 kernel the card holds at once, by key split: "
          f"{qk.card_limits(torch.device('cuda'))}", flush=True)
    flavours = args.flavours.split(",")
    built = build_flavours(flavours, args.source)
    for fl in flavours:
        print(f"ptxas, {fl}: " + "; ".join(built[fl][1]))
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in args.shapes.split(","):
        b, t, h, d = (int(x) for x in shape.split("x"))
        q, k, v = (torch.randn((b, t, h, d), device="cuda", generator=gen).bfloat16()
                   for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ref = qk.attention_plain(q, k, v).float()
        want = qk.attention(q, k, v)
        flops = 4 * b * h * t * t * d
        mma = lambda: qk.attention(q, k, v, route="mma")
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        mma_ms, sdpa_ms = time_ms(mma, args.reps), time_ms(sdpa, args.reps)
        mma_dev, sdpa_dev = graph_ms(mma), graph_ms(sdpa)
        limits = qk.card_limits(q.device)
        for fl in flavours:
            if fl in SPLITS and d != 256:
                continue
            if (fl in ("whole_s", "no_xchg") and d != 512) or (fl == "nc1" and d == 512):
                continue
            fn, plan = built[fl][0], qk.wgmma_plan(d, b, h, t, *limits, split=SPLITS.get(fl))
            if fl == "nc1":
                plan = (plan[0], 1)
            o = torch.empty_like(q)
            launch(fn, q, k, v, o, plan)
            torch.cuda.synchronize()
            err = (o.float() - ref).abs().max().item() / ref.abs().max().item()
            if fl == "kernel" and args.source == str(SOURCE) and not torch.equal(o, want):
                raise AssertionError("the probe's kernel build differs from the wrapper's")
            if fl not in STRIPPED and err > 2e-2:
                raise AssertionError(f"{fl} {shape} disagrees with the plain version: {err}")
            ms = time_ms(lambda: launch(fn, q, k, v, o, plan), args.reps)
            dev = graph_ms(lambda: launch(fn, q, k, v, o, plan))
            row = dict(flavour=fl, shape=[b, t, h, d], split=plan[0], consumers=plan[1], ms=ms,
                       device_ms=dev,
                       tflops=flops / ms / 1e9, device_tflops=flops / dev / 1e9, mma_ms=mma_ms,
                       sdpa_ms=sdpa_ms, mma_device_ms=mma_dev, sdpa_device_ms=sdpa_dev,
                       rel_err=err)
            rows.append(row)
            print(f"  {fl:12s} [{b},{t},{h},{d}] plan {plan}: {ms:.4f} ms, device "
                  f"{dev:.4f} ms {row['device_tflops']:.0f} TFLOP/s (mma {mma_ms:.4f} / device "
                  f"{mma_dev:.4f}, sdpa {sdpa_ms:.4f} / device {sdpa_dev:.4f}) rel_err {err:.2e}",
                  flush=True)
    result = dict(gpu=gpu, rows=rows, ptxas={fl: built[fl][1] for fl in flavours})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(dict(gpu=gpu, rows=rows)))


if __name__ == "__main__":
    main()
