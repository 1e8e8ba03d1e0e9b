"""The GEGLU feed-forward's wgmma route on the card, shape by shape (PyTorch port).

    python3 tools/torch_geglu_probe.py [--shapes 32768x320x1280,...] [--sweep]
        [--flavours no_erf,stages5,gate256] [--baseline PATH,...]
        [--plan ROWS1,ROWS2,BN2,SPLIT] [--calls 20] [--json PATH]

Builds ``diffusion_tts_torch/csrc/geglu_ff.cu`` (``build.build``), prints
ptxas's registers and spills of the wgmma kernels, then at each (M, C, F)
shape (default: the SD-1.5 UNet's GEGLU calls of one SD search, F = 4C):
  * holds the wgmma route against ``geglu_ff_plain`` within 2e-2 of the
    largest output, and two calls against each other bit for bit;
  * times by CUDA-graph replay (``--calls`` calls captured once, the lesser
    of two replays in turns) the wgmma route at ``wgmma_plan``'s plan, the
    mma route (``route="mma"``, the first tensor-core design) and the library
    call (``linear``-``gelu``-``linear`` in bf16);
  * splits the wgmma route's device time between its two launches with
    ``torch.profiler`` (``--calls`` calls);
  * with ``--sweep``, times the wgmma route at other plans too (tile rows of
    each launch, launch 2's split of the depth), each checked against the
    plain version first;
  * with ``--flavours``, times the wgmma route (its plan, both launches by
    torch.profiler) built from edited copies of the source in
    ``build/probe_geglu/``: ``no_erf``, launch 1's gelu without erff (a
    wrong result by design: the epilogue's ALU cost); ``stages3`` /
    ``stages5``, a ring of 3 stages everywhere or of 5 for the two-consumer
    kernels instead of 4; ``gate256``, launch 1 on 256 B rows (128 g
    columns a tile, m64n256k16) instead of 128 (at F a multiple of 128); ``split_nowrite``, ``split_nofence``, ``split_noreduce``,
    launch 2's split depth without its partial stores, without its two
    fences or without the last arrival's sum (wrong by design). An edit
    whose line moved raises; ``no_gstore``, launch 1 without its stores of g
    (all else kept); ``no_epi1``, launch 1's epilogue down to one add a
    value and the store;
  * with ``--baseline``, the same for other versions of the source
    (comma-separated paths: a ``git archive`` of the parent, say), each the
    flavour "baseline:<file stem>";
  * with ``--plan``, every call of the run (checks included) at that plan
    instead of ``wgmma_plan``'s.
Also checks the route at the card-test rows M = 1, 100, 128, 300, 512, 2048
for C = 320, 640, 1280. Prints the card's name and power limit, one line per
(shape, plan) and one JSON object last. Needs an NVIDIA card; imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import json
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffusion_tts_torch.ops.kernels import _launch, build  # noqa: E402
from diffusion_tts_torch.ops.kernels import geglu_ff as gg  # noqa: E402

OUT_DIR = build.BUILD_DIR.parent / "probe_geglu"
ERF_LINE = "v[e] = h * (0.5f * gate * (1.f + erff(gate * 0.70710678118654752f)));"
STAGES_LINE = "static constexpr int kStages = NC == 1 && BN == 160 ? 3 : 4;"
GATE_BN_LINE = "constexpr int kGateBN = 128;"
SS_ANCHOR = '#include "mma_bf16.cuh"\n'
PARTIAL_LINE = "make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);"
FENCE_LINE = "__threadfence();"
REDUCE_LINE = "if (!last) continue;"
G_STORE = ("          *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * n + col) =\n"
           "              __floats2bfloat162_rn(v[0], v[1]);")

# (M, C, F) of the GEGLU calls of one SD search (chip_smoke.py phase 6: 6
# steps, N = 4, K = 2, the UNet at batch 8 and 2)
SD_SHAPES = ((32768, 320, 1280), (8192, 320, 1280), (8192, 640, 2560), (2048, 640, 2560),
             (2048, 1280, 5120), (512, 1280, 5120), (128, 1280, 5120))
TEST_ROWS = (1, 100, 128, 300, 512, 2048)
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def inputs(m: int, c: int, f: int, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed + m + c)
    r = lambda shape, s: (torch.randn(shape, device="cuda", generator=g) * s).bfloat16()
    return r((m, c), 1), r((2 * f, c), c ** -0.5), r((2 * f,), 0.1), r((c, f), f ** -0.5), \
        r((c,), 0.1)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


class Plan:
    """``gg.wgmma_plan`` replaced by a fixed plan while in use."""

    def __init__(self, plan):
        self.plan, self.saved = plan, gg.wgmma_plan

    def __enter__(self):
        if self.plan is not None:
            gg.wgmma_plan = lambda m, c, f, sms: self.plan

    def __exit__(self, *exc):
        gg.wgmma_plan = self.saved


def graph_ms(fns, calls: int) -> list[float]:
    """Device ms of one call of each fn: ``calls`` calls captured in a CUDA
    graph, replayed in turns (each fn, then in reverse order), the lesser of
    each fn's two timings."""
    graphs = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        graphs.append(graph)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = [[] for _ in graphs]
    for i in list(range(len(graphs))) + list(reversed(range(len(graphs)))):
        torch.cuda.synchronize()
        start.record()
        for _ in range(3):
            graphs[i].replay()
        end.record()
        end.synchronize()
        times[i].append(start.elapsed_time(end) / (3 * calls))
    return [min(t) for t in times]


def launch_split(fn, calls: int) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dev and "geglu" in ev.key:
            name = ev.key.replace("(anonymous namespace)::", "").replace("void ", "")
            out[name.split("(")[0]] = dev / 1e3 / calls
    return out


def edit(src: str, flavour: str) -> str:
    """The source with the flavour's edit; raises if the edited line moved."""
    old, new, count = {
        "no_erf": (ERF_LINE, "v[e] = h * (0.5f * gate * (1.f + gate));", 2),
        "stages3": (STAGES_LINE, "static constexpr int kStages = 3;", 1),
        "stages5": (STAGES_LINE, "static constexpr int kStages = NC == 2 ? 5 : BN == 160 ? 3 : 4;",
                    1),
        "split_nowrite": ("if (col < n)\n          *reinterpret_cast<float2*>",
                          "if (col < 0)\n          *reinterpret_cast<float2*>", 1),
        "split_nofence": (FENCE_LINE, ";", 2),
        "split_noreduce": (REDUCE_LINE, "continue;", 1),
        "no_gstore": (G_STORE, "          if (v[0] == 1.2345e-38f && v[1] == v[0])\n" + G_STORE, 1),
        "no_epi1": ("const float h = round_bf16(acc[4 * j + 2 * r + e] +",
                    "if (1) { v[e] = acc[4 * j + 2 * r + e] + acc[4 * (j + NT / 8) + 2 * r + e]; "
                    "continue; }\n            const float h = round_bf16(acc[4 * j + 2 * r + e] +", 1)}[flavour]
    if src.count(old) != count:
        raise RuntimeError(f"{flavour}: expected {count} of {old!r} in geglu_ff.cu")
    return src.replace(old, new)


def gate256(src: str) -> str:
    """Launch 1 on 256 B rows (128 h and the same 128 gate columns), with the
    m64n256k16 product the source does not instantiate."""
    if src.count(GATE_BN_LINE) != 1 or src.count(SS_ANCHOR) != 1:
        raise RuntimeError("gate256: the tile line or the include moved in geglu_ff.cu")
    regs = ", ".join(f"%{i}" for i in range(128))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(128))
    spec = ("namespace dtts {\ntemplate <>\n__device__ __forceinline__ void wgmma_ss<256>("
            "float (&d)[128], uint64_t da, uint64_t db, int scale_d) {\n  asm volatile(\n"
            '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %130, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {{{regs}}}, %128, '
            '%129, p, 1, 1, 0, 0;\\n}\\n"\n'
            f'      : {outs}\n      : "l"(da), "l"(db), "r"(scale_d));\n}}\n}}  // namespace dtts\n')
    return src.replace(GATE_BN_LINE, "constexpr int kGateBN = 256;").replace(
        SS_ANCHOR, SS_ANCHOR + spec)


def build_flavours(flavours, baselines=()) -> dict:
    """{flavour: the C entry of its library}, all nvcc processes at once;
    each source of ``baselines`` is built as it is, named "baseline:<stem>"."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "geglu_ff.cu").read_text()
    sources = {f"baseline:{Path(p).stem}": p for p in baselines}
    procs = {}
    for fl in flavours + list(sources):
        cu = OUT_DIR / f"geglu_ff_{fl.replace(':', '_')}.cu"
        lib = cu.parent / f"lib{cu.stem}.so"
        if fl in sources:
            cu.write_text(Path(sources[fl]).read_text())
        else:
            cu.write_text(gate256(text) if fl == "gate256" else edit(text, fl))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(cu)]
        procs[fl] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    out = {}
    for fl, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {fl}:\n{log}")
        fn = ctypes.CDLL(str(lib)).dtts_geglu_ff
        fn.restype, fn.argtypes = ctypes.c_int, list(gg._ARGTYPES)
        out[fl] = fn
    return out


class Library:
    """The wrapper bound to ``fn`` (a flavour's C entry) while in use."""

    def __init__(self, fn):
        self.fn, self.saved = fn, _launch.bind

    def __enter__(self):
        _launch.bind = lambda *args: self.fn

    def __exit__(self, *exc):
        _launch.bind = self.saved


def check(m, c, f, plan=None, seed=0) -> tuple[float, bool]:
    x, w0, b0, w2, b2 = inputs(m, c, f, seed)
    with Plan(plan):
        before = dict(gg.ROUTE_LAUNCHES)
        out = gg.geglu_ff(x, w0, b0, w2, b2)
        again = gg.geglu_ff(x, w0, b0, w2, b2)
        torch.cuda.synchronize()
    if gg.ROUTE_LAUNCHES["wgmma"] != before["wgmma"] + 2 * gg.LAUNCHES_PER_CALL:
        raise AssertionError(f"({m}, {c}, {f}) did not run on the wgmma route")
    err = rel_err(out, gg.geglu_ff_plain(x, w0, b0, w2, b2))
    same = torch.equal(out, again)
    if not (err <= 2e-2 and torch.isfinite(out).all() and same):
        raise AssertionError(f"({m}, {c}, {f}) plan {plan}: rel err {err:.3e}, "
                             f"two calls equal: {same}")
    return err, same


def sweep_plans(m: int, c: int, f: int, sms: int) -> list[tuple]:
    """Other plans than wgmma_plan's: launch 1's tile rows flipped, launch
    2's tile rows and columns (64 or 128, 128 or 160) each at one share of
    the depth F, and at C = 1280 launch 2's split at 2, 3 and 4 shares."""
    base = gg.wgmma_plan(m, c, f, sms)
    rows1, rows2, bn2, split = base
    plans = {(192 - rows1, rows2, bn2, split)}
    plans |= {(rows1, rows, bn, 1) for rows in (64, 128) for bn in (128, 160)}
    if c == 1280:
        plans |= {(rows1, rows2, bn2, s) for s in (2, 3, 4)}
    plans.discard(base)
    return sorted(plans)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join("x".join(map(str, s)) for s in SD_SHAPES))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--flavours", default="")
    ap.add_argument("--plan", default=None)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(gpu)
    built = build.build(("geglu_ff",))
    ptxas = []
    for _, log in built.values():
        cur = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                cur = line.split("'")[1] if "geglu_wgmma_kernel" in line else None
            elif cur and ("Used" in line or "spill" in line):
                ptxas.append(f"{cur}: {line.strip()}")
    print("\n".join(ptxas))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flavours = build_flavours([fl for fl in args.flavours.split(",") if fl],
                              [p for p in (args.baseline or "").split(",") if p])
    if args.plan:
        forced = tuple(int(v) for v in args.plan.split(","))
        gg.wgmma_plan = lambda m, c, f, sms: forced

    tests = []
    for c in (320, 640, 1280):
        for m in TEST_ROWS:
            err, _ = check(m, c, 4 * c)
            tests.append(dict(shape=[m, c, 4 * c], plan=gg.wgmma_plan(m, c, 4 * c, sms),
                              max_rel_err=err))
            print(f"check ({m}, {c}, {4 * c}) plan {tests[-1]['plan']}: rel err {err:.3e}")

    rows = []
    for spec in args.shapes.split(","):
        m, c, f = (int(v) for v in spec.split("x"))
        x, w0, b0, w2, b2 = inputs(m, c, f)
        plan = gg.wgmma_plan(m, c, f, sms)
        err, _ = check(m, c, f)
        kernel = lambda: gg.geglu_ff(x, w0, b0, w2, b2)
        mma = lambda: gg.geglu_ff(x, w0, b0, w2, b2, route="mma")

        def library():
            h, gate = F.linear(x, w0, b0).chunk(2, dim=-1)
            return F.linear(h * F.gelu(gate), w2, b2)

        with torch.no_grad():
            dev, mma_dev, lib_dev = graph_ms([kernel, mma, library], args.calls)
            split = launch_split(kernel, args.calls)
        flops = 6 * m * c * f
        bound = max(flops / PEAK_FLOPS, (2 * m * c + 3 * c * f) * 2 / PEAK_BYTES) * 1e3
        row = dict(shape=[m, c, f], plan=plan, max_rel_err=err, device_ms=dev,
                   mma_device_ms=mma_dev, library_device_ms=lib_dev, bound_ms=bound,
                   tflops=flops / dev / 1e9, launches_ms=split, plans={})
        print(f"({m}, {c}, {f}) plan {plan}: wgmma {dev:.4f} ms ({row['tflops']:.1f} TFLOP/s), "
              f"mma {mma_dev:.4f}, library {lib_dev:.4f}, bound {bound:.4f}; launches "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
        row["flavours"] = {}
        for fl, fn in flavours.items():
            with Library(fn), torch.no_grad():
                ms = graph_ms([kernel], args.calls)[0]
                parts = launch_split(kernel, args.calls)
            row["flavours"][fl] = dict(device_ms=ms, launches_ms=parts)
            print(f"    flavour {fl}: {ms:.4f} ms; launches "
                  + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        if args.sweep:
            for other in sweep_plans(m, c, f, sms):
                err_o, _ = check(m, c, f, other)
                with Plan(other), torch.no_grad():
                    ms = graph_ms([kernel], args.calls)[0]
                row["plans"][str(other)] = ms
                print(f"    plan {other}: {ms:.4f} ms (rel err {err_o:.3e})")
        rows.append(row)
    result = dict(gpu=gpu, ptxas=ptxas, tests=tests, rows=rows)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(dict(gpu=gpu, rows=[{k: r[k] for k in ("shape", "plan", "device_ms",
                                                             "mma_device_ms",
                                                             "library_device_ms")}
                                         for r in rows])))


if __name__ == "__main__":
    main()
