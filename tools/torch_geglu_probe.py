"""The GEGLU feed-forward's wgmma route (or, with ``--dtype fp32``, its
tf32x3 route) on the card, shape by shape (PyTorch port).

    python3 tools/torch_geglu_probe.py [--dtype bf16|fp32] [--shapes 32768x320x1280,...]
        [--sweep] [--flavours no_erf,stages5,gate256] [--baseline PATH,...]
        [--plan ROWS1,ROWS2,BN2,SPLIT] [--calls 20] [--json PATH]

Builds ``diffusion_tts_torch/csrc/geglu_ff.cu`` (``build.build``), prints
ptxas's registers and spills of the wgmma kernels, then at each (M, C, F)
shape (default: the SD-1.5 UNet's GEGLU calls of one SD search, F = 4C):
  * holds the wgmma route against ``geglu_ff_plain`` within 2e-2 of the
    largest output, and two calls against each other bit for bit;
  * times by CUDA-graph replay (``--calls`` calls captured once, the lesser
    of two replays in turns) the wgmma route at ``wgmma_plan``'s plan, the
    mma route (``route="mma"``, the first tensor-core design) and the library
    call (``linear``-``gelu``-``linear`` in bf16) and the plain version,
    summed over one SD search's calls where the shapes are the default;
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

``--dtype fp32`` does the same for the fp32 route, "tf32x3" (three tf32
products on the tensor cores, TF32 off for the library), at
``tf32x3_plan``'s plans: held within 1e-4, timed beside the fma route
(``route="fma"``, the first design) and the library call in fp32, with
its own flavours: ``no_split`` (no lo written: the products read stale
lo, wrong by design), ``one_pass`` (hi.hi alone, the split kept: wrong by
design),
``tf_stages3`` (3 raw stages instead of up to 4), ``one_chain`` (no
promotion: every product of a unit accumulates in the tensor cores, the
first design's numerics), ``promote8`` (groups of 8 stages instead of 4).
Flavours meant to be right (tf_stages3, one_chain, promote8 and the bf16
stages3, stages5, gate256) are held against the plain version
first, within the dtype's tolerance, and their error is printed.
"""
from __future__ import annotations

import argparse
import json
import ctypes
import os
import re
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
# steps, N = 4, K = 2, the UNet at batch 8 and 2) and each one's calls there
SD_SHAPES = ((32768, 320, 1280), (8192, 320, 1280), (8192, 640, 2560), (2048, 640, 2560),
             (2048, 1280, 5120), (512, 1280, 5120), (128, 1280, 5120))
SD_CALLS = dict(zip(SD_SHAPES, (60, 30, 60, 30, 60, 42, 6)))
TEST_ROWS = (1, 100, 128, 300, 512, 2048)
PEAK_FLOPS, PEAK_BYTES = {"bf16": 989e12, "fp32": 494.7e12 / 3}, 3.35e12
# What each dtype runs: its route, the plan function, the first design, the tolerance.
ROUTE = {"bf16": "wgmma", "fp32": "tf32x3"}
PLAN_FN = {"bf16": "wgmma_plan", "fp32": "tf32x3_plan"}
FIRST = {"bf16": "mma", "fp32": "fma"}
TOL = {"bf16": 2e-2, "fp32": 1e-4}
DTYPE = {"bf16": torch.bfloat16, "fp32": torch.float32}
TF_SPLIT = "    split_stage(s, lb);\n"
TF_LO_PRODUCTS = ("wgmma_ss_tf32<BN>(part, al_desc + lstep + o, b_desc + step + o, !fresh || "
                  "k8 > 0);",
                  "wgmma_ss_tf32<BN>(part, a_desc + step + o, bl_desc + lstep + o, 1);")
TF_HI_PRODUCT = "wgmma_ss_tf32<BN>(part, a_desc + step + o, b_desc + step + o, 1);"
TF_STAGES = "static constexpr int kStages = kFit < 4 ? kFit : 4;"
TF_PROMOTE = "constexpr int kTfPromote = 4;"
RIGHT = ("tf_stages3", "one_chain", "promote8", "stages3", "stages5", "gate256")
dtype_name = "bf16"  # set by main's --dtype


def inputs(m: int, c: int, f: int, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed + m + c)
    dt = DTYPE[dtype_name]
    r = lambda shape, s: (torch.randn(shape, device="cuda", generator=g) * s).to(dt)
    return r((m, c), 1), r((2 * f, c), c ** -0.5), r((2 * f,), 0.1), r((c, f), f ** -0.5), \
        r((c,), 0.1)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


class Plan:
    """The dtype's plan function (``gg.wgmma_plan`` or ``gg.tf32x3_plan``)
    replaced by a fixed plan while in use."""

    def __init__(self, plan):
        self.name = PLAN_FN[dtype_name]
        self.plan, self.saved = plan, getattr(gg, self.name)

    def __enter__(self):
        if self.plan is not None:
            setattr(gg, self.name, lambda m, c, f, sms: self.plan)

    def __exit__(self, *exc):
        setattr(gg, self.name, self.saved)


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
    if flavour == "one_pass":
        for line in TF_LO_PRODUCTS:
            src = edit_once(src, line, "", flavour)
        return edit_once(src, TF_HI_PRODUCT, TF_HI_PRODUCT.replace(", 1);", ", !fresh || k8 > 0);"),
                         flavour)
    old, new, count = {
        "one_chain": (TF_PROMOTE, TF_PROMOTE.replace("4", "1 << 30"), 1),
        "promote8": (TF_PROMOTE, TF_PROMOTE.replace("4", "8"), 1),
        "no_split": (TF_SPLIT, "", 1),
        "tf_stages3": (TF_STAGES, "static constexpr int kStages = 3;", 1),
        "no_erf": (ERF_LINE, "v[e] = h * (0.5f * gate * (1.f + gate));", 2),
        "stages3": (STAGES_LINE, "static constexpr int kStages = 3;", 1),
        "stages5": (STAGES_LINE, "static constexpr int kStages = NC == 2 ? 5 : BN == 160 ? 3 : 4;",
                    1),
        "split_nowrite": ("if (col < n)\n          *reinterpret_cast<float2*>",
                          "if (col < 0)\n          *reinterpret_cast<float2*>", 1),
        "split_nofence": (FENCE_LINE, ";", 4),  # the wgmma and tf32x3 routes' both
        "split_noreduce": (REDUCE_LINE, "continue;", 1),
        "no_gstore": (G_STORE, "          if (v[0] == 1.2345e-38f && v[1] == v[0])\n" + G_STORE, 1),
        "no_epi1": ("const float h = round_bf16(acc[4 * j + 2 * r + e] +",
                    "if (1) { v[e] = acc[4 * j + 2 * r + e] + acc[4 * (j + NT / 8) + 2 * r + e]; "
                    "continue; }\n            const float h = round_bf16(acc[4 * j + 2 * r + e] +", 1)}[flavour]
    if src.count(old) != count:
        raise RuntimeError(f"{flavour}: expected {count} of {old!r} in geglu_ff.cu")
    return src.replace(old, new)


def edit_once(src: str, old: str, new: str, flavour: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"{flavour}: expected one {old!r} in geglu_ff.cu")
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
        cur = None
        for line in log.splitlines():  # the flavour's registers and spills
            if "Compiling entry function" in line:
                kind = "tf32" if dtype_name == "fp32" else "wgmma"
                cur = re.search(rf"geglu_{kind}_kernelILi(\d+)ELi(\d+)ELb([01])", line)
            elif cur and ("Used" in line or "spill" in line):
                print(f"flavour {fl} ptxas <{', '.join(cur.groups())}>: {line.strip()}")
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
    route = ROUTE[dtype_name]
    with Plan(plan):
        before = dict(gg.ROUTE_LAUNCHES)
        out = gg.geglu_ff(x, w0, b0, w2, b2)
        again = gg.geglu_ff(x, w0, b0, w2, b2)
        torch.cuda.synchronize()
    if gg.ROUTE_LAUNCHES[route] != before[route] + 2 * gg.LAUNCHES_PER_CALL:
        raise AssertionError(f"({m}, {c}, {f}) did not run on the {route} route")
    err = rel_err(out, gg.geglu_ff_plain(x, w0, b0, w2, b2))
    same = torch.equal(out, again)
    if not (err <= TOL[dtype_name] and torch.isfinite(out).all() and same):
        raise AssertionError(f"({m}, {c}, {f}) plan {plan}: rel err {err:.3e}, "
                             f"two calls equal: {same}")
    return err, same


def sweep_plans(m: int, c: int, f: int, sms: int) -> list[tuple]:
    """Other plans than the dtype's plan function gives: launch 1's tile rows
    flipped (64 and 128), launch 2's tile rows and
    columns (64 or 128, 128 or 160) each at one share of the depth F, and at
    C = 1280 launch 2's split at 2, 3 and 4 shares."""
    base = getattr(gg, PLAN_FN[dtype_name])(m, c, f, sms)
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
    ap.add_argument("--dtype", choices=sorted(ROUTE), default="bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    global dtype_name
    dtype_name = args.dtype
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(gpu)
    built = build.build(("geglu_ff",))
    ptxas = []
    for _, log in built.values():
        cur = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = "geglu_wgmma_kernel" if dtype_name == "bf16" else "geglu_tf32_kernel"
                cur = line.split("'")[1] if kernel in line else None
            elif cur and ("Used" in line or "spill" in line):
                ptxas.append(f"{cur}: {line.strip()}")
    print("\n".join(ptxas))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flavours = build_flavours([fl for fl in args.flavours.split(",") if fl],
                              [p for p in (args.baseline or "").split(",") if p])
    plan_of = lambda m, c, f: getattr(gg, PLAN_FN[dtype_name])(m, c, f, sms)
    if args.plan:
        forced = tuple(int(v) for v in args.plan.split(","))
        setattr(gg, PLAN_FN[dtype_name], lambda m, c, f, sms: forced)

    tests = []
    for c in (320, 640, 1280):
        for m in TEST_ROWS:
            err, _ = check(m, c, 4 * c)
            tests.append(dict(shape=[m, c, 4 * c], plan=plan_of(m, c, 4 * c), max_rel_err=err))
            print(f"check ({m}, {c}, {4 * c}) plan {tests[-1]['plan']}: rel err {err:.3e}")

    rows = []
    for spec in args.shapes.split(","):
        m, c, f = (int(v) for v in spec.split("x"))
        x, w0, b0, w2, b2 = inputs(m, c, f)
        plan = plan_of(m, c, f)
        err, _ = check(m, c, f)
        kernel = lambda: gg.geglu_ff(x, w0, b0, w2, b2)
        mma = lambda: gg.geglu_ff(x, w0, b0, w2, b2, route=FIRST[dtype_name])

        def library():
            h, gate = F.linear(x, w0, b0).chunk(2, dim=-1)
            return F.linear(h * F.gelu(gate), w2, b2)

        with torch.no_grad():
            dev, mma_dev, lib_dev, plain_dev = graph_ms(
                [kernel, mma, library, lambda: gg.geglu_ff_plain(x, w0, b0, w2, b2)], args.calls)
            split = launch_split(kernel, args.calls)
        flops = 6 * m * c * f
        item = x.element_size()
        bound = max(flops / PEAK_FLOPS[dtype_name],
                    (2 * m * c + 3 * c * f) * item / PEAK_BYTES) * 1e3
        first = FIRST[dtype_name]
        row = dict(shape=[m, c, f], dtype=dtype_name, plan=plan, max_rel_err=err, device_ms=dev,
                   library_device_ms=lib_dev, plain_device_ms=plain_dev, bound_ms=bound,
                   tflops=flops / dev / 1e9, launches_ms=split, plans={})
        row[f"{first}_device_ms"] = mma_dev
        print(f"({m}, {c}, {f}) {dtype_name} plan {plan}: {ROUTE[dtype_name]} {dev:.4f} ms "
              f"({row['tflops']:.1f} TFLOP/s), {first} {mma_dev:.4f}, library {lib_dev:.4f}, "
              f"plain {plain_dev:.4f}, bound {bound:.4f}; launches "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
        row["flavours"] = {}
        for fl, fn in flavours.items():
            with Library(fn), torch.no_grad():
                fl_err = rel_err(kernel(), gg.geglu_ff_plain(x, w0, b0, w2, b2))
                if fl in RIGHT and not fl_err <= TOL[dtype_name]:
                    raise AssertionError(f"flavour {fl} at ({m}, {c}, {f}): rel err {fl_err:.3e}")
                ms = graph_ms([kernel], args.calls)[0]
                parts = launch_split(kernel, args.calls)
            row["flavours"][fl] = dict(device_ms=ms, launches_ms=parts, max_rel_err=fl_err,
                                       tflops=flops / ms / 1e9)
            print(f"    flavour {fl}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, rel err "
                  f"{fl_err:.2e}); launches "
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
    keys = ("device_ms", f"{FIRST[dtype_name]}_device_ms", "library_device_ms",
            "plain_device_ms", "bound_ms")
    if {tuple(r["shape"]) for r in rows} == set(SD_CALLS):  # the sums over one SD search
        result["search"] = {k: sum(SD_CALLS[tuple(r["shape"])] * r[k] for r in rows) for k in keys}
        print("one SD search's calls: " + ", ".join(f"{k} {v:.2f}"
                                                    for k, v in result["search"].items()))
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(dict(gpu=gpu, dtype=dtype_name, search=result.get("search"),
                          rows=[{k: r[k] for k in ("shape", "plan") + keys} for r in rows])))


if __name__ == "__main__":
    main()
