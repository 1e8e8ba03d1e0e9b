"""Where conv3x3_same's and conv3x3_up2's time goes on the card, for the wgmma routes and the
ring (PyTorch port).

    python3 tools/torch_conv_probe.py [--shapes 4x512x512x128x128,4x128x128x512x512]
        [--flavours products_only,...] [--ring-flavours ring_products_only,...]
        [--up2-shapes 4x512x512x64x64,...] [--up2-flavours up2_products_only,...]
        [--calls 10] [--json PATH]

Builds ``diffusion_tts_torch/csrc/conv3x3.cu`` (``build.build``), prints
ptxas's registers and spills of the wgmma kernels, then at each B x C x K x
H x W shape (default: the SD-1.5 decoder's [4,512,128,128,512] and
[4,128,512,512,128] conv3x3_same calls) and each epilogue (none, residual,
and at the first shape a shortcut of Cres = C), every call with the
GroupNorm+SiLU prologue and a bias as the SD decoder makes them:
  * holds the wgmma route against ``conv3x3_same_plain`` within 2e-2 of the
    largest output (on the first image) and two calls against each other bit
    for bit;
  * times by CUDA-graph replay (``--calls`` calls captured once, the lesser
    of two replays in turns) the wgmma route, the ring (``route="ring"``,
    PR 8's design) and cuDNN's bare conv (``F.conv2d`` with the bias);
  * times edited copies of the source, built in ``build/probe_conv/``
    (never switches in the source; an edit whose line moved raises), each
    a wrong result by design but the first three:
      - other rings than 4 weight slots, 2 raw slots and 2 patches (what
        shared memory allows beside the staging tiles): ``w3x3`` (3 weight,
        3 raw), ``w3`` (3 weight);
      - ``no_epilogue``: no output stores (each kept behind a test that
        never holds, so that the products stay live) and no residual reads
        (the products, the transform and the loads kept);
      - ``no_transform``: the consumer warps skip their share of the
        transform and only arrive (the loads, products and epilogue kept);
      - ``products_transform``: no loads (the TMA boxes of zero bytes) and
        no epilogue: the products and the transform;
      - ``products_only``: no loads, no transform, no epilogue: the
        products and the barrier protocol alone;
      - ``transform_only``: no loads, no products, no epilogue: the
        transform and the barrier protocol alone;
      - ``batch1`` / ``batch4``: 1 or 4 transform units a warp has in
        flight instead of 2;
      - ``no_tanh``: the prologue without its tanh (its MUFU cost);
        ``no_prologue``: the transform without the prologue (a transpose);
      - ``timeline``: clock64 around each section of the consumer warps'
        loop (the waits for weights, patch and products, the products'
        issue, the transform's waits, units and fence, the tile end with
        the epilogue), summed over the warps of one call: cycles a warp
        and each section's share;
  * at the first shape, the ring's own flavours (``ring_no_epilogue``,
    ``ring_no_transform``, ``ring_products_only``: the same cuts of PR 8's
    design, timed with ``route="ring"``), which split the ring's time.
Then, at each B x C x K x H x W up-conv shape (default: the SD-1.5
decoder's three conv3x3_up2 calls at batch 4, H x W the source), with a bias:
  * holds the up-conv's wgmma route against ``conv3x3_up2_plain`` within
    2e-2 of the largest output (on the first image) and two calls bit for
    bit;
  * times by CUDA-graph replay the wgmma route, the ring (``route="ring"``)
    and ``interpolate`` + ``F.conv2d``;
  * times edited copies of the up-conv's kernel, each its own build:
      - ``up2_products_only``: no loads (boxes of zero bytes), no transform
        and no TMA stores: the products and the barrier protocol (the
        staging tile's stores keep the accumulators, and so the products,
        live);
      - ``up2_products_transform``: no loads and no TMA stores: the products
        and the transform;
      - ``up2_no_transform``: the consumer warps skip their share of the
        transform and only arrive (loads, products and epilogue kept);
      - ``up2_no_epilogue``: no TMA stores (the staging tile's stores kept);
      - ``up2_w2``: 2 weight slots instead of 3;
      - ``up2_centre_mn``: at 1-row tiles, the two column phases' centre
        taps (column shift 0) read their B operand MN-major from 128-byte-
        swizzled TMA boxes of x ([16 channels][64 pixels], three rows x two
        halves, 12 KB a stage, riding in the weight slot: 2 slots, so
        ``up2_w2`` is its control) instead of the transformed patch (a right
        result: the side shifts still read the patch, which is built whole).
Prints the card's name and power limit, one line per (shape, epilogue,
design) and one JSON object last. Needs an NVIDIA card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffusion_tts_torch.ops.kernels import _launch, build  # noqa: E402
from diffusion_tts_torch.ops.kernels import conv3x3 as cv  # noqa: E402

OUT_DIR = build.BUILD_DIR.parent / "probe_conv"
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
SHAPES = ((4, 512, 512, 128, 128), (4, 128, 128, 512, 512))
UP2_SHAPES = ((4, 512, 512, 64, 64), (4, 512, 512, 128, 128), (4, 256, 256, 256, 256))

RINGS = "constexpr int kWgSw = 4, kWgSx = 2, kWgP = 2;  // weight slots, raw slots, patches"
STORES = ("      tma_store_4d(&omap, out_tile, t.x0, t.y0 + role, t.k0, t.b);\n"
          "      tma_store_4d(&omap, out_tile + kWgOutBox, t.x0 + 64, t.y0 + role, t.k0, t.b);\n")
RES_LOAD = "if (residual && elected && s == (n > 1 ? 1 : 0)) {"
RES_WAIT = "    if (residual) {\n      mbar_wait(rfull(role), tc & 1);"
RES_READ = "      if (residual) ldmatrix_x4(res, addr);"
TRANSFORM = ("wg_transform<GN>(xslot(xs), wg_smem + (xslot(xs) - smem_base), pslot(ps), a, t, "
             "warp_id,\n                     lane);")
TANH = "  y0 = fmaf(h0, tanh_approx(h0), h0);\n  y1 = fmaf(h1, tanh_approx(h1), h1);"
PROLOGUE = "      if (GN) {\n        const int gy = t.y0 - 1 + r, gx0 = t.x0 - 8 + 16 * q;"
PRODUCTS = "wgmma_ss<128>(acc, da, db, s > 0 || tap > 0);"
BATCH = "constexpr int kWgBatch = 2;"
LOAD_W = ("mbar_expect_tx(wfull(ws), kWgWSlot);\n"
          "          tma_load_3d(wslot(ws), &wmap, wfull(ws), s * kWgChannels, t.k0, 0);")
LOAD_X = ("mbar_expect_tx(xfull(xs), kWgRawBytes + (GN ? kWgScaleShift : 0));\n"
          "          tma_load_4d(xslot(xs), &xmap, xfull(xs), t.x0 - 8, t.y0 - 1, s * kWgChannels, "
          "t.b);\n          if (GN) {")
RING_TRANSFORM = "if (next_patch != nullptr) transform<UP2, GN>(next_patch, next_slot, a, k);"
RING_TRANSFORM0 = "  transform<UP2, GN>(patch_of(0), slot_of(0), a, k);"
RING_ISSUE = "  if (s < k.n) {\n    unsigned char* slot"
RING_STORE = "        if (kk >= a.k || y >= a.h || x >= a.w_) continue;\n        const float* src"

NO_LOADS = [(LOAD_W, "mbar_expect_tx(wfull(ws), 0);"),
            (LOAD_X, "mbar_expect_tx(xfull(xs), 0);\n          if (false) {")]
# the staging tile's stmatrix keeps the accumulators, and so the products, live
NO_EPI = [(STORES, ""), (RES_LOAD, "if (false) {"),
          (RES_WAIT, "    if (false) {\n      mbar_wait(rfull(role), tc & 1);"), (RES_READ, "")]

# The timeline: clock64 around each section of the consumer loop, summed over
# the consumer warps (lane 0) into a device array that two C entries clear
# and read.
PROF_NAMES = ("wait weights", "wait patch", "issue products", "wait products + free",
              "transform waits", "transform units", "transform fence + arrive",
              "tile end + epilogue")
TIMELINE = [
    ('#include "mma_bf16.cuh"\n',
     '#include "mma_bf16.cuh"\n__device__ unsigned long long dtts_conv_prof[8];\n'
     '#define PROF(i, stmt) { const long long t0_ = clock64(); stmt; prof[i] += clock64() - t0_; }\n'),
    ("  auto transform = [&](int it, int ip, const WgTile& t) {",
     "  long long prof[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  auto transform = [&](int it, int ip, const WgTile& t) {"),
    ("    mbar_wait(xfull(xs), (it / kWgSx) & 1);\n    if (ip >= kWgP) mbar_wait(pempty(ps), "
     "((ip / kWgP) - 1) & 1);",
     "    PROF(4, mbar_wait(xfull(xs), (it / kWgSx) & 1);\n    if (ip >= kWgP) mbar_wait(pempty(ps), "
     "((ip / kWgP) - 1) & 1));"),
    (TRANSFORM, "PROF(5, " + TRANSFORM[:-1] + ");"),
    ("    fence_proxy_async();  // the patch is read by wgmma (the async proxy)\n    __syncwarp();",
     "    const long long t6_ = clock64();\n    fence_proxy_async();\n    __syncwarp();"),
    ("      mbar_arrive(xempty(xs));\n    }\n  };",
     "      mbar_arrive(xempty(xs));\n    }\n    prof[6] += clock64() - t6_;\n  };"),
    ("      mbar_wait(wfull(ws), (it / kWgSw) & 1);", "      PROF(0, mbar_wait(wfull(ws), (it / kWgSw) & 1));"),
    ("        mbar_wait(pfull(ps), (ip / kWgP) & 1);\n        fence_regs(acc);",
     "        PROF(1, mbar_wait(pfull(ps), (ip / kWgP) & 1));\n        fence_regs(acc);"),
    ("#pragma unroll\n        for (int tap = 0; tap < 9; ++tap) {",
     "        const long long t2_ = clock64();\n#pragma unroll\n        for (int tap = 0; tap < 9; ++tap) {"),
    ("          wgmma_ss<128>(acc, da, db, s > 0 || tap > 0);\n        }\n        wgmma_commit();",
     "          wgmma_ss<128>(acc, da, db, s > 0 || tap > 0);\n        }\n        wgmma_commit();\n"
     "        prof[2] += clock64() - t2_;"),
    ("      if (pend) {\n        wgmma_wait<1>();\n        fence_regs(acc);\n        release();\n"
     "      }",
     "      PROF(3, if (pend) {\n        wgmma_wait<1>();\n        fence_regs(acc);\n"
     "        release();\n      })"),
    ("    wgmma_wait<0>();\n    fence_regs(acc);\n    release();\n",
     "    const long long t7_ = clock64();\n    wgmma_wait<0>();\n    fence_regs(acc);\n    release();\n"),
    ("      bulk_commit();\n    }\n  }\n  if (elected) bulk_wait<0>();",
     "      bulk_commit();\n    }\n    prof[7] += clock64() - t7_;\n  }\n"
     "  if (lane == 0)\n    for (int i = 0; i < 8; ++i) atomicAdd(&dtts_conv_prof[i], "
     "(unsigned long long)prof[i]);\n  if (elected) bulk_wait<0>();"),
]
TIMELINE_ENTRIES = """
extern "C" int dtts_conv_prof_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, dtts_conv_prof, sizeof(dtts_conv_prof));
}
extern "C" int dtts_conv_prof_clear() {
  static const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(dtts_conv_prof, zero, sizeof(zero));
}
"""
EDITS = {
    "w3x3": [(RINGS, RINGS.replace("kWgSw = 4, kWgSx = 2", "kWgSw = 3, kWgSx = 3"))],
    "w3": [(RINGS, RINGS.replace("kWgSw = 4", "kWgSw = 3"))],
    "no_epilogue": NO_EPI,
    "no_transform": [(TRANSFORM, "")],
    "products_transform": NO_LOADS + NO_EPI,
    "products_only": NO_LOADS + NO_EPI + [(TRANSFORM, "")],
    "transform_only": NO_LOADS + NO_EPI + [(PRODUCTS, "(void)da; (void)db;")],
    "batch1": [(BATCH, "constexpr int kWgBatch = 1;")],
    "batch4": [(BATCH, "constexpr int kWgBatch = 4;")],
    "timeline": TIMELINE,
    "no_tanh": [(TANH, "  y0 = h0 + h0;\n  y1 = h1 + h1;")],
    "no_prologue": [(PROLOGUE, "      if (false) {\n        const int gy = t.y0 - 1 + r, "
                               "gx0 = t.x0 - 8 + 16 * q;")],
    "ring_no_epilogue": [(RING_STORE, RING_STORE.replace("if (kk >= a.k ||", "if (kk >= 0 ||"))],
    "ring_no_transform": [(RING_TRANSFORM, ""), (RING_TRANSFORM0, "")],
    "ring_products_only": [(RING_TRANSFORM, ""), (RING_TRANSFORM0, ""),
                           (RING_ISSUE, "  if (false) {\n    unsigned char* slot"),
                           (RING_STORE, RING_STORE.replace("if (kk >= a.k ||", "if (kk >= 0 ||"))],
}

# The up-conv's kernel (conv3_up2_wgmma_kernel).
UP2_WLOAD = ("        mbar_expect_tx(wfull(ws), kUpWSlot);\n"
             "        bulk_load(wslot(ws), wsrc + ((int64_t)(t.k0 / kWgM) * n + s) * (kUpWSlot / 2), "
             "kUpWSlot,\n                  wfull(ws));\n")
UP2_LOADS = (UP2_WLOAD + "        mbar_expect_tx(xfull(xs), U::kRawBytes);\n"
             "        tma_load_4d(xslot(xs), &xmap, xfull(xs), t.x0 - 8, t.y0 - 1, s * kUpChannels, "
             "t.b);\n")
UP2_TRANSFORM = "    up2_transform<SR>(xslot(xs), pslot(ps), warp_id, lane);\n"
UP2_STORES = ("#pragma unroll\n      for (int q = 0; q < 4; ++q)\n"
              "        tma_store_4d(&omap, out_tile + q * kWgOutBox, 2 * t.x0 + 64 * (q % "
              "kBoxesPerRow),\n                     2 * (t.y0 + q / kBoxesPerRow) + role, t.k0, "
              "t.b);\n")
UP2_RINGS = "constexpr int kUpSw = 3, kUpSx = 2, kUpP = 2;"
UP2_NO_LOADS = [(UP2_LOADS, "        mbar_expect_tx(wfull(ws), 0);\n"
                            "        mbar_expect_tx(xfull(xs), 0);\n")]
# The centre taps' B from TMA boxes of x in the weight slot (after its 32 KB):
# box q = 2 row + half, [16 channels][64 pixels] of 128-byte rows, swizzled;
# MN-major descriptors with the halves 2048 bytes apart (LBO) and 8-channel
# groups 1024 apart (SBO).
UP2_CENTRE = [
    (UP2_RINGS, "constexpr int kUpSw = 2, kUpSx = 2, kUpP = 2;"),
    ("constexpr int kUpWSlot = 16 * kWgTapBytes;     // 32768: one bulk copy",
     "constexpr int kUpWSlot = 16 * kWgTapBytes + 6 * 2048;"),
    ("                       const __grid_constant__ CUtensorMap omap, const ConvArgs a) {",
     "                       const __grid_constant__ CUtensorMap omap, const ConvArgs a,\n"
     "                       const __grid_constant__ CUtensorMap cmap) {"),
    (UP2_WLOAD,
     "        mbar_expect_tx(wfull(ws), 16 * kWgTapBytes + (SR == 1 ? 6 * 2048 : 0));\n"
     "        bulk_load(wslot(ws), wsrc + ((int64_t)(t.k0 / kWgM) * n + s) * (16 * kWgTapBytes / 2),"
     "\n                  16 * kWgTapBytes, wfull(ws));\n"
     "        if (SR == 1)\n"
     "          for (int q = 0; q < 6; ++q)\n"
     "            tma_load_4d(wslot(ws) + 16 * kWgTapBytes + q * 2048, &cmap, wfull(ws),\n"
     "                        t.x0 + 64 * (q & 1), t.y0 - 1 + (q >> 1), s * kUpChannels, t.b);\n"),
    ("                                             uint32_t pslot, int pa, bool first) {\n",
     "                                             uint32_t pslot, int pa, bool first) {\n"
     "  const uint32_t cbox = wslot + 16 * kWgTapBytes;\n"),
    ("        wgmma_ss<U::kCols>(acc[e][sr], da, db, scale);",
     "        if (SR == 1 && e + s == 1)\n"
     "          wgmma_ss_bmn128(*reinterpret_cast<float(*)[64]>(&acc[e][sr][0]), da,\n"
     "                          wgmma_desc(cbox + (pa + r) * 4096, 2048, 1024, 1), scale);\n"
     "        else\n"
     "          wgmma_ss<U::kCols>(acc[e][sr], da, db, scale);"),
    ("    const int e = encode_map(&om, a.out, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);\n"
     "    if (e != 0) return e;\n  }\n  cudaError_t err = cudaFuncSetAttribute(conv3_up2_wgmma_kernel<SR>,",
     "    const int e = encode_map(&om, a.out, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);\n"
     "    if (e != 0) return e;\n  }\n  CUtensorMap cm;\n  {\n"
     "    const cuuint64_t dims[4] = {(cuuint64_t)a.w_, (cuuint64_t)a.h, (cuuint64_t)a.c,\n"
     "                                (cuuint64_t)a.b};\n"
     "    const cuuint64_t strides[3] = {(cuuint64_t)a.w_ * 2, hw * 2, hw * a.c * 2};\n"
     "    const cuuint32_t box[4] = {64, 1, kUpChannels, 1};\n"
     "    const int e = encode_map(&cm, a.x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);\n"
     "    if (e != 0) return e;\n  }\n"
     "  cudaError_t err = cudaFuncSetAttribute(conv3_up2_wgmma_kernel<SR>,"),
    ("stream>>>(xm, om, a);", "stream>>>(xm, om, a, cm);"),
]
EDITS.update({
    "up2_products_only": UP2_NO_LOADS + [(UP2_TRANSFORM, ""), (UP2_STORES, "")],
    "up2_products_transform": UP2_NO_LOADS + [(UP2_STORES, "")],
    "up2_no_transform": [(UP2_TRANSFORM, "")],
    "up2_no_epilogue": [(UP2_STORES, "")],
    "up2_w2": [(UP2_RINGS, UP2_RINGS.replace("kUpSw = 3", "kUpSw = 2"))],
    "up2_centre_mn": UP2_CENTRE,
})
WGMMA_FLAVOURS = [f for f in EDITS if not f.startswith(("ring_", "up2_"))]
RING_FLAVOURS = [f for f in EDITS if f.startswith("ring_")]
UP2_FLAVOURS = [f for f in EDITS if f.startswith("up2_")]


def edit(src: str, flavour: str) -> str:
    for old, new in EDITS[flavour]:
        if src.count(old) != 1:
            raise RuntimeError(f"{flavour}: expected one {old!r} in conv3x3.cu")
        src = src.replace(old, new)
    return src + (TIMELINE_ENTRIES if flavour == "timeline" else "")


def build_flavours(flavours) -> dict:
    """{flavour: the C entry of its library (conv3x3_up2's for the up2_
    flavours, else conv3x3_same's)}, all nvcc processes at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "conv3x3.cu").read_text()
    procs = {}
    for fl in flavours:
        cu = OUT_DIR / f"conv3x3_{fl}.cu"
        lib = cu.parent / f"lib{cu.stem}.so"
        cu.write_text(edit(text, fl))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(cu)]
        procs[fl] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    out = {}
    for fl, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {fl}:\n{log}")
        print(f"ptxas, flavour {fl}: " + "; ".join(ptxas_of(log)))
        dll = ctypes.CDLL(str(lib))
        if fl.startswith("up2_"):
            fn = dll.dtts_conv3x3_up2
            fn.restype, fn.argtypes = ctypes.c_int, list(cv._UP2_ARGTYPES)
        else:
            fn = dll.dtts_conv3x3_same
            fn.restype, fn.argtypes = ctypes.c_int, list(cv._SAME_ARGTYPES)
        fn.dll = dll
        out[fl] = fn
    return out


def ptxas_of(log: str) -> list[str]:
    """The register and spill lines of the wgmma kernels in nvcc's log."""
    found, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if ("conv3_wgmma_kernel" in line
                                         or "conv3_up2_wgmma_kernel" in line) else None
        elif cur and ("Used" in line or "spill" in line):
            found.append(f"{cur[-40:]}: {line.strip()}")
    return found


def timeline(fn, call, b: int, k: int, h: int, w: int) -> dict:
    """One call of the timeline flavour: each section's clock cycles a
    consumer warp (summed over the warps, divided by them) and its share."""
    dll = fn.dll
    dll.dtts_conv_prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 8)()
    with Library(fn), torch.no_grad():
        call()
        torch.cuda.synchronize()
        dll.dtts_conv_prof_clear()
        call()
        torch.cuda.synchronize()
    dll.dtts_conv_prof_read(ctypes.addressof(buf))
    warps = min(cv.wgmma_plan(b, k, h, w, 132)["tiles"], 132) * 4 * cv.WGMMA_TILE[1]
    cycles = [v / warps for v in buf]
    total = sum(cycles)
    print("      timeline, clock cycles a consumer warp: " + "; ".join(
        f"{name} {c:.0f} ({c / total:.1%})" for name, c in zip(PROF_NAMES, cycles)))
    return {name: c for name, c in zip(PROF_NAMES, cycles)}


class Library:
    """The wrapper bound to ``fn`` (a flavour's C entry) while in use."""

    def __init__(self, fn):
        self.fn, self.saved = fn, _launch.bind

    def __enter__(self):
        _launch.bind = lambda *args: self.fn

    def __exit__(self, *exc):
        _launch.bind = self.saved


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
        graphs[i].replay()
        end.record()
        end.synchronize()
        times[i].append(start.elapsed_time(end) / calls)
    del graphs
    torch.cuda.empty_cache()
    return [min(t) for t in times]


def inputs(b, c, k, h, w, epilogue, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed + c + k + h)
    r = lambda shape, s=1.0: (torch.randn(shape, device="cuda", generator=g) * s)
    x, weight = r((b, c, h, w)).bfloat16(), r((k, c, 3, 3), (9 * c) ** -0.5).bfloat16()
    kw = dict(bias=r((k,), 0.1).bfloat16(), gn_scale=1 + 0.5 * r((b, c)), gn_shift=0.1 * r((b, c)))
    if epilogue == "residual":
        kw["residual"] = r((b, k, h, w)).bfloat16()
    if epilogue == "shortcut":
        kw["shortcut"] = (r((b, c, h, w)).bfloat16(), r((k, c), c ** -0.5).bfloat16())
    return x, weight, kw


def up2_row(spec: str, flavours, libs, calls: int) -> dict:
    """One up-conv shape: the wgmma route checked against the twin and
    itself, its device time beside the ring's and the library's, then each
    edited copy's."""
    b, c, k, h, w = (int(v) for v in spec.split("x"))
    g = torch.Generator(device="cuda").manual_seed(c + k + h)
    x = torch.randn((b, c, h, w), device="cuda", generator=g).bfloat16()
    weight = (torch.randn((k, c, 3, 3), device="cuda", generator=g) * (9 * c) ** -0.5).bfloat16()
    bias = (torch.randn((k,), device="cuda", generator=g) * 0.1).bfloat16()
    out, again = cv.conv3x3_up2(x, weight, bias), cv.conv3x3_up2(x, weight, bias)
    ref = cv.conv3x3_up2_plain(x[:1], weight, bias)
    err = ((out[:1].float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    if cv.up2_route(x.dtype, c, k, w) != "wgmma" or not (err <= 2e-2 and torch.equal(out, again)):
        raise AssertionError(f"up2 {spec}: rel err {err:.3e}, two calls equal "
                             f"{torch.equal(out, again)}")
    wg = lambda: cv.conv3x3_up2(x, weight, bias)
    ring = lambda: cv.conv3x3_up2(x, weight, bias, route="ring")
    lib = lambda: F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), weight, bias,
                           padding=1)
    with torch.no_grad():
        dev, ring_dev, lib_dev = graph_ms([wg, ring, lib], calls)
    flops = 32 * b * h * w * c * k
    moved = (x.numel() + weight.numel() + 4 * b * k * h * w) * 2
    bound = max(flops / PEAK_FLOPS, moved / PEAK_BYTES) * 1e3
    row = dict(shape=[b, c, k, h, w], epilogue="up2", max_rel_err=err, device_ms=dev,
               ring_device_ms=ring_dev, library_device_ms=lib_dev, bound_ms=bound,
               tflops=flops / dev / 1e9, plan=cv.up2_wgmma_plan(b, k, h, w, 132), flavours={})
    print(f"up2 {spec}: wgmma {dev:.4f} ms ({row['tflops']:.1f} TFLOP/s), ring {ring_dev:.4f} "
          f"({flops / ring_dev / 1e9:.1f}), interpolate+conv2d {lib_dev:.4f}, bound {bound:.4f}; "
          f"rel err {err:.3e}, two calls bit-identical")
    for fl in flavours:
        with Library(libs[fl]), torch.no_grad():
            ms = graph_ms([wg], calls)[0]
        row["flavours"][fl] = ms
        print(f"    {fl}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
        if fl == "up2_centre_mn":  # a right result: held against the route
            with Library(libs[fl]), torch.no_grad():
                mn = wg()
            row["centre_mn_rel_err"] = ((mn[:1].float() - ref.float()).abs().max()
                                        / ref.float().abs().max()).item()
            print(f"      centre_mn rel err {row['centre_mn_rel_err']:.3e}")
    del x, weight, out, again, ref
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join("x".join(map(str, s)) for s in SHAPES))
    ap.add_argument("--flavours", default=",".join(WGMMA_FLAVOURS))
    ap.add_argument("--ring-flavours", default=",".join(RING_FLAVOURS))
    ap.add_argument("--up2-shapes", default=",".join("x".join(map(str, s)) for s in UP2_SHAPES))
    ap.add_argument("--up2-flavours", default=",".join(UP2_FLAVOURS))
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(gpu)
    built = build.build(("conv3x3",))
    ptxas = [line for _, log in built.values() for line in ptxas_of(log)]
    print("\n".join(ptxas) or "conv3x3 was built already: no ptxas lines")
    wg_flavours = [f for f in args.flavours.split(",") if f]
    ring_flavours = [f for f in args.ring_flavours.split(",") if f]
    up2_flavours = [f for f in args.up2_flavours.split(",") if f]
    libs = build_flavours(wg_flavours + ring_flavours + up2_flavours)

    rows = []
    specs = [spec for spec in args.shapes.split(",") if spec]
    # every shape without and with a residual, then the first with a shortcut
    cases = [(n, spec, epi) for n, spec in enumerate(specs) for epi in ("none", "residual")]
    for n, spec, epilogue in cases + ([(0, specs[0], "shortcut")] if specs else []):
        b, c, k, h, w = (int(v) for v in spec.split("x"))
        x, weight, kw = inputs(b, c, k, h, w, epilogue)
        cres = c if epilogue == "shortcut" else 0
        out = cv.conv3x3_same(x, weight, **kw)
        again = cv.conv3x3_same(x, weight, **kw)
        # the twin on the first image (cuDNN finds no fp32 engine for some
        # whole-batch 1x1 shortcuts; the images are independent)
        first = {key: (v[:1] if key in ("residual", "gn_scale", "gn_shift") else v)
                 for key, v in kw.items()}
        if "shortcut" in kw:
            first["shortcut"] = (kw["shortcut"][0][:1], kw["shortcut"][1])
        ref = cv.conv3x3_same_plain(x[:1], weight, **first)
        err = ((out[:1].float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        if cv.same_route(x.dtype, c, k, w, cres) != "wgmma" or not (
                err <= 2e-2 and torch.equal(out, again)):
            raise AssertionError(f"{spec} {epilogue}: rel err {err:.3e}, two calls equal "
                                 f"{torch.equal(out, again)}")
        del ref
        wg = lambda: cv.conv3x3_same(x, weight, **kw)
        ring = lambda: cv.conv3x3_same(x, weight, route="ring", **kw)
        lib = lambda: F.conv2d(x, weight, kw["bias"], padding=1)
        with torch.no_grad():
            dev, ring_dev, lib_dev = graph_ms([wg, ring, lib], args.calls)
        flops = 2 * b * h * w * (9 * c + cres) * k
        moved = (x.numel() + weight.numel() + b * k * h * w * (
            2 if epilogue == "residual" else 1) + b * cres * h * w + k * cres) * 2
        bound = max(flops / PEAK_FLOPS, moved / PEAK_BYTES) * 1e3
        row = dict(shape=[b, c, k, h, w], epilogue=epilogue, cres=cres, max_rel_err=err,
                   device_ms=dev, ring_device_ms=ring_dev, library_device_ms=lib_dev,
                   bound_ms=bound, tflops=flops / dev / 1e9, flavours={})
        print(f"{spec} {epilogue}: wgmma {dev:.4f} ms ({row['tflops']:.1f} TFLOP/s), ring "
              f"{ring_dev:.4f} ({flops / ring_dev / 1e9:.1f}), cuDNN {lib_dev:.4f}, bound "
              f"{bound:.4f}; rel err {err:.3e}, two calls bit-identical")
        for fl in wg_flavours + (ring_flavours if n == 0 and epilogue == "none" else []):
            call = ring if fl.startswith("ring_") else wg
            with Library(libs[fl]), torch.no_grad():
                ms = graph_ms([call], args.calls)[0]
            row["flavours"][fl] = ms
            print(f"    {fl}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
            if fl == "timeline":
                row["timeline"] = timeline(libs[fl], call, b, k, h, w)
        rows.append(row)
        del x, weight, kw, out, again
        torch.cuda.empty_cache()
    for spec in [spec for spec in args.up2_shapes.split(",") if spec]:
        rows.append(up2_row(spec, up2_flavours, libs, args.calls))
    result = dict(gpu=gpu, ptxas=ptxas, rows=rows)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    print(json.dumps(dict(gpu=gpu, rows=[{k: r[k] for k in (
        "shape", "epilogue", "device_ms", "ring_device_ms", "library_device_ms", "flavours")}
        for r in rows])))


if __name__ == "__main__":
    main()
