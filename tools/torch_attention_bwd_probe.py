"""What bounds the attention backward's wide mma form on the card, and the
wgmma route beside it (PyTorch port).

    python3 tools/torch_attention_bwd_probe.py [--batch 32] [--tokens 64,128,256,512]
        [--flavours kernel,no_copies,no_mma,no_ldmatrix] [--reps 50]
        [--adm 16:1024:6,16:256:9,16:64:12] [--json PATH]

Builds ``diffusion_tts_torch/csrc/attention_bwd.cu`` with nvcc into
``build/probe/`` once per flavour, each with one more exported C function
that launches the wide form's dQ kernel, its dK/dV kernel or both at a
chosen block shape, and times the raw launches with CUDA events at
``[batch, T, 768]``: the qkv form with one head of 256, the CIFAR-10
DDPM++ net's attention, with blocks of 64 and of 32 rows (the route picks
one from the grid).
Flavours, each stripped of one kind of work to see how much of the time
it holds (their gradients are wrong by design; only "kernel" is checked,
bit for bit, against the wrapper's):
  kernel       the source as it is;
  no_copies    no cp.async of the streamed tiles after the first;
  no_mma       every mma.sync replaced by a register add;
  no_ldmatrix  every ldmatrix fragment load replaced by register moves.
Then, at each T, the device time (torch.profiler, the sum of the kernels'
device times over 20 calls) of the wrapper's whole call
(``qkv_self_attention_bwd``) on its own route, wgmma (the two launches,
delta computed in the first), and on the mma route forced (the row term
delta in PyTorch and the two launches), and of the library's backward
(``torch.autograd.grad`` through ``scaled_dot_product_attention`` on the
same q, k, v and gradient), which leaves out the host time that the event
timings of chip_smoke.py's rows read at these small shapes; the same lines
at d = 64 for ``--adm``'s (batch, T, heads), the ADM training sites; the
wgmma route's time is also split between its dQ and dK/dV kernels.
Only the "kernel" flavour is checked, bit for bit, against the wrapper's
forced mma route. Prints the card's name and power limit, ptxas's
registers and spills of each wide kernel, one line per (flavour, rows, T)
and per shape, and one JSON object last. Needs an NVIDIA card; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffusion_tts_torch.ops.kernels import build  # noqa: E402
from diffusion_tts_torch.ops.kernels import qkv_attention as qk  # noqa: E402

D = 256
ROWS = (64, 32)
OUT_DIR = build.BUILD_DIR.parent / "probe"

ENTRY = """
namespace {
template <int BM>
int probe_launch(int which, const void* const* p, int b, int t, const int64_t* s, float sl2e,
                 float scale) {
  using C = WideShape<%(d)d, BM>;
  static_assert(C::kFits, "shape");
  cudaFuncSetAttribute(dq_wide_kernel<%(d)d, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::kDqSmem);
  cudaFuncSetAttribute(dkv_wide_kernel<%(d)d, BM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDkvSmem);
  dim3 grid((t + BM - 1) / BM, 1, b);
  const bf16 *q = (const bf16*)p[0], *k = (const bf16*)p[1], *v = (const bf16*)p[2],
             *g = (const bf16*)p[3];
  if (which & 1)
    dq_wide_kernel<%(d)d, BM><<<grid, C::kThreads, C::kDqSmem>>>(
        q, k, v, g, (const float*)p[4], (const float*)p[5], (bf16*)p[6], t, s[0], s[1], s[2],
        s[3], s[4], s[5], s[6], s[7], s[8], sl2e, scale);
  if (which & 2)
    dkv_wide_kernel<%(d)d, BM><<<grid, C::kThreads, C::kDkvSmem>>>(
        q, k, v, g, (const float*)p[4], (const float*)p[5], (bf16*)p[7], (bf16*)p[8], t, s[0],
        s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], sl2e, scale);
  return (int)cudaGetLastError();
}
}  // namespace

// which: 1 = dQ, 2 = dK/dV, 3 = both; p: q, k, v, g, lse, delta, dq, dk, dv;
// s: the (batch, token, head) strides of q/k/v, of g and of the results.
extern "C" int probe(int shape, int which, const void* const* p, int b, int t, const int64_t* s,
                     float sl2e, float scale) {
  switch (shape) {
%(cases)s
  }
  return -1;
}
"""

FAKES = """
__device__ __forceinline__ void fake_mma(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  d[0] += __uint_as_float(a[0] ^ b0);
  d[1] += __uint_as_float(a[1] ^ b1);
}
__device__ __forceinline__ void fake_ld(uint32_t (&r)[4], const bf16*, int pitch, int r0,
                                        int c0, int lane) {
  r[0] = r0 + lane, r[1] = c0 + lane, r[2] = pitch, r[3] = 3 * lane;
}
"""

WIDE_MARK = "// ------------------------------------------------- mma route, the wide form"
FAKES_AFTER = "using bf16 = __nv_bfloat16;\n"


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"the probe's flavour no longer matches the source: {old!r}")
    return text.replace(old, new)


def flavours(src: str) -> dict[str, str]:
    """The source of each flavour. The copies are the wide form's own; the
    mma and ldmatrix calls are stripped everywhere (the wide form shares
    accumulate_mma with the narrow one, and only the wide kernels run)."""
    head, wide = src[:src.index(WIDE_MARK)], src[src.index(WIDE_MARK):]
    for buf, base in (("ks", "kb"), ("vs", "vb"), ("qs", "qb"), ("gs", "gb")):
        stem = f"copy_rows<D, BN, NT>({buf} + nx * BN * P, {base},"
        wide = _replace(wide, stem, "if (false) " + stem)
    faked = _replace(src, FAKES_AFTER, FAKES_AFTER + FAKES)
    no_ld = faked
    for fn in ("load_a", "load_b2", "load_b2_trans"):
        no_ld = _replace(no_ld, f"dtts::{fn}(", "fake_ld(")
    return {"kernel": src, "no_copies": head + wide,
            "no_mma": _replace(faked, "dtts::mma_bf16(", "fake_mma("), "no_ldmatrix": no_ld}


def build_all(names) -> dict[str, ctypes._CFuncPtr]:
    """One library per flavour, nvcc all at once; prints ptxas's lines of
    the wide kernels."""
    src = build.CSRC.joinpath("attention_bwd.cu").read_text()
    cases = "\n".join(f"    case {i}: return probe_launch<{bm}>(which, p, b, t, s, sl2e, scale);"
                      for i, bm in enumerate(ROWS))
    entry = ENTRY % {"d": D, "cases": cases}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in flavours(src).items():
        if name not in names:
            continue
        cu, lib = OUT_DIR / f"{name}.cu", OUT_DIR / f"lib{name}.so"
        cu.write_text(text + entry)
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} flavour:\n{log}")
        current = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"(dq|dkv)_wide_kernelILi(\d+)ELi(\d+)E", line)
                current = m and f"{m.group(1)} d={m.group(2)} {m.group(3)} rows"
            elif current and ("Used" in line or "spill" in line):
                print(f"ptxas {name} {current}: {line.strip()}")
        fn = ctypes.CDLL(str(lib)).probe
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_float, ctypes.c_float]
        fns[name] = fn
    return fns


def events_ms(fn, reps: int) -> float:
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


def device_ms(fn, reps: int = 20) -> float:
    """Device ms of one call of fn: the kernels' device time summed over
    ``reps`` calls under torch.profiler, divided by ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages())
    if not total:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / reps / 1e3


def kernel_device_ms(fn, reps: int = 20) -> dict[str, float]:
    """Device ms of one call of fn by kernel: the two wgmma launches' share
    (dq_wgmma_kernel, dkv_wgmma_kernel) and the rest."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        name = next((k for k in ("dq_wgmma", "dkv_wgmma") if k in e.key), "other")
        out[name] = out.get(name, 0.0) + e.self_device_time_total / reps / 1e3
    return out


def route_device_times(qkv, out, g, lse, heads: int, d: int) -> dict:
    """Device ms of one backward call at [B, T, 3C] on the wgmma route (and
    of its two kernels), on the mma route forced, and of the library's
    backward on the same inputs."""
    b, t, c3 = qkv.shape
    c = c3 // 3

    def wrapper(route=None):
        dqkv = torch.empty_like(qkv)
        qk._launch_bwd(*qk._thirds(qkv, c), out, g, lse, *qk._thirds(dqkv, c), d, b, heads, t,
                       (t * c3, c3, d), (t * c3, c3, d), route)
        return dqkv

    if not torch.equal(wrapper(), qk.qkv_self_attention_bwd(qkv, out, g, heads, lse)):
        raise AssertionError("the probe's wgmma call differs from the wrapper's")
    q, k, v = (x.reshape(b, t, heads, d).transpose(1, 2).contiguous().requires_grad_(True)
               for x in qkv.chunk(3, dim=-1))
    lo = F.scaled_dot_product_attention(q, k, v)
    lg = g.reshape(b, t, heads, d).transpose(1, 2).contiguous()
    library = lambda: torch.autograd.grad(lo, (q, k, v), lg, retain_graph=True)
    plan = qk.bwd_wgmma_plan(d)
    dev = dict(shape=[b, t, c3], heads=heads, d=d, plan=list(plan),
               wgmma_device_ms=device_ms(wrapper), mma_device_ms=device_ms(lambda: wrapper("mma")),
               library_device_ms=device_ms(library))
    dev["wgmma_kernels_ms"] = kernel_device_ms(wrapper)
    print(f"device time {dev['shape']} d={d}: wgmma {dev['wgmma_device_ms'] * 1e3:.1f} us "
          f"(plan {plan}), mma {dev['mma_device_ms'] * 1e3:.1f} us, the library's backward "
          f"{dev['library_device_ms'] * 1e3:.1f} us; wgmma by kernel "
          f"{({k: round(v * 1e3, 1) for k, v in dev['wgmma_kernels_ms'].items()})}", flush=True)
    return dev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tokens", default="64,128,256,512")
    ap.add_argument("--flavours", default="kernel,no_copies,no_mma,no_ldmatrix")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--adm", default="16:1024:6,16:256:9,16:64:12",
                    help="batch:T:heads of the d = 64 device-time lines ('' for none)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_attention_bwd_probe: needs an NVIDIA card")
    tag = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(tag)
    fns = build_all(args.flavours.split(","))
    rows, devices, b = [], [], args.batch
    for t in (int(x) for x in args.tokens.split(",")):
        gen = torch.Generator(device="cuda").manual_seed(t)
        qkv = torch.randn((b, t, 3 * D), device="cuda", generator=gen).bfloat16()
        g = torch.randn((b, t, D), device="cuda", generator=gen).bfloat16()
        lse = torch.empty((b, 1, t), device="cuda")
        out = qk._qkv_forward(qkv, 1, lse)
        want = qk.qkv_self_attention_bwd(qkv, out, g, 1, lse, route="mma")
        # the row term as the wrapper computes it (ops/kernels/qkv_attention.py::_launch_bwd)
        delta = (g.float() * out.float()).reshape(b, t, 1, D).sum(dim=-1)
        delta = delta.permute(0, 2, 1).contiguous()
        dqkv = torch.empty_like(qkv)
        item = qkv.element_size()
        ptrs = (ctypes.c_void_p * 9)(
            *(qkv.data_ptr() + i * D * item for i in range(3)), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(dqkv.data_ptr() + i * D * item for i in range(3)))
        strides = (ctypes.c_int64 * 9)(t * 3 * D, 3 * D, D, t * D, D, D, t * 3 * D, 3 * D, D)
        ops = 14 * b * t * t * D
        for name, fn in fns.items():
            for shape, bm in enumerate(ROWS):
                def call(which, fn=fn, shape=shape):
                    err = fn(shape, which, ptrs, b, t, strides, qk._LOG2E / D ** 0.5, 1 / D ** 0.5)
                    if err:
                        raise RuntimeError(f"probe launch failed: cudaError {err}")
                call(3)
                torch.cuda.synchronize()
                row = dict(flavour=name, rows=bm, shape=[b, t, 3 * D],
                           ms=events_ms(lambda: call(3), args.reps),
                           dq_ms=events_ms(lambda: call(1), args.reps),
                           dkv_ms=events_ms(lambda: call(2), args.reps))
                row["tflops"] = ops / row["ms"] / 1e9
                if name == "kernel" and not torch.equal(dqkv, want):
                    raise AssertionError(f"the {bm}-row blocks differ from the wrapper's "
                                         f"gradient at {row['shape']}")
                rows.append(row)
                print(f"{name:>11} {bm}-row blocks {row['shape']}: both "
                      f"{row['ms'] * 1e3:.1f} us ({row['tflops']:.1f} TFLOP/s), dq "
                      f"{row['dq_ms'] * 1e3:.1f} us, dkv {row['dkv_ms'] * 1e3:.1f} us", flush=True)
        devices.append(route_device_times(qkv, out, g, lse, 1, D))
    for shape in args.adm.split(",") if args.adm else ():
        b64, t, heads = (int(x) for x in shape.split(":"))
        gen = torch.Generator(device="cuda").manual_seed(t)
        qkv = torch.randn((b64, t, 3 * heads * 64), device="cuda", generator=gen).bfloat16()
        g = torch.randn((b64, t, heads * 64), device="cuda", generator=gen).bfloat16()
        lse = torch.empty((b64, heads, t), device="cuda")
        out = qk._qkv_forward(qkv, heads, lse)
        devices.append(route_device_times(qkv, out, g, lse, heads, 64))
    result = {"gpu": tag, "rows": rows, "device": devices}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
