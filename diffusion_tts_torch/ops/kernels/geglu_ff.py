"""GEGLU feed-forward: the CUDA kernel and its plain twin.

Replaces diffusion_tts_tpu/ops/pallas/geglu_ff.py::geglu_ff (Pallas
kernels ``_geglu_kernel`` and ``_geglu_stream_kernel``). The source is
``csrc/geglu_ff.cu``; its header says what bounds it on the H100 and what
the design does about that.

Weights are in PyTorch's ``[out, in]`` layout, as ``nn.Linear`` keeps them:
w0 ``[2F, C]`` (h rows, then gate rows), w2 ``[C, F]``; x, the weights and
the biases share one dtype. A CPU tensor goes through the plain PyTorch
version; a CUDA tensor goes through the kernel or the call raises.
``LAUNCHES`` counts kernel launches, two per call (gate, then out). The
kernels are forward-only, as the Pallas ones are; the gradient is autograd's
through the plain twin (``_launch.with_twin_backward``).

Four routes, picked by ``route(dtype, c, f)`` before the launch:
``"wgmma"`` (Hopper's warpgroup products fed by TMA) for bf16 with C and F
multiples of 64, which covers every SD-1.5 width; ``"mma"`` (the first
tensor-core design, mma.sync) for the other bf16 widths, multiples of 8 (the
test nets); ``"tf32x3"`` (the wgmma route's structure in fp32, each product
three tf32 products on the tensor cores) for fp32 with C and F multiples of
32, every SD-1.5 width again; ``"fma"`` (fp32 FMA on the CUDA cores) for the
other fp32 widths (the test nets' C = 40). The tensor-core routes read rows
in 16-byte pieces: bf16 with C or F not a multiple of 8, or an operand not
16-byte aligned, raises before any launch. ``ROUTE_LAUNCHES`` counts
launches per route. A caller may ask for ``route="fma"`` at any shape and
for ``route="mma"`` at any bf16 width the mma route takes, which times the
earlier designs; ``route="wgmma"`` or ``"tf32x3"`` where the predicate does
not give it raises. Nothing falls back from one route to another.

The wgmma route's tiling is ``wgmma_plan(m, c, f, sms)``, the tf32x3
route's ``tf32x3_plan``: tile rows of each launch, launch 2's tile columns
and its split of the depth F where the tiles would not fill the card's SMs
(the split's fp32 partials live in a scratch tensor the wrapper allocates).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from diffusion_tts_torch.ops.kernels import _launch

LAUNCHES_PER_CALL = 2
# The routes, in the order of their codes in csrc/geglu_ff.cu.
ROUTES = _launch.ROUTES + ("wgmma", "tf32x3")
ROUTE_CODES = {r: code for code, r in enumerate(ROUTES)}
WGMMA_MULTIPLE = 64   # C and F of the wgmma route: its TMA boxes are 64 columns
TF32X3_MULTIPLE = 32  # C and F of the tf32x3 route: its TMA boxes are 32 floats
_DEPTH_STEP = 64      # the wgmma route's K per stage and launch 1's tile columns
_TF32_DEPTH = 32      # the tf32x3 route's K per stage
_ARGTYPES = ((_launch.PTR,) * 7 + (_launch.INT,) * 5 + (_launch.PTR,) * 2
             + (_launch.INT,) * 4 + (_launch.PTR,))

LAUNCHES = 0
ROUTE_LAUNCHES = {r: 0 for r in ROUTES}


def route(dtype: torch.dtype, c: int, f: int) -> str:
    """The kernels' route for ``dtype`` and widths C, F: "wgmma" for bf16
    with C and F multiples of 64, "mma" for the other bf16 widths, "tf32x3"
    for fp32 with C and F multiples of 32, "fma" for the other fp32 widths.
    Raises for bf16 with C or F not a multiple of 8, which no tensor-core
    route can take."""
    if dtype != torch.bfloat16:
        tf32 = c % TF32X3_MULTIPLE == 0 and f % TF32X3_MULTIPLE == 0
        return "tf32x3" if dtype == torch.float32 and tf32 else "fma"
    if c % 8 or f % 8:
        raise ValueError(f"geglu_ff: the mma route takes C and F multiples of 8, got C={c}, "
                         f"F={f}")
    return "wgmma" if c % WGMMA_MULTIPLE == 0 and f % WGMMA_MULTIPLE == 0 else "mma"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wgmma_plan(m: int, c: int, f: int, sms: int) -> tuple[int, int, int, int]:
    """(rows1, rows2, bn2, split) of the wgmma route for M rows on a card of
    ``sms`` SMs. rows1, launch 1's tile rows: 64 (one consumer warpgroup,
    two blocks an SM) where 128-row tiles would not give every SM one, else
    128 or 192 (two or three consumers, one block an SM), whichever loads
    fewer rows into the busiest SM (a tile loads its rows of x and 128 rows
    of w0 a depth step: launch 1 is bound by what it reads from L2, and a
    192-row tile reads 17% less a row). rows2 and bn2, launch 2's tile rows and
    columns (128 or 160: C = 320, 640 and 1280 are whole numbers of either
    or both): the pair whose busiest SM has the least work, its tiles
    (rows * bn each) dealt out evenly over the SMs, ties to 128 rows and
    then to 128 columns. split: launch 2's shares of the depth F where its
    tiles fill under a quarter of the block slots (of the SD calls, the
    C = 1280 one at M = 128): one share for every four slots a tile has, at
    most 4 and at least 4 depth steps of 64 a share. The card's times
    chose these rules (tools/torch_geglu_probe.py --sweep)."""
    steps = f // _DEPTH_STEP  # launch 1's column tiles (64 wide) and launch 2's depth steps
    rows1 = 64
    if _cdiv(m, 128) * steps >= sms:
        rows1 = min((128, 192), key=lambda r: _cdiv(_cdiv(m, r) * steps, sms) * (r + 128))
    tiles = lambda rows, bn: _cdiv(m, rows) * _cdiv(c, bn)
    rows2, bn2 = min(((r, b) for r in (128, 64) for b in (128, 160)),
                     key=lambda rb: (_cdiv(tiles(*rb), sms) * rb[0] * rb[1], -rb[0], rb[1]))
    slots = sms * (1 if rows2 == 128 else 2)
    split = max(1, min(slots // (4 * tiles(rows2, bn2)), 4, steps // 4))
    return rows1, rows2, bn2, split


def tf32x3_plan(m: int, c: int, f: int, sms: int) -> tuple[int, int, int, int]:
    """(rows1, rows2, bn2, split) of the tf32x3 route, one block an SM (its
    raw stages and two lo buffers take 148-222 KB). rows1: launch 1's tile
    rows, 64 or 128 (one or two consumer warpgroups: a third would not hold
    the accumulator and the total in its registers), whichever gives the
    busiest SM the fewest rows of x and w0 to load and split (a tile loads
    and splits its rows of x and 128 rows of w0 a depth step). rows2 and
    bn2: launch 2's tile, as ``wgmma_plan`` picks it with one block slot an
    SM. split: launch 2's shares of the depth F, 1 to 4 with at least 8
    depth steps of 32 a share, whichever gives the busiest SM the least
    depth to run (its units times a share's depth), ties to fewer shares: of
    the SD calls the C = 1280 ones at M = 128 (4 shares: 20 tiles) and 512
    (3: 80 tiles). The card's times chose these rules
    (tools/torch_geglu_probe.py --dtype fp32 --sweep)."""
    steps = f // 64  # launch 1's column tiles (64 wide)
    rows1 = min((64, 128), key=lambda r: (_cdiv(_cdiv(m, r) * steps, sms) * (r + 128), r))
    tiles = lambda rows, bn: _cdiv(m, rows) * _cdiv(c, bn)
    rows2, bn2 = min(((r, b) for r in (128, 64) for b in (128, 160)),
                     key=lambda rb: (_cdiv(tiles(*rb), sms) * rb[0] * rb[1], -rb[0], rb[1]))
    n = tiles(rows2, bn2)
    split = min(range(1, max(1, min(4, f // _TF32_DEPTH // 8)) + 1),
                key=lambda s: (_cdiv(n * s, sms) / s, s))
    return rows1, rows2, bn2, split


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def geglu_ff_plain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin with the kernel's cast points (the Pallas
    reference ``_geglu_reference``): fp32 products, the projection rounded
    to x.dtype after its bias, the gelu gate in fp32 (exact erf) rounded
    again, the output rounded once."""
    dtype = x.dtype
    f = w2.shape[1]
    q = F.linear(x.float(), w0.float(), b0.float()).to(dtype)
    h, gate = q[..., :f].float(), q[..., f:].float()
    g = (h * F.gelu(gate)).to(dtype)
    return F.linear(g.float(), w2.float(), b2.float()).to(dtype)


def geglu_ff(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor, *, route: str | None = None) -> torch.Tensor:
    """(h * gelu(gate)) . w2^T + b2 with [h | gate] = x . w0^T + b0.
    x: [..., C]; returns x.shape in x.dtype. ``route``: None takes
    ``route(x.dtype, C, F)``'s; "fma" forces the CUDA-core kernels, "mma"
    the mma.sync ones (bf16)."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w0, b0, w2, b2)
    kernel = functools.partial(_geglu_ff_kernel, forced=route)
    return _launch.with_twin_backward(kernel, geglu_ff_plain, x, w0, b0, w2, b2)


def _pick_route(forced: str | None, dtype: torch.dtype, c: int, f: int) -> str:
    """``forced`` if given (None takes ``route``'s): "fma" at any shape,
    "mma" at any bf16 width it takes, "wgmma" and "tf32x3" only where
    ``route`` gives them."""
    if forced == "fma":
        return "fma"
    want = route(dtype, c, f)
    if forced is None or forced == want or (forced == "mma" and want == "wgmma"):
        return forced or want
    if forced == "mma":
        raise ValueError(f"geglu_ff: the mma route takes bfloat16, got {dtype}")
    if forced == "wgmma":
        raise ValueError(f"geglu_ff: the wgmma route takes bfloat16 with C and F multiples of "
                         f"{WGMMA_MULTIPLE}, got {dtype} at C={c}, F={f}")
    if forced == "tf32x3":
        raise ValueError(f"geglu_ff: the tf32x3 route takes float32 with C and F multiples of "
                         f"{TF32X3_MULTIPLE}, got {dtype} at C={c}, F={f}")
    raise ValueError(f"geglu_ff: route must be one of {ROUTES}, got {forced!r}")


def _geglu_ff_kernel(x, w0, b0, w2, b2, forced: str | None = None):
    global LAUNCHES
    c = x.shape[-1]
    f = w2.shape[-1]
    chosen = _pick_route(forced, x.dtype, c, f)
    for name, t, shape in (("w0", w0, (2 * f, c)), ("b0", b0, (2 * f,)), ("w2", w2, (c, f)),
                           ("b2", b2, (c,))):
        _launch.check(t, name)
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {list(shape)} in {x.dtype}, got "
                             f"{list(t.shape)} in {t.dtype}")
    x2 = x.reshape(-1, c)
    _launch.check(x2, "x")
    m = x2.shape[0]
    g = torch.empty((m, f), dtype=x.dtype, device=x.device)
    out = torch.empty((m, c), dtype=x.dtype, device=x.device)
    if chosen != "fma":
        biases = (b0.data_ptr(), b2.data_ptr()) if chosen != "mma" else ()
        _launch.check_aligned("geglu_ff", (x2.data_ptr(), w0.data_ptr(), w2.data_ptr(),
                                           g.data_ptr(), out.data_ptr(), *biases))
    plan, ws, counters = (0, 0, 0, 1), None, None
    if chosen in ("wgmma", "tf32x3"):
        plan = (wgmma_plan if chosen == "wgmma" else tf32x3_plan)(m, c, f,
                                                                   _sm_count(x.device.index))
        rows2, bn2, split = plan[1:]
        if split > 1:
            ws = torch.empty((split, m, c), dtype=torch.float32, device=x.device)
            counters = torch.empty(_cdiv(m, rows2) * _cdiv(c, bn2), dtype=torch.int32,
                                   device=x.device)
    fn = _launch.bind("geglu_ff", "dtts_geglu_ff", _ARGTYPES)
    err = fn(x2.data_ptr(), w0.data_ptr(), b0.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             g.data_ptr(), out.data_ptr(), _launch.DTYPE_CODES[x.dtype], m, c, f,
             ROUTE_CODES[chosen], None if ws is None else ws.data_ptr(),
             None if counters is None else counters.data_ptr(), *plan, _launch.stream(x))
    _launch.raise_on(err, "geglu_ff")
    LAUNCHES += LAUNCHES_PER_CALL
    ROUTE_LAUNCHES[chosen] += LAUNCHES_PER_CALL
    return out.reshape(x.shape)


def tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [64, 32] . b [32, 32]^T (fp32 CUDA tensors) by four tf32 wgmma
    products whose operands lie in shared memory as the tf32x3 route's do,
    as given: what the tensor cores read of an fp32 value (the route takes
    each operand as it lies for its hi, csrc/geglu_ff.cu's split_stage).
    Not a launch of the route: ``LAUNCHES`` does not count it."""
    for name, t, shape in (("a", a, (64, 32)), ("b", b, (32, 32))):
        _launch.check(t, name)
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {list(shape)} in float32, got {list(t.shape)} "
                             f"in {t.dtype}")
    d = torch.empty((64, 32), dtype=torch.float32, device=a.device)
    _launch.check_aligned("tf32_product", (a.data_ptr(), b.data_ptr(), d.data_ptr()))
    fn = _launch.bind("geglu_ff", "dtts_geglu_tf32_reads", (_launch.PTR,) * 4)
    _launch.raise_on(fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), _launch.stream(a)),
                     "tf32_product")
    return d


__all__ = ["geglu_ff", "geglu_ff_plain", "route", "wgmma_plan", "tf32x3_plan", "tf32_product",
           "LAUNCHES", "LAUNCHES_PER_CALL", "ROUTES", "ROUTE_CODES", "ROUTE_LAUNCHES",
           "WGMMA_MULTIPLE", "TF32X3_MULTIPLE"]
