"""3x3 SAME conv with a GroupNorm+SiLU prologue and a fused epilogue, and
nearest-2x upsample + 3x3 conv: the CUDA kernels, their plain twins and the
routing predicates.

Replaces diffusion_tts_tpu/ops/pallas/conv3x3.py::conv3x3_same (Pallas
kernels ``_conv3_stacked_kernel`` / ``_conv3_kernel``) and ::conv3x3_up2
(``_conv3_up2_kernel``). The source is ``csrc/conv3x3.cu``; its header says
what bounds the kernels on the H100 and what the design does about that.

The functions keep the port's layout: x ``[B, C, H, W]`` contiguous, the
weight ``nn.Conv2d``'s ``[K, C, 3, 3]``, residual and output ``[B, K, H, W]``,
the shortcut input ``[B, Cres, H, W]`` with its 1x1 weight ``[K, Cres]``
(the JAX package's are NHWC / HWIO). Any C, K, H and W are taken. Numerics,
in both the kernels and the twins:

  * the prologue is ``silu(float(x) * scale + shift)`` in fp32 with
    per-(batch, channel) fp32 scale/shift, rounded to the activation dtype
    before the product;
  * SAME padding pads the normalized input: a tap outside the image
    contributes 0, not ``silu(shift)``;
  * activation-dtype operands, fp32 accumulation; bias, residual and the 1x1
    shortcut product are added in fp32 and the result is rounded once.
    (``nn.Conv2d`` followed by an add rounds twice in bf16: the two routes
    differ by a bf16 ulp, and the twin follows the kernel.);
  * up2 folds the 3x3 taps into the four 2x2 phase kernels in fp32 and
    rounds them once to the activation dtype (``ops/resample.py``).

A CPU tensor goes through the plain twin; a CUDA tensor goes through the
kernel or the call raises. Each call repacks its weight into the kernel's
``[tap, K, C]`` layout with a tensor copy (up2: folds the phase kernels
first); those are not kernel launches. ``SAME_LAUNCHES`` and
``UP2_LAUNCHES`` count kernel launches, one per call. The kernels are
forward-only, as the Pallas ones are; the gradient is autograd's through the
plain twin (``_launch.with_twin_backward``), the counterpart of the JAX
package's ``custom_vjp`` over the jnp reference.

Three designs, picked before the launch and passed to the C entry as an
int. ``conv3x3_same`` takes ``same_route(dtype, c, k, w, cres)``:
``"wgmma"`` (bf16 with C a multiple of 16, Cres of 32 and W of 8: every
shape of the SD decoder and encoder; Hopper's warpgroup products fed by TMA,
the prologue applied by the consumer warps between their products,
persistent blocks, a TMA-stored epilogue), else what
``conv_route`` gives. ``conv3x3_up2`` takes ``up2_route(dtype, c, k, w)``:
``"wgmma"`` (bf16 with C a multiple of 16 and W of 8: every up-conv of the
SD decoder; the same machinery with one consumer warpgroup per row phase,
both column phases' accumulators in its registers and the columns
interleaved in the epilogue), else what ``conv_route`` gives.
``conv_route`` gives ``"ring"`` (bf16 with C and Cres multiples of 16 and W
a multiple of 8; a ring of ``cp.async`` stages, ``ldmatrix`` fragments, an
epilogue through shared memory) or ``"v1"`` (the first design: fp32 on the
CUDA cores, and bf16 at ragged C, Cres or W). The wgmma and ring routes
read rows in 16-byte pieces and refuse, before any launch, a pointer that
is not 16-byte aligned. ``SAME_ROUTE_LAUNCHES`` and ``UP2_ROUTE_LAUNCHES``
count launches per route. ``route=`` forces one: "v1" at any shape, "ring"
only where ``conv_route`` gives it (chip_smoke.py times the ring beside
wgmma on both functions), "wgmma" only where ``same_route`` /
``up2_route`` gives it (else ``ValueError`` before any launch). Nothing
falls back from one route to another. On the CPU the route is accepted and
the plain twin runs. ``wgmma_plan`` and ``up2_wgmma_plan`` give the wgmma
routes' tiles, persistent blocks and shared memory for a call.

Routing to the kernels (counterparts of ``pallas_conv3_shape_eligible``,
``pallas_conv3_eligible``, ``pallas_shortcut_eligible`` and
``pallas_up2_eligible``). Kept, so that the port launches where the JAX
package does: a 3x3 kernel, C and K multiples of 128, H and W at least
``MIN_SPATIAL`` (96), an up2 source of at least ``UP2_MIN_SPATIAL`` (64),
Cres a multiple of 128. Dropped, because they describe the TPU and not the
function: the backend test, ``w % 16`` and ``h % 2`` (tiling rules of the
Pallas kernels; these kernels mask ragged edges). The predicates look at
shapes only, never at the device: on the CPU the same route runs through
the twins. ``DTTS_NO_CONV_KERNELS=1``, read once at import, turns all three
routes off (the counterpart of the JAX package's ``DTTS_NO_PALLAS_CONV``):
every 3x3 conv is then cuDNN, every GroupNorm standalone, and the
upsamplers go through ``ops/resample.py``.
"""
from __future__ import annotations

import contextlib
import functools
import os

import torch
import torch.nn.functional as F

from diffusion_tts_torch.ops.kernels import _launch
from diffusion_tts_torch.ops.resample import interleave_phases, phase_kernels

MIN_SPATIAL = 96
UP2_MIN_SPATIAL = 64
CHANNEL_MULTIPLE = 128
_NO_CONV_KERNELS = os.environ.get("DTTS_NO_CONV_KERNELS", "") not in ("", "0")

_SAME_ARGTYPES = (_launch.PTR,) * 9 + (_launch.INT,) * 8 + (_launch.PTR,)
_UP2_ARGTYPES = (_launch.PTR,) * 4 + (_launch.INT,) * 7 + (_launch.PTR,)

# The kernels' designs, by their route code in csrc/conv3x3.cu.
ROUTES = ("v1", "ring", "wgmma")
RING_CHANNEL_MULTIPLE = 16  # C and Cres
RING_WIDTH_MULTIPLE = 8  # W: whole 16-byte chunks of a bf16 row
# The wgmma route's conditions (beside bf16): C a multiple of its conv stage's
# 16 channels, Cres of its shortcut stage's 32, W of 8 (16-byte rows for TMA).
WGMMA_CHANNEL_MULTIPLE = 16
WGMMA_SHORTCUT_MULTIPLE = 32
WGMMA_WIDTH_MULTIPLE = 8
# Its tile (output channels, rows, columns) and rings (weight slots, raw
# slots, operand patches), as the source defines them (kWgM, kWgNC, kWgCols;
# kWgSw, kWgSx, kWgP).
WGMMA_TILE = (64, 3, 128)
WGMMA_RINGS = (4, 2, 2)
SMEM_PER_BLOCK = 232448  # bytes a block may have on an H100
# The up-conv's wgmma route (kUpChannels, kUpWidth): bf16, C a multiple of 16,
# W of 8. Its tile is 64 channels x SR source rows x 128 / SR columns, SR = 2
# up to a source width of UP2_NARROW_WIDTH (kUpNarrow), else 1; its rings
# (kUpSw, kUpSx, kUpP) and consumer warpgroups (kUpNC, one per row phase).
UP2_WGMMA_CHANNEL_MULTIPLE = 16
UP2_WGMMA_WIDTH_MULTIPLE = 8
UP2_NARROW_WIDTH = 64
UP2_WGMMA_RINGS = (3, 2, 2)
UP2_WGMMA_CONSUMERS = 2

SAME_LAUNCHES = 0
UP2_LAUNCHES = 0
SAME_ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
UP2_ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


# ------------------------------------------------------------------ routing


def conv3_shape_eligible(h: int, w: int, c: int, k: int) -> bool:
    """Whether a 3x3 stride-1 conv of C -> K channels at H x W takes the
    kernel (and its GroupNorm the fold into the prologue)."""
    if _NO_CONV_KERNELS or c % CHANNEL_MULTIPLE or k % CHANNEL_MULTIPLE:
        return False
    return h >= MIN_SPATIAL and w >= MIN_SPATIAL


def conv3_eligible(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """x [B, C, H, W], weight [K, C, kh, kw]."""
    if tuple(weight.shape[2:]) != (3, 3):
        return False
    return conv3_shape_eligible(x.shape[2], x.shape[3], x.shape[1], weight.shape[0])


def shortcut_eligible(cres: int) -> bool:
    """Whether a 1x1 shortcut of Cres input channels folds into an eligible
    conv's epilogue."""
    return cres % CHANNEL_MULTIPLE == 0


def up2_eligible(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """x [B, C, H, W] is the un-upsampled source; weight [K, C, kh, kw]."""
    if _NO_CONV_KERNELS or tuple(weight.shape[2:]) != (3, 3):
        return False
    if x.shape[1] % CHANNEL_MULTIPLE or weight.shape[0] % CHANNEL_MULTIPLE:
        return False
    return x.shape[2] >= UP2_MIN_SPATIAL and x.shape[3] >= UP2_MIN_SPATIAL


def conv_route(dtype: torch.dtype, c: int, k: int, w: int, cres: int = 0) -> str:
    """The kernels' design for a call of C -> K channels at width W with a
    shortcut of Cres channels (0: none): "ring" for bf16 with C and Cres
    multiples of 16 and W a multiple of 8, else "v1". K and H do not enter:
    both designs mask a ragged last block of output channels or rows."""
    if (dtype == torch.bfloat16 and c % RING_CHANNEL_MULTIPLE == 0
            and cres % RING_CHANNEL_MULTIPLE == 0 and w % RING_WIDTH_MULTIPLE == 0):
        return "ring"
    return "v1"


def same_route(dtype: torch.dtype, c: int, k: int, w: int, cres: int = 0) -> str:
    """``conv3x3_same``'s design for a call of C -> K channels at width W
    with a shortcut of Cres channels (0: none): "wgmma" for bf16 with C a
    multiple of 16, Cres of 32 and W of 8, else ``conv_route``'s. K and H do
    not enter: the tiles mask a ragged last block of channels or rows."""
    if (dtype == torch.bfloat16 and c % WGMMA_CHANNEL_MULTIPLE == 0
            and cres % WGMMA_SHORTCUT_MULTIPLE == 0 and w % WGMMA_WIDTH_MULTIPLE == 0):
        return "wgmma"
    return conv_route(dtype, c, k, w, cres)


def up2_route(dtype: torch.dtype, c: int, k: int, w: int) -> str:
    """``conv3x3_up2``'s design for a call of C -> K channels at source width
    W: "wgmma" for bf16 with C a multiple of 16 and W of 8, else
    ``conv_route``'s. K and H do not enter: TMA clips a ragged last block of
    channels or rows."""
    if (dtype == torch.bfloat16 and c % UP2_WGMMA_CHANNEL_MULTIPLE == 0
            and w % UP2_WGMMA_WIDTH_MULTIPLE == 0):
        return "wgmma"
    return conv_route(dtype, c, k, w)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wgmma_plan(b: int, k: int, h: int, w: int, sms: int) -> dict:
    """The wgmma route's launch for a call: its tiles (64 channels x 3 rows
    x 128 columns of one image), the persistent blocks (one an SM, at most
    one a tile) and the dynamic shared memory a block takes (1024 bytes of
    alignment slack, the rings, the epilogue's staging tiles and the
    mbarriers), as csrc/conv3x3.cu computes them."""
    m, rows, cols = WGMMA_TILE
    sw, sx, sp = WGMMA_RINGS
    tiles = b * _cdiv(h, rows) * _cdiv(w, cols) * _cdiv(k, m)
    weights = 9 * m * WGMMA_CHANNEL_MULTIPLE * 2
    raw = max(WGMMA_CHANNEL_MULTIPLE * (rows + 2) * (cols + 24) * 2,
              rows * 2 * WGMMA_SHORTCUT_MULTIPLE * 64 * 2)
    patch = 2 * (rows + 2) * (cols + 16) * 16
    staging = rows * m * cols * 2  # the epilogue's, one output row of bf16 a consumer
    smem = 1024 + sw * weights + sx * raw + staging + sp * patch + 16 * (sw + sx + sp) + 8 * rows
    return {"tiles": tiles, "blocks": min(tiles, sms), "smem_bytes": smem}


def up2_wgmma_plan(b: int, k: int, h: int, w: int, sms: int) -> dict:
    """The up-conv's wgmma route for a call at source size H x W: its source
    rows and columns a tile (SR, 128 / SR with SR = 2 up to W = 64, else 1),
    its tiles (64 channels x SR x 128 / SR of one image), the persistent
    blocks (one an SM, at most one a tile) and the dynamic shared memory a
    block takes (1024 bytes of alignment slack, the rings sized for SR = 1,
    the two warpgroups' staging tiles of 64 channels x 256 output columns and
    the mbarriers), as csrc/conv3x3.cu computes them."""
    m, sw, sx, sp = WGMMA_TILE[0], *UP2_WGMMA_RINGS
    rows = 2 if w <= UP2_NARROW_WIDTH else 1
    cols = WGMMA_TILE[2] // rows
    tiles = b * _cdiv(h, rows) * _cdiv(w, cols) * _cdiv(k, m)
    weights = 16 * m * UP2_WGMMA_CHANNEL_MULTIPLE * 2  # 4 phases x 4 taps
    raw = 15 * 1024  # the larger of the two raw boxes (3 x 152 x 16, 5 x 88 x 16), rounded up
    patch = 2 * 3 * (WGMMA_TILE[2] + 16) * 16
    staging = UP2_WGMMA_CONSUMERS * m * 256 * 2
    smem = 1024 + sw * weights + sx * raw + staging + sp * patch + 16 * (sw + sx + sp)
    return {"rows": rows, "cols": cols, "tiles": tiles, "blocks": min(tiles, sms),
            "smem_bytes": smem}


def _pick_route(name: str, route: str | None, dtype: torch.dtype, c: int, k: int, w: int,
                cres: int = 0) -> str:
    """``route`` if given (None takes the predicate's: ``same_route`` for
    conv3x3_same, ``up2_route`` for conv3x3_up2): "v1" at any shape, "ring"
    only where ``conv_route`` gives it, "wgmma" only where the function's
    predicate gives it."""
    same = name == "conv3x3_same"
    want = same_route(dtype, c, k, w, cres) if same else up2_route(dtype, c, k, w)
    if route is None:
        return want
    if route not in ROUTES:
        raise ValueError(f"{name}: route must be one of {ROUTES}, got {route!r}")
    if route == "ring" and conv_route(dtype, c, k, w, cres) != "ring":
        raise ValueError(f"{name}: the ring route takes bfloat16 with C and Cres multiples of "
                         f"{RING_CHANNEL_MULTIPLE} and W a multiple of {RING_WIDTH_MULTIPLE}, "
                         f"got {dtype}, C={c}, Cres={cres}, W={w}")
    if route == "wgmma" and want != "wgmma":
        if same:
            raise ValueError(f"{name}: the wgmma route takes conv3x3_same in bfloat16 with C a "
                             f"multiple of {WGMMA_CHANNEL_MULTIPLE}, Cres of "
                             f"{WGMMA_SHORTCUT_MULTIPLE} and W of {WGMMA_WIDTH_MULTIPLE}, got "
                             f"{name}, {dtype}, C={c}, Cres={cres}, W={w}")
        raise ValueError(f"{name}: the wgmma route takes bfloat16 with C a multiple of "
                         f"{UP2_WGMMA_CHANNEL_MULTIPLE} and W of {UP2_WGMMA_WIDTH_MULTIPLE}, "
                         f"got {dtype}, C={c}, W={w}")
    return route


# ------------------------------------------------------------- plain twins


@contextlib.contextmanager
def _fp32_convs():
    """cuDNN's fp32 convolutions in full fp32 (it takes TF32 by default)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def conv3x3_same_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                       residual: torch.Tensor | None = None, *,
                       gn_scale: torch.Tensor | None = None,
                       gn_shift: torch.Tensor | None = None,
                       shortcut: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """Plain PyTorch twin of ``conv3x3_same`` with its numerics: prologue in
    fp32 rounded to x.dtype, the conv of the upcast operands in fp32 (TF32
    off), bias, residual and shortcut product added in fp32, one rounding."""
    if gn_scale is not None:
        xn = x.float() * gn_scale.float()[:, :, None, None] + gn_shift.float()[:, :, None, None]
        x = F.silu(xn).to(x.dtype)
    with _fp32_convs():
        out = F.conv2d(x.float(), weight.float(), padding=1)
        if bias is not None:
            out = out + bias.float().view(1, -1, 1, 1)
        if residual is not None:
            out = out + residual.float()
        if shortcut is not None:
            sc_x, sc_w = shortcut
            out = out + F.conv2d(sc_x.float(), sc_w.float()[:, :, None, None])
    return out.to(x.dtype)


def conv3x3_up2_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of ``conv3x3_up2``: ``nn_upsample2x_conv3x3``
    (ops/resample.py) with fp32 accumulation: the phase kernels folded in
    fp32 and rounded to weight.dtype, the four phase convs of the upcast
    operands in fp32 (TF32 off), + bias in fp32, one rounding."""
    b, _, h, w = x.shape
    with _fp32_convs():
        out = F.conv2d(F.pad(x.float(), (1, 1, 1, 1)), phase_kernels(weight).float())
    y = interleave_phases(out, h, w)
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1)
    return y.to(x.dtype)


# ---------------------------------------------------------------- wrappers


def _like(t: torch.Tensor, x: torch.Tensor, shape: tuple, name: str) -> torch.Tensor:
    """``t`` checked against ``shape``, ``x``'s dtype and device."""
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
    if t.dtype != x.dtype or t.device != x.device:
        raise TypeError(f"{name} must be {x.dtype} on {x.device}, got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")
    return t


def _check_conv(x: torch.Tensor, weight: torch.Tensor, bias, name: str) -> tuple[int, ...]:
    if x.ndim != 4 or weight.ndim != 4 or tuple(weight.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"{name}: x must be [B, C, H, W] and weight [K, C, 3, 3], got "
                         f"{list(x.shape)} and {list(weight.shape)}")
    b, c, h, w = x.shape
    k = weight.shape[0]
    if x.device.type != "cpu":
        _launch.check(x, name)
        _like(weight, x, (k, c, 3, 3), "weight")
        if bias is not None:
            _like(bias, x, (k,), "bias")
    return b, c, h, w, k


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def conv3x3_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None, *,
                 gn_scale: torch.Tensor | None = None, gn_shift: torch.Tensor | None = None,
                 shortcut: tuple[torch.Tensor, torch.Tensor] | None = None,
                 route: str | None = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv of x [B, C, H, W] with weight [K, C, 3, 3],
    fp32 accumulation, output [B, K, H, W] in x.dtype. Optional prologue:
    with fp32 ``gn_scale``/``gn_shift`` [B, C] (GroupNorm folded by the
    caller: scale = rstd * gamma, shift = beta - mean * scale) the conv is of
    silu(x * scale + shift), and the normalized tensor never reaches device
    memory. Optional epilogue: + bias [K], then + residual [B, K, H, W] or
    + the 1x1 projection of ``shortcut = (sc_x [B, Cres, H, W], sc_w
    [K, Cres])`` (its own bias folded into ``bias`` by the caller).
    ``route``: None takes ``same_route``'s; "v1", "ring" or "wgmma" forces
    one."""
    if (gn_scale is None) != (gn_shift is None):
        raise ValueError("gn_scale and gn_shift must be given together")
    if shortcut is not None and residual is not None:
        raise ValueError("shortcut and residual exclude each other (the shortcut is the skip)")
    _check_conv(x, weight, bias, "conv3x3_same")
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, weight, bias, residual, gn_scale=gn_scale,
                                  gn_shift=gn_shift, shortcut=shortcut)
    sc_x, sc_w = shortcut if shortcut is not None else (None, None)
    kernel = functools.partial(_same_kernel, route=route)
    return _launch.with_twin_backward(kernel, _same_plain, x, weight, bias, residual,
                                      gn_scale, gn_shift, sc_x, sc_w)


def _same_plain(x, weight, bias, residual, gn_scale, gn_shift, sc_x, sc_w):
    return conv3x3_same_plain(x, weight, bias, residual, gn_scale=gn_scale, gn_shift=gn_shift,
                              shortcut=None if sc_x is None else (sc_x, sc_w))


def _same_kernel(x, weight, bias, residual, gn_scale, gn_shift, sc_x, sc_w,
                 route: str | None = None):
    global SAME_LAUNCHES
    b, c, h, w = x.shape
    k = weight.shape[0]
    if residual is not None:
        _like(residual, x, (b, k, h, w), "residual")
    if gn_scale is not None:
        if tuple(gn_scale.shape) != (b, c) or tuple(gn_shift.shape) != (b, c):
            raise ValueError(f"gn_scale and gn_shift must be [B, C] = [{b}, {c}], got "
                             f"{list(gn_scale.shape)} and {list(gn_shift.shape)}")
        gn_scale = gn_scale.to(device=x.device, dtype=torch.float32).contiguous()
        gn_shift = gn_shift.to(device=x.device, dtype=torch.float32).contiguous()
    cres = 0
    if sc_x is not None:
        cres = sc_x.shape[1]
        _like(sc_x, x, (b, cres, h, w), "shortcut input")
        _like(sc_w, x, (k, cres), "shortcut weight")
    route = _pick_route("conv3x3_same", route, x.dtype, c, k, w, cres)
    packed = weight.permute(2, 3, 0, 1).contiguous()  # [3, 3, K, C]: tap-major rows of C
    out = torch.empty((b, k, h, w), dtype=x.dtype, device=x.device)
    if route in ("ring", "wgmma"):
        _launch.check_aligned("conv3x3_same", [t.data_ptr() for t in (
            x, packed, residual, gn_scale, gn_shift, sc_x, sc_w, out) if t is not None])
    fn = _launch.bind("conv3x3", "dtts_conv3x3_same", _SAME_ARGTYPES)
    err = fn(x.data_ptr(), packed.data_ptr(), _ptr(bias), _ptr(residual), _ptr(gn_scale),
             _ptr(gn_shift), _ptr(sc_x), _ptr(sc_w), out.data_ptr(),
             _launch.DTYPE_CODES[x.dtype], b, c, k, h, w, cres, ROUTES.index(route),
             _launch.stream(x))
    _launch.raise_on(err, "conv3x3_same")
    SAME_LAUNCHES += 1
    SAME_ROUTE_LAUNCHES[route] += 1
    return out


def conv3x3_up2(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, *,
                route: str | None = None) -> torch.Tensor:
    """conv3x3_pad1(nearest_upsample_2x(x)) for x [B, C, H, W] and weight
    [K, C, 3, 3], as the four 2x2 phase convs on the un-upsampled input with
    fp32 accumulation, written straight to [B, K, 2H, 2W] in x.dtype.
    ``route``: None takes ``up2_route``'s; "v1", "ring" or "wgmma" forces
    one."""
    _check_conv(x, weight, bias, "conv3x3_up2")
    if x.device.type == "cpu":
        return conv3x3_up2_plain(x, weight, bias)
    kernel = functools.partial(_up2_kernel, route=route)
    return _launch.with_twin_backward(kernel, conv3x3_up2_plain, x, weight, bias)


def _up2_operand_blocks(phased: torch.Tensor, k: int, c: int) -> torch.Tensor:
    """The wgmma route's weights: the phase kernels [4K, C, 2, 2] (phase-major
    rows) -> [ceil(K / 64)][C / 16][16 (phase, tap)][2 channel halves][64
    rows][8 channels], rows past K zero: each (64-channel block, 16-channel
    stage) one contiguous 32 KB block in wgmma's K-major core-matrix layout,
    which the kernel copies to shared memory as it stands. One copy where K
    is a multiple of 64 (every SD up-conv)."""
    m = WGMMA_TILE[0]
    kb = _cdiv(k, m)
    wp = phased.view(4, k, c, 2, 2)
    if k % m:
        wp = F.pad(wp, (0, 0, 0, 0, 0, 0, 0, kb * m - k))
    # (phase, kb, row, stage, half, channel, r, s) -> (kb, stage, phase, r, s, half, row, channel)
    blocks = wp.view(4, kb, m, c // 16, 2, 8, 2, 2).permute(1, 3, 0, 6, 7, 4, 2, 5)
    return blocks.contiguous().view(kb, c // 16, 16, 2, m, 8)


def _up2_kernel(x, weight, bias, route: str | None = None):
    global UP2_LAUNCHES
    b, c, h, w = x.shape
    k = weight.shape[0]
    route = _pick_route("conv3x3_up2", route, x.dtype, c, k, w)
    phased = phase_kernels(weight)  # [4K, C, 2, 2], phase-major
    if route == "wgmma":
        packed = _up2_operand_blocks(phased, k, c)
    else:  # [phase, r, s, K, C]
        packed = phased.view(4, k, c, 2, 2).permute(0, 3, 4, 1, 2).contiguous()
    out = torch.empty((b, k, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if route in ("ring", "wgmma"):
        _launch.check_aligned("conv3x3_up2", (x.data_ptr(), packed.data_ptr(), out.data_ptr()))
    fn = _launch.bind("conv3x3", "dtts_conv3x3_up2", _UP2_ARGTYPES)
    err = fn(x.data_ptr(), packed.data_ptr(), _ptr(bias), out.data_ptr(),
             _launch.DTYPE_CODES[x.dtype], b, c, k, h, w, ROUTES.index(route), _launch.stream(x))
    _launch.raise_on(err, "conv3x3_up2")
    UP2_LAUNCHES += 1
    UP2_ROUTE_LAUNCHES[route] += 1
    return out


__all__ = ["conv3x3_same", "conv3x3_up2", "conv3x3_same_plain", "conv3x3_up2_plain",
           "conv3_shape_eligible", "conv3_eligible", "shortcut_eligible", "up2_eligible",
           "conv_route", "same_route", "up2_route", "wgmma_plan", "up2_wgmma_plan", "ROUTES",
           "MIN_SPATIAL", "UP2_MIN_SPATIAL", "SAME_LAUNCHES", "UP2_LAUNCHES",
           "SAME_ROUTE_LAUNCHES", "UP2_ROUTE_LAUNCHES"]
