"""Self-attention, forward and backward: the CUDA kernels and their plain
twins.

Replaces three Pallas kernels of diffusion_tts_tpu/ops/pallas/attention.py:
``qkv_self_attention`` (``_qkv_attn_kernel``, ``_qkv_attn_pair_kernel``),
``flash_attention`` (``_attn_kernel``, ``_attn_kernel_dual``) and the flash
backward ``_flash_attention_vjp`` (``_attn_stats_kernel``,
``_attn_bwd_dq_kernel``, ``_attn_bwd_dkv_kernel``). The sources are
``csrc/qkv_attention.cu`` and ``csrc/attention_bwd.cu``; their headers say
what bounds them on the H100 and what the designs do about that.

``qkv_self_attention`` takes ``[B, T, 3C]`` with q|k|v in contiguous
thirds, each head-major (the layout ``models.torch_import`` produces) and
returns ``[B, T, C]``. ``attention`` runs the same kernel on separate
``[B, T, H, D]`` q, k and v. The forward kernel takes the head widths in
``HEAD_DIMS``: 64 (the ADM), 256 (the CIFAR-10 DDPM++ SongUNet's single
head), 40/80/160 (the SD UNet), 512 (the SD VAE's single head) and 4 ... 32
(the test-width SD nets); the backward kernels take ``BWD_HEAD_DIMS`` (all
of those but 512). A CPU tensor goes
through the plain PyTorch versions; a CUDA tensor goes through the kernels
or the call raises. ``LAUNCHES`` counts forward launches, ``BWD_LAUNCHES``
backward launches (``BWD_LAUNCHES_PER_CALL`` = 2 per call: dQ, then dK/dV).

The forward kernel has four routes, picked before the launch: "wgmma"
(Hopper's asynchronous warpgroup products fed by TMA), "mma" (the
warp-level mma.sync products of the first tensor-core design), "tf32x3"
(fp32 on the tensor cores, each product three tf32 wgmma products) and
"fma" (fp32 FMA on the CUDA cores). ``forward_route(dtype, d)`` gives
"wgmma" for bf16 at ``WGMMA_HEAD_DIMS`` (the ADM's 64, the SD UNet's 40, 80
and 160, the DDPM++ net's 256, the SD VAE's 512), "mma" for bf16 at the
other widths of ``MMA_HEAD_DIMS`` (16 and 32 of the test nets), "tf32x3" for
fp32 at ``TF32X3_HEAD_DIMS`` (the ADM's 64 and the DDPM++ net's 256, the
CLIs' default dtype) and "fma" otherwise. A tf32x3 launch takes
``tf32x3_plan``: d = 256's key split as on the wgmma route, one consumer
warpgroup. A wgmma
launch takes ``wgmma_plan(d, b, h, t, *card_limits(device))``: (key split,
consumer warpgroups). At d = 256 it splits each 64-row q tile's keys over a
thread-block cluster of ``wgmma_split`` CTAs where the tiles alone would
leave the card short of SMs; an unsplit launch takes ``wgmma_consumers``'
one or two consumer warpgroups (at d = 512 always two, each holding half of
O's columns, and no key split: see ``csrc/qkv_attention.cu``'s header).
Tests and probes may force a factor through ``split=`` of ``_qkv_forward`` /
``_bthd_forward``; the public wrappers take none. The backward
kernels have the same three: ``backward_route(dtype, d)`` gives "wgmma" for
bf16 at ``BWD_WGMMA_HEAD_DIMS`` (the ADM training path's d = 64 and the
DDPM++ training path's d = 256), "mma" for bf16 at the other widths of
``BWD_MMA_HEAD_DIMS``, "fma" otherwise; a wgmma backward takes
``bwd_wgmma_plan(d)``, the warpgroups of its dQ and its dK/dV blocks, and
computes the row term delta in its dQ launch. The
tensor-core routes read rows in 16-byte pieces (TMA's rule too): the call
raises, before any launch, on a pointer or a (batch, token, head) stride
that is not a multiple of 16 bytes. ``ROUTE_LAUNCHES`` and
``BWD_ROUTE_LAUNCHES`` count launches per route. A caller may ask for
``route="fma"`` at any shape and for ``route="mma"`` at any bf16 width of
``MMA_HEAD_DIMS`` (the backward: of ``BWD_MMA_HEAD_DIMS``), which times the
earlier designs; nothing falls back from one route to another. The backward
has no tf32x3 route: fp32 training reads the tf32x3 forward's row statistic
in the fma backward.

Both functions are differentiable (``torch.autograd.Function``). When a
gradient is asked for, the forward kernel also writes each row's
log2-sum-exp2 (fp32 ``[B, H, T]``) and the backward is ``attention_bwd``:
the backward kernels on the card, ``attention_bwd_plain`` on the CPU, one
formula in both places. Under ``torch.no_grad()`` nothing is saved and the
forward is the bare kernel launch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from diffusion_tts_torch.ops.kernels import _launch

_LOG2E = 1.4426950408889634
HEAD_DIMS = (4, 8, 16, 32, 40, 64, 80, 160, 256, 512)
MMA_HEAD_DIMS = HEAD_DIMS[2:]
WGMMA_HEAD_DIMS = (40, 64, 80, 160, 256, 512)
# fp32 on the tensor cores (three tf32 products each), and the K/V tile's keys
# at each width (csrc/qkv_attention.cu's Tf32Tiles).
TF32X3_HEAD_DIMS = (64, 256)
TF32X3_KEY_ROWS = {64: 32, 256: 16}
# d = 256's key split on the wgmma route: CTAs a work tile (a cluster of them).
WGMMA_SPLITS = (1, 2, 4)
# The routes of the forward and of the backward, in the order of their codes
# in csrc/qkv_attention.cu and csrc/attention_bwd.cu (the backward's are the
# first three).
ROUTES = _launch.ROUTES + ("wgmma", "tf32x3")
ROUTE_CODES = {route: code for code, route in enumerate(ROUTES)}
BWD_ROUTES = ROUTES[:3]
BWD_HEAD_DIMS = HEAD_DIMS[:-1]
BWD_MMA_HEAD_DIMS = (16, 32, 40, 64, 80, 160, 256)
BWD_WGMMA_HEAD_DIMS = (64, 256)
BWD_LAUNCHES_PER_CALL = 2
_ENCODE_FAILED = 1000  # csrc/qkv_attention.cu's kEncodeFailed: a tensor map was refused
_ARGTYPES = ((_launch.PTR,) * 4 + (_launch.INT,) * 5 + (_launch.I64,) * 6
             + (_launch.F32, _launch.PTR) + (_launch.INT,) * 3 + (_launch.PTR,))
_CLUSTERS_ARGTYPES = (_launch.INT, ctypes.POINTER(ctypes.c_int))
_BWD_ARGTYPES = ((_launch.PTR,) * 10 + (_launch.INT,) * 5 + (_launch.I64,) * 12
                 + (_launch.F32, _launch.F32) + (_launch.INT,) * 3 + (_launch.PTR,))

LAUNCHES = 0
BWD_LAUNCHES = 0
ROUTE_LAUNCHES = {route: 0 for route in ROUTES}
BWD_ROUTE_LAUNCHES = {route: 0 for route in BWD_ROUTES}


def forward_route(dtype: torch.dtype, d: int) -> str:
    """The forward kernel's route for inputs of ``dtype`` and head width
    ``d``: "wgmma" for bf16 at a width of WGMMA_HEAD_DIMS, "mma" for bf16 at
    the other widths of MMA_HEAD_DIMS, "tf32x3" for fp32 at a width of
    TF32X3_HEAD_DIMS, else "fma"."""
    if dtype == torch.float32:
        return "tf32x3" if d in TF32X3_HEAD_DIMS else "fma"
    if dtype != torch.bfloat16:
        return "fma"
    return "wgmma" if d in WGMMA_HEAD_DIMS else "mma" if d in MMA_HEAD_DIMS else "fma"


def wgmma_consumers(b: int, h: int, t: int, sms: int, d: int | None = None) -> int:
    """Consumer warpgroups of an unsplit wgmma launch: at d = 512 two,
    which share 64-row q tiles and split O's columns; else two (128-row q
    tiles) where t > 64 and 128-row tiles still give the card's ``sms`` at
    least one tile each, else one (64-row tiles). At d = 256 and 512 two
    take the producer-warpgroup layout (csrc/qkv_attention.cu's header)."""
    if d == 512:
        return 2
    return 2 if t > 64 and b * h * -(-t // 128) >= sms else 1


def wgmma_plan(d: int, b: int, h: int, t: int, sms: int, clusters: dict[int, int],
               split: int | None = None) -> tuple[int, int]:
    """(key split, consumer warpgroups) of a wgmma launch, which the C
    entry takes as it is: ``wgmma_split``'s factor at d = 256 (``split``
    forces one), 1 at the other widths; one consumer warpgroup where the
    keys are split, else ``wgmma_consumers``' (at d = 512 its two column
    warpgroups)."""
    if split is None:
        split = wgmma_split(b, h, t, sms, clusters) if d == 256 else 1
    return split, 1 if split > 1 else wgmma_consumers(b, h, t, sms, d)


def wgmma_split(b: int, h: int, t: int, sms: int, clusters: dict[int, int],
                key_rows: int = 64) -> int:
    """CTAs sharing each 64-row q tile's keys on the wgmma route at d = 256:
    the larger of 4 and 2 that keeps the grid (b * h * ceil(t / 64) tiles
    times the factor) within the card's ``sms``, whose clusters of that
    many CTAs the card holds at once (``clusters[factor]``, from
    ``card_limits``: one CTA an SM, a cluster on one GPC) and that gives every
    CTA at least one K/V tile of ``key_rows`` keys (64 on the wgmma route,
    TF32X3_KEY_ROWS on tf32x3), else 1. On the wgmma route the training
    batches ([32, 256, 768]: 128 tiles) and the CIFAR-10 search's
    [8, 64, 768] (one key tile) take 1."""
    tiles, key_tiles = b * h * -(-t // 64), -(-t // key_rows)
    for split in (4, 2):
        if tiles * split <= sms and tiles <= clusters[split] and split <= key_tiles:
            return split
    return 1


def tf32x3_plan(d: int, b: int, h: int, t: int, sms: int, clusters: dict[int, int],
                split: int | None = None) -> tuple[int, int]:
    """(key split, consumer warpgroups) of a tf32x3 launch, which the C
    entry takes as it is: at d = 256 ``wgmma_split``'s factor over 16-key
    tiles (``split`` forces one; the kernel, like the wgmma route's at
    d = 256, holds one CTA an SM, so the card's clusters are the same), 1 at
    d = 64; one consumer warpgroup a block."""
    if split is None:
        split = (wgmma_split(b, h, t, sms, clusters, TF32X3_KEY_ROWS[d]) if d == 256 else 1)
    return split, 1


_CARDS: dict[int, tuple[int, dict[int, int]]] = {}


def card_limits(device: torch.device) -> tuple[int, dict[int, int]]:
    """(SM count, {split: clusters of the d = 256 kernel the card holds at
    once}) of the card, asked once."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _CARDS:
        fn = _launch.bind("qkv_attention", "dtts_attention_split_clusters", _CLUSTERS_ARGTYPES)
        clusters = {}
        for split in WGMMA_SPLITS[1:]:
            n = ctypes.c_int(0)
            with torch.cuda.device(index):
                _launch.raise_on(fn(split, ctypes.byref(n)), "attention (cluster occupancy)")
            clusters[split] = n.value
        _CARDS[index] = (torch.cuda.get_device_properties(index).multi_processor_count, clusters)
    return _CARDS[index]


def backward_route(dtype: torch.dtype, d: int) -> str:
    """The backward kernels' route for inputs of ``dtype`` and head width
    ``d``: "wgmma" for bf16 at a width of BWD_WGMMA_HEAD_DIMS, "mma" for bf16
    at the other widths of BWD_MMA_HEAD_DIMS, else "fma"."""
    if dtype != torch.bfloat16:
        return "fma"
    return ("wgmma" if d in BWD_WGMMA_HEAD_DIMS else "mma" if d in BWD_MMA_HEAD_DIMS
            else "fma")


def bwd_wgmma_plan(d: int) -> tuple[int, int]:
    """(warpgroups of a dQ block, of a dK/dV block) of a wgmma backward at
    head width ``d``, which the C entry checks: (1, 1) at d = 64, where
    blocks of one warpgroup feeding their own rings share an SM three at a
    time (two warpgroups sharing each streamed tile measured slower on an
    H100, PERF.md §6, PR 23); (1, 2) at d = 256, one warpgroup holding dQ's
    64 x 256 fp32 and two splitting dK's and dV's columns
    (csrc/attention_bwd.cu's header)."""
    return (1, 2) if d == 256 else (1, 1)


def _pick_route(want: str, route: str | None, dtype: torch.dtype, d: int, widths,
                wgmma_widths=WGMMA_HEAD_DIMS) -> str:
    """``route`` if given (None takes ``want``): "fma" at any shape, a
    tensor-core route only where the predicate gave it (or, for "mma", a
    bf16 tensor-core route: ``widths`` are the widths it takes,
    ``wgmma_widths`` the wgmma route's)."""
    route = route or want
    allowed = (want, "fma", "mma") if want == "wgmma" else (want, "fma")
    if route not in allowed:
        if route == "tf32x3":
            raise ValueError(f"the tf32x3 route takes float32 at head widths "
                             f"{TF32X3_HEAD_DIMS}, got {dtype} at {d}")
        raise ValueError(f"the {route} route takes bfloat16 at head widths "
                         f"{wgmma_widths if route == 'wgmma' else widths}, got {dtype} at {d}")
    return route


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for fp32 and bf16 inputs (the kernels' accumulation type);
    float64 stays float64, for gradient checks of the plain versions."""
    return torch.promote_types(dtype, torch.float32)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] attention with the reference cast points
    (diffusion_tts_tpu/ops/attention.py::_xla_attention): scores from q and
    k upcast to fp32, softmax in fp32, weights cast to the input dtype for
    P.V, P.V accumulated in fp32 and cast back."""
    dtype, acc = q.dtype, _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc) * scale)
    w = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(acc), v.to(acc))
    return out.to(dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the backward kernels, (dq, dk, dv) for
    [B, T, H, D] inputs: diffusion_tts_tpu/ops/pallas/attention.py::
    _attention_bwd_explicit line by line, with the softmax VJP's row term
    taken from the saved output (delta = sum_d g*o) as the flash kernels
    take it. Product operands in the input dtype, every accumulation, the
    softmax and its VJP in fp32, the scale applied after accumulation."""
    dtype, acc = q.dtype, _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va, ga = q.to(acc), k.to(acc), v.to(acc), g.to(dtype).to(acc)
    s = torch.einsum("bqhd,bkhd->bhqk", qa, ka) * scale
    w = torch.softmax(s, dim=-1)  # fp32 [B, H, Tq, Tk]
    wb = w.to(dtype).to(acc)
    dv = torch.einsum("bhqk,bqhd->bkhd", wb, ga)
    dw = torch.einsum("bqhd,bkhd->bhqk", ga, va)
    delta = (ga * o.to(acc)).sum(dim=-1).permute(0, 2, 1)  # [B, H, Tq]
    ds = w * (dw - delta[..., None])  # softmax VJP, fp32
    dsb = ds.to(dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, ka) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qa) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _split_heads(qkv: torch.Tensor, heads: int):
    b, t, c3 = qkv.shape
    c = c3 // 3
    return (qkv[..., i * c:(i + 1) * c].reshape(b, t, heads, c // heads) for i in range(3))


def qkv_self_attention_plain(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (the Pallas reference
    ``_qkv_attention_reference``): split heads, attend, merge."""
    b, t, c3 = qkv.shape
    return attention_plain(*_split_heads(qkv, heads)).reshape(b, t, c3 // 3)


def _check_width(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head widths {HEAD_DIMS}, got {d}")


def _pick_plan(split: int | None, route: str, d: int, b: int, h: int, t: int,
               device: torch.device) -> tuple[int, int]:
    """(key split, consumer warpgroups) of one launch: ``wgmma_plan``'s on
    the wgmma route and ``tf32x3_plan``'s on tf32x3, with ``split`` forced
    at d = 256 (a factor of WGMMA_SPLITS); (1, 1) on the other routes, where
    no other split is taken."""
    splits_route = route in ("wgmma", "tf32x3") and d == 256
    if split is not None and split not in (WGMMA_SPLITS if splits_route else (1,)):
        raise ValueError(f"the key split takes {WGMMA_SPLITS} on the wgmma and tf32x3 routes "
                         f"at d = 256 and 1 elsewhere, got {split} on the {route} route at {d}")
    if route == "tf32x3":  # only d = 256 splits, and asks the card for its limits
        limits = card_limits(device) if d == 256 else (0, {})
        return tf32x3_plan(d, b, h, t, *limits, split=split)
    if route != "wgmma":
        return 1, 1
    return wgmma_plan(d, b, h, t, *card_limits(device), split=split)


def _launch_kernel(q_ptr: int, k_ptr: int, v_ptr: int, out: torch.Tensor, d: int, b: int,
                   h: int, t: int, in_strides: tuple[int, int, int],
                   out_strides: tuple[int, int, int],
                   lse: torch.Tensor | None = None, route: str | None = None,
                   split: int | None = None) -> None:
    """One launch over (batch, head, q tile); strides in elements for
    (batch, token, head), the head width's stride being 1. ``lse``, fp32
    [B, H, T], takes the row statistic the backward needs. ``route``: None
    takes ``forward_route``'s; "fma" may be asked for at any shape.
    ``split``: None takes ``wgmma_plan``'s (``tf32x3_plan``'s); a factor
    forces that key split on the wgmma or tf32x3 route at d = 256 (tests and
    probes)."""
    global LAUNCHES
    route = _pick_route(forward_route(out.dtype, d), route, out.dtype, d, MMA_HEAD_DIMS)
    if route != "fma":
        _launch.check_aligned("attention", (q_ptr, k_ptr, v_ptr, out.data_ptr()),
                              in_strides + out_strides, out.element_size())
    split, consumers = _pick_plan(split, route, d, b, h, t, out.device)
    fn = _launch.bind("qkv_attention", "dtts_attention", _ARGTYPES)
    err = fn(q_ptr, k_ptr, v_ptr, out.data_ptr(), _launch.DTYPE_CODES[out.dtype], d, b, h, t,
             *in_strides, *out_strides, _LOG2E / math.sqrt(d),
             None if lse is None else lse.data_ptr(), ROUTE_CODES[route], split,
             consumers, _launch.stream(out))
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"attention: cuTensorMapEncodeTiled failed with CUresult "
                           f"{err - _ENCODE_FAILED} (or the driver has no entry point for it)")
    _launch.raise_on(err, "attention")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1


def _launch_bwd(q_ptr: int, k_ptr: int, v_ptr: int, o: torch.Tensor, g: torch.Tensor,
                lse: torch.Tensor, dq_ptr: int, dk_ptr: int, dv_ptr: int, d: int, b: int,
                h: int, t: int, in_strides: tuple[int, int, int],
                out_strides: tuple[int, int, int], route: str | None = None) -> torch.Tensor:
    """The two backward launches. ``o`` and ``g`` are contiguous
    [B, T, H*D]-like; q/k/v and dq/dk/dv are addressed by pointer and
    (batch, token, head) strides. ``route``: None takes ``backward_route``'s;
    "fma" may be asked for at any shape, "mma" at any bf16 width of
    BWD_MMA_HEAD_DIMS. Returns the row term delta, fp32 [B, H, T], that the
    launches read: the wgmma route's dQ launch writes it."""
    global BWD_LAUNCHES
    if d not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"the backward kernels take head widths {BWD_HEAD_DIMS}, got {d}")
    route = _pick_route(backward_route(g.dtype, d), route, g.dtype, d, BWD_MMA_HEAD_DIMS,
                        BWD_WGMMA_HEAD_DIMS)
    g_strides = o_strides = (t * h * d, h * d, d)
    if route != "fma":
        ptrs = (q_ptr, k_ptr, v_ptr, g.data_ptr(), dq_ptr, dk_ptr, dv_ptr)
        strides = in_strides + g_strides + out_strides
        if route == "wgmma":  # its dQ launch reads o for delta
            ptrs, strides = ptrs + (o.data_ptr(),), strides + o_strides
        _launch.check_aligned("attention_bwd", ptrs, strides, g.element_size())
    plan = bwd_wgmma_plan(d) if route == "wgmma" else (1, 1)
    if route == "wgmma":
        delta = torch.empty((b, h, t), dtype=torch.float32, device=g.device)
    else:
        # The softmax VJP's row term: an elementwise product and a row sum,
        # which the JAX package also computes outside its kernels. fp32
        # [B, H, T].
        delta = (g.float() * o.float()).reshape(b, t, h, d).sum(dim=-1).permute(0, 2, 1)
        delta = delta.contiguous()
    fn = _launch.bind("attention_bwd", "dtts_attention_bwd", _BWD_ARGTYPES)
    err = fn(q_ptr, k_ptr, v_ptr, g.data_ptr(), o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq_ptr, dk_ptr, dv_ptr, _launch.DTYPE_CODES[g.dtype], d, b, h, t, *in_strides,
             *g_strides, *o_strides, *out_strides, _LOG2E / math.sqrt(d), 1.0 / math.sqrt(d),
             ROUTE_CODES[route], *plan, _launch.stream(g))
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"attention_bwd: cuTensorMapEncodeTiled failed with CUresult "
                           f"{err - _ENCODE_FAILED} (or the driver has no entry point for it)")
    _launch.raise_on(err, "attention_bwd")
    BWD_LAUNCHES += BWD_LAUNCHES_PER_CALL
    BWD_ROUTE_LAUNCHES[route] += BWD_LAUNCHES_PER_CALL
    return delta


def _thirds(x: torch.Tensor, c: int) -> tuple[int, int, int]:
    """Pointers to the q, k and v thirds of a contiguous [B, T, 3C]."""
    base, item = x.data_ptr(), x.element_size()
    return base, base + c * item, base + 2 * c * item


def _qkv_forward(qkv: torch.Tensor, heads: int, lse: torch.Tensor | None,
                 route: str | None = None, split: int | None = None) -> torch.Tensor:
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    _launch_kernel(*_thirds(qkv, c), out, d, b, heads, t, (t * c3, c3, d), (t * c, c, d), lse,
                   route, split)
    return out


def _bthd_forward(q, k, v, lse: torch.Tensor | None, route: str | None = None,
                  split: int | None = None) -> torch.Tensor:
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    strides = (t * h * d, h * d, d)
    _launch_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out, d, b, h, t, strides, strides,
                   lse, route, split)
    return out


def _lse_buffer(x: torch.Tensor, b: int, h: int, t: int) -> torch.Tensor:
    return torch.empty((b, h, t), dtype=torch.float32, device=x.device)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                  g: torch.Tensor, lse: torch.Tensor | None = None, *,
                  route: str | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of [B, T, H, D] attention from its inputs, output ``o``
    and the output's gradient ``g``. On the card ``lse`` is the forward
    kernel's row statistic (fp32 [B, H, T], log2 domain); when None the
    forward kernel is run once more to get it. ``route``: None takes
    ``backward_route``'s; "fma" forces the CUDA-core kernels, "mma" the
    mma.sync ones at a wgmma width."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, g)
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o)):
        _launch.check(x, name)
    if not (q.shape == k.shape == v.shape == o.shape == g.shape) or q.ndim != 4 or \
            not (q.dtype == k.dtype == v.dtype == o.dtype):
        raise ValueError("q, k, v, o and g must be [B, T, H, D] of one shape and dtype")
    b, t, h, d = q.shape
    if lse is None:
        lse = _lse_buffer(q, b, h, t)
        _bthd_forward(q, k, v, lse)
    g = g.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    strides = (t * h * d, h * d, d)
    _launch_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o, g, lse, dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), d, b, h, t, strides, strides, route)
    return dq, dk, dv


def qkv_self_attention_bwd(qkv: torch.Tensor, out: torch.Tensor, g: torch.Tensor, heads: int,
                           lse: torch.Tensor | None = None, *, route: str | None = None
                           ) -> torch.Tensor:
    """The gradient of qkv_self_attention with respect to its [B, T, 3C]
    input, from the forward's output ``out``, the output's gradient ``g``
    (both [B, T, C]) and, on the card, the forward kernel's row statistic
    ``lse``. On the card the backward kernels read q, k and v as the thirds
    of ``qkv`` and write dq | dk | dv straight into the thirds of the result:
    no head-split copy, no concatenation. ``route`` as for ``attention_bwd``."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    if qkv.device.type == "cpu":
        grads = attention_bwd_plain(*_split_heads(qkv, heads), out.reshape(b, t, heads, d),
                                    g.reshape(b, t, heads, d))
        return torch.cat([x.reshape(b, t, c) for x in grads], dim=-1)
    if lse is None:
        raise ValueError("on the card the backward needs the forward kernel's row statistic")
    g = g.to(qkv.dtype).contiguous()  # it arrives from the model's permute
    dqkv = torch.empty_like(qkv)
    _launch_bwd(*_thirds(qkv, c), out, g, lse, *_thirds(dqkv, c), d, b, heads, t,
                (t * c3, c3, d), (t * c3, c3, d), route)
    return dqkv


def _backward_route_of(route: str | None) -> str | None:
    """A forced "fma" forward takes the fma backward too; otherwise the
    backward follows its own predicate ("wgmma" at bf16 d = 64 and 256,
    "mma" at the other bf16 widths up to 256)."""
    return "fma" if route == "fma" else None


class _QKVAttention(torch.autograd.Function):
    """qkv_self_attention with its gradient."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int, route: str | None) -> torch.Tensor:
        ctx.heads, ctx.route = heads, _backward_route_of(route)
        if qkv.device.type == "cpu":
            out = qkv_self_attention_plain(qkv, heads)
            ctx.save_for_backward(qkv, out)
            return out
        b, t, _ = qkv.shape
        lse = _lse_buffer(qkv, b, heads, t)
        out = _qkv_forward(qkv, heads, lse, route)
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        qkv, out, *lse = ctx.saved_tensors
        dqkv = qkv_self_attention_bwd(qkv, out, g, ctx.heads, *lse, route=ctx.route)
        return dqkv, None, None


class _Attention(torch.autograd.Function):
    """[B, T, H, D] attention with its gradient."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                route: str | None) -> torch.Tensor:
        ctx.route = _backward_route_of(route)
        if q.device.type == "cpu":
            out = attention_plain(q, k, v)
            ctx.save_for_backward(q, k, v, out)
            return out
        b, t, h, _ = q.shape
        lse = _lse_buffer(q, b, h, t)
        out = _bthd_forward(q, k, v, lse, route)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        q, k, v, out, *lse = ctx.saved_tensors
        return (*attention_bwd(q, k, v, out, g, *lse, route=ctx.route), None)


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def qkv_self_attention(qkv: torch.Tensor, heads: int, *, route: str | None = None
                       ) -> torch.Tensor:
    """All-heads self-attention, [B, T, 3C] -> [B, T, C] in qkv.dtype.
    ``route``: None takes ``forward_route``'s (and ``backward_route``'s for
    the gradient); "fma" forces the CUDA-core kernels, forward and backward
    (in fp32 the first design beside "tf32x3"); "mma" forces the mma.sync
    forward at a "wgmma" width."""
    if qkv.device.type != "cpu":
        _launch.check(qkv, "qkv_self_attention")
        if qkv.ndim != 3 or qkv.shape[2] % (3 * heads):
            raise ValueError(f"qkv must be [B, T, 3C] with C % heads == 0, got "
                             f"{tuple(qkv.shape)} and {heads} heads")
        _check_width(qkv.shape[2] // (3 * heads))
    if _wants_grad(qkv):
        return _QKVAttention.apply(qkv, heads, route)
    if qkv.device.type == "cpu":
        return qkv_self_attention_plain(qkv, heads)
    return _qkv_forward(qkv, heads, None, route)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              route: str | None = None) -> torch.Tensor:
    """[B, T, H, D] attention through the same kernel, [B, T, H, D] out.
    ``route`` as for ``qkv_self_attention``."""
    if q.device.type != "cpu":
        for name, x in (("q", q), ("k", k), ("v", v)):
            _launch.check(x, name)
        if not (q.shape == k.shape == v.shape and q.dtype == k.dtype == v.dtype) or q.ndim != 4:
            raise ValueError("q, k and v must be [B, T, H, D] of one shape and dtype, got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        _check_width(q.shape[3])
    if _wants_grad(q, k, v):
        return _Attention.apply(q, k, v, route)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _bthd_forward(q, k, v, None, route)


__all__ = ["qkv_self_attention", "qkv_self_attention_plain", "attention", "attention_plain",
           "attention_bwd", "attention_bwd_plain", "qkv_self_attention_bwd", "forward_route",
           "backward_route", "wgmma_plan", "wgmma_split", "wgmma_consumers", "bwd_wgmma_plan",
           "tf32x3_plan", "card_limits", "WGMMA_SPLITS", "LAUNCHES", "TF32X3_HEAD_DIMS",
           "TF32X3_KEY_ROWS", "BWD_ROUTES",
           "ROUTE_LAUNCHES", "BWD_LAUNCHES", "BWD_ROUTE_LAUNCHES", "BWD_LAUNCHES_PER_CALL",
           "HEAD_DIMS", "MMA_HEAD_DIMS", "WGMMA_HEAD_DIMS", "ROUTES", "BWD_HEAD_DIMS",
           "BWD_MMA_HEAD_DIMS", "BWD_WGMMA_HEAD_DIMS"]
