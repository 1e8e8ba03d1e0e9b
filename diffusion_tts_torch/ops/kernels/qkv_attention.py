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
``HEAD_DIMS``: 64 (the EDM UNet), 40/80/160 (the SD UNet), 512 (the SD
VAE's single head) and 4 ... 32 (the test-width SD nets); the backward
kernels take ``BWD_HEAD_DIMS`` (all of those but 512). A CPU tensor goes
through the plain PyTorch versions; a CUDA tensor goes through the kernels
or the call raises. ``LAUNCHES`` counts forward launches, ``BWD_LAUNCHES``
backward launches (``BWD_LAUNCHES_PER_CALL`` = 2 per call: dQ, then dK/dV).

Both the forward and the backward kernels have two routes, picked before
the launch: ``"mma"`` (the products on the tensor cores) and ``"fma"`` (fp32
FMA on the CUDA cores). ``forward_route(dtype, d)`` gives "mma" for bf16 at
the widths of ``MMA_HEAD_DIMS``, every width a main path runs;
``backward_route(dtype, d)`` gives "mma" for bf16 at ``BWD_MMA_HEAD_DIMS``
(the training path's d = 64 among them; d = 160 stays on "fma"). fp32 and
the other bf16 widths take "fma". The mma routes copy rows in 16-byte
pieces: the call raises, before any launch, on a pointer or a (batch,
token, head) stride that is not a multiple of 16 bytes. ``ROUTE_LAUNCHES``
and ``BWD_ROUTE_LAUNCHES`` count launches per route. A caller may ask for
``route="fma"`` at any shape, which times the first design.

Both functions are differentiable (``torch.autograd.Function``). When a
gradient is asked for, the forward kernel also writes each row's
log2-sum-exp2 (fp32 ``[B, H, T]``) and the backward is ``attention_bwd``:
the backward kernels on the card, ``attention_bwd_plain`` on the CPU, one
formula in both places. Under ``torch.no_grad()`` nothing is saved and the
forward is the bare kernel launch.
"""
from __future__ import annotations

import math

import torch

from diffusion_tts_torch.ops.kernels import _launch

_LOG2E = 1.4426950408889634
HEAD_DIMS = (4, 8, 16, 32, 40, 64, 80, 160, 512)
MMA_HEAD_DIMS = HEAD_DIMS[2:]
BWD_HEAD_DIMS = HEAD_DIMS[:-1]
BWD_MMA_HEAD_DIMS = (16, 32, 40, 64, 80)
BWD_LAUNCHES_PER_CALL = 2
_ARGTYPES = ((_launch.PTR,) * 4 + (_launch.INT,) * 5 + (_launch.I64,) * 6
             + (_launch.F32, _launch.PTR, _launch.INT, _launch.PTR))
_BWD_ARGTYPES = ((_launch.PTR,) * 9 + (_launch.INT,) * 5 + (_launch.I64,) * 9
                 + (_launch.F32, _launch.F32, _launch.INT, _launch.PTR))

LAUNCHES = 0
BWD_LAUNCHES = 0
ROUTE_LAUNCHES = {route: 0 for route in _launch.ROUTES}
BWD_ROUTE_LAUNCHES = {route: 0 for route in _launch.ROUTES}


def forward_route(dtype: torch.dtype, d: int) -> str:
    """The forward kernel's route for inputs of ``dtype`` and head width
    ``d``: "mma" for bf16 at a width of MMA_HEAD_DIMS, else "fma"."""
    return "mma" if dtype == torch.bfloat16 and d in MMA_HEAD_DIMS else "fma"


def backward_route(dtype: torch.dtype, d: int) -> str:
    """The backward kernels' route for inputs of ``dtype`` and head width
    ``d``: "mma" for bf16 at a width of BWD_MMA_HEAD_DIMS, else "fma"."""
    return "mma" if dtype == torch.bfloat16 and d in BWD_MMA_HEAD_DIMS else "fma"


def _pick_route(want: str, route: str | None, dtype: torch.dtype, d: int, widths) -> str:
    """``route`` if given (None takes ``want``): "fma" at any shape, "mma"
    only where the predicate gave it."""
    route = route or want
    if route not in (want, "fma"):
        raise ValueError(f"the mma route takes bfloat16 at head widths {widths}, "
                         f"got {dtype} at {d}")
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


def _launch_kernel(q_ptr: int, k_ptr: int, v_ptr: int, out: torch.Tensor, d: int, b: int,
                   h: int, t: int, in_strides: tuple[int, int, int],
                   out_strides: tuple[int, int, int],
                   lse: torch.Tensor | None = None, route: str | None = None) -> None:
    """One launch over (batch, head, q tile); strides in elements for
    (batch, token, head), the head width's stride being 1. ``lse``, fp32
    [B, H, T], takes the row statistic the backward needs. ``route``: None
    takes ``forward_route``'s; "fma" may be asked for at any shape."""
    global LAUNCHES
    route = _pick_route(forward_route(out.dtype, d), route, out.dtype, d, MMA_HEAD_DIMS)
    if route == "mma":
        _launch.check_aligned("attention", (q_ptr, k_ptr, v_ptr, out.data_ptr()),
                              in_strides + out_strides, out.element_size())
    fn = _launch.bind("qkv_attention", "dtts_attention", _ARGTYPES)
    err = fn(q_ptr, k_ptr, v_ptr, out.data_ptr(), _launch.DTYPE_CODES[out.dtype], d, b, h, t,
             *in_strides, *out_strides, _LOG2E / math.sqrt(d),
             None if lse is None else lse.data_ptr(), _launch.ROUTE_CODES[route],
             _launch.stream(out))
    _launch.raise_on(err, "attention")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1


def _launch_bwd(q_ptr: int, k_ptr: int, v_ptr: int, o: torch.Tensor, g: torch.Tensor,
                lse: torch.Tensor, dq_ptr: int, dk_ptr: int, dv_ptr: int, d: int, b: int,
                h: int, t: int, in_strides: tuple[int, int, int],
                out_strides: tuple[int, int, int], route: str | None = None) -> None:
    """The two backward launches. ``o`` and ``g`` are contiguous
    [B, T, H*D]-like; q/k/v and dq/dk/dv are addressed by pointer and
    (batch, token, head) strides. ``route``: None takes ``backward_route``'s;
    "fma" may be asked for at any shape."""
    global BWD_LAUNCHES
    if d not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"the backward kernels take head widths {BWD_HEAD_DIMS}, got {d}")
    route = _pick_route(backward_route(g.dtype, d), route, g.dtype, d, BWD_MMA_HEAD_DIMS)
    g_strides = (t * h * d, h * d, d)
    if route == "mma":
        _launch.check_aligned("attention_bwd", (q_ptr, k_ptr, v_ptr, g.data_ptr(), dq_ptr,
                                                dk_ptr, dv_ptr),
                              in_strides + g_strides + out_strides, g.element_size())
    # The softmax VJP's row term: an elementwise product and a row sum, which
    # the JAX package also computes outside its kernels. fp32 [B, H, T].
    delta = (g.float() * o.float()).reshape(b, t, h, d).sum(dim=-1).permute(0, 2, 1).contiguous()
    fn = _launch.bind("attention_bwd", "dtts_attention_bwd", _BWD_ARGTYPES)
    err = fn(q_ptr, k_ptr, v_ptr, g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq_ptr,
             dk_ptr, dv_ptr, _launch.DTYPE_CODES[g.dtype], d, b, h, t, *in_strides,
             *g_strides, *out_strides, _LOG2E / math.sqrt(d), 1.0 / math.sqrt(d),
             _launch.ROUTE_CODES[route], _launch.stream(g))
    _launch.raise_on(err, "attention_bwd")
    BWD_LAUNCHES += BWD_LAUNCHES_PER_CALL
    BWD_ROUTE_LAUNCHES[route] += BWD_LAUNCHES_PER_CALL


def _thirds(x: torch.Tensor, c: int) -> tuple[int, int, int]:
    """Pointers to the q, k and v thirds of a contiguous [B, T, 3C]."""
    base, item = x.data_ptr(), x.element_size()
    return base, base + c * item, base + 2 * c * item


def _qkv_forward(qkv: torch.Tensor, heads: int, lse: torch.Tensor | None,
                 route: str | None = None) -> torch.Tensor:
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    _launch_kernel(*_thirds(qkv, c), out, d, b, heads, t, (t * c3, c3, d), (t * c, c, d), lse,
                   route)
    return out


def _bthd_forward(q, k, v, lse: torch.Tensor | None, route: str | None = None) -> torch.Tensor:
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    strides = (t * h * d, h * d, d)
    _launch_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out, d, b, h, t, strides, strides,
                   lse, route)
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
    ``backward_route``'s; "fma" forces the CUDA-core kernels."""
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
    backward follows its own predicate (at d = 160 the forward's mma route
    has no backward counterpart)."""
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
    the gradient); "fma" forces the CUDA-core kernels, forward and backward."""
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
           "backward_route", "LAUNCHES", "ROUTE_LAUNCHES", "BWD_LAUNCHES", "BWD_ROUTE_LAUNCHES",
           "BWD_LAUNCHES_PER_CALL", "HEAD_DIMS", "MMA_HEAD_DIMS", "BWD_HEAD_DIMS",
           "BWD_MMA_HEAD_DIMS"]
