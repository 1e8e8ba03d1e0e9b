"""GroupNorm (+ pre-add, + SiLU): the CUDA kernel and its plain twin.

Replaces diffusion_tts_tpu/ops/pallas/groupnorm.py::group_norm_silu and
::group_norm_silu_prebias (Pallas kernel ``_gn_kernel``). The source is
``csrc/groupnorm.cu``; its header says what bounds it on the H100 and what
the design does about that.

x is contiguous NCHW ``[B, C, ...]`` (the SD modules' layout); the
statistics of each (batch, group) are fp32 raw moments with the variance
clamped at 0, as ``_gn_kernel`` takes them. scale/bias are ``[C]`` or
per-sample ``[B, C]``; ``pre`` ``[B, C]`` is added to x before the
statistics. A CPU tensor goes through the plain PyTorch version; a CUDA
tensor goes through the kernel or the call raises. The kernels are
forward-only, as the Pallas ones are; the gradient is autograd's through the
plain twin (``_launch.with_twin_backward``), the counterpart of the JAX
package's ``custom_vjp`` over the jnp reference.

Two designs, picked by ``gn_route(dtype, c, hw, groups)`` before the launch:
``"slab"`` (fp32 and bf16 with each channel's row a multiple of 16 bytes:
HW a multiple of 8 in bf16, of 4 in fp32; every GroupNorm of the SD search)
is one launch that reads x once, a thread-block cluster of
``gn_slab_cluster(...)`` CTAs holding each (batch, group) in shared memory;
``"v1"`` (the first design, any HW) is two launches, moments then
normalize. ``route=`` on ``group_norm_silu`` and ``group_norm_silu_prebias``
forces one: "v1" at any shape (chip_smoke.py times it beside the slab),
"slab" only where ``gn_route`` gives it (else ``ValueError`` before any
launch, as for a pointer that is not 16-byte aligned). On the CPU every
route runs the plain twin. ``LAUNCHES`` counts kernel launches,
``ROUTE_LAUNCHES`` the same per route, ``LAUNCHES_PER_CALL[route]`` a
call's (slab 1, v1 2).

``group_norm_stats`` replaces groupnorm.py::group_norm_stats (Pallas kernel
``_gn_stats_kernel``): the statistics alone, from one read of x, as the
per-(batch, channel) fp32 mean and rstd of the channel's group, for the 3x3
conv kernel's normalize-on-load prologue. It is the second entry of the same
source (v1's moments launch, then a per-group finalize);
``STATS_LAUNCHES`` counts its launches, ``STATS_LAUNCHES_PER_CALL`` = 2 per
call, apart from ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from diffusion_tts_torch.ops.kernels import _launch

CHUNK = 8192  # v1: pixels of one channel per block
_ARGTYPES = ((_launch.PTR,) * 6 + (_launch.INT,) * 7 + (_launch.F32, _launch.INT, _launch.PTR))
_SLAB_ARGTYPES = ((_launch.PTR,) * 5 + (_launch.INT,) * 8 + (_launch.F32, _launch.INT, _launch.PTR))
_CLUSTERS_ARGTYPES = ((_launch.INT,) * 3 + (ctypes.POINTER(ctypes.c_int),))
_STATS_ARGTYPES = ((_launch.PTR,) * 4 + (_launch.INT,) * 6 + (_launch.F32, _launch.PTR))

# The kernels' two designs, by their route code in csrc/groupnorm.cu.
ROUTES = ("v1", "slab")
LAUNCHES_PER_CALL = {"v1": 2, "slab": 1}
STATS_LAUNCHES_PER_CALL = 2
# The slab route (csrc/groupnorm.cu states the same numbers): rows of whole
# 16-byte vectors; at most SLAB_BUDGET bytes of a CTA's part of a group in
# shared memory (two CTAs per SM), the rest of a larger part read twice.
SLAB_ROW_BYTES = 16
SLAB_BUDGET = 96 * 1024
SLAB_MAX_CLUSTER = 8
SLAB_FILL_CTAS = 132  # the H100's SMs: clusters grow while a call has fewer CTAs

LAUNCHES = 0
STATS_LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
# (dtype code, cs, shared bytes) -> clusters the card holds at once, from the
# first launch of each kind
_SLAB_CLUSTERS: dict[tuple[int, int, int], int] = {}


def group_norm_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                          groups: int, eps: float = 1e-5, apply_silu: bool = True,
                          pre: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel with its numerics: fp32 raw moments
    of x (+ pre), variance clamped at 0, affine and SiLU in fp32, one
    rounding to x.dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, c, -1)
    if pre is not None:
        xf = xf + pre.float().reshape(b, c, 1)
    xg = xf.reshape(b, groups, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = torch.clamp((xg * xg).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, -1)
    out = out * scale.float().reshape(-1, c, 1) + bias.float().reshape(-1, c, 1)
    if apply_silu:
        out = F.silu(out)
    return out.reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------ routing


def gn_route(dtype: torch.dtype, c: int, hw: int, groups: int) -> str:
    """The kernels' design for a GroupNorm of C channels in ``groups``
    groups over HW pixels: "slab" for fp32 and bf16 when each channel's row
    is a multiple of 16 bytes (HW a multiple of 8 in bf16, of 4 in fp32),
    else "v1"."""
    if (dtype in (torch.float32, torch.bfloat16) and groups > 0 and c % groups == 0
            and hw * dtype.itemsize % SLAB_ROW_BYTES == 0):
        return "slab"
    return "v1"


def gn_slab_cluster(b: int, groups: int, cg: int, hw: int, dtype: torch.dtype) -> int:
    """CTAs per (batch, group) cluster on the slab route: the least of 1, 2,
    4, 8 at which a CTA's part of the group (cg * HW values) fits
    SLAB_BUDGET, then doubled, up to 8, while the call has fewer than
    SLAB_FILL_CTAS CTAs (batch 2 at 32 groups: 64 -> 256)."""
    vectors = cg * hw * dtype.itemsize // SLAB_ROW_BYTES
    cs = 1
    while cs < SLAB_MAX_CLUSTER and -(-vectors // cs) * SLAB_ROW_BYTES > SLAB_BUDGET:
        cs *= 2
    while cs < SLAB_MAX_CLUSTER and b * groups * cs < SLAB_FILL_CTAS:
        cs *= 2
    return cs


def gn_slab_smem(cs: int, cg: int, hw: int, dtype: torch.dtype) -> int:
    """Dynamic shared bytes of one slab CTA: its part of the group, at most
    SLAB_BUDGET (a larger part, at cs = 8 only, reads the rest twice)."""
    part = -(-(cg * hw * dtype.itemsize // SLAB_ROW_BYTES) // cs) * SLAB_ROW_BYTES
    return min(part, SLAB_BUDGET)


def _pick_route(route: str | None, dtype: torch.dtype, c: int, hw: int, groups: int) -> str:
    """``route`` if given (None takes ``gn_route``'s): "v1" at any shape,
    "slab" only where ``gn_route`` gives it."""
    want = gn_route(dtype, c, hw, groups)
    if route is None:
        return want
    if route not in ROUTES:
        raise ValueError(f"group_norm_silu: route must be one of {ROUTES}, got {route!r}")
    if route == "slab" and want != "slab":
        raise ValueError(f"group_norm_silu: the slab route takes float32 or bfloat16 with each "
                         f"channel's row a multiple of {SLAB_ROW_BYTES} bytes, got {dtype} at "
                         f"HW={hw}")
    return route


def _slab_ready(code: int, cs: int, smem: int) -> None:
    """Set the slab kernel up for (dtype, cs, smem) on its first launch of
    that kind, and raise if the card cannot schedule such a cluster."""
    key = (code, cs, smem)
    if key in _SLAB_CLUSTERS:
        return
    clusters = ctypes.c_int(0)
    fn = _launch.bind("groupnorm", "dtts_group_norm_slab_clusters", _CLUSTERS_ARGTYPES)
    _launch.raise_on(fn(code, cs, smem, ctypes.byref(clusters)), "group_norm_silu (slab set-up)")
    if clusters.value < 1:
        raise RuntimeError(f"group_norm_silu: the card cannot schedule a cluster of {cs} CTAs "
                           f"with {smem} bytes of shared memory each")
    _SLAB_CLUSTERS[key] = clusters.value


def _affine(v: torch.Tensor, b: int, c: int, x: torch.Tensor, name: str) -> torch.Tensor:
    if tuple(v.shape) not in ((c,), (b, c)):
        raise ValueError(f"{name} must be [C] or [B, C] = [{c}] or [{b}, {c}], "
                         f"got {tuple(v.shape)}")
    return v.to(device=x.device, dtype=torch.float32).contiguous()


def _plain(x, scale, bias, pre, groups, eps, apply_silu):
    return group_norm_silu_plain(x, scale, bias, groups=groups, eps=eps,
                                 apply_silu=apply_silu, pre=pre)


def _group_norm(x, scale, bias, pre, groups, eps, apply_silu, route):
    if route is not None and route not in ROUTES:
        raise ValueError(f"group_norm_silu: route must be one of {ROUTES}, got {route!r}")
    if x.device.type == "cpu":
        return _plain(x, scale, bias, pre, groups, eps, apply_silu)
    kernel = functools.partial(_group_norm_kernel, route=route)
    return _launch.with_twin_backward(kernel, _plain, x, scale, bias, pre, groups, eps,
                                      apply_silu)


def _group_norm_kernel(x, scale, bias, pre, groups, eps, apply_silu, route=None):
    global LAUNCHES
    _launch.check(x, "group_norm_silu")
    if x.ndim < 3:
        raise ValueError(f"x must be [B, C, ...], got {tuple(x.shape)}")
    b, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    scale, bias = _affine(scale, b, c, x, "scale"), _affine(bias, b, c, x, "bias")
    if scale.shape != bias.shape:
        raise ValueError("scale and bias must have one shape")
    pre_ptr = None
    if pre is not None:
        if tuple(pre.shape) != (b, c):
            raise ValueError(f"pre must be [B, C] = [{b}, {c}], got {tuple(pre.shape)}")
        pre = pre.to(device=x.device, dtype=torch.float32).contiguous()
        pre_ptr = pre.data_ptr()
    route = _pick_route(route, x.dtype, c, hw, groups)
    out = torch.empty_like(x)
    code, bstride = _launch.DTYPE_CODES[x.dtype], c if scale.ndim == 2 else 0
    if route == "slab":
        _launch.check_aligned("group_norm_silu", (x.data_ptr(), out.data_ptr()))
        cs = gn_slab_cluster(b, groups, c // groups, hw, x.dtype)
        smem = gn_slab_smem(cs, c // groups, hw, x.dtype)
        _slab_ready(code, cs, smem)
        fn = _launch.bind("groupnorm", "dtts_group_norm_slab", _SLAB_ARGTYPES)
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), pre_ptr, out.data_ptr(), code,
                 b, c, hw, groups, cs, smem, bstride, eps, int(apply_silu), _launch.stream(x))
    else:
        chunks = -(-hw // CHUNK)
        partial = torch.empty((b * c * chunks * 2,), dtype=torch.float32, device=x.device)
        fn = _launch.bind("groupnorm", "dtts_group_norm", _ARGTYPES)
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), pre_ptr, partial.data_ptr(),
                 out.data_ptr(), code, b, c, hw, groups, CHUNK, bstride, eps, int(apply_silu),
                 _launch.stream(x))
    _launch.raise_on(err, "group_norm_silu")
    LAUNCHES += LAUNCHES_PER_CALL[route]
    ROUTE_LAUNCHES[route] += LAUNCHES_PER_CALL[route]
    return out


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                    groups: int, eps: float = 1e-5, apply_silu: bool = True,
                    route: str | None = None) -> torch.Tensor:
    """(GN(x) * scale + bias) (+ SiLU) for x [B, C, ...]; scale/bias [C] or
    per-sample [B, C]. Returns x.shape in x.dtype. ``route``: None takes
    ``gn_route``'s; "v1" or "slab" forces one."""
    return _group_norm(x, scale, bias, None, groups, eps, apply_silu, route)


def group_norm_silu_prebias(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            pre: torch.Tensor, *, groups: int, eps: float = 1e-5,
                            apply_silu: bool = True, route: str | None = None) -> torch.Tensor:
    """silu(GN(x + pre) * scale + bias) with per-sample pre [B, C]; the add
    never makes a pass of its own. ``route`` as for ``group_norm_silu``."""
    return _group_norm(x, scale, bias, pre, groups, eps, apply_silu, route)


def group_norm_stats_plain(x: torch.Tensor, *, groups: int,
                           eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the statistics kernel: fp32 per-channel sums of
    x and x^2, summed over each group's channels, mean = sum / n, variance
    from the raw moments clamped at 0, each group's (mean, rstd) repeated
    over its channels. Returns two fp32 [B, C] tensors."""
    b, c = x.shape[:2]
    cg = c // groups
    xf = x.float().reshape(b, c, -1)
    n = float(xf.shape[-1] * cg)
    s1 = xf.sum(dim=-1).reshape(b, groups, cg).sum(dim=-1)
    s2 = (xf * xf).sum(dim=-1).reshape(b, groups, cg).sum(dim=-1)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return (mean.repeat_interleave(cg, dim=1),
            torch.rsqrt(var + eps).repeat_interleave(cg, dim=1))


def group_norm_stats(x: torch.Tensor, *, groups: int,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) of each channel's group, two fp32 [B, C] tensors, for x
    [B, C, ...]; x is read once."""
    if x.ndim < 3:
        raise ValueError(f"x must be [B, C, ...], got {tuple(x.shape)}")
    c = x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    plain = lambda x, groups, eps: group_norm_stats_plain(x, groups=groups, eps=eps)
    if x.device.type == "cpu":
        return plain(x, groups, eps)
    return _launch.with_twin_backward(_group_norm_stats_kernel, plain, x, groups, eps)


def _group_norm_stats_kernel(x: torch.Tensor, groups: int, eps: float):
    global STATS_LAUNCHES
    b, c = x.shape[:2]
    _launch.check(x, "group_norm_stats")
    hw = math.prod(x.shape[2:])
    chunks = -(-hw // CHUNK)
    partial = torch.empty((b * c * chunks * 2,), dtype=torch.float32, device=x.device)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    fn = _launch.bind("groupnorm", "dtts_group_norm_stats", _STATS_ARGTYPES)
    err = fn(x.data_ptr(), partial.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
             _launch.DTYPE_CODES[x.dtype], b, c, hw, groups, CHUNK, eps, _launch.stream(x))
    _launch.raise_on(err, "group_norm_stats")
    STATS_LAUNCHES += STATS_LAUNCHES_PER_CALL
    return mean, rstd


__all__ = ["group_norm_silu", "group_norm_silu_prebias", "group_norm_silu_plain",
           "group_norm_stats", "group_norm_stats_plain", "gn_route", "gn_slab_cluster",
           "gn_slab_smem", "ROUTES", "LAUNCHES", "ROUTE_LAUNCHES", "STATS_LAUNCHES",
           "LAUNCHES_PER_CALL", "STATS_LAUNCHES_PER_CALL", "SLAB_BUDGET",
           "CHUNK"]
