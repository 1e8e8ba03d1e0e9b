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
tensor goes through the kernel or the call raises. ``LAUNCHES`` counts
kernel launches, two per call (moments, then normalize).

``group_norm_stats`` replaces groupnorm.py::group_norm_stats (Pallas kernel
``_gn_stats_kernel``): the statistics alone, from one read of x, as the
per-(batch, channel) fp32 mean and rstd of the channel's group, for the 3x3
conv kernel's normalize-on-load prologue. It is the second entry of the same
source (the same moments launch, then a per-group finalize);
``STATS_LAUNCHES`` counts its launches, two per call, apart from
``LAUNCHES``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from diffusion_tts_torch.ops.kernels import _launch

CHUNK = 8192  # pixels of one channel per block
LAUNCHES_PER_CALL = 2
_ARGTYPES = ((_launch.PTR,) * 6 + (_launch.INT,) * 7 + (_launch.F32, _launch.INT, _launch.PTR))

_STATS_ARGTYPES = ((_launch.PTR,) * 4 + (_launch.INT,) * 6 + (_launch.F32, _launch.PTR))

LAUNCHES = 0
STATS_LAUNCHES = 0


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


def _affine(v: torch.Tensor, b: int, c: int, x: torch.Tensor, name: str) -> torch.Tensor:
    if tuple(v.shape) not in ((c,), (b, c)):
        raise ValueError(f"{name} must be [C] or [B, C] = [{c}] or [{b}, {c}], "
                         f"got {tuple(v.shape)}")
    return v.to(device=x.device, dtype=torch.float32).contiguous()


def _group_norm(x, scale, bias, pre, groups, eps, apply_silu):
    global LAUNCHES
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale, bias, groups=groups, eps=eps,
                                     apply_silu=apply_silu, pre=pre)
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
    out = torch.empty_like(x)
    chunks = -(-hw // CHUNK)
    partial = torch.empty((b * c * chunks * 2,), dtype=torch.float32, device=x.device)
    fn = _launch.bind("groupnorm", "dtts_group_norm", _ARGTYPES)
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), pre_ptr, partial.data_ptr(),
             out.data_ptr(), _launch.DTYPE_CODES[x.dtype], b, c, hw, groups, CHUNK,
             c if scale.ndim == 2 else 0, eps, int(apply_silu), _launch.stream(x))
    _launch.raise_on(err, "group_norm_silu")
    LAUNCHES += LAUNCHES_PER_CALL
    return out


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                    groups: int, eps: float = 1e-5, apply_silu: bool = True) -> torch.Tensor:
    """(GN(x) * scale + bias) (+ SiLU) for x [B, C, ...]; scale/bias [C] or
    per-sample [B, C]. Returns x.shape in x.dtype."""
    return _group_norm(x, scale, bias, None, groups, eps, apply_silu)


def group_norm_silu_prebias(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            pre: torch.Tensor, *, groups: int, eps: float = 1e-5,
                            apply_silu: bool = True) -> torch.Tensor:
    """silu(GN(x + pre) * scale + bias) with per-sample pre [B, C]; the add
    never makes a pass of its own."""
    return _group_norm(x, scale, bias, pre, groups, eps, apply_silu)


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
    global STATS_LAUNCHES
    if x.ndim < 3:
        raise ValueError(f"x must be [B, C, ...], got {tuple(x.shape)}")
    b, c = x.shape[:2]
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if x.device.type == "cpu":
        return group_norm_stats_plain(x, groups=groups, eps=eps)
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
    STATS_LAUNCHES += LAUNCHES_PER_CALL
    return mean, rstd


__all__ = ["group_norm_silu", "group_norm_silu_prebias", "group_norm_silu_plain",
           "group_norm_stats", "group_norm_stats_plain", "LAUNCHES", "STATS_LAUNCHES",
           "LAUNCHES_PER_CALL", "CHUNK"]
