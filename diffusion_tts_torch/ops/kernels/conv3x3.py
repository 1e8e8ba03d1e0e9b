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

Routing (counterparts of ``pallas_conv3_shape_eligible``,
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
import os

import torch
import torch.nn.functional as F

from diffusion_tts_torch.ops.kernels import _launch
from diffusion_tts_torch.ops.resample import interleave_phases, phase_kernels

MIN_SPATIAL = 96
UP2_MIN_SPATIAL = 64
CHANNEL_MULTIPLE = 128
_NO_CONV_KERNELS = os.environ.get("DTTS_NO_CONV_KERNELS", "") not in ("", "0")

_SAME_ARGTYPES = (_launch.PTR,) * 9 + (_launch.INT,) * 7 + (_launch.PTR,)
_UP2_ARGTYPES = (_launch.PTR,) * 4 + (_launch.INT,) * 6 + (_launch.PTR,)

SAME_LAUNCHES = 0
UP2_LAUNCHES = 0


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
                 shortcut: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv of x [B, C, H, W] with weight [K, C, 3, 3],
    fp32 accumulation, output [B, K, H, W] in x.dtype. Optional prologue:
    with fp32 ``gn_scale``/``gn_shift`` [B, C] (GroupNorm folded by the
    caller: scale = rstd * gamma, shift = beta - mean * scale) the conv is of
    silu(x * scale + shift), and the normalized tensor never reaches device
    memory. Optional epilogue: + bias [K], then + residual [B, K, H, W] or
    + the 1x1 projection of ``shortcut = (sc_x [B, Cres, H, W], sc_w
    [K, Cres])`` (its own bias folded into ``bias`` by the caller)."""
    if (gn_scale is None) != (gn_shift is None):
        raise ValueError("gn_scale and gn_shift must be given together")
    if shortcut is not None and residual is not None:
        raise ValueError("shortcut and residual exclude each other (the shortcut is the skip)")
    _check_conv(x, weight, bias, "conv3x3_same")
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, weight, bias, residual, gn_scale=gn_scale,
                                  gn_shift=gn_shift, shortcut=shortcut)
    sc_x, sc_w = shortcut if shortcut is not None else (None, None)
    return _launch.with_twin_backward(_same_kernel, _same_plain, x, weight, bias, residual,
                                      gn_scale, gn_shift, sc_x, sc_w)


def _same_plain(x, weight, bias, residual, gn_scale, gn_shift, sc_x, sc_w):
    return conv3x3_same_plain(x, weight, bias, residual, gn_scale=gn_scale, gn_shift=gn_shift,
                              shortcut=None if sc_x is None else (sc_x, sc_w))


def _same_kernel(x, weight, bias, residual, gn_scale, gn_shift, sc_x, sc_w):
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
    packed = weight.permute(2, 3, 0, 1).contiguous()  # [3, 3, K, C]: tap-major rows of C
    out = torch.empty((b, k, h, w), dtype=x.dtype, device=x.device)
    fn = _launch.bind("conv3x3", "dtts_conv3x3_same", _SAME_ARGTYPES)
    err = fn(x.data_ptr(), packed.data_ptr(), _ptr(bias), _ptr(residual), _ptr(gn_scale),
             _ptr(gn_shift), _ptr(sc_x), _ptr(sc_w), out.data_ptr(),
             _launch.DTYPE_CODES[x.dtype], b, c, k, h, w, cres, _launch.stream(x))
    _launch.raise_on(err, "conv3x3_same")
    SAME_LAUNCHES += 1
    return out


def conv3x3_up2(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """conv3x3_pad1(nearest_upsample_2x(x)) for x [B, C, H, W] and weight
    [K, C, 3, 3], as the four 2x2 phase convs on the un-upsampled input with
    fp32 accumulation, written straight to [B, K, 2H, 2W] in x.dtype."""
    _check_conv(x, weight, bias, "conv3x3_up2")
    if x.device.type == "cpu":
        return conv3x3_up2_plain(x, weight, bias)
    return _launch.with_twin_backward(_up2_kernel, conv3x3_up2_plain, x, weight, bias)


def _up2_kernel(x, weight, bias):
    global UP2_LAUNCHES
    b, c, h, w = x.shape
    k = weight.shape[0]
    # [4K, C, 2, 2] (phase-major) -> [phase, r, s, K, C]
    packed = phase_kernels(weight).view(4, k, c, 2, 2).permute(0, 3, 4, 1, 2).contiguous()
    out = torch.empty((b, k, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    fn = _launch.bind("conv3x3", "dtts_conv3x3_up2", _UP2_ARGTYPES)
    err = fn(x.data_ptr(), packed.data_ptr(), _ptr(bias), out.data_ptr(),
             _launch.DTYPE_CODES[x.dtype], b, c, k, h, w, _launch.stream(x))
    _launch.raise_on(err, "conv3x3_up2")
    UP2_LAUNCHES += 1
    return out


__all__ = ["conv3x3_same", "conv3x3_up2", "conv3x3_same_plain", "conv3x3_up2_plain",
           "conv3_shape_eligible", "conv3_eligible", "shortcut_eligible", "up2_eligible",
           "MIN_SPATIAL", "UP2_MIN_SPATIAL", "SAME_LAUNCHES", "UP2_LAUNCHES"]
