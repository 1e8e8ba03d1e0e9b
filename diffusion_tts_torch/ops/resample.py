"""Nearest-2x upsample + 3x3 conv through the 2x2-phase decomposition
(counterpart of diffusion_tts_tpu/ops/resample.py).

Because nearest-up duplicates pixels, conv3x3(nn_up2(x)) is exactly a
family of four 2x2-kernel convs on the un-upsampled input: for output row
2i+dh (1D view, pad-1 conv)

  dh=0:  y[2i]   = K0*x[i-1] + (K1+K2)*x[i]
  dh=1:  y[2i+1] = (K0+K1)*x[i] + K2*x[i+1]

and the 2D kernel is the tensor product of the row and column foldings.
The four phases run as one ``F.conv2d`` with 4*O output channels over the
once-padded input and are then interleaved. This is the same formulation
as the JAX package (the tap sums, done in fp32, are its only reassociation
against nearest-up followed by a 3x3 conv), in NCHW.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _fold(k: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """3 taps -> 2 phase taps along ``dim``."""
    k0, k1, k2 = k.unbind(dim)
    return torch.stack([k0, k1 + k2] if d == 0 else [k0 + k1, k2], dim=dim)


def phase_kernels(w: torch.Tensor) -> torch.Tensor:
    """[O, I, 3, 3] conv weight -> [4*O, I, 2, 2] phase weights, phases
    ordered (dh, dw) = (0,0), (0,1), (1,0), (1,1) along the output axis."""
    wf = w.float()
    phases = [_fold(_fold(wf, dw, 3), dh, 2) for dh in (0, 1) for dw in (0, 1)]
    return torch.cat(phases, dim=0).to(w.dtype)


def nn_upsample2x_conv3x3(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """conv3x3_pad1(nearest_upsample_2x(x)) without the upsampled input.
    x: [B, I, H, W]; w: [O, I, 3, 3]; returns [B, O, 2H, 2W]."""
    b, _, h, wd = x.shape
    o = w.shape[0]
    out = F.conv2d(F.pad(x, (1, 1, 1, 1)), phase_kernels(w))  # [B, 4O, H+1, W+1]
    p = {(dh, dw): out[:, (2 * dh + dw) * o:(2 * dh + dw + 1) * o, dh:dh + h, dw:dw + wd]
         for dh in (0, 1) for dw in (0, 1)}
    rows = [torch.stack([p[(dh, 0)], p[(dh, 1)]], dim=-1) for dh in (0, 1)]  # [B,O,H,W,2]
    y = torch.stack(rows, dim=3).reshape(b, o, 2 * h, 2 * wd)  # [B,O,H,2,W,2]
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    return y


__all__ = ["nn_upsample2x_conv3x3", "phase_kernels"]
