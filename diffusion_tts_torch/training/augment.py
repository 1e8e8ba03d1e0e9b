"""Non-leaky augmentation pipeline with conditioning labels (counterpart of
diffusion_tts_tpu/training/augment.py; reference edm/training/augment.py:
115-330).

Per-sample probabilistic pixel blits (x/y-flip, integer rotate and
translate), geometric transforms composed as a 3x3 inverse matrix
(isotropic and anisotropic scale, fractional rotation and translation) and
colour transforms as a 4x4 matrix (brightness, contrast, lumaflip, hue,
saturation). Returns (augmented images, label vector) in the JAX package's
layout, which conditions the net (augment_dim=9 for the EDM configuration:
xflip, yflip, scale, rotate_frac x2, aniso x2, translate_frac x2).

The geometric warp is the reference's sym6-wavelet anti-aliased
resampling: reflect-pad, wavelet-filtered 2x upsample, bilinear grid sample
in normalized coordinates, wavelet-filtered 2x downsample. As in the JAX
package the pad margin is the static ceiling (H-1, W-1) rather than the
reference's data-dependent one (every position the tight margin covers is
covered, and positions outside it are never sampled). ``filtered=False``
selects the plain bilinear warp.

Plain PyTorch on the images' device (the JAX module is plain jnp, no
Pallas kernel): ``F.pad``, depthwise ``conv2d`` / ``conv_transpose2d``,
``F.affine_grid`` + ``F.grid_sample`` and batched ``matmul``. Images are
NHWC fp32, as the losses hand them over. The transform matrices are
composed in float64 and the warp runs in float64, rounding to float32 once,
so that the card and the CPU give the same images to float32 rounding
(float32 sample coordinates part them by 1e-5 of the images' scale). The
draws come from the
``generator`` handed to the call (a ``torch.Generator`` on the images'
device); torch cannot replay JAX's threefry bits, so a comparison with the
JAX pipe injects the post-gate values through ``draws``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

# sym6 wavelet low-pass decomposition filter (the reference's
# wavelets['sym6'], augment.py:35)
_SYM6 = np.asarray([
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
    -0.048311742585633, 0.4910559419267466, 0.787641141030194,
    0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
    0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
], dtype=np.float32)


def _cos(x: torch.Tensor) -> torch.Tensor:
    """cos in float64 rounded to float32: the same bits on the card and on
    the CPU, whose float32 cos differ in the last place."""
    return torch.cos(x.double()).float()


def _sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).float()


def _stack_rows(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _translate2d(tx, ty):
    o, z = torch.ones_like(tx), torch.zeros_like(tx)
    return _stack_rows([[o, z, tx], [z, o, ty], [z, z, o]])


def _scale2d(sx, sy):
    o, z = torch.ones_like(sx), torch.zeros_like(sx)
    return _stack_rows([[sx, z, z], [z, sy, z], [z, z, o]])


def _rotate2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(theta), torch.zeros_like(theta)
    return _stack_rows([[c, -s, z], [s, c, z], [z, z, o]])


def _translate3d(bx, by, bz):
    o, z = torch.ones_like(bx), torch.zeros_like(bx)
    return _stack_rows([[o, z, z, bx], [z, o, z, by], [z, z, o, bz], [z, z, z, o]])


def _scale3d(sx, sy, sz):
    o, z = torch.ones_like(sx), torch.zeros_like(sx)
    return _stack_rows([[sx, z, z, z], [z, sy, z, z], [z, z, sz, z], [z, z, z, o]])


def _rotate3d_about(axis, theta):
    """Rotation about a unit 3-vector, embedded in a homogeneous 4x4."""
    vx, vy, vz = axis[0], axis[1], axis[2]
    c, s = torch.cos(theta), torch.sin(theta)
    cc = 1.0 - c
    o, z = torch.ones_like(theta), torch.zeros_like(theta)
    return _stack_rows([
        [vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s, z],
        [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s, z],
        [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c, z],
        [z, z, z, o],
    ])


def _bilinear_warp(images: torch.Tensor, g_inv: torch.Tensor) -> torch.Tensor:
    """Per-sample inverse affine in pixel-centred coordinates with bilinear
    sampling and zero padding, in float64 (see _filtered_warp). images NHWC
    fp32, g_inv [B, 3, 3]; returns fp32."""
    b, h, w, c = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dev = images.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev) - cy,
                            torch.arange(w, dtype=torch.float64, device=dev) - cx,
                            indexing="ij")
    coords = torch.stack([xs, ys, torch.ones_like(xs)], 0).reshape(3, -1)  # [3, H*W]
    src = torch.matmul(g_inv.double(), coords)  # [B, 3, H*W]
    # pixel index -> grid_sample's align_corners=False normalized coordinate
    gx = (2.0 * (src[:, 0] + cx) + 1.0) / w - 1.0
    gy = (2.0 * (src[:, 1] + cy) + 1.0) / h - 1.0
    grid = torch.stack([gx, gy], -1).reshape(b, h, w, 2)
    out = F.grid_sample(images.permute(0, 3, 1, 2).double(), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1).float()


def _filtered_warp(images: torch.Tensor, g_inv: torch.Tensor) -> torch.Tensor:
    """The reference's anti-aliased geometric warp (augment.py:232-270):
    reflect-pad -> sym6 2x upsample -> grid sample -> sym6 2x downsample ->
    crop, with the static margin ceiling (diffusion_tts_tpu's
    _filtered_warp). images NHWC fp32, g_inv [B, 3, 3]; returns fp32. It
    runs in float64: the sample coordinates reach about 4x the
    image's size, where a float32 ulp moves a sample by 1e-5 pixel and the
    card's and the CPU's roundings part by as much in the output; in
    float64 both round once, at the end. The tensors are a few MB."""
    n, h, w, c = images.shape
    dev = images.device
    hz = torch.from_numpy(_SYM6).to(dev, torch.float64)
    taps = hz.numel()
    hz_pad = taps // 4  # 3
    x = images.permute(0, 3, 1, 2).double()
    x = F.pad(x, (w - 1, w - 1, h - 1, h - 1), mode="reflect")  # static margin ceiling

    # Upsample 2x (augment.py:251-256): zero-interleave, then correlate with
    # hz[::-1] padded by 6, width then height, 2n wide. A stride-2 transposed
    # conv with weight hz is that correlation (its kernel is flipped), with
    # padding taps - 1 - 6 = 5.
    pad_up = (taps + 1) // 2
    k_w = hz.reshape(1, 1, 1, taps).expand(c, 1, 1, taps)
    k_h = hz.reshape(1, 1, taps, 1).expand(c, 1, taps, 1)
    x = F.conv_transpose2d(x, k_w, stride=(1, 2), padding=(0, taps - 1 - pad_up), groups=c)
    x = F.conv_transpose2d(x, k_h, stride=(2, 1), padding=(taps - 1 - pad_up, 0), groups=c)
    up_h, up_w = x.shape[2], x.shape[3]

    # Coordinate bookkeeping (augment.py:257-262) folded into two constant
    # 3x3s: theta = scale2d(2/up_w, 2/up_h) @ t(-.5,-.5) @ scale2d(2,2) @ G_inv
    #               @ scale2d(.5,.5) @ t(.5,.5) @ scale2d(out_w/2, out_h/2)
    out_h, out_w = (h + hz_pad * 2) * 2, (w + hz_pad * 2) * 2

    def t2(tx, ty):
        return np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)

    def s2(sx, sy):
        return np.diag([sx, sy, 1.0])

    a_const = torch.from_numpy(s2(2.0 / up_w, 2.0 / up_h) @ t2(-0.5, -0.5) @ s2(2.0, 2.0))
    b_const = torch.from_numpy(s2(0.5, 0.5) @ t2(0.5, 0.5) @ s2(out_w / 2.0, out_h / 2.0))
    theta = a_const.to(dev) @ g_inv.double() @ b_const.to(dev)
    grid = F.affine_grid(theta[:, :2, :], [n, c, out_h, out_w], align_corners=False)
    x = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)

    # Downsample 2x + crop (augment.py:267-270): correlate with hz at stride
    # 2, width then height.
    pad_down = (taps - 1) // 2
    x = F.conv2d(x, k_w, stride=(1, 2), padding=(0, pad_down), groups=c)
    x = x[:, :, :, hz_pad:-hz_pad]
    x = F.conv2d(x, k_h, stride=(2, 1), padding=(pad_down, 0), groups=c)
    x = x[:, :, hz_pad:-hz_pad, :]
    return x.permute(0, 2, 3, 1).float()


@dataclasses.dataclass(frozen=True)
class AugmentPipe:
    p: float = 1.0
    xflip: float = 0.0
    yflip: float = 0.0
    rotate_int: float = 0.0
    translate_int: float = 0.0
    translate_int_max: float = 0.125
    scale: float = 0.0
    rotate_frac: float = 0.0
    aniso: float = 0.0
    translate_frac: float = 0.0
    scale_std: float = 0.2
    rotate_frac_max: float = 1.0
    aniso_std: float = 0.2
    aniso_rotate_prob: float = 0.5
    translate_frac_std: float = 0.125
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    # True = the reference's sym6-filtered anti-aliased warp; False = plain
    # bilinear (cheaper, a documented divergence)
    filtered: bool = True

    def __call__(self, images: torch.Tensor, generator: torch.Generator | None = None, *,
                 draws: dict | None = None):
        """images [N, H, W, C] fp32 (C 1 or 3) -> (images, labels [N,
        label_dim]). ``draws``: optional {name: post-gate parameter values}
        taking the place of the generator's draws (names: xflip, yflip,
        rotate_int, translate_int, scale, rotate_frac, aniso_w, aniso_r,
        translate_frac, brightness, contrast, lumaflip, hue, saturation;
        translate_int and translate_frac are [2, N], the others [N])."""
        n, h, w, c = images.shape
        dev = images.device
        images = images.float()
        labels = []
        draws = draws or {}

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        def randint(high):
            return torch.randint(0, high, (n,), generator=generator, device=dev).float()

        def maybe(prob_mult, val):
            # one gate per sample: [N] for a [N] value, [1, N] for a [2, N] one
            keep = rand(*val.shape[:1]) < prob_mult * self.p
            return torch.where(keep, val, torch.zeros_like(val))

        def inj(name, draw_fn):
            # injected values are post-gate parameters; else the generator's
            # draw behind its probability gate
            if name in draws:
                return torch.tensor(np.asarray(draws[name], np.float32), device=dev)
            return draw_fn()

        def pair_gate(prob, val):
            # translate_int / translate_frac: x and y behind one gate per sample
            keep = rand(1, n) < prob * self.p
            return torch.where(keep, val, torch.zeros_like(val))

        # Pixel blits (augment.py:160-196).
        if self.xflip > 0:
            wv = inj("xflip", lambda: maybe(self.xflip, randint(2)))
            images = torch.where(wv.reshape(-1, 1, 1, 1) == 1, images.flip(2), images)
            labels.append(wv[:, None])
        if self.yflip > 0:
            wv = inj("yflip", lambda: maybe(self.yflip, randint(2)))
            images = torch.where(wv.reshape(-1, 1, 1, 1) == 1, images.flip(1), images)
            labels.append(wv[:, None])
        if self.rotate_int > 0:
            wv = inj("rotate_int", lambda: maybe(self.rotate_int, randint(4)))
            m = wv.reshape(-1, 1, 1, 1)
            images = torch.where((m == 1) | (m == 2), images.flip(2), images)
            images = torch.where((m == 2) | (m == 3), images.flip(1), images)
            images = torch.where((m == 1) | (m == 3), images.transpose(1, 2), images)
            labels += [((wv == 1) | (wv == 2)).float()[:, None],
                       ((wv == 2) | (wv == 3)).float()[:, None]]
        if self.translate_int > 0:
            wv = inj("translate_int", lambda: pair_gate(self.translate_int, rand(2, n) * 2 - 1))
            tx = torch.round(wv[0] * (w * self.translate_int_max)).long()
            ty = torch.round(wv[1] * (h * self.translate_int_max)).long()
            ys = torch.arange(h, device=dev)[None, :, None]
            xs = torch.arange(w, device=dev)[None, None, :]
            # mirror-wrap indexing (augment.py:189-192); % is the floor modulo
            xi = (w - 1) - ((w - 1) - (xs - tx[:, None, None]) % (w * 2 - 2)).abs()
            yi = (h - 1) - ((h - 1) - (ys + ty[:, None, None]) % (h * 2 - 2)).abs()
            idx = (yi * w + xi).reshape(n, h * w, 1).expand(n, h * w, c)
            images = torch.gather(images.reshape(n, h * w, c), 1, idx).reshape(n, h, w, c)
            labels += [(tx / (w * self.translate_int_max)).float()[:, None],
                       (ty / (h * self.translate_int_max)).float()[:, None]]

        # Geometric transform parameters (augment.py:200-227), composed in
        # float64 from the float32 draws (the warp runs in float64).
        f64 = lambda v: v.double()
        g_inv = torch.eye(3, dtype=torch.float64, device=dev).expand(n, 3, 3)
        use_geom = False
        if self.scale > 0:
            wv = inj("scale", lambda: maybe(self.scale, randn(n)))
            s = torch.exp2(f64(wv) * self.scale_std)
            g_inv = g_inv @ _scale2d(1 / s, 1 / s)
            labels.append(wv[:, None])
            use_geom = True
        if self.rotate_frac > 0:
            wv = inj("rotate_frac", lambda: maybe(
                self.rotate_frac, (rand(n) * 2 - 1) * (math.pi * self.rotate_frac_max)))
            g_inv = g_inv @ _rotate2d(f64(wv))  # rotate2d_inv(-w) == rotate2d(w)
            labels += [(_cos(wv) - 1)[:, None], _sin(wv)[:, None]]
            use_geom = True
        if self.aniso > 0:
            if "aniso_w" in draws:
                wv = torch.tensor(np.asarray(draws["aniso_w"], np.float32), device=dev)
                r = torch.tensor(np.asarray(draws["aniso_r"], np.float32), device=dev)
            else:
                wv, r = randn(n), (rand(n) * 2 - 1) * math.pi
                wv = maybe(self.aniso, wv)
                r = torch.where(rand(n) < self.aniso_rotate_prob, r, torch.zeros_like(r))
            s = torch.exp2(f64(wv) * self.aniso_std)
            g_inv = g_inv @ _rotate2d(-f64(r)) @ _scale2d(1 / s, s) @ _rotate2d(f64(r))
            labels += [(wv * _cos(r))[:, None], (wv * _sin(r))[:, None]]
            use_geom = True
        if self.translate_frac > 0:
            wv = inj("translate_frac", lambda: pair_gate(self.translate_frac, randn(2, n)))
            g_inv = g_inv @ _translate2d(-f64(wv[0]) * (w * self.translate_frac_std),
                                         -f64(wv[1]) * (h * self.translate_frac_std))
            labels += [wv[0][:, None], wv[1][:, None]]
            use_geom = True

        if use_geom:
            images = (_filtered_warp if self.filtered else _bilinear_warp)(images, g_inv)

        # Colour transforms (augment.py:277-318), composed in float64 and
        # applied in float32.
        eye4 = torch.eye(4, dtype=torch.float64, device=dev)
        m = eye4.expand(n, 4, 4)
        use_color = False
        luma = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=torch.float64, device=dev) / math.sqrt(3.0)
        outer = torch.outer(luma, luma)
        if self.brightness > 0:
            wv = inj("brightness", lambda: maybe(self.brightness, randn(n)))
            b = f64(wv) * self.brightness_std
            m = _translate3d(b, b, b) @ m
            labels.append(wv[:, None])
            use_color = True
        if self.contrast > 0:
            wv = inj("contrast", lambda: maybe(self.contrast, randn(n)))
            cs = torch.exp2(f64(wv) * self.contrast_std)
            m = _scale3d(cs, cs, cs) @ m
            labels.append(wv[:, None])
            use_color = True
        if self.lumaflip > 0:
            wv = inj("lumaflip", lambda: maybe(self.lumaflip, randint(2)))
            m = (eye4 - 2.0 * outer * f64(wv)[:, None, None]) @ m
            labels.append(wv[:, None])
            use_color = True
        if self.hue > 0:
            wv = inj("hue", lambda: maybe(
                self.hue, (rand(n) * 2 - 1) * (math.pi * self.hue_max)))
            m = _rotate3d_about(luma[:3] / torch.linalg.norm(luma[:3]), f64(wv)) @ m
            labels += [(_cos(wv) - 1)[:, None], _sin(wv)[:, None]]
            use_color = True
        if self.saturation > 0:
            wv = inj("saturation", lambda: maybe(self.saturation, randn(n)))
            sat = torch.exp2(f64(wv) * self.saturation_std)[:, None, None]
            m = (outer + (eye4 - outer) * sat) @ m
            labels.append(wv[:, None])
            use_color = True

        if use_color:
            m = m.float()
            flat = images.reshape(n, h * w, c)
            if c == 3:
                flat = flat @ m[:, :3, :3].transpose(1, 2) + m[:, None, :3, 3]
            elif c == 1:
                mm = m[:, :3, :].mean(dim=1, keepdim=True)  # [n, 1, 4]
                flat = flat * mm[:, :, :3].sum(-1, keepdim=True) + mm[:, :, 3:]
            else:
                raise ValueError("images must have 1 or 3 channels")
            images = flat.reshape(n, h, w, c)

        label_vec = (torch.cat(labels, dim=1).float() if labels
                     else torch.zeros((n, 0), device=dev))
        return images, label_vec

    @property
    def label_dim(self) -> int:
        dim = 0
        for attr, width in (
            ("xflip", 1), ("yflip", 1), ("rotate_int", 2), ("translate_int", 2),
            ("scale", 1), ("rotate_frac", 2), ("aniso", 2), ("translate_frac", 2),
            ("brightness", 1), ("contrast", 1), ("lumaflip", 1), ("hue", 2),
            ("saturation", 1),
        ):
            if getattr(self, attr) > 0:
                dim += width
        return dim


def edm_augment_pipe(p: float = 0.12) -> AugmentPipe:
    """The EDM training configuration (reference train.py:144-146): 9 label
    dims."""
    return AugmentPipe(p=p, xflip=1e8, yflip=1, scale=1, rotate_frac=1, aniso=1,
                       translate_frac=1)


__all__ = ["AugmentPipe", "edm_augment_pipe"]
