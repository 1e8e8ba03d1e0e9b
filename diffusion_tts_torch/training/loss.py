"""Diffusion training losses: VP, VE, EDM (counterpart of
diffusion_tts_tpu/training/loss.py; reference training/loss.py:20-80).

Each loss is a callable ``loss_fn(denoise, images, labels, generator=None,
augment_fn=None, *, u=None, noise=None, augment_draws=None) -> per-pixel
loss [B, H, W, C]``: noise levels drawn from the formulation's
distribution, weighted denoising MSE on the images ``augment_fn``
(training/augment.py's pipe, or None) returns, whose labels condition the
net. ``denoise(x, sigma, labels, augment_labels)`` is the preconditioned
net. Images are NHWC in [-1, 1].

The two draws (the [B, 1, 1, 1] noise-level variate and the unit noise of
the images' shape) come from ``generator``, a ``torch.Generator`` on the
images' device, or are handed in as ``u`` and ``noise``; the pipe draws
from the same generator, or takes ``augment_draws`` (its ``draws=``):
torch cannot reproduce JAX's threefry bits, so a test that compares with
the JAX package injects JAX's draws.
"""
from __future__ import annotations

import dataclasses

import torch


def _draws(images: torch.Tensor, generator, u, noise, uniform: bool):
    b = images.shape[0]
    draw = torch.rand if uniform else torch.randn
    if u is None:
        u = draw((b, 1, 1, 1), generator=generator, device=images.device)
    if noise is None:
        noise = torch.randn(images.shape, generator=generator, device=images.device)
    return u.reshape(b, 1, 1, 1).float(), noise.float()


def _weighted_mse(denoise, images, labels, sigma, weight, noise, augment_fn, generator,
                  augment_draws):
    y, augment_labels = (augment_fn(images, generator, draws=augment_draws) if augment_fn
                         else (images, None))
    d_yn = denoise(y + noise * sigma, sigma.reshape(-1), labels, augment_labels)
    return weight * (d_yn - y) ** 2


@dataclasses.dataclass(frozen=True)
class VPLoss:
    """sigma from the VP schedule at t ~ U(eps_t, 1); weight 1/sigma^2."""

    beta_d: float = 19.9
    beta_min: float = 0.1
    epsilon_t: float = 1e-5

    def sigma(self, t):
        t = torch.as_tensor(t, dtype=torch.float32)
        return torch.sqrt(torch.expm1(0.5 * self.beta_d * t**2 + self.beta_min * t))

    def __call__(self, denoise, images, labels, generator=None, augment_fn=None, *,
                 u=None, noise=None, augment_draws=None):
        u, noise = _draws(images, generator, u, noise, uniform=True)
        sigma = self.sigma(1.0 + u * (self.epsilon_t - 1.0))
        return _weighted_mse(denoise, images, labels, sigma, 1.0 / sigma**2, noise, augment_fn,
                             generator, augment_draws)


@dataclasses.dataclass(frozen=True)
class VELoss:
    """log-uniform sigma in [sigma_min, sigma_max]; weight 1/sigma^2."""

    sigma_min: float = 0.02
    sigma_max: float = 100.0

    def __call__(self, denoise, images, labels, generator=None, augment_fn=None, *,
                 u=None, noise=None, augment_draws=None):
        u, noise = _draws(images, generator, u, noise, uniform=True)
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** u
        return _weighted_mse(denoise, images, labels, sigma, 1.0 / sigma**2, noise, augment_fn,
                             generator, augment_draws)


@dataclasses.dataclass(frozen=True)
class EDMLoss:
    """ln(sigma) ~ N(P_mean, P_std^2); weight (s^2+sd^2)/(s*sd)^2."""

    P_mean: float = -1.2
    P_std: float = 1.2
    sigma_data: float = 0.5

    def __call__(self, denoise, images, labels, generator=None, augment_fn=None, *,
                 u=None, noise=None, augment_draws=None):
        rnd, noise = _draws(images, generator, u, noise, uniform=False)
        sigma = torch.exp(rnd * self.P_std + self.P_mean)
        weight = (sigma**2 + self.sigma_data**2) / (sigma * self.sigma_data) ** 2
        return _weighted_mse(denoise, images, labels, sigma, weight, noise, augment_fn,
                             generator, augment_draws)


__all__ = ["VPLoss", "VELoss", "EDMLoss"]
