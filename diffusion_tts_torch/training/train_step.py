"""One optimization step: gradient accumulation, LR ramp, Adam, EMA
(counterpart of diffusion_tts_tpu/training/train_step.py).

Counterpart of the reference training loop's inner iteration
(training/training_loop.py:123-148): R accumulation rounds with the
gradients summed (there: ``ddp_sync`` no-sync loops; in the JAX package a
``lax.scan`` inside one compiled program; here a Python loop of
forward + backward, PyTorch runs eagerly), the mean over R, NaN-scrubbed
gradients (``nan_to_num``, :137-139), the LR ramp-up, Adam, and the ramped
EMA (:142-148). The JAX package's ``accum_unroll`` and ``accum_flat_carry``
work around the TPU runtime and have no counterpart.

The state is updated in place: the net's parameters, the EMA copy, the
optimizer's moments and ``nimg``.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    lr_rampup_kimg: float = 10000.0  # train.py:73 / training_loop.py:135-136
    ema_halflife_kimg: float = 500.0  # training_loop.py:142-148
    ema_rampup_ratio: float = 0.05
    grad_accum_rounds: int = 1
    total_batch: int = 512  # global batch per step (nimg increment)


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    """Adam with ``optax.adam``'s update: bias-corrected moments, eps added
    outside the root. The ramped learning rate is set on the parameter
    group before every step."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=tuple(cfg.betas), eps=cfg.eps)


@dataclasses.dataclass
class TrainState:
    net: nn.Module  # the trained parameters
    ema: nn.Module  # their exponential moving average, never differentiated
    opt: torch.optim.Adam
    nimg: int = 0  # images seen (the reference's cur_nimg counter)

    @classmethod
    def create(cls, net: nn.Module, cfg: TrainConfig) -> "TrainState":
        ema = copy.deepcopy(net).eval().requires_grad_(False)
        return cls(net=net, ema=ema, opt=make_optimizer(cfg, net.parameters()))


def lr_at(cfg: TrainConfig, nimg: int) -> float:
    """The ramped learning rate before a step that starts at ``nimg``
    (training_loop.py:135-136), in fp32 like the JAX step."""
    ramp = min(np.float32(nimg) / np.float32(max(cfg.lr_rampup_kimg * 1000.0, 1e-8)),
               np.float32(1.0))
    return float(np.float32(cfg.lr) * ramp)


def ema_beta_at(cfg: TrainConfig, nimg_new: int) -> float:
    """The EMA decay after a step that ends at ``nimg_new``: the half-life
    ramps up with the images seen (training_loop.py:142-148)."""
    halflife = min(np.float32(cfg.ema_halflife_kimg * 1000.0),
                   np.float32(nimg_new) * np.float32(cfg.ema_rampup_ratio))
    return float(np.float32(0.5) ** (np.float32(cfg.total_batch)
                                     / max(halflife, np.float32(1e-8))))


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor | None,
               loss_fn: Callable, cfg: TrainConfig, generator: torch.Generator | None = None,
               augment_fn: Callable | None = None,
               draws: Sequence[dict] | None = None) -> dict:
    """One step on images [R, micro, H, W, C] and labels [R, micro, L], R the
    accumulation rounds. ``generator`` feeds the loss's draws, the augment
    pipe's (``augment_fn``, training/augment.py), dropout and label dropout;
    ``draws``, one ``dict(u=..., noise=...[, augment_draws=...])`` per round,
    takes the place of the loss's draws (and of the pipe's, by the pipe's
    ``draws=`` names). Returns the metrics: ``loss`` (a tensor on
    the device, so that the host does not wait for it), ``lr``, ``ema_beta``.
    """
    r = cfg.grad_accum_rounds
    if images.shape[0] != r:
        raise ValueError(f"images lead with {images.shape[0]} rounds, the config says {r}")
    net = state.net.train()
    params = [p for p in net.parameters() if p.requires_grad]
    state.opt.zero_grad(set_to_none=True)

    def denoise(x, sigma, lab, augment_labels):
        return net(x, sigma, lab, augment_labels, generator)

    loss_sum = torch.zeros((), device=images.device)
    for j in range(r):
        lab = None if labels is None else labels[j]
        loss = loss_fn(denoise, images[j], lab, generator, augment_fn,
                       **(draws[j] if draws is not None else {})).mean()
        loss.backward()  # gradients of the rounds add up in .grad
        loss_sum += loss.detach()

    grads = [p.grad for p in params if p.grad is not None]
    with torch.no_grad():
        torch._foreach_div_(grads, float(r))
        for g in grads:
            torch.nan_to_num_(g, nan=0.0, posinf=1e5, neginf=-1e5)

    # LR ramp-up from nimg before the increment
    lr = lr_at(cfg, state.nimg)
    for group in state.opt.param_groups:
        group["lr"] = lr
    state.opt.step()

    # EMA with ramp-up: e <- p + (e - p) * beta
    state.nimg += cfg.total_batch
    beta = ema_beta_at(cfg, state.nimg)
    with torch.no_grad():
        ema, cur = list(state.ema.parameters()), list(net.parameters())
        torch._foreach_sub_(ema, cur)
        torch._foreach_mul_(ema, beta)
        torch._foreach_add_(ema, cur)
    return {"loss": loss_sum / r, "lr": lr, "ema_beta": beta}


__all__ = ["TrainState", "TrainConfig", "make_optimizer", "train_step", "lr_at", "ema_beta_at"]
