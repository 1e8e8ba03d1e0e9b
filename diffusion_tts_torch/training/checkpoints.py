"""Checkpoint / resume (counterpart of diffusion_tts_tpu/training/checkpoints.py).

Counterpart of the reference's two-tier scheme (training_loop.py:177-193):
(1) EMA *snapshots*: the EMA net's ``state_dict`` written with
``torch.save``, plus ``<path>.config.json`` that reconstructs the module;
(2) full *state dumps*: parameters, EMA, Adam moments and ``nimg`` for an
exact resume. Files are read with ``torch.load(weights_only=True)``: they
hold tensors and plain containers only.

``train_state_from_flax`` carries a training state of the JAX package
(numpy trees of its ``TrainState``) into the port, so that a run started
there continues here.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Mapping

import torch
from torch import nn

from diffusion_tts_torch.models.torch_import import load_into, state_dict_from_flax
from diffusion_tts_torch.training.train_step import TrainConfig, TrainState

# On-disk parameter-layout version, shared with the JAX package's
# checkpoints. History:
#   1 (implicit, no marker): qkv projection channels in the reference's
#     interleaved ((head, d), 3) order.
#   2: qkv channels de-interleaved to contiguous (3, head, d) thirds
#     (models/torch_import._deinterleave_qkv). A version-1 state loads without
#     shape errors but silently permutes attention channels, so loads
#     hard-fail on a mismatch.
CKPT_FORMAT_VERSION = 2


def _check_format_version(found: int | None, path: str) -> None:
    if found == CKPT_FORMAT_VERSION:
        return
    raise ValueError(
        f"checkpoint {path} has parameter-layout version {found} "
        f"(expected {CKPT_FORMAT_VERSION}). A pre-qkv-deinterleave state would "
        "load cleanly but silently channel-permute attention outputs. "
        "Re-export it from the source weights "
        "(diffusion_tts_torch.models.torch_import.load_reference_state_dict).")


def _write(path: str, payload: Any) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a killed run leaves no half-written checkpoint
    return path


def save_snapshot(path: str, ema_state: Mapping[str, torch.Tensor], config: dict) -> None:
    """EMA snapshot + reconstruction config (network-snapshot-*.pkl
    counterpart, training_loop.py:177-189)."""
    path = _write(path, {k: v.detach().cpu() for k, v in ema_state.items()})
    with open(path + ".config.json", "w") as f:
        json.dump(dict(config, ckpt_format_version=CKPT_FORMAT_VERSION), f, indent=2)


def load_snapshot(path: str) -> tuple[dict[str, torch.Tensor], dict]:
    path = os.path.abspath(path)
    with open(path + ".config.json") as f:
        config = json.load(f)
    _check_format_version(config.get("ckpt_format_version"), path)
    return torch.load(path, map_location="cpu", weights_only=True), config


def save_state(path: str, state: TrainState) -> None:
    """Full training state dump (training-state-*.pt counterpart,
    training_loop.py:191-193)."""
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}
    opt = state.opt.state_dict()
    opt["state"] = {i: {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in s.items()}
                    for i, s in opt["state"].items()}
    _write(path, {"ckpt_format_version": CKPT_FORMAT_VERSION, "net": cpu(state.net.state_dict()),
                  "ema": cpu(state.ema.state_dict()), "opt": opt, "nimg": int(state.nimg)})


def load_state(path: str, like: TrainState) -> TrainState:
    """Load a state dump into ``like`` (a fresh ``TrainState`` of the same
    net) in place and return it."""
    path = os.path.abspath(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    _check_format_version(payload.get("ckpt_format_version"), path)
    load_into(like.net, payload["net"])
    load_into(like.ema, payload["ema"])
    like.opt.load_state_dict(payload["opt"])  # moves the moments to the parameters' device
    like.nimg = int(payload["nimg"])
    return like


def train_state_from_flax(net: nn.Module, cfg: TrainConfig, params: Mapping,
                          ema_params: Mapping, mu: Mapping, nu: Mapping, count: int,
                          nimg: int) -> TrainState:
    """A JAX ``TrainState`` continued in the port. ``params``, ``ema_params``
    and Adam's first and second moments ``mu`` and ``nu`` are flax trees with
    numpy leaves (``jax.device_get`` of ``state.params``, ``state.ema_params``
    and the ``ScaleByAdamState`` inside ``state.opt_state``), ``count`` Adam's
    step count, ``nimg`` the images seen. ``net`` is the port's module of the
    same architecture; it is loaded in place."""
    load_into(net, state_dict_from_flax(params))
    state = TrainState.create(net, cfg)
    load_into(state.ema, state_dict_from_flax(ema_params))
    first, second = state_dict_from_flax(mu), state_dict_from_flax(nu)
    for name, p in net.named_parameters():
        state.opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": first[name].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": second[name].to(device=p.device, dtype=p.dtype),
        }
    state.nimg = int(nimg)
    return state


def parse_kimg_from_name(path: str) -> int:
    """Resume kimg from the filename (train.py:170-176:
    training-state-<kimg>.*)."""
    m = re.search(r"-(\d+)(?:\.[^.]*)?$", os.path.basename(path.rstrip("/")))
    return int(m.group(1)) if m else 0


__all__ = [
    "save_snapshot", "load_snapshot", "save_state", "load_state", "train_state_from_flax",
    "parse_kimg_from_name", "CKPT_FORMAT_VERSION",
]
