"""Carry weights into the port (counterpart of
diffusion_tts_tpu/models/torch_import.py).

Two sources, both given as ``{name: numpy array}``:

  * ``load_reference_state_dict``: a reference-style torch ``state_dict``
    (edm/training/networks.py), e.g. the goldens' ``sd::`` entries. The
    port's modules carry the reference's names and shapes, so the only
    changes are the qkv de-interleave and dropping ``resample_filter``.
  * ``state_dict_from_flax``: the JAX package's flax parameter tree, whose
    qkv is already de-interleaved: ``enc_<name>`` -> ``enc.<name>``, conv
    kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in],
    ``scale`` -> ``weight``.

Both produce the port's ``state_dict``; ``load_into`` loads one and fails
loudly on a missing or extra key.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_SKIP_LEAVES = {"resample_filter"}


def _deinterleave_qkv(arr: np.ndarray, axis: int = -1) -> np.ndarray:
    """Reorder UNetBlock qkv projection output channels from the reference's
    interleaved ((head, d), 3) layout (networks.py:183 reshapes the conv
    output as [N*heads, cph, 3, HW]) to contiguous (3, (head, d)), the
    layout the attention kernel reads."""
    c3 = arr.shape[axis]
    if c3 % 3:
        raise ValueError(f"qkv axis of size {c3} is not a multiple of 3")
    arr = np.moveaxis(arr, axis, -1)
    shape = arr.shape
    arr = np.swapaxes(arr.reshape(shape[:-1] + (c3 // 3, 3)), -1, -2).reshape(shape)
    return np.moveaxis(arr, -1, axis)


def load_reference_state_dict(state: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Reference torch state dict -> the port's state dict."""
    out = {}
    for name, value in state.items():
        parts = name.split(".")
        if parts[-1] in _SKIP_LEAVES:
            continue
        value = np.asarray(value, np.float32)
        if len(parts) >= 2 and parts[-2] == "qkv":
            value = _deinterleave_qkv(value, axis=0)
        out[name] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``params`` tree (numpy leaves) -> the port's state dict."""
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                if k.startswith(("enc_", "dec_")) and isinstance(v, Mapping):
                    walk(v, path + k.split("_", 1))
                else:
                    walk(v, path + [k])
            return
        value = np.asarray(node, np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            leaf = "weight"
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif value.ndim == 2:
                value = value.T
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {value.shape}")
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"unmapped leaf {'/'.join(path)}")
        name = ".".join(path[:-1] + [leaf])
        if name in out:
            raise ValueError(f"duplicate parameter {name}")
        out[name] = torch.from_numpy(np.ascontiguousarray(value))

    walk(params, [])
    return out


def load_into(module: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Load ``state`` into ``module``; raises on a missing or extra key (a
    parameter left at its random init would pass silently otherwise)."""
    own = module.state_dict()
    missing, extra = sorted(own.keys() - state.keys()), sorted(state.keys() - own.keys())
    if missing or extra:
        raise ValueError(f"checkpoint/model mismatch; missing={missing[:4]} extra={extra[:4]}")
    module.load_state_dict(state, strict=True)
    return module


__all__ = ["load_reference_state_dict", "state_dict_from_flax", "load_into"]
