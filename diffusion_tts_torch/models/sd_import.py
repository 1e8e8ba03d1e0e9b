"""Carry Stable Diffusion weights into the port (counterpart of
diffusion_tts_tpu/models/sd_import.py).

The port's SD modules carry diffusers' names and shapes, so:

  * ``load_diffusers`` loads a diffusers state dict (the goldens' ``sd::``
    entries, a checkpoint's ``.safetensors``) as it is; keys of parts the
    module does not build (``UNPORTED_PREFIXES``, the VAE's encoder) are
    skipped, any other missing or extra key raises;
  * ``state_dict_from_flax_sd`` turns the JAX package's flax SD params
    (numpy leaves) into that state dict, inverting
    ``convert_diffusers_state_dict``: ``name_{i}`` -> ``name.{i}`` for the
    indexed containers, conv kernels HWIO -> OIHW, dense kernels
    [in, out] -> [out, in], ``scale`` -> ``weight``;
  * ``load_safetensors`` reads a ``.safetensors`` file with numpy alone.
"""
from __future__ import annotations

import json
import struct
from typing import Mapping

import numpy as np
import torch
from torch import nn

from diffusion_tts_torch.models.torch_import import load_into

# diffusers containers whose children are numbered: flax names them name_{i}
_INDEXED = {"down_blocks", "up_blocks", "resnets", "attentions", "downsamplers",
            "upsamplers", "transformer_blocks", "to_out", "net"}


def load_diffusers(module: nn.Module, state: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a diffusers state dict into the port's module (rounded once to
    each parameter's dtype); raises on a missing or extra key."""
    skip = getattr(module, "UNPORTED_PREFIXES", ())
    tensors = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.float32)))
               for k, v in state.items() if not k.startswith(skip)}
    return load_into(module, tensors)


def _diffusers_path(parts: list[str]) -> list[str]:
    out = []
    for p in parts:
        head, _, idx = p.rpartition("_")
        out.extend([head, idx] if head in _INDEXED and idx.isdigit() else [p])
    return out


def state_dict_from_flax_sd(params: Mapping) -> dict[str, np.ndarray]:
    """Flax SD ``params`` tree (numpy leaves, no ``"params"`` wrapper) ->
    a diffusers-named state dict of numpy arrays."""
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [k])
            return
        value = np.asarray(node, np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif value.ndim == 2:
                value = value.T
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {value.shape}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"unmapped leaf {'/'.join(path)}")
        name = ".".join(_diffusers_path(path[:-1]) + [leaf])
        if name in out:
            raise ValueError(f"duplicate parameter {name}")
        out[name] = np.ascontiguousarray(value)

    walk(params, [])
    return out


_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64, "I64": np.int64,
           "I32": np.int32, "U8": np.uint8, "BOOL": np.bool_}


def load_safetensors(path: str) -> dict[str, np.ndarray]:
    """Read a .safetensors file into float32 numpy arrays (bf16 widened)."""
    out = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + hlen)
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = np.asarray(data[start:end])
        if meta["dtype"] == "BF16":
            arr = (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        elif meta["dtype"] in _DTYPES:
            arr = raw.view(_DTYPES[meta["dtype"]])
        else:
            raise ValueError(f"{path}: unsupported dtype {meta['dtype']} for {key}")
        out[key] = np.array(arr.reshape(meta["shape"]), np.float32)  # a writable copy
    return out


__all__ = ["load_diffusers", "state_dict_from_flax_sd", "load_safetensors"]
