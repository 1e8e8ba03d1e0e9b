"""Parameter sharding over the ``model`` axis (counterpart of
diffusion_tts_tpu/parallel/sharding_rules.py).

The JAX rule shards every large array's output-feature dimension over
'model': the last dimension of a conv kernel (HWIO) or dense kernel
([in, out]), and biases and norm scales (their only dimension). In torch's
layout the output features lead: dim 0 of a conv weight [O, I, kh, kw], a
linear weight [out, in], a bias or a norm weight. FSDP2's ``fully_shard``
over a 2-D (data, model) mesh shards dim 0 over 'model' and replicates over
'data' (HSDP), which is that rule; what the rule leaves whole (too small,
or not divisible) FSDP2 is told to ignore, and its gradient is all-reduced
here. The Adam moments follow their parameters, and the EMA is sharded the
same way, so its update runs on local shards.

Under FSDP2 every rank computes on its own share of the batch (the model
ranks too), and the step's gradient is the mean over all of them: the
same step as data parallelism over every rank, with each rank holding
1/model of every sharded tensor.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard


def param_spec(leaf, axis_size: int, min_size: int = 2):
    """The placement of one tensor on the model axis: ``Shard(0)`` when its
    leading (output-feature) dimension divides by the axis and holds at
    least ``min_size`` rows a rank, else ``Replicate()``."""
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) >= 1 and shape[0] % axis_size == 0 and shape[0] >= min_size * axis_size:
        return Shard(0)
    return Replicate()


class ModelSharded:
    """How ``train_step`` runs a step of a ``shard_state`` state: forwards
    through the FSDP2 module itself, the gradient reduce-scatter only in the
    last accumulation round, then the mean of the replicated parameters'
    gradients over every rank."""

    def __init__(self, net: nn.Module, replicated: list[nn.Parameter]):
        self.module, self.replicated = net, replicated

    def round(self, last: bool):
        self.module.set_requires_gradient_sync(last)
        return contextlib.nullcontext()

    def reduce(self) -> None:
        grads = [p.grad for p in self.replicated if p.grad is not None]
        if grads:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            flat /= dist.get_world_size()
            for g, v in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(v.view_as(g))


def shard_state(state, mesh: DeviceMesh, axis: str = "model", min_size: int = 64):
    """Shard a fresh ``TrainState``'s net, EMA and Adam moments on ``axis``
    (the last dimension of ``mesh``; a 2-D mesh replicates over its first)
    by ``param_spec``, in place. A mesh without ``axis`` leaves the state as
    it is. Returns ``state``."""
    from torch.distributed.fsdp import fully_shard

    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return state
    if names[-1] != axis:
        raise ValueError(f"the model axis {axis!r} must be the mesh's last, not of {names}")
    if state.opt.state:
        raise ValueError("shard_state takes a state before its first step (no Adam moments)")
    size = mesh.size(names.index(axis))
    whole = {n for n, p in state.net.named_parameters()
             if isinstance(param_spec(p, size, min_size), Replicate)}
    for module in (state.net, state.ema):
        fully_shard(module, mesh=mesh, ignored_params={
            p for n, p in module.named_parameters() if n in whole})
    sharded = [p for n, p in state.net.named_parameters() if n not in whole]
    replicated = [p for n, p in state.net.named_parameters() if n in whole]
    defaults = state.opt.defaults
    # two groups: torch's foreach kernels take DTensors or tensors, not both
    state.opt = type(state.opt)([{"params": sharded}, {"params": replicated}], **defaults)
    state.parallel = ModelSharded(state.net, replicated)
    return state


def is_sharded(p) -> bool:
    return isinstance(p, DTensor) and any(isinstance(pl, Shard) for pl in p.placements)


def describe_sharding(module: nn.Module, max_rows: int = 20) -> str:
    rows = [f"{n}: {tuple(p.shape)} -> {p.placements}"
            for n, p in module.named_parameters() if is_sharded(p)]
    out = "\n".join(rows[:max_rows])
    if len(rows) > max_rows:
        out += f"\n... {len(rows) - max_rows} more sharded parameters"
    return out or "(fully replicated)"


__all__ = ["param_spec", "shard_state", "describe_sharding", "is_sharded", "ModelSharded"]
