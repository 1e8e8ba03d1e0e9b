"""Device meshes, the data-parallel step and candidate sharding
(counterpart of diffusion_tts_tpu/parallel/mesh.py).

The JAX package turns the reference's NCCL layer (DDP's bucketed
all-reduce, the stats all_reduce) into shardings on a ``jax.sharding.Mesh``
and lets XLA insert the collectives. Here the collectives are
torch.distributed's, on a ``DeviceMesh`` with the same axis names:

  data       batch sharding: ``shard_train_step`` wraps the net in
             ``DistributedDataParallel`` over this axis's group;
  model      the parameter sharding of ``sharding_rules.shard_state``;

and the search's candidate axis is ``CandidateShards``: each rank runs the
denoiser forwards of its contiguous slice of the flattened [N*B] candidate
expansion, then every output is all-gathered, so every rank holds (and
scores, and selects from) the whole candidate set.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# The first flattened candidate lane of the slice this rank is running
# inside CandidateShards.map; 0 everywhere else.
_LANE_START = contextvars.ContextVar("candidate_lane_start", default=0)


def make_mesh(axes: dict[str, int] | None = None, *, device_type: str) -> DeviceMesh:
    """A mesh over the group's ranks with the given axis sizes (default:
    every rank on "data"); raises when they do not multiply to the world."""
    world = dist.get_world_size()
    axes = axes or {"data": world}
    if math.prod(axes.values()) != world:
        raise ValueError(f"mesh {axes} needs {math.prod(axes.values())} ranks, have {world}")
    return init_device_mesh(device_type, tuple(axes.values()), mesh_dim_names=tuple(axes))


def shard_array(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim``, the dimension
    sharded over every rank of ``mesh`` (the JAX package's
    ``shard_array(x, mesh, P(..., "data"))`` as the rank sees it)."""
    n, world = x.shape[dim], mesh.size()
    if n % world:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not divide over {world} ranks")
    size = n // world
    return x.narrow(dim, mesh.get_rank() * size, size)


class DataParallel:
    """How ``train_step`` runs one rank's share of a data-parallel step:
    its forwards go through ``module`` (the ``DistributedDataParallel``
    wrapper), every accumulation round but the last under ``no_sync()``
    (training_loop.py:123-132), so the gradient is all-reduced (averaged)
    once, in the last round's backward."""

    def __init__(self, ddp: nn.parallel.DistributedDataParallel):
        self.module = ddp

    def round(self, last: bool):
        return contextlib.nullcontext() if last else self.module.no_sync()

    def reduce(self) -> None:
        """Nothing left: the last round's backward all-reduced the gradient."""


def shard_train_step(state, mesh: DeviceMesh):
    """Make ``train_step`` data-parallel over the mesh's "data" axis: each
    rank steps on its own share of the batch and the gradients are averaged
    over the ranks (the JAX package's gradient mean over the sharded
    batch). A state from ``sharding_rules.shard_state`` is already
    data-parallel and does not come here. Returns ``state``, set up in
    place."""
    # DDP broadcasts the net from the group's rank 0 here; the EMA starts as
    # the same copy on every rank (the same seeded init or resumed state).
    # The buffers are constants (FourierEmbedding's freqs, iDDPM's u), made
    # alike on every rank: no broadcast before every forward.
    state.parallel = DataParallel(nn.parallel.DistributedDataParallel(
        state.net, process_group=mesh.get_group("data"), broadcast_buffers=False))
    return state


def check_consistency(module: nn.Module) -> None:
    """Raise unless every parameter and buffer of ``module`` is bit for bit
    rank 0's (the reference's check_ddp_consistency,
    misc.py:180-193), compared in one flat broadcast."""
    tensors = [t.detach() for t in list(module.parameters()) + list(module.buffers())]
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    if not torch.equal(flat.view(torch.int32), ref.view(torch.int32)):
        names = [n for n, _ in list(module.named_parameters()) + list(module.named_buffers())]
        sizes = [t.numel() for t in tensors]
        for name, a, b in zip(names, flat.split(sizes), ref.split(sizes)):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"rank {dist.get_rank()}: {name} differs from rank 0's")


def candidate_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of a per-sample tensor ``t`` [B, ...] (class labels, text
    embeddings) for ``n`` flattened candidate lanes, lane j taking row
    j % B: ``t`` repeated n / B times, or, inside ``CandidateShards.map``,
    the rows of this rank's slice of the lanes."""
    start, b = _LANE_START.get(), t.shape[0]
    if start == 0 and n % b == 0:
        return t.repeat((n // b,) + (1,) * (t.ndim - 1))
    return t[(start + torch.arange(n, device=t.device)) % b]


class CandidateShards:
    """The flattened [N*B] candidate axis of a search's expansion, spread
    over every rank of the group. Every rank must make the same calls:
    each runs the whole search, and ``map`` splits only the forwards it is
    given."""

    @property
    def world(self) -> int:
        return dist.get_world_size()

    def map(self, fn, *flat: torch.Tensor):
        """``fn`` on this rank's contiguous slice of the lanes (dim 0 of
        every tensor of ``flat``), its outputs (a tensor or a tuple of
        tensors, lanes first) gathered from every rank in lane order."""
        world, n = self.world, flat[0].shape[0]
        if n % world:
            raise ValueError(f"{n} candidate lanes do not divide over {world} ranks")
        size = n // world
        start = dist.get_rank() * size
        token = _LANE_START.set(start)
        try:
            out = fn(*(t[start:start + size] for t in flat))
        finally:
            _LANE_START.reset(token)
        if isinstance(out, torch.Tensor):
            return self._gather(out)
        return tuple(self._gather(o) for o in out)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        full = t.new_empty((self.world * t.shape[0],) + t.shape[1:])
        dist.all_gather_into_tensor(full, t)
        return full


__all__ = ["make_mesh", "shard_array", "shard_train_step", "DataParallel", "check_consistency",
           "candidate_rows", "CandidateShards"]
