"""The training loop: ticks, snapshots, stats.jsonl, and resume (counterpart
of diffusion_tts_tpu/training/loop.py).

Counterpart of the reference training loop (edm/training/training_loop.py:
25-216): the optimization step is ``train_step`` (eager PyTorch: the
accumulation rounds, Adam and the EMA are ordinary kernel launches), the
host loop feeds batches, tracks ticks and writes snapshots and stats. The
loss stays on the device between ticks, so the host enqueues steps without
waiting for the device.

Inside a process group the loop is data-parallel, as the JAX loop is over
its mesh: it takes the mesh, or builds one over the group's ranks, and
makes the step data-parallel over its ``data`` axis
(``parallel/mesh.py::shard_train_step``, DistributedDataParallel). Each
rank feeds its own share of the global batch and draws its own noise;
the moments of the stats are summed over the ranks at every tick, and rank
0 alone writes stats.jsonl, snapshots and state dumps.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from diffusion_tts_torch.models.torch_import import load_into
from diffusion_tts_torch.parallel.distributed import is_main_process, rank, rank_device, world_size
from diffusion_tts_torch.parallel.mesh import check_consistency, make_mesh, shard_train_step
from diffusion_tts_torch.training import checkpoints
from diffusion_tts_torch.training.train_step import TrainConfig, TrainState, train_step
from diffusion_tts_torch.utils import rng
from diffusion_tts_torch.utils.device import resolve_device
from diffusion_tts_torch.utils.logging_utils import format_time, print0
from diffusion_tts_torch.utils.stats import Collector, JsonlLogger

# Max pending-loss device scalars held between ticks: the backlog is
# drained into the Collector once it reaches this many steps, so a
# kimg-scale tick cannot pin thousands of live device buffers. By drain
# time the oldest entry is this many steps behind the enqueue frontier, so
# the host fetch does not stall the device.
MAX_PENDING_LOSSES = 64


@dataclasses.dataclass
class LoopConfig:
    run_dir: str = "runs/exp"
    total_kimg: int = 200000  # training_loop.py defaults
    kimg_per_tick: int = 50
    snapshot_ticks: int = 50
    state_dump_ticks: int = 500
    seed: int = 0
    batch_size: int = 512  # global
    batch_gpu: int | None = None  # microbatch per accumulation round per rank
    # Accepted for the JAX CLI's sake and without effect: there it moves the
    # boundary of the compiled program (several steps per dispatch); eager
    # PyTorch has no such boundary.
    steps_per_dispatch: int = 1


def training_loop(
    *,
    net: nn.Module,  # precond module; its parameters are trained in place
    net_config: dict,
    data_iter: Iterator[tuple[np.ndarray, np.ndarray]],  # this rank's share of each batch
    loss_fn: Callable,
    train_cfg: TrainConfig,
    loop_cfg: LoopConfig,
    augment_fn: Callable | None = None,
    device: torch.device | str = "cuda",
    resume_state_path: str | None = None,
    transfer_snapshot_path: str | None = None,
    max_ticks: int | None = None,
    mesh=None,
) -> TrainState:
    dev = rank_device(resolve_device(device))
    if mesh is None and dist.is_initialized():
        mesh = make_mesh(device_type=dev.type)
    main = is_main_process()
    if main:
        os.makedirs(loop_cfg.run_dir, exist_ok=True)
    net.to(dev)
    n_params = sum(p.numel() for p in net.parameters())
    print0(f"{type(net).__name__}: {n_params} parameters on {dev}")
    if transfer_snapshot_path:
        # transfer learning: initialize from a donor EMA snapshot, keeping the
        # random init of any parameter the donor lacks or shapes differently
        # (train.py:165-169, misc.py:155-166)
        donor, _ = checkpoints.load_snapshot(transfer_snapshot_path)
        own = net.state_dict()
        load_into(net, {k: donor[k] if k in donor and donor[k].shape == v.shape else v
                        for k, v in own.items()})
        print0(f"transferred weights from {transfer_snapshot_path}")
    state = TrainState.create(net, train_cfg)
    if resume_state_path:
        state = checkpoints.load_state(resume_state_path, like=state)
        print0(f"resumed from {resume_state_path} at nimg={state.nimg}")
    if mesh is not None:
        state = shard_train_step(state, mesh)

    rounds = train_cfg.grad_accum_rounds
    generator = torch.Generator(device=dev)
    # every draw of a step is addressed by (seed, nimg[, rank]): a resumed
    # run draws what the uninterrupted one would have, and ranks draw apart
    step_path = () if world_size() == 1 else (rank(),)
    collector = Collector()
    jsonl = JsonlLogger(os.path.join(loop_cfg.run_dir, "stats.jsonl")) if main else None
    tick = 0
    tick_start_nimg = state.nimg
    tick_start_time = start_time = time.time()
    pending_losses: list[torch.Tensor] = []  # device scalars; drained at ticks

    def drain() -> None:
        if pending_losses:
            collector.report("Loss/loss", torch.stack(pending_losses).cpu().numpy())
            pending_losses.clear()

    def snapshot(name: str) -> None:
        if mesh is not None:  # every rank holds rank 0's net, checked as the reference does
            # before each snapshot (check_ddp_consistency, misc.py:180-193)
            check_consistency(state.net)
            check_consistency(state.ema)
        if main:
            checkpoints.save_snapshot(os.path.join(loop_cfg.run_dir, name),
                                      state.ema.state_dict(), net_config)

    def to_rounds(batch: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.asarray(batch, np.float32)).to(dev, non_blocking=True)
        return x.reshape((rounds, x.shape[0] // rounds) + x.shape[1:])

    try:
        while True:
            images, labels = next(data_iter)
            generator.manual_seed(rng.fold_in_path(loop_cfg.seed, state.nimg, *step_path))
            metrics = train_step(state, to_rounds(images), to_rounds(labels), loss_fn,
                                 train_cfg, generator, augment_fn)
            pending_losses.append(metrics["loss"])
            if len(pending_losses) >= MAX_PENDING_LOSSES:
                drain()
            nimg = state.nimg

            done = nimg >= loop_cfg.total_kimg * 1000
            tick_done = nimg >= tick_start_nimg + loop_cfg.kimg_per_tick * 1000
            if tick_done or done:
                drain()  # waits for the device: the tick's time is the device's
                now = time.time()
                collector.report0(
                    "Timing/sec_per_kimg",
                    (now - tick_start_time) / max((nimg - tick_start_nimg) / 1000, 1e-8))
                collector.sync()
                print0(f"tick {tick:<5d} kimg {nimg / 1000:<9.1f} "
                       f"loss {collector.mean('Loss/loss'):<8.4f} "
                       f"time {format_time(now - start_time)}")
                if main:
                    jsonl.write(collector, tick=tick, kimg=nimg / 1000)
                collector.reset()
                tick += 1
                tick_start_nimg = nimg
                tick_start_time = now

                if loop_cfg.snapshot_ticks and tick % loop_cfg.snapshot_ticks == 0:
                    snapshot(f"network-snapshot-{nimg // 1000:06d}.pt")
                if main and loop_cfg.state_dump_ticks and tick % loop_cfg.state_dump_ticks == 0:
                    checkpoints.save_state(
                        os.path.join(loop_cfg.run_dir, f"training-state-{nimg // 1000:06d}.pt"),
                        state)
                if max_ticks is not None and tick >= max_ticks:
                    break
            if done:
                break
    finally:
        if main:
            jsonl.close()
    snapshot("network-snapshot-final.pt")
    return state


__all__ = ["training_loop", "LoopConfig", "MAX_PENDING_LOSSES"]
