"""Train diffusion models (EDM recipes) on NVIDIA cards (counterpart of
the repo's train.py):

    python -m diffusion_tts_torch.train --outdir=training-runs \\
        --data=datasets/imagenet-64x64.zip --cond=1 --arch=adm --bf16=1 --augment=0
    torchrun --standalone --nproc_per_node=8 -m diffusion_tts_torch.train ...

Same flags, arch presets (ddpmpp, ncsnpp, adm), precond/loss pairs (vp, ve,
edm), run-dir naming, options dump and resume/transfer plumbing as the JAX
CLI (reference edm/train.py:41-236), the augmentation pipe included:
``--augment P > 0`` (default 0.12, the recipe's) trains on the EDM pipe's
images at probability P and conditions the net on its 9 labels. Runs on
the card unless ``--device cpu`` is given.

Under torchrun the ranks train data-parallel (one card each over NCCL, or
``--dist-backend gloo``, which lets ranks share a card or run on the CPU):
``--batch`` is the global batch, ``--batch-gpu`` the micro-batch of one
rank's accumulation round, so ``batch = batch_gpu x rounds x ranks``
(reference training_loop.py:60-64); each rank reads its own rank-strided
share of the data.
"""
from __future__ import annotations

import argparse
import json
import os
import re

import torch

ARCH_PRESETS = {
    # reference train.py:116-124
    "ddpmpp": dict(model_type="SongUNet",
                   model_kwargs=dict(embedding_type="positional", encoder_type="standard",
                                     decoder_type="standard", channel_mult_noise=1,
                                     resample_filter=(1, 1), model_channels=128,
                                     channel_mult=(2, 2, 2))),
    "ncsnpp": dict(model_type="SongUNet",
                   model_kwargs=dict(embedding_type="fourier", encoder_type="residual",
                                     decoder_type="standard", channel_mult_noise=2,
                                     resample_filter=(1, 3, 3, 1), model_channels=128,
                                     channel_mult=(2, 2, 2))),
    "adm": dict(model_type="DhariwalUNet",
                model_kwargs=dict(model_channels=192, channel_mult=(1, 2, 3, 4))),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--outdir", required=True)
    p.add_argument("--data", required=True, help="dataset dir or zip")
    p.add_argument("--cond", type=int, default=0)
    p.add_argument("--arch", choices=["ddpmpp", "ncsnpp", "adm"], default="ddpmpp")
    p.add_argument("--precond", choices=["vp", "ve", "edm"], default="edm")
    p.add_argument("--duration", type=float, default=200.0, help="Mimg")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--batch-gpu", type=int, default=None,
                   help="microbatch per accumulation round of one rank")
    p.add_argument("--cbase", type=int, default=None)
    p.add_argument("--cres", type=str, default=None, help="comma-separated channel multipliers")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ema", type=float, default=0.5, help="EMA half-life, Mimg")
    p.add_argument("--dropout", type=float, default=0.13)
    p.add_argument("--augment", type=float, default=0.12)
    p.add_argument("--xflip", type=int, default=0)
    p.add_argument("--bf16", type=int, default=0,
                   help="bf16 compute with fp32 parameters (the reference's --fp16 counterpart)")
    p.add_argument("--ls", type=float, default=1.0,
                   help="loss scaling (reference --ls; bf16 rarely needs it)")
    p.add_argument("--desc", type=str, default=None)
    p.add_argument("--nosubdir", action="store_true")
    p.add_argument("--tick", type=int, default=50, help="kimg per tick")
    p.add_argument("--snap", type=int, default=50, help="ticks per snapshot")
    p.add_argument("--dump", type=int, default=500, help="ticks per state dump")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--transfer", type=str, default=None, help="EMA snapshot to initialize from")
    p.add_argument("--resume", type=str, default=None, help="training state to resume")
    p.add_argument("--max-ticks", type=int, default=None, help="stop after N ticks (smoke runs)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="accepted as in the JAX CLI and without effect: eager PyTorch has no "
                        "compiled program whose boundary it could move")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default="nccl",
                   help="torch.distributed backend under torchrun: nccl (one rank per card) "
                        "or gloo (ranks may share a card; the CPU). The JAX CLI has no such "
                        "flag: XLA picks its own transport")
    p.add_argument("-n", "--dry-run", action="store_true")
    args = p.parse_args(argv)

    # the process group before anything else (the reference's dist.init() at
    # train.py:81); nothing happens without torchrun's environment
    from diffusion_tts_torch.parallel.distributed import process_group

    with process_group(args.dist_backend, device=args.device):
        _train(args)


def _train(args) -> None:
    import torch.distributed as dist

    from diffusion_tts_torch.models import preconds
    from diffusion_tts_torch.parallel.distributed import rank, rank_device, world_size
    from diffusion_tts_torch.training import loss as losses
    from diffusion_tts_torch.training.augment import edm_augment_pipe
    from diffusion_tts_torch.training.dataset import ImageDataset, batch_iterator
    from diffusion_tts_torch.training.loop import LoopConfig, training_loop
    from diffusion_tts_torch.training.train_step import TrainConfig
    from diffusion_tts_torch.utils.device import resolve_device
    from diffusion_tts_torch.utils.logging_utils import Logger, print0

    device = rank_device(resolve_device(args.device))
    world = world_size()
    if args.batch % world:
        raise SystemExit(f"--batch {args.batch} does not divide over {world} ranks")
    dataset = ImageDataset(path=args.data, use_labels=bool(args.cond), xflip=bool(args.xflip))
    if args.cond and dataset.label_dim == 0:
        raise SystemExit("--cond=1 requires labels specified in dataset.json")
    res = dataset.image_shape[0]

    preset = ARCH_PRESETS[args.arch]
    model_kwargs = dict(preset["model_kwargs"], dropout=args.dropout)
    if args.cbase is not None:
        model_kwargs["model_channels"] = args.cbase
    if args.cres is not None:
        model_kwargs["channel_mult"] = tuple(int(x) for x in args.cres.split(","))
    augment_fn = None
    if args.augment > 0:
        augment_fn = edm_augment_pipe(p=args.augment)
        model_kwargs["augment_dim"] = augment_fn.label_dim

    precond_cls = {"vp": preconds.VPPrecond, "ve": preconds.VEPrecond,
                   "edm": preconds.EDMPrecond}[args.precond]
    loss_fn = {"vp": losses.VPLoss(), "ve": losses.VELoss(),
               "edm": losses.EDMLoss()}[args.precond]
    if args.ls != 1.0:
        inner_loss = loss_fn
        loss_fn = lambda *a, **kw: args.ls * inner_loss(*a, **kw)

    net_config = dict(
        precond=args.precond, img_resolution=res, img_channels=dataset.image_shape[2],
        label_dim=dataset.label_dim if args.cond else 0,
        model_type=preset["model_type"], model_kwargs=model_kwargs,
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # the init is the same for every --seed, as in the JAX CLI
        net = precond_cls(
            img_resolution=res, img_channels=dataset.image_shape[2],
            label_dim=net_config["label_dim"], model_type=preset["model_type"],
            model_kwargs=model_kwargs,
            dtype=torch.bfloat16 if args.bf16 else torch.float32, param_dtype=torch.float32)

    # Run dir naming (reference train.py:186-198).
    desc = f"{os.path.splitext(os.path.basename(args.data))[0]}-" \
           f"{'cond' if args.cond else 'uncond'}-{args.arch}-{args.precond}"
    if args.desc:
        desc += f"-{args.desc}"
    if args.nosubdir:
        run_dir = args.outdir
    else:
        existing = [int(m.group(1))
                    for d in (os.listdir(args.outdir) if os.path.isdir(args.outdir) else [])
                    if (m := re.match(r"(\d+)-", d))]
        run_dir = os.path.join(args.outdir, f"{max(existing, default=-1) + 1:05d}-{desc}")

    rounds = max(args.batch // ((args.batch_gpu or args.batch // world) * world), 1)
    seed = args.seed if args.seed is not None else int.from_bytes(os.urandom(2), "little")
    if world > 1:  # every rank takes rank 0's seed and run dir, as the reference does
        shared = [seed, run_dir]
        dist.broadcast_object_list(shared, src=0)
        seed, run_dir = shared
    train_cfg = TrainConfig(
        lr=args.lr, grad_accum_rounds=rounds, total_batch=args.batch,
        ema_halflife_kimg=args.ema * 1000.0,
    )
    loop_cfg = LoopConfig(
        run_dir=run_dir, total_kimg=int(args.duration * 1000),
        kimg_per_tick=args.tick, snapshot_ticks=args.snap,
        state_dump_ticks=args.dump, seed=seed, batch_size=args.batch,
        batch_gpu=args.batch_gpu, steps_per_dispatch=args.steps_per_dispatch,
    )

    opts_dump = dict(vars(args), run_dir=run_dir, net_config=net_config, seed=seed)
    print0(json.dumps(opts_dump, indent=2, default=str))
    if args.dry_run:
        print0("--dry-run: exiting")
        return

    logger = None
    if rank() == 0:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "training_options.json"), "w") as f:
            json.dump(opts_dump, f, indent=2, default=str)
        logger = Logger(os.path.join(run_dir, "log.txt"), "a")
    try:
        data_iter = batch_iterator(dataset, args.batch // world, shard=rank(),
                                   num_shards=world, seed=seed)
        training_loop(
            net=net, net_config=net_config, data_iter=data_iter, loss_fn=loss_fn,
            train_cfg=train_cfg, loop_cfg=loop_cfg, augment_fn=augment_fn, device=device,
            resume_state_path=args.resume, transfer_snapshot_path=args.transfer,
            max_ticks=args.max_ticks,
        )
    finally:
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    main()
