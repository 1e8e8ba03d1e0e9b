"""Training throughput: images/s and sec/kimg on one card (counterpart of the
repo's tools/train_bench.py).

    python -m diffusion_tts_torch.tools.train_bench [--arch cifar10] [--batch 128]
        [--rounds 1] [--steps 8] [--dtype bfloat16] [--chain 1] [--profile DIR]
        [--json out.json] [--device cuda]

One optimization step (``training/train_step.py``: ``rounds`` accumulation
rounds of ``batch`` images, Adam, the ramped EMA) of the ``--arch`` net
(``backends/edm_entry.py``) under EDMPrecond and EDMLoss, no augmentation,
bf16 compute with fp32 parameters (``--dtype float32``: fp32 throughout),
random weights from numpy seed 0, on the JAX tool's synthetic batch:
standard-normal images from numpy seed 0, one-hot labels from the same
generator. The first step is the warm-up (``compile_s``: PyTorch compiles
nothing, so it is that step's wall time); then ``steps`` timed repetitions,
each of ``chain`` steps enqueued and one sync, ended by a value fetch of
the last loss; ``step_ms`` is the best repetition over ``chain``.

``step_gflops`` is the canonical count of one step's products
(``utils/roofline.py::train_step_flops``: every round's loss forward and
backward on fake tensors; the optimizer and the EMA are elementwise and not
counted; the JAX tool takes XLA's cost analysis of the whole step, which
counts every operation). ``sol`` is ``model_tflops_s`` over the card's
dense bf16 peak (``DENSE_BF16_PEAK``; an unknown card raises, as in
bench.py; on the CPU the nominal 1e12). ``scan`` is always 1: the JAX
tool's ``--scan``, ``--unroll``, ``--tree-carry`` and ``--no-donate`` shape
an XLA program and have no counterpart in eager PyTorch.

Prints ONE JSON line with the JAX tool's keys. On the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None) -> dict:
    from diffusion_tts_torch.backends.edm_entry import NET_CONFIGS, PRECONDS
    from diffusion_tts_torch.models.torch_import import load_into, random_state_dict
    from diffusion_tts_torch.training.loss import EDMLoss
    from diffusion_tts_torch.training.train_step import TrainConfig, TrainState, train_step
    from diffusion_tts_torch.utils import rng
    from diffusion_tts_torch.utils.device import profiled, resolve_device
    from diffusion_tts_torch.utils.roofline import peak_flops, train_step_flops

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="cifar10", choices=sorted(NET_CONFIGS))
    ap.add_argument("--batch", type=int, default=128, help="micro-batch per round")
    ap.add_argument("--rounds", type=int, default=1, help="grad-accum rounds")
    ap.add_argument("--steps", type=int, default=8, help="timed repetitions")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="compute dtype; parameters stay fp32")
    ap.add_argument("--chain", type=int, default=1, metavar="N",
                    help="enqueue N dependent steps per timed repetition and sync once")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one more step into DIR")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg_net = NET_CONFIGS[args.arch]
    net = PRECONDS["edm"](dtype=DTYPES[args.dtype], param_dtype=torch.float32, **cfg_net)
    load_into(net, random_state_dict(net, 0)).to(dev)
    res, ch, label_dim = cfg_net["img_resolution"], cfg_net["img_channels"], cfg_net["label_dim"]

    g = np.random.default_rng(0)
    micro, rounds = args.batch, args.rounds
    total_batch = micro * rounds
    images = torch.from_numpy(
        g.normal(size=(rounds, micro, res, res, ch)).astype(np.float32)).to(dev)
    labels = (torch.from_numpy(np.eye(label_dim, dtype=np.float32)[
        g.integers(0, label_dim, (rounds, micro))]).to(dev) if label_dim else None)
    cfg = TrainConfig(lr=1e-4, grad_accum_rounds=rounds, total_batch=total_batch)
    state = TrainState.create(net, cfg)
    loss_fn = EDMLoss()
    steps_run = 0

    def step() -> dict:
        nonlocal steps_run
        gen = rng.generator(1, steps_run, device=dev)
        steps_run += 1
        return train_step(state, images, labels, loss_fn, cfg, gen)

    t0 = time.perf_counter()
    metrics = step()
    float(metrics["loss"])
    compile_s = time.perf_counter() - t0

    best = float("inf")
    for _ in range(args.steps):
        t0 = time.perf_counter()
        for _ in range(args.chain):
            metrics = step()
        float(metrics["loss"])  # a value fetch: waits for the device
        best = min(best, (time.perf_counter() - t0) / args.chain)

    if args.profile:
        with profiled(args.profile, "train_bench", dev):
            float(step()["loss"])

    flops = train_step_flops(cfg_net, micro, rounds)["total_flops"]
    peak = peak_flops(dev)
    img_per_s = total_batch / best
    out = dict(
        arch=args.arch, params=sum(p.numel() for p in net.parameters()), batch=total_batch,
        dtype=args.dtype, chain=args.chain,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        scan=1, img_per_s=img_per_s, sec_per_kimg=1000.0 / img_per_s, step_ms=best * 1e3,
        compile_s=compile_s, loss=float(metrics["loss"]), step_gflops=flops / 1e9,
        model_tflops_s=flops / best / 1e12, sol=flops / best / peak,
    )
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
