"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--kernels-json PATH]

Phases, each of which raises on failure (nothing is caught):

  1. environment: the card's name and power limit, torch and CUDA versions;
     fails without a card;
  2. build: every CUDA kernel of the main paths, from csrc/, with nvcc (one
     process per source, all at once), and ptxas's register and spill lines
     for the conv kernels' ring route and for the attention kernels at
     d = 256;
  3. EDM kernels: the qkv attention kernel against its plain PyTorch
     version at the EDM path's shapes (and the flagship's [16, T, 3C]
     shapes), bf16 within 2e-2 and fp32 within 1e-4 with TF32 off; kernel,
     plain and library (scaled_dot_product_attention, timed only here)
     times beside the least time the card could take; each row names the
     route its predicate gave (bf16: "mma", the tensor cores; fp32: "fma")
     and, at bf16, times the CUDA-core "fma" route too (``fma_ms``: the
     first design, from the same run), with the achieved TFLOP/s;
  4. EDM main path: the full-width ImageNet-64 EDMPrecond/DhariwalUNet in
     bf16 with random weights from a numpy seed, one forward held against
     the same weights in fp32 on the CPU, then eps-greedy search (18 steps,
     2 samples, N=4, K=2) through the entry point, with every kernel's
     launches counted, each on the route its predicate gives (every one on
     "mma");
 4b. the other EDM searches through the same entry point on the same net:
     rejection (N=4) and beam (B=2, N=4) at 18 steps, MCTS (N=2, S=2, one
     phase) at 6 steps, 2 samples each; per run its wall time, NFE, NFE/s,
     peak memory, scores and launches; the launches held against the
     method's structure (22 per denoiser call: 792 / 792 / 2376), all on
     "mma"; finite images in [0, 1] whose score, computed again, is the
     returned one; rejection's x against replay_trajectory of its best
     candidate's recorded noise (2e-2 of x's largest magnitude); MCTS run
     twice from one seed, bit-identical; then the qkv attention kernel
     against its plain version at the batches these searches add (4, 16),
     untimed;
  4d. the CIFAR-10 DDPM++ path (``--arch cifar10``: the SongUNet at full
     width, 128 channels, mult (2, 2, 2), 4 blocks, one attention head of
     256 at 16x16 and the decoder's 8x8_in0; bf16, random weights from numpy
     seed 0): the qkv attention kernel at d = 256 against its plain version
     at [8, 256, 768] and [8, 64, 768] (bf16 on "mma", fp32 with TF32 off on
     "fma"; kernel, plain, SDPA, bound and ``fma_ms`` times); full-width
     forwards in fp32 and bf16 on the card against fp32 on the CPU (1e-3 /
     5e-2 of the largest magnitude) of the CIFAR-10 net, of NCSN++ (the
     ncsnpp preset under VEPrecond) and of the ImageNet-64 ADM under
     iDDPMPrecond; eps-greedy (18 steps, 2 samples, N=4, K=2, brightness)
     through generate_image_grid(arch="cifar10"): 432 attention launches,
     all on "mma"; then rejection, beam and MCTS as in 4b (6 launches per
     denoiser call);
 5. training (the EDM backend's): the attention backward kernels against
     their plain version at the flagship's [16, T, 3C] training shapes (bf16,
     each of dq, dk, dv within 2e-2 of its largest magnitude; one shape in
     fp32 within 1e-4; one [2, 4096, 8, 40] call through ``attention``), with
     kernel, plain, library (autograd of scaled_dot_product_attention, timed
     only) and bound times, each row's route (bf16: "mma", fp32: "fma"), the
     "fma" route's time at bf16 (``fma_ms``, the first design) and the
     TFLOP/s on the 14*B*H*T^2*d operations the kernels run; the gradient
     of every forward-only kernel's wrapper against its twin's at one small
     shape each; one full-width training forward + backward (batch 2, draws
     from a seed) in fp32 on the card against fp32 on the CPU and in bf16
     compute with fp32 parameters;
     then ``training_loop`` at full width in bf16 on an in-memory dataset:
     batch 32 as 2 rounds of 16, dropout 0.10, 1 warm step and 4 timed steps,
     the forward and backward launches counted (all of them on "mma"), a
     snapshot and a state dump written, read back and held equal;
 5b. DDPM++ / VP training (the training CLI's --arch ddpmpp --precond vp
     --cond 1 --bf16 1 --augment 0): the backward kernels at d = 256 against
     their plain version at [32, 256, 768] and [32, 64, 768] in bf16 and one
     shape in fp32 (both on "fma": the backward's mma route stops at d = 80),
     with kernel, plain, library and bound times; one full-width VPLoss
     forward + backward at batch 2 on the card against the CPU as in 5; the
     CLI's dry run; training_loop at full width on an in-memory random
     32x32 dataset, batch 64 as 2 rounds of 32, dropout 0.10, 1 warm and 4
     timed steps: 6 forward and 12 backward attention launches a micro-batch
     (60 / 120), forward on "mma", backward on "fma";
 5c. augmented DDPM++ / VP training at the training CLI's defaults
     (--augment 0.12): the EDM augment pipe on the card against the CPU at
     [32, 32, 32, 3] and [16, 64, 64, 3] under injected draws, fp32 with TF32
     off (images within 1e-5 of their largest magnitude, labels equal), its
     ms per call with the card's own draws, the CLI's dry run (augment_dim 9),
     then training_loop as in 5b with the pipe and a map_augment of 9 inputs:
     step ms and img/s beside 5b's from the same call, the pipe's share of a
     step, the same 60 / 120 attention launches on "mma" / "fma";
  6. SD main path: the full-width SD-1.5 UNet and VAE decoder (random
     weights from a numpy seed) at the default routing (the VAE decoder's
     convs from 128x128 up through the conv kernels, their GroupNorms folded
     into the conv prologue), one UNet forward (batch 2, 77-token context)
     and one VAE decode in fp32 and bf16 on the card held against fp32 on
     the CPU (which runs the same route through the plain versions), then
     the pipeline's bf16 eps-greedy search (6 steps, N=4, K=2, one prompt,
     brightness) twice, with every kernel's launches counted, held against
     the counts the architecture and the routing predicates give (attention
     and GEGLU all on "mma", conv3x3_same and conv3x3_up2 all on "ring",
     GroupNorm(+SiLU) all on "slab", one launch a call), and every kernel
     call's shape recorded;
 6d. the SD-1.5 VAE encoder on phase 6's VAE (random weights from numpy
     seed 1): encode in fp32 and in bf16 on the card against fp32 on the CPU
     at [1, 3, 256, 256] (1e-3 / 5e-2 of the largest magnitude of mean and
     logvar), one 512x512 bf16 encode's launches held against the
     encoder's architecture and the routing predicates (#2 once, GroupNorm
     10, statistics and conv3x3_same 12, each on its fast route), encode
     timed at 512x512, batches 1 and 4, beside its canonical FLOPs and
     TFLOP/s, and one encode -> sample -> decode round trip (finite, the
     input's shape); it runs after 6c and 7;
 6b. the other SD searches through the pipeline's __call__ (6 steps, one
     prompt): rejection (N=4), beam (B=2, N=4) and MCTS (N=2, S=2); per run
     as in 4b, the launches held against the UNet calls and VAE decodes the
     method makes (UNet / decode calls: 6 / 2, 12 / 8, 54 / 7) and against
     the calls recorded by shape; rejection's replay and MCTS's repeat as in
     4b; then every kernel against its plain version at each shape these
     searches give it and eps-greedy's does not (UNet batches 4 and 16,
     decode batches 2 and 8), untimed;
  7. SD kernels: attention, GroupNorm(+SiLU), GEGLU, GroupNorm statistics,
     conv3x3_same (every prologue/epilogue variant that occurred) and
     conv3x3_up2 against their plain versions at every shape the SD search
     gave them (bf16) and at one shape each in fp32, within 2e-2 / 1e-4 of
     the output's largest magnitude (statistics: of the largest mean and of
     the largest rstd), with kernel, plain, library and bound times (5
     repetitions instead of 20 at the 512x512 shapes); attention and GEGLU
     rows as in phase 3 (route, ``fma_ms``, TFLOP/s); conv rows with their
     route, ``v1_ms`` (bf16: the first design, timed in turns with the ring:
     ring, v1, v1, ring, the lesser of each pair) and TFLOP/s; GroupNorm rows
     with their route, ``v1_ms`` (slab and v1 in turns, as the conv's), TB/s,
     and the device time of the slab, v1 and the library call
     (``device_ms``, ``v1_device_ms``, ``library_device_ms``: 20 calls
     captured once in a CUDA graph and timed by replay, which leaves the
     host's call rate out), each shape's two slab calls held bit-identical;
  8. the CLI: one ``diffusion_tts_torch.main.main`` call on the card (EDM
     ImageNet-64, the ImageNet classifier's reward with random weights,
     eps-greedy N=4 K=2, bf16), its PNG written to a temporary directory,
     its 1584 attention launches held against the search's structure;
 9. the ablation sampler (samplers/edm.py::AblationSampler), the EDM
     paper's three original samplers on the nets the port serves, at full
     width with random weights from numpy seed 0: VP (euler, vp/vp/vp) on
     the CIFAR-10 DDPM++ under VPPrecond, VE (euler, ve/ve/none) on the
     NCSN++ preset at 32x32 under VEPrecond, iDDPM (euler, iddpm/linear/none)
     on the ImageNet-64 ADM under iDDPMPrecond, each clamped to its net's
     sigma range: 2 steps in fp32 at batch 2 on the card against the same
     run on the CPU (1e-3 of the largest output), then 18 steps in bf16 at
     batch 8 timed (wall s, NFE/s, peak GiB), its attention launches held
     against the architecture (6 / 6 / 22 sites x 18 forwards, all on
     "mma"); then eps-greedy (2 samples, N=4, K=2, 6 steps) through
     EDMSearchBackend with the iDDPM sampler (22 x 12 launches);
10. the bench twins, each through its main(argv) on the card, each run's
     launches of every kernel held against the searches it makes: ``bench``
     at its defaults (its JSON line printed by it; the FLOPs per image held
     to the CPU test's 219,315,105,792, vs_baseline > 0), ``bench --sd`` at
     the short SD configuration (6 steps, N=4, K=2, 2 calls), ``entry()``'s
     forward at batch 4, ``tools.reward_bench`` on the ImageNet-64 ADM (bf16,
     6 steps, N=2, K=2, B=2, S=2, seeds 0 and 1, all six methods; each
     row's NFE is nfe_per_sample's) and ``tools.sd_reward_bench``
     (brightness, 6 steps, seed 0: naive, rejection, eps-greedy), each
     table printed as a JSON line; ``tools.train_bench`` at ``--arch cifar10
     --batch 128 --steps 4`` and ``--arch imagenet64 --batch 16 --rounds 2
     --steps 4`` (its JSON line, peak memory; #1 and #3 launched sites x
     rounds x 5 steps and twice that, on the routes the predicates give);
12. parallelism through torch.distributed (it runs after 10; one card, so
     NCCL at world size 1 and two gloo ranks on cuda:0): 12a / 12b,
     ``entry.dryrun_multichip(1)`` over NCCL and ``(2)`` over two gloo ranks
     sharing the card (each a training step, candidate-sharded eps-greedy,
     beam and tiny-SD searches; their lines printed; their processes run
     beside the untimed unsharded references of 12d and 12e); 12c, the full-width
     ImageNet-64 ADM (bf16 compute, fp32 parameters, dropout 0), two steps
     of 32 images as 2 gloo ranks x 16 under DistributedDataParallel,
     against one process's 2 rounds x 16 under the same injected draws: the
     all-reduced gradient's cosine with it >= 0.99 (bf16) and, in fp32 at
     one step, within 1e-3 of its largest magnitude; both ranks' parameters
     and EMA bit-identical after each step; per rank the step ms, the step
     with DDP's sync skipped, one all_reduce of the gradient's 1.18 GB,
     peak memory and the launches of #1 and #3 (44 / 88, on "mma"); the same
     steps over NCCL at world size 1 in turns with the same steps outside a
     group, beside phase 5's step, and one step of each under the profiler
     (the device time the DDP wrapper adds); 12d, phase 4's
     eps-greedy candidate-sharded over the two ranks: in fp32 (TF32 off)
     the unsharded run's selections exactly, scores within 1e-4 relative,
     then in bf16 each rank's wall time, NFE/s, peak memory and 1584 #1
     launches at batch 4; 12e, ``tools/generate.py`` at ``--arch imagenet64
     --steps 18 --seeds 0-7`` (random weights, fp32), ``--batch 8`` in one
     process against ``--batch 2`` on the two ranks: every PNG within one
     uint8 level, the differing pixels counted;
11. one JSON line of kernel numbers (each kernel's launches by method of
     4b / 6b under "method_launches"; phase 12's numbers under "parallel"),
     then the result line.

The rewards (4c after 4b, 6c after 6b, on the same net and pipeline):
 4c. the 64x64 noisy-ImageNet classifier (``EncoderUNetModel`` defaults,
     random weights from numpy seed 0) on a batch of 8 in fp32 against the
     same call on the CPU (logits within 1e-3 of their largest magnitude,
     probabilities and scores within 1e-5); eps-greedy (18 steps, 2
     samples, N=4, K=2, bf16) through generate_image_grid with the
     classifier (``scorer_needs_labels``) and with compressibility
     (max_size 3000, the exact JPEG mode);
 6c. SD-1.5's text tower (``SD15_TEXT``) on 2 x 77 random ids and CLIP
     ViT-L/14 (``CLIP_VIT_L14``: image features of 4 images at 512x512
     through ``preprocess_images``, text features, cosine scores) in fp32
     against the CPU (1e-3 of the largest magnitude; scores 1e-4);
     eps-greedy (6 steps, one prompt, N=4, K=2) on the phase 6 pipeline with
     prompt embeddings from the text tower, with CLIP (the prompt's text
     features as scorer_cond, as the CLI passes them) and with
     compressibility (max_size 150000).
     Each search prints its wall time, NFE, NFE/s, peak memory, scores,
     launches and the scorer's share of the wall time (from a second run
     with the scorer's calls timed between syncs); its launches are the
     brightness search's (``method_calls``: no reward runs a kernel of the
     port), its images finite in [0, 1], its score the scorer's on the
     returned images again. On the images these searches produced, the
     exact mode's JPEG sizes (the encoder that served is printed: native
     libjpeg or PIL; where native serves, byte for byte PIL's), its scores
     against 1 - clip(PIL size / cap) at the search's cap and at one above
     every size, and the dct mode's bits on the card against the CPU (1e-4
     relative).

With --kernels-json, the per-shape rows, the 4b / 4c / 6b / 6c / 9 search
lines and phase 10's and 12's lines also go to that file. The script imports nothing
of JAX; it needs the repository beside it.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import torch
import torch.nn.functional as F

import torch.distributed as dist

from diffusion_tts_torch import main as cli
from diffusion_tts_torch import train as train_cli
from diffusion_tts_torch.entry import dryrun_multichip
from diffusion_tts_torch.backends import edm_entry
from diffusion_tts_torch.backends.edm_entry import (
    IMAGENET64_ADM,
    generate_image_grid,
    load_network,
)
from diffusion_tts_torch.models.clip import CLIP_VIT_L14, SD15_TEXT, CLIPModel, CLIPTextModel
from diffusion_tts_torch.models.preconds import EDMPrecond, VEPrecond, VPPrecond, iDDPMPrecond
from diffusion_tts_torch.models.torch_import import load_into, random_state_dict
from diffusion_tts_torch.models import sd_layers, sd_vae
from diffusion_tts_torch.models.sd_unet import UNet2DConditionModel
from diffusion_tts_torch.ops.kernels import build
from diffusion_tts_torch.ops.kernels import conv3x3 as cv
from diffusion_tts_torch.ops.kernels import geglu_ff as gg
from diffusion_tts_torch.ops.kernels import groupnorm as gn
from diffusion_tts_torch.ops.kernels import qkv_attention as qk
from diffusion_tts_torch.parallel.distributed import free_port, launch, process_group
from diffusion_tts_torch.parallel.mesh import (
    CandidateShards,
    check_consistency,
    make_mesh,
    shard_train_step,
)
from diffusion_tts_torch.pipelines import sd_pipeline
from diffusion_tts_torch.pipelines.sd_pipeline import (
    SD15_UNET,
    SD15_VAE,
    StableDiffusionSearchPipeline,
)
from diffusion_tts_torch.scorers import (
    BrightnessScorer,
    CLIPScorer,
    CompressibilityScorer,
    ImageNetScorer,
    compressibility,
    native,
)
from diffusion_tts_torch.samplers.edm import AblationSampler
from diffusion_tts_torch.scorers.clip import preprocess_images
from diffusion_tts_torch.search import (
    EDMSearchBackend,
    record_step_draws,
    replay_trajectory,
    run_search,
)
from diffusion_tts_torch.search.nfe import nfe_per_sample
from diffusion_tts_torch.tools import generate
from diffusion_tts_torch.training import checkpoints
from diffusion_tts_torch.training.augment import edm_augment_pipe
from diffusion_tts_torch.training.dataset import ImageDataset, batch_iterator
from diffusion_tts_torch.training.loop import LoopConfig, training_loop
from diffusion_tts_torch.training.loss import EDMLoss, VPLoss
from diffusion_tts_torch.training.train_step import TrainConfig, TrainState, train_step
from diffusion_tts_torch.utils.config import SearchParams

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
# The flagship's attention sites: (T, heads, sites per forward).
SITES = ((1024, 6, 7), (256, 9, 7), (64, 12, 8))
STEPS, SAMPLES, N, K = 18, 2, 4, 2
# The short SD search (bench.py --sd on the CPU): 6 steps, N=4, K=2, one prompt.
SD_STEPS, SD_N, SD_K, SD_PROMPTS, CLIP_TOKENS = 6, 4, 2, 1, 77
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Phases 4b and 6b: (method, params, steps) through the entry points. MCTS
# runs 6 steps on EDM: its rollouts make its forwards grow with steps^2
# (756 denoiser calls at 18 steps, 108 at 6).
EDM_METHOD_RUNS = (("rejection", SearchParams(N=4), STEPS),
                   ("beam", SearchParams(B=2, N=4), STEPS),
                   ("mcts", SearchParams(N=2, S=2), 6))
SD_METHOD_RUNS = (("rejection", SearchParams(N=4), SD_STEPS),
                  ("beam", SearchParams(B=2, N=4), SD_STEPS),
                  ("mcts", SearchParams(N=2, S=2), SD_STEPS))
# Training: batch 32 as 2 accumulation rounds of micro-batch 16, 1 warm + 4 timed steps.
TRAIN_BATCH, TRAIN_ROUNDS, TRAIN_STEPS = 32, 2, 5
# Phases 4d and 5b: the CIFAR-10 DDPM++ net's attention sites (T, heads, sites
# per forward), one head of 256: the four 16x16 encoder blocks and the
# decoder's 16x16_block4 at T = 256, the decoder's 8x8_in0 at T = 64.
CIFAR_SITES, CIFAR_D = ((256, 1, 5), (64, 1, 1)), 256
# NCSN++ (the training CLI's ncsnpp preset) at CIFAR-10's size and labels
NCSNPP_CIFAR = dict(edm_entry.CIFAR10_DDPMPP, model_kwargs=dict(
    train_cli.ARCH_PRESETS["ncsnpp"]["model_kwargs"], dropout=0.0))
# The net `train --arch ddpmpp --cond 1` builds on a 32x32 10-class dataset;
# batch 64 as 2 rounds of micro-batch 32.
DDPMPP_TRAIN = dict(img_resolution=32, img_channels=3, label_dim=10, model_type="SongUNet",
                    model_kwargs=train_cli.ARCH_PRESETS["ddpmpp"]["model_kwargs"])
CIFAR_TRAIN_BATCH = 64

# Kernel calls per SD-1.5 UNet forward and per VAE decode of 64x64 latents,
# from the architecture and the routing predicates (phase 6 derives them
# from the modules again and holds them equal): the UNet never exceeds
# 64x64, so none of its convs is routed and each GroupNorm module is one call.
SD_PER_UNET = {"attention": 16, "attention_bwd": 0, "group_norm_silu": 61, "geglu_ff": 16,
               "group_norm_stats": 0, "conv3x3_same": 0, "conv3x3_up2": 0}
SD_PER_DECODE = {"attention": 1, "attention_bwd": 0, "group_norm_silu": 12, "geglu_ff": 0,
                 "group_norm_stats": 18, "conv3x3_same": 18, "conv3x3_up2": 3}

ROUTE_COUNTERS = {"attention": qk.ROUTE_LAUNCHES, "attention_bwd": qk.BWD_ROUTE_LAUNCHES,
                  "geglu_ff": gg.ROUTE_LAUNCHES, "conv3x3_same": cv.SAME_ROUTE_LAUNCHES,
                  "conv3x3_up2": cv.UP2_ROUTE_LAUNCHES, "group_norm_silu": gn.ROUTE_LAUNCHES}
# Each kernel's redesigned route, which every launch of a main path must take.
FAST_ROUTE = {"attention": "mma", "attention_bwd": "mma", "geglu_ff": "mma",
              "conv3x3_same": "ring", "conv3x3_up2": "ring", "group_norm_silu": "slab"}


def reset_launches() -> None:
    qk.LAUNCHES = qk.BWD_LAUNCHES = gn.LAUNCHES = gn.STATS_LAUNCHES = gg.LAUNCHES = 0
    cv.SAME_LAUNCHES = cv.UP2_LAUNCHES = 0
    for routes in ROUTE_COUNTERS.values():
        routes.update(dict.fromkeys(routes, 0))


def read_routes() -> dict:
    return {name: dict(routes) for name, routes in ROUTE_COUNTERS.items()}


def check_routes(path: str, got: dict, want: dict, routes: dict | None = None) -> None:
    """Every launch of ``want``'s kernels on ``path`` took the kernel's
    redesigned route (FAST_ROUTE, or the route ``routes`` names for the
    kernel on this path): ``got`` from read_routes(), ``want`` {kernel name:
    launches}."""
    for name, n in want.items():
        route = (routes or {}).get(name, FAST_ROUTE[name])
        expected = {**dict.fromkeys(got[name], 0), route: n}
        if got[name] != expected:
            raise AssertionError(f"{name} on the {path} path: routes {got[name]}, "
                                 f"expected all {n} launches on {route}")
    print(f"  routes on the {path} path: " + ", ".join(f"{k} {got[k]}" for k in want))


def launches_per_call() -> dict:
    """Launches of one call of each kernel on its fast route."""
    return {"attention": 1, "attention_bwd": qk.BWD_LAUNCHES_PER_CALL,
            "group_norm_silu": gn.LAUNCHES_PER_CALL[FAST_ROUTE["group_norm_silu"]],
            "geglu_ff": gg.LAUNCHES_PER_CALL, "group_norm_stats": gn.STATS_LAUNCHES_PER_CALL,
            "conv3x3_same": 1, "conv3x3_up2": 1}


def read_launches() -> dict:
    return {"attention": qk.LAUNCHES, "attention_bwd": qk.BWD_LAUNCHES,
            "group_norm_silu": gn.LAUNCHES, "geglu_ff": gg.LAUNCHES,
            "group_norm_stats": gn.STATS_LAUNCHES, "conv3x3_same": cv.SAME_LAUNCHES,
            "conv3x3_up2": cv.UP2_LAUNCHES}


def ptxas_lines(log: str, entry: str) -> dict[str, list[str]]:
    """The register and spill lines of ``nvcc -Xptxas -v``'s report for each
    compiled kernel whose mangled name contains ``entry``."""
    found, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            current = name if entry in name else None
            if current:
                found[current] = []
        elif current and ("spill" in line or "Used" in line):
            found[current].append(line.strip())
    return found


def gpu_tag() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_in_turns(fn, other, reps: int = 20) -> tuple[float, float]:
    """(ms of fn, ms of other), each the lesser of two timings taken in
    turns (fn, other, other, fn): at a host-bound shape one timing alone
    reads the host's noise as much as the device."""
    a1, b1, b2, a2 = (time_ms(f, reps) for f in (fn, other, other, fn))
    return min(a1, a2), min(b1, b2)


def graph_ms(fns, calls: int = 20, replays: int = 3) -> list[float]:
    """Device ms of one call of each of ``fns``: ``calls`` calls captured
    once in a torch.cuda.CUDAGraph (after one call outside the capture) and
    timed by replay, in turns (each fn, then in reverse order), the lesser
    of each fn's two timings. The host's call rate is left out; the same
    input is read by every call, so a tensor that fits the 50 MB L2 may be
    read from it. A failed capture raises."""
    graphs = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        graphs.append(graph)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = [[] for _ in graphs]
    for i in list(range(len(graphs))) + list(reversed(range(len(graphs)))):
        torch.cuda.synchronize()
        start.record()
        for _ in range(replays):
            graphs[i].replay()
        end.record()
        end.synchronize()
        times[i].append(start.elapsed_time(end) / (replays * calls))
    del graphs
    torch.cuda.empty_cache()
    return [min(t) for t in times]


def route_columns(row: dict, route: str, flops: float, first, kernel, reps: int = 20) -> None:
    """The row's route, the first design's time and the TFLOP/s of the
    kernel time. Attention and GEGLU: ``fma_ms``, the CUDA-core route timed
    alone unless the row is on it. The conv kernels and GroupNorm: ``v1_ms``,
    timed in turns with the ring or the slab (which sets the row's ``ms``
    anew) unless the row is on v1."""
    row["route"] = route
    if route in ("mma", "fma"):
        row["fma_ms"] = time_ms(first) if route == "mma" else row["ms"]
    elif route in ("ring", "slab"):
        row["ms"], row["v1_ms"] = time_in_turns(kernel, first, reps)
    else:
        row["v1_ms"] = row["ms"]
    if flops:
        row["tflops"] = flops / row["ms"] / 1e9


def bound(flops: float, moved_bytes: float, dtype: torch.dtype) -> tuple[float, str]:
    """The least time for the work in ms and what sets it: the operations at
    the dtype's peak or the bytes at the memory rate."""
    ops, mem = flops / PEAK_FLOPS[dtype], moved_bytes / PEAK_BYTES
    return max(ops, mem) * 1e3, "operations" if ops >= mem else "bytes"


def attention_bound_ms(b: int, t: int, heads: int, dtype: torch.dtype,
                       d: int = 64) -> tuple[float, str]:
    """Least time for one call: 4*B*H*T^2*d operations at the dtype's peak,
    or reading [B, T, 3C] and writing [B, T, C] at the memory rate."""
    ops = 4 * b * heads * t * t * d / PEAK_FLOPS[dtype]
    moved = b * t * 4 * heads * d * torch.finfo(dtype).bits // 8 / PEAK_BYTES
    return max(ops, moved) * 1e3, "operations" if ops >= moved else "bytes"


def check_attention(b: int, t: int, heads: int, dtype: torch.dtype, tag: str,
                    timed: bool = True, d: int = 64) -> dict:
    """The kernel against its plain version at [b, t, 3C] with heads of
    width ``d``; with ``timed``, the row's times and route columns too."""
    g = torch.Generator(device="cuda").manual_seed(1000 * t + b)
    qkv = torch.randn((b, t, 3 * heads * d), device="cuda", generator=g).to(dtype)
    out = qk.qkv_self_attention(qkv, heads)
    ref = qk.qkv_self_attention_plain(qkv, heads)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    max_abs = diff.max().item()
    max_rel = max_abs / ref.float().abs().max().item()  # relative to the largest output
    tol = TOL[dtype]
    ok = bool(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol))
    if not timed:
        print(f"  qkv_attention {[b, t, 3 * heads * d]} {str(dtype).split('.')[-1]:>8} "
              f"heads={heads:2d}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} (tol {tol}) "
              f"[{tag}]")
        if not ok:
            raise AssertionError(f"qkv_attention [{b}, {t}] disagrees with its plain version")
        return dict(shape=[b, t, 3 * heads * d], max_abs_err=max_abs, max_rel_err=max_rel)
    q, k, v = (x.reshape(b, t, heads, d).transpose(1, 2).contiguous()
               for x in qkv.chunk(3, dim=-1))
    row = dict(shape=[b, t, 3 * heads * d], heads=heads, dtype=str(dtype).split(".")[-1],
               max_abs_err=max_abs, max_rel_err=max_rel,
               ms=time_ms(lambda: qk.qkv_self_attention(qkv, heads)),
               plain_ms=time_ms(lambda: qk.qkv_self_attention_plain(qkv, heads), reps=5),
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)))
    row["bound_ms"], row["bound_by"] = attention_bound_ms(b, t, heads, dtype, d)
    route_columns(row, qk.forward_route(dtype, d), 4 * b * heads * t * t * d,
                  lambda: qk.qkv_self_attention(qkv, heads, route="fma"), None)
    print(f"  qkv_attention {row['shape']} {row['dtype']:>8} heads={heads:2d}: "
          f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} (tol {tol}) route={row['route']} "
          f"kernel_ms={row['ms']:.4f} ({row['tflops']:.1f} TFLOP/s) fma_ms={row['fma_ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) [{tag}]")
    if not ok:
        raise AssertionError(f"qkv_attention disagrees with its plain version: {row}")
    return row


def edm_phases(tag: str) -> tuple[list[dict], dict]:
    """Phases 3, 4 and 4b: the EDM kernel checks, the EDM main path and the
    other searches. Returns (the searches' lines, the kernel line)."""
    print("EDM kernels vs plain:")
    main_rows, rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (N * SAMPLES, 16):
            for t, heads, _ in SITES:
                row = check_attention(b, t, heads, dtype, tag)
                rows.append(row)
                if b == N * SAMPLES and dtype == torch.bfloat16:
                    main_rows.append(row)
    q, k, v = (torch.randn((8, 1024, 6, 64), device="cuda").bfloat16() for _ in range(3))
    err = (qk.attention(q, k, v).float() - qk.attention_plain(q, k, v).float()).abs().max().item()
    print(f"  attention [8,1024,6,64] bfloat16 ([B,T,H,D] strides, route "
          f"{qk.forward_route(q.dtype, 64)}): max_abs={err:.3e}")
    if err > TOL[torch.bfloat16]:
        raise AssertionError(f"attention ([B,T,H,D]) disagrees with its plain version: {err}")

    t0 = time.perf_counter()
    net = load_network("imagenet64", dtype=torch.bfloat16, device="cuda", seed=0)
    load_s = time.perf_counter() - t0
    ref_cpu = load_network("imagenet64", dtype=torch.float32, device="cpu", seed=0)
    net32 = load_network("imagenet64", dtype=torch.float32, device="cuda", seed=0)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 64, 64, 3), generator=g) * torch.tensor([80.0, 0.5]).view(2, 1, 1, 1)
    sigma, labels = torch.tensor([80.0, 0.5]), torch.eye(1000)[[3, 977]]
    with torch.no_grad():
        y_ref = ref_cpu(x, sigma, labels)
        y32 = net32(x.cuda(), sigma.cuda(), labels.cuda()).cpu()
        y16 = net(x.cuda(), sigma.cuda(), labels.cuda()).cpu()
    del ref_cpu, net32
    scale = y_ref.abs().max().item()
    e32, e16 = ((y - y_ref).abs().max().item() / scale for y in (y32, y16))
    print(f"EDM forward [2,64,64,3] vs fp32 on the CPU (max abs err / max abs): "
          f"fp32 card {e32:.3e}, bf16 card {e16:.3e}")
    if not (e32 < 1e-3 and e16 < 5e-2 and torch.isfinite(y16).all()):
        raise AssertionError(f"full-width forward disagrees with the CPU: fp32 {e32}, bf16 {e16}")

    params = SearchParams(N=N, K=K)
    search = lambda: generate_image_grid(
        arch="imagenet64", scorer=BrightnessScorer(), method="eps_greedy", params=params,
        seed=0, gridw=SAMPLES, num_steps=STEPS, dtype=torch.bfloat16, device="cuda", net=net)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = search()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, routes = qk.LAUNCHES, read_routes()
    others = {k: v for k, v in read_launches().items() if k != "attention" and v}
    if others:
        raise AssertionError(f"the EDM main path launched kernels it does not route to: {others}")
    t0 = time.perf_counter()
    search()  # the same request again: steady state, not counted
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    expected = sum(n for _, _, n in SITES) * 2 * STEPS * K
    nfe = nfe_per_sample("eps_greedy", STEPS, params) * SAMPLES
    print(f"EDM main path: eps_greedy 18 steps B={SAMPLES} N={N} K={K} bf16: load {load_s:.2f} s, "
          f"search {first_s:.3f} s first / {again_s:.3f} s again, {nfe} NFE, "
          f"{nfe / first_s:.2f} / {nfe / again_s:.2f} NFE/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"scores {result.score.tolist()}, launches {{'qkv_attention': {launches}}} [{tag}]")
    if launches != expected:
        raise AssertionError(f"qkv_attention launched {launches} times on the EDM main path, "
                             f"expected {expected}")
    check_routes("EDM", routes, {"attention": expected})
    if not (torch.isfinite(result.score).all() and torch.isfinite(result.x).all()
            and result.images.shape == (SAMPLES, 64, 64, 3)
            and 0 <= result.images.min() <= result.images.max() <= 1):
        raise AssertionError("EDM main path output is not finite images in [0, 1]")
    searches = edm_methods_phase(net, tag)
    rewards = edm_rewards_phase(net, tag)
    del net
    torch.cuda.empty_cache()

    per_forward = lambda key: sum(r[key] * n for r, (_, _, n) in zip(main_rows, SITES))
    return searches + rewards, {
        "name": "qkv_attention", "route": "cuda",
        "source": "diffusion_tts_torch/csrc/qkv_attention.cu",
        "replaces": "diffusion_tts_tpu/ops/pallas/attention.py:713",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times: the 22 attention sites of one bf16 forward at the main
        # path's batch (N * samples), summed
        "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": max(main_rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": per_forward("library_ms"), "fma_ms": per_forward("fma_ms"),
        "method_launches": {r["method"]: r["launches"]["qkv_attention"] for r in searches},
        "shapes": rows,
    }


# ----------------------------------------------------------------------- SD


def sd_pipeline_like(ref: StableDiffusionSearchPipeline, dtype: torch.dtype):
    """The same weights as ``ref`` on the card in ``dtype``."""
    with torch.device("cuda"):
        unet = UNet2DConditionModel(**SD15_UNET, dtype=dtype)
        vae = sd_vae.AutoencoderKL(**SD15_VAE, dtype=dtype)
    unet.load_state_dict(ref.unet.state_dict())
    vae.load_state_dict(ref.vae.state_dict())
    return StableDiffusionSearchPipeline(unet=unet.eval(), vae=vae.eval())


class KernelShapes:
    """Counts every kernel call of the SD modules (``pipe``'s UNet and VAE
    decoder, or the given ``modules``: the VAE encoder in phase 6d) by its
    shape while they run. Forward hooks on the modules: attention [B, T, H, D], GroupNorm
    (x shape, groups, eps, silu) or, when the module was asked for its
    folded statistics, group_norm_stats (x shape, groups, eps), GEGLU
    (M, C, F). Recording stand-ins for the two conv functions, which the
    modules reach only where the routing predicates send them: conv3x3_same
    (x shape, K, prologue, bias, "residual" / "shortcut" / "none", Cres),
    conv3x3_up2 (x shape, K, bias)."""

    NAMES = ("attention", "group_norm_silu", "geglu_ff", "group_norm_stats", "conv3x3_same",
             "conv3x3_up2")

    def __init__(self, pipe: StableDiffusionSearchPipeline | None = None, *,
                 modules: tuple[torch.nn.Module, ...] | None = None):
        self.counts = {name: collections.Counter() for name in self.NAMES}
        self.handles = []
        roots = modules if modules is not None else (pipe.unet, pipe.vae.decoder)
        for m in (m for root in roots for m in root.modules()):
            if isinstance(m, sd_layers.GroupNorm):
                hook = self.group_norm
            elif isinstance(m, sd_layers.CrossAttention):
                hook = self.self_attention
            elif isinstance(m, sd_vae.VAEAttention):
                hook = lambda mod, a, out: self.counts["attention"].update(
                    [(a[0].shape[0], a[0].shape[2] * a[0].shape[3], 1, a[0].shape[1])])
            elif isinstance(m, sd_layers.FeedForward):
                hook = lambda mod, a, out: self.counts["geglu_ff"].update(
                    [(a[0].numel() // a[0].shape[-1], a[0].shape[-1],
                      mod.net[2].weight.shape[1])])
            else:
                continue
            self.handles.append(m.register_forward_hook(hook))
        self.same, self.up2 = cv.conv3x3_same, cv.conv3x3_up2
        cv.conv3x3_same, cv.conv3x3_up2 = self.conv_same, self.conv_up2

    def self_attention(self, mod, a, out) -> None:
        """The self-attention calls (one argument) reach the kernel; the
        cross-attention ones run their einsums. A hook returns None: any
        other value would replace the module's output."""
        if len(a) == 1:
            self.counts["attention"].update([(a[0].shape[0], a[0].shape[1], mod.heads,
                                              mod.dim_head)])

    def group_norm(self, mod, a, out) -> None:
        if isinstance(out, tuple):  # (scale, shift): the statistics call
            self.counts["group_norm_stats"].update([(tuple(a[0].shape), mod.groups, mod.eps)])
        else:
            self.counts["group_norm_silu"].update(
                [(tuple(a[0].shape), mod.groups, mod.eps, mod.apply_silu)])

    def conv_same(self, x, weight, bias=None, residual=None, *, gn_scale=None, gn_shift=None,
                  shortcut=None):
        tail = "residual" if residual is not None else "shortcut" if shortcut is not None \
            else "none"
        self.counts["conv3x3_same"].update(
            [(tuple(x.shape), weight.shape[0], gn_scale is not None, bias is not None, tail,
              shortcut[0].shape[1] if shortcut is not None else 0)])
        return self.same(x, weight, bias, residual, gn_scale=gn_scale, gn_shift=gn_shift,
                         shortcut=shortcut)

    def conv_up2(self, x, weight, bias=None):
        self.counts["conv3x3_up2"].update([(tuple(x.shape), weight.shape[0], bias is not None)])
        return self.up2(x, weight, bias)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        cv.conv3x3_same, cv.conv3x3_up2 = self.same, self.up2


def rel_err(out, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max abs reference); for tuples of
    tensors, the largest of each over the pairs."""
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(out, ref)]
    return max(errs), max(e / r.float().abs().max().item() for e, r in zip(errs, ref))


def kernel_row(name: str, shape, dtype, out, ref, kernel, plain, library, flops_bytes,
               tag: str, reps: int = 20, route=None, timed: bool = True) -> dict:
    """One kernel's check and times at one shape. ``route``: (the route the
    predicate gave, a call of the same kernel on its first design, "fma" or
    "v1") for the kernels with two routes. Without ``timed``, the check
    alone."""
    torch.cuda.synchronize()
    max_abs, max_rel = rel_err(out, ref)
    finite = all(torch.isfinite(o).all() for o in ((out,) if isinstance(out, torch.Tensor) else out))
    if not timed:
        print(f"  {name} {list(shape)} {str(dtype).split('.')[-1]:>8}: max_abs={max_abs:.3e} "
              f"max_rel={max_rel:.3e} (tol {TOL[dtype]}) [{tag}]")
        if not (max_rel <= TOL[dtype] and finite):
            raise AssertionError(f"{name} {list(shape)} disagrees with its plain version")
        return dict(shape=list(shape), max_abs_err=max_abs, max_rel_err=max_rel)
    row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1], max_abs_err=max_abs,
               max_rel_err=max_rel, ms=time_ms(kernel, reps), plain_ms=time_ms(plain, 3),
               library_ms=time_ms(library, reps))
    row["bound_ms"], row["bound_by"] = bound(*flops_bytes, dtype)
    routed = ""
    if route is not None:
        route_columns(row, route[0], flops_bytes[0], route[1], kernel, reps)
        first = "fma_ms" if "fma_ms" in row else "v1_ms"
        if flops_bytes[0]:
            rate = f"{row['tflops']:.1f} TFLOP/s"
        else:  # a memory-bound kernel: its bytes over its time
            row["tb_per_s"] = flops_bytes[1] / row["ms"] / 1e9
            rate = f"{row['tb_per_s']:.2f} TB/s"
        routed = f" route={row['route']} ({rate}) {first}={row[first]:.4f}"
    print(f"  {name} {row['shape']} {row['dtype']:>8}: max_abs={max_abs:.3e} "
          f"max_rel={max_rel:.3e} (tol {TOL[dtype]}) kernel_ms={row['ms']:.4f}{routed} "
          f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) [{tag}]")
    if not (max_rel <= TOL[dtype] and finite):
        raise AssertionError(f"{name} disagrees with its plain version: {row}")
    return row


def check_sd_attention(key, dtype, tag, timed=True):
    b, t, h, d = key
    g = torch.Generator(device="cuda").manual_seed(t + d)
    q, k, v = (torch.randn((b, t, h, d), device="cuda", generator=g).to(dtype)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    item = torch.finfo(dtype).bits // 8
    return kernel_row("attention", key, dtype, qk.attention(q, k, v), qk.attention_plain(q, k, v),
                      lambda: qk.attention(q, k, v), lambda: qk.attention_plain(q, k, v),
                      lambda: F.scaled_dot_product_attention(qt, kt, vt),
                      (4 * b * h * t * t * d, 4 * b * t * h * d * item), tag, timed=timed,
                      route=(qk.forward_route(dtype, d), lambda: qk.attention(q, k, v, route="fma")))


def check_group_norm(key, dtype, tag, timed=True):
    """The row of kernel_row with the route columns (the slab and v1 in
    turns) and the device times by graph replay; two calls of the routed
    kernel must be bit-identical. Without ``timed``, the check alone."""
    shape, groups, eps, silu = key
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    c = shape[1]
    w = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    b = 0.1 * torch.randn(c, device="cuda", generator=g)
    kernel = lambda: gn.group_norm_silu(x, w, b, groups=groups, eps=eps, apply_silu=silu)
    first = lambda: gn.group_norm_silu(x, w, b, groups=groups, eps=eps, apply_silu=silu,
                                       route="v1")
    plain = lambda: gn.group_norm_silu_plain(x, w, b, groups=groups, eps=eps, apply_silu=silu)

    def library():
        y = F.group_norm(x, groups, w.to(dtype), b.to(dtype), eps)
        return F.silu(y) if silu else y

    out = kernel()
    if not timed:
        return kernel_row("group_norm_silu", shape, dtype, out, plain(), kernel, plain, library,
                          None, tag, timed=False)
    if not torch.equal(out, kernel()):
        raise AssertionError(f"group_norm_silu {list(shape)} {dtype}: two calls differ")
    row = kernel_row("group_norm_silu", shape, dtype, out, plain(), kernel, plain, library,
                     (0, 2 * x.numel() * x.element_size()), tag, reps=reps_for(shape),
                     route=(gn.gn_route(dtype, c, x[0, 0].numel(), groups), first))
    row["device_ms"], row["v1_device_ms"], row["library_device_ms"] = graph_ms(
        (kernel, first, library))
    print(f"    device ms by graph replay: {row['route']} {row['device_ms']:.4f}, "
          f"v1 {row['v1_device_ms']:.4f}, library {row['library_device_ms']:.4f}, "
          f"bound {row['bound_ms']:.4f}; two calls bit-identical")
    return row


def check_geglu(key, dtype, tag, timed=True):
    m, c, f = key
    g = torch.Generator(device="cuda").manual_seed(m + c)
    r = lambda shape, s: (torch.randn(shape, device="cuda", generator=g) * s).to(dtype)
    x, w0, b0, w2, b2 = r((m, c), 1), r((2 * f, c), c ** -0.5), r((2 * f,), 0.1), \
        r((c, f), f ** -0.5), r((c,), 0.1)
    kernel = lambda: gg.geglu_ff(x, w0, b0, w2, b2)
    plain = lambda: gg.geglu_ff_plain(x, w0, b0, w2, b2)

    def library():
        h, gate = F.linear(x, w0, b0).chunk(2, dim=-1)
        return F.linear(h * F.gelu(gate), w2, b2)

    item = torch.finfo(dtype).bits // 8
    return kernel_row("geglu_ff", key, dtype, kernel(), plain(), kernel, plain, library,
                      (6 * m * c * f, (2 * m * c + 3 * c * f) * item), tag, reps=10, timed=timed,
                      route=(gg.route(dtype, c, f),
                             lambda: gg.geglu_ff(x, w0, b0, w2, b2, route="fma")))


def reps_for(shape) -> int:
    """Timing repetitions of the conv kernels' checks: fewer at 512x512."""
    return 5 if shape[-1] >= 512 else 20


def check_group_norm_stats(key, dtype, tag, timed=True):
    shape, groups, eps = key
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    kernel = lambda: gn.group_norm_stats(x, groups=groups, eps=eps)
    plain = lambda: gn.group_norm_stats_plain(x, groups=groups, eps=eps)
    library = lambda: torch.var_mean(x.reshape(shape[0], groups, -1), dim=-1)
    return kernel_row("group_norm_stats", shape, dtype, kernel(), plain(), kernel, plain, library,
                      (0, x.numel() * x.element_size()), tag, reps=reps_for(shape), timed=timed)


def check_conv_same(key, dtype, tag, timed=True):
    """Library: F.conv2d in the working dtype on an input taken as already
    normalized, with the bias and no skip: it leaves the prologue and the
    rest of the epilogue out."""
    shape, k, has_gn, has_bias, tail, cres = key
    b, c, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(c + k + h)
    r = lambda sh, s=1.0: (torch.randn(sh, device="cuda", generator=g) * s).to(dtype)
    x, weight = r(shape), r((k, c, 3, 3), (9 * c) ** -0.5)
    kw = {"bias": r((k,), 0.1) if has_bias else None}
    if has_gn:
        kw["gn_scale"] = 1 + 0.5 * torch.randn((b, c), device="cuda", generator=g)
        kw["gn_shift"] = 0.1 * torch.randn((b, c), device="cuda", generator=g)
    if tail == "residual":
        kw["residual"] = r((b, k, h, w))
    if tail == "shortcut":
        kw["shortcut"] = (r((b, cres, h, w)), r((k, cres), cres ** -0.5))
    kernel = lambda: cv.conv3x3_same(x, weight, **kw)
    plain = lambda: cv.conv3x3_same_plain(x, weight, **kw)
    library = lambda: F.conv2d(x, weight, kw["bias"], padding=1)
    item = x.element_size()
    moved = (x.numel() + weight.numel() + b * k * h * w * (2 if tail == "residual" else 1)
             + (b * cres * h * w + k * cres)) * item
    name = f"conv3x3_same[{'gn+' if has_gn else ''}{'bias+' if has_bias else ''}{tail}]"
    row = kernel_row(name, (b, c, h, w, k), dtype, kernel(), plain(), kernel, plain, library,
                     (2 * b * h * w * (9 * c + cres) * k, moved), tag, reps=reps_for(shape),
                     timed=timed, route=(cv.conv_route(dtype, c, k, w, cres),
                            lambda: cv.conv3x3_same(x, weight, route="v1", **kw)))
    row["variant"] = dict(prologue=has_gn, bias=has_bias, epilogue=tail, cres=cres)
    return row


def check_conv_up2(key, dtype, tag, timed=True):
    shape, k, has_bias = key
    b, c, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(c + k + h)
    r = lambda sh, s=1.0: (torch.randn(sh, device="cuda", generator=g) * s).to(dtype)
    x, weight, bias = r(shape), r((k, c, 3, 3), (9 * c) ** -0.5), r((k,), 0.1) if has_bias else None
    kernel = lambda: cv.conv3x3_up2(x, weight, bias)
    plain = lambda: cv.conv3x3_up2_plain(x, weight, bias)
    library = lambda: F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), weight, bias,
                               padding=1)
    moved = (x.numel() + weight.numel() + 4 * b * k * h * w) * x.element_size()
    return kernel_row("conv3x3_up2", (b, c, h, w, k), dtype, kernel(), plain(), kernel, plain,
                      library, (32 * b * h * w * c * k, moved), tag, reps=reps_for((2 * w,)),
                      timed=timed, route=(cv.conv_route(dtype, c, k, w),
                             lambda: cv.conv3x3_up2(x, weight, bias, route="v1")))


# ----------------------------------------------------------------- training


def check_attention_bwd(b: int, t: int, heads: int, dtype: torch.dtype, tag: str,
                        d: int = 64) -> dict:
    """The backward kernels through qkv_self_attention's backward() at
    [B, T, 3C] against the plain version; each of dq, dk, dv within the
    dtype's tolerance of that gradient's largest magnitude. ``ms`` times the
    wrapper's backward function called directly (the row term delta and the
    two launches), ``autograd_ms`` the same through ``torch.autograd.grad``,
    as the library's backward is timed: at the small sites both are the
    autograd engine's dispatch, not the device. ``fma_ms`` times the same
    call on the "fma" route (the first design) where the row is on "mma",
    in turns with ``ms``; ``tflops`` counts the 14*B*H*T^2*d operations the
    two kernels run (S and dP in each). ``d`` is the head width."""
    c = heads * d
    gen = torch.Generator(device="cuda").manual_seed(7000 + t + b)
    qkv = torch.randn((b, t, 3 * c), device="cuda", generator=gen).to(dtype).requires_grad_(True)
    g = torch.randn((b, t, c), device="cuda", generator=gen).to(dtype)
    out = qk.qkv_self_attention(qkv, heads)
    via_autograd = lambda: torch.autograd.grad(out, qkv, g, retain_graph=True)[0]
    got = via_autograd()
    lse = out.grad_fn.saved_tensors[2]
    backward = lambda route=None: qk.qkv_self_attention_bwd(qkv.detach(), out.detach(), g,
                                                            heads, lse, route=route)
    if not torch.equal(backward(), got):
        raise AssertionError("attention_bwd: two runs on the same inputs differ")
    split = lambda x: x.detach().reshape(b, t, -1, d)
    q, k, v = (split(x) for x in qkv.chunk(3, dim=-1))
    plain = lambda: qk.attention_bwd_plain(q, k, v, split(out), split(g))
    ref = plain()
    torch.cuda.synchronize()
    errs = [rel_err(a.reshape(b, t, heads, d), r) for a, r in zip(got.chunk(3, dim=-1), ref)]
    max_abs, max_rel = max(e[0] for e in errs), max(e[1] for e in errs)
    lq, lk, lv = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    lo, lg = F.scaled_dot_product_attention(lq, lk, lv), split(g).transpose(1, 2).contiguous()
    row = dict(shape=[b, t, 3 * c], heads=heads, dtype=str(dtype).split(".")[-1],
               max_abs_err=max_abs, max_rel_err=max_rel,
               autograd_ms=time_ms(via_autograd), plain_ms=time_ms(plain, reps=3),
               library_ms=time_ms(lambda: torch.autograd.grad(lo, (lq, lk, lv), lg,
                                                              retain_graph=True)))
    # the least any implementation needs: S, dP, dV, dQ, dK; q, k, v, o, g read
    # once and dq, dk, dv written once
    row["bound_ms"], row["bound_by"] = bound(10 * b * heads * t * t * d,
                                             8 * b * t * c * torch.finfo(dtype).bits // 8, dtype)
    row["route"] = qk.backward_route(dtype, d)
    if row["route"] == "mma":
        row["ms"], row["fma_ms"] = time_in_turns(backward, lambda: backward("fma"))
    else:
        row["ms"] = row["fma_ms"] = time_ms(backward)
    row["tflops"] = 14 * b * heads * t * t * d / row["ms"] / 1e9
    print(f"  attention_bwd {row['shape']} {row['dtype']:>8} heads={heads:2d}: "
          f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} (tol {TOL[dtype]}) route={row['route']} "
          f"kernel_ms={row['ms']:.4f} ({row['tflops']:.1f} TFLOP/s; through autograd "
          f"{row['autograd_ms']:.4f}) fma_ms={row['fma_ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) [{tag}]")
    if not (max_rel <= TOL[dtype] and torch.isfinite(got).all()):
        raise AssertionError(f"attention_bwd disagrees with its plain version: {row}")
    return row


def check_twin_gradients() -> None:
    """backward() through each forward-only kernel's wrapper on the card
    reaches every input and weight and equals the twin's gradient within the
    forward's tolerance (bf16, one small shape each)."""
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(99)
    r = lambda shape, s=1.0, dt=dtype: (torch.randn(shape, device="cuda", generator=gen) * s).to(dt)
    f32 = torch.float32
    x, cx = r((2, 64, 12, 12)), r((2, 16, 10, 12))
    cases = {
        "group_norm_silu": (lambda x, w, b: gn.group_norm_silu(x, w, b, groups=8),
                            lambda x, w, b: gn.group_norm_silu_plain(x, w, b, groups=8),
                            (x, 1 + r((64,), 0.1, f32), r((64,), 0.1, f32))),
        "group_norm_silu_prebias": (
            lambda x, w, b, p: gn.group_norm_silu_prebias(x, w, b, p, groups=8),
            lambda x, w, b, p: gn.group_norm_silu_plain(x, w, b, groups=8, pre=p),
            (x, 1 + r((64,), 0.1, f32), r((64,), 0.1, f32), r((2, 64), 1.0, f32))),
        "group_norm_stats": (lambda x: gn.group_norm_stats(x, groups=8),
                             lambda x: gn.group_norm_stats_plain(x, groups=8), (x,)),
        "geglu_ff": (gg.geglu_ff, gg.geglu_ff_plain,
                     (r((48, 32)), r((128, 32), 32 ** -0.5), r((128,), 0.1),
                      r((32, 64), 64 ** -0.5), r((32,), 0.1))),
        "conv3x3_same": (
            lambda x, w, b, s, t, sx, sw: cv.conv3x3_same(x, w, b, gn_scale=s, gn_shift=t,
                                                          shortcut=(sx, sw)),
            lambda x, w, b, s, t, sx, sw: cv.conv3x3_same_plain(x, w, b, gn_scale=s, gn_shift=t,
                                                                shortcut=(sx, sw)),
            (cx, r((24, 16, 3, 3), 1 / 12), r((24,)), 1 + r((2, 16), 0.3, f32),
             r((2, 16), 0.1, f32), r((2, 8, 10, 12)), r((24, 8), 0.3))),
        "conv3x3_up2": (cv.conv3x3_up2, cv.conv3x3_up2_plain,
                        (cx, r((24, 16, 3, 3), 1 / 12), r((24,)))),
    }
    for name, (kernel, plain, tensors) in cases.items():
        grads = []
        for fn in (kernel, plain):
            leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
            out = fn(*leaves)
            outs = (out,) if isinstance(out, torch.Tensor) else out
            if fn is kernel:
                cot = [r(o.shape, 1.0, o.dtype) for o in outs]
            grads.append(torch.autograd.grad(outs, leaves, cot))
        worst = max(rel_err(a, b)[1] for a, b in zip(*grads))
        print(f"  {name}: backward() through the kernel's wrapper vs its twin, "
              f"{len(tensors)} gradients, max_rel={worst:.3e} (tol {TOL[dtype]})")
        if not (worst <= TOL[dtype] and all(torch.isfinite(a).all() for a in grads[0])):
            raise AssertionError(f"{name}: the wrapper's gradient disagrees with its twin's")


_TRAINING_WEIGHTS: dict = {}


def training_net(dtype: torch.dtype, device: str, dropout: float = 0.0,
                 cfg: dict = IMAGENET64_ADM, precond=EDMPrecond) -> torch.nn.Module:
    """The full-width net of ``cfg`` under ``precond`` (default: the
    ImageNet-64 ADM under EDM) as the training CLI builds it (fp32
    parameters, compute in ``dtype``), with random weights in every layer:
    from the architecture's init, which zeroes conv1, proj and out_conv, no
    gradient would reach an attention site in the first step. The weights
    (numpy seed 0, load_network's) are drawn once per process and layout;
    the net is built on ``device``, as the loaded state overwrites its init."""
    cfg = dict(cfg, model_kwargs=dict(cfg["model_kwargs"], dropout=dropout))
    with torch.device(device):
        net = precond(dtype=dtype, param_dtype=torch.float32, **cfg)
    key = (precond, tuple((k, tuple(v.shape)) for k, v in net.state_dict().items()))
    if key not in _TRAINING_WEIGHTS:
        _TRAINING_WEIGHTS[key] = random_state_dict(net, 0)
    return load_into(net, _TRAINING_WEIGHTS[key]).to(device)


def loss_and_grads(net: torch.nn.Module, images, labels, draws,
                   loss_fn=EDMLoss()) -> tuple[float, dict]:
    dev = next(net.parameters()).device
    net.train().zero_grad(set_to_none=True)
    loss = loss_fn(lambda x, s, lab, al: net(x, s, lab, al), images.to(dev), labels.to(dev),
                   **{k: v.to(dev) for k, v in draws.items()}).mean()
    loss.backward()
    missing = [n for n, p in net.named_parameters() if p.grad is None]
    if missing:
        raise AssertionError(f"{len(missing)} parameters got no gradient: {missing[:4]}")
    return loss.item(), {n: p.grad.detach().float().cpu() for n, p in net.named_parameters()}


def check_training_forward_backward(cfg: dict = IMAGENET64_ADM, precond=EDMPrecond,
                                    loss_fn=EDMLoss()) -> None:
    """One full-width loss forward + backward (default: the ADM under EDM),
    batch 2, dropout off, the draws from a seed: fp32 on the card against
    fp32 on the CPU, then bf16 compute with fp32 parameters on the card."""
    res, label_dim = cfg["img_resolution"], cfg["label_dim"]
    g = torch.Generator().manual_seed(21)
    images = torch.rand((2, res, res, 3), generator=g) * 2 - 1
    labels = torch.eye(label_dim)[[3, (label_dim - 23) % label_dim]]
    u_draw = torch.randn if isinstance(loss_fn, EDMLoss) else torch.rand  # VP, VE: uniform
    draws = dict(u=u_draw((2, 1, 1, 1), generator=g),
                 noise=torch.randn((2, res, res, 3), generator=g))
    run = lambda dtype, device: loss_and_grads(
        training_net(dtype, device, cfg=cfg, precond=precond), images, labels, draws, loss_fn)
    t0 = time.perf_counter()
    loss_ref, grads_ref = run(torch.float32, "cpu")
    cpu_s = time.perf_counter() - t0
    loss32, grads32 = run(torch.float32, "cuda")
    loss16, grads16 = run(torch.bfloat16, "cuda")
    worst = max((grads32[n] - r).abs().max().item() / r.abs().max().item()
                for n, r in grads_ref.items())
    # in float64: fp32 sums over 296M elements are off by percents
    flat = lambda grads: torch.cat([grads[n].reshape(-1) for n in grads_ref]).double()
    cosine = F.cosine_similarity(flat(grads16), flat(grads_ref), dim=0).item()
    rel32, rel16 = (abs(x - loss_ref) / abs(loss_ref) for x in (loss32, loss16))
    print(f"training forward + backward {type(loss_fn).__name__} [2,{res},{res},3], "
          f"{len(grads_ref)} parameters, vs fp32 on the CPU ({cpu_s:.1f} s): loss {loss_ref:.6f}; fp32 card loss rel err {rel32:.3e} (limit "
          f"1e-4), worst gradient err / max {worst:.3e} (limit 1e-3); bf16 compute + fp32 "
          f"parameters loss rel err {rel16:.3e} (limit 5e-2), gradient cosine {cosine:.5f} "
          f"(limit 0.99)")
    if not (rel32 <= 1e-4 and worst <= 1e-3 and rel16 <= 5e-2 and cosine >= 0.99):
        raise AssertionError("the full-width training forward + backward disagrees with the CPU")
    torch.cuda.empty_cache()


def check_training_loop(tag: str, fwd_rows: list[dict], bwd_rows: list[dict], *,
                        cfg: dict = IMAGENET64_ADM, precond=EDMPrecond, precond_name: str = "edm",
                        loss_fn=EDMLoss(), batch: int = TRAIN_BATCH, rounds: int = TRAIN_ROUNDS,
                        sites_of: tuple = SITES, routes_of: dict | None = None,
                        label: str = "ImageNet-64 ADM", augment_fn=None) -> dict:
    """TRAIN_STEPS steps through training_loop, the function the training CLI
    calls, at full width in bf16 compute with fp32 parameters, dropout 0.10
    (default: the ImageNet-64 ADM under EDM; ``sites_of`` its attention
    sites, ``routes_of`` the routes its launches must take where they are not
    FAST_ROUTE's; ``augment_fn`` the augment pipe, whose labels the net's
    augment_dim must take): every step its own tick, so that stats.jsonl
    times each (the tick's drain waits for the device)."""
    res, label_dim = cfg["img_resolution"], cfg["label_dim"]
    g = np.random.default_rng(0)
    labels = g.integers(0, label_dim, 256)
    labels[0] = label_dim - 1  # the largest label sets the one-hot width
    data = ImageDataset(g.integers(0, 256, (256, res, res, 3), dtype=np.uint8), labels)
    make = lambda: training_net(torch.bfloat16, "cuda", dropout=0.10, cfg=cfg, precond=precond)
    net = make()
    before = {n: p.detach().cpu().clone() for n, p in net.named_parameters()}
    micro = batch // rounds
    train_cfg = TrainConfig(lr=1e-4, lr_rampup_kimg=2 * batch / 1000, grad_accum_rounds=rounds,
                            total_batch=batch)
    with tempfile.TemporaryDirectory() as run_dir:
        loop_cfg = LoopConfig(run_dir=run_dir, total_kimg=1000, kimg_per_tick=batch / 1000,
                              snapshot_ticks=TRAIN_STEPS, state_dump_ticks=TRAIN_STEPS, seed=0,
                              batch_size=batch, batch_gpu=micro)
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = training_loop(
            net=net, net_config=dict(cfg, precond=precond_name),
            data_iter=batch_iterator(data, batch, seed=0), loss_fn=loss_fn,
            train_cfg=train_cfg, loop_cfg=loop_cfg, augment_fn=augment_fn, device="cuda",
            max_ticks=TRAIN_STEPS)
        torch.cuda.synchronize()
        launches, routes = read_launches(), read_routes()
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(run_dir, "stats.jsonl")) as f:
            ticks = [json.loads(line) for line in f]
        kimg = state.nimg // 1000
        ema, config = checkpoints.load_snapshot(
            os.path.join(run_dir, f"network-snapshot-{kimg:06d}.pt"))
        fresh = make()
        back = checkpoints.load_state(
            os.path.join(run_dir, f"training-state-{kimg:06d}.pt"),
            like=TrainState.create(fresh, train_cfg))
    losses = [t["Loss/loss"]["mean"] for t in ticks]
    step_ms = [t["Timing/sec_per_kimg"]["mean"] * batch for t in ticks]
    timed = sorted(step_ms[1:])
    median = (timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    sites = sum(n for _, _, n in sites_of)
    want = {"attention": sites * rounds * TRAIN_STEPS,
            "attention_bwd": sites * qk.BWD_LAUNCHES_PER_CALL * rounds * TRAIN_STEPS}
    per_micro = lambda rows: sum(r["ms"] * n for r, (_, _, n) in zip(rows, sites_of))
    fwd_ms, bwd_ms = per_micro(fwd_rows) * rounds, per_micro(bwd_rows) * rounds
    print(f"training main path: training_loop, {label} {precond_name} bf16 compute / fp32 "
          f"parameters, {type(loss_fn).__name__}, batch {batch} as {rounds} x {micro}, dropout "
          f"0.10, Adam: step ms {[round(m, 1) for m in step_ms]} (first is the warm step), median "
          f"of the timed {median:.1f} ms = {batch / median * 1e3:.2f} img/s, peak memory "
          f"{peak:.2f} GiB, losses {[round(x, 4) for x in losses]}, attention kernels per step "
          f"(timed alone at batch {micro}, summed over the {sites} sites and {rounds} rounds): "
          f"forward {fwd_ms:.1f} ms = {fwd_ms / median:.1%}, backward {bwd_ms:.1f} ms = "
          f"{bwd_ms / median:.1%} of a step, launches {launches} [{tag}]")
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{name} launched {n} times in training, expected "
                                 f"{want.get(name, 0)}")
    check_routes(f"{label} training", routes, want, routes_of)
    if not (len(losses) == TRAIN_STEPS and all(np.isfinite(losses))):
        raise AssertionError(f"training losses are not finite: {losses}")
    if state.nimg != batch * TRAIN_STEPS or back.nimg != state.nimg:
        raise AssertionError(f"nimg is {state.nimg} / {back.nimg} after {TRAIN_STEPS} steps")
    moved = [(p.detach().cpu() - before[n]).abs().max().item()
             for n, p in state.net.named_parameters()]
    ema_moved = [(p.detach().cpu() - before[n]).abs().max().item()
                 for n, p in state.ema.named_parameters()]
    if not (min(moved) > 0 and max(ema_moved) > 0
            and all(torch.isfinite(p).all() for p in state.net.parameters())):
        raise AssertionError("training left a parameter or the EMA where it was, or not finite")
    if config["ckpt_format_version"] != checkpoints.CKPT_FORMAT_VERSION or not all(
            torch.equal(ema[n], p.detach().cpu()) for n, p in state.ema.state_dict().items()):
        raise AssertionError("the snapshot read back differs from the EMA")
    same = all(torch.equal(a, b) for mod in ("net", "ema") for a, b in zip(
        getattr(back, mod).parameters(), getattr(state, mod).parameters()))
    same = same and all(
        torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
        and a["step"] == b["step"]
        for a, b in zip(back.opt.state.values(), state.opt.state.values()))
    if not same:
        raise AssertionError("the state dump read back differs from the training state")
    print(f"  snapshot and state dump written, read back and equal; parameters moved by "
          f"{min(moved):.2e} ... {max(moved):.2e}, EMA by up to {max(ema_moved):.2e}; "
          f"nimg {state.nimg}")
    del state, back, net, fresh
    torch.cuda.empty_cache()
    return {"launches": launches["attention_bwd"], "forward_launches": launches["attention"],
            "routes": routes["attention_bwd"], "step_ms": step_ms,
            "img_per_s": batch / median * 1e3, "peak_gib": peak}


def training_phases(tag: str, edm_line: dict) -> dict:
    """Phase 5: the training path of the EDM backend."""
    print("attention backward kernels vs plain:")
    micro = TRAIN_BATCH // TRAIN_ROUNDS
    main_rows = [check_attention_bwd(micro, t, heads, torch.bfloat16, tag) for t, heads, _ in SITES]
    rows = main_rows + [check_attention_bwd(micro, 256, 9, torch.float32, tag)]
    gen = torch.Generator(device="cuda").manual_seed(40)
    q, k, v, g = (torch.randn((2, 4096, 8, 40), device="cuda", generator=gen).bfloat16()
                  for _ in range(4))
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    out = qk.attention(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    ref = qk.attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(), g)
    err = max(rel_err(a, r)[1] for a, r in zip(got, ref))
    print(f"  attention_bwd [2,4096,8,40] bfloat16 through attention's backward(): "
          f"max_rel={err:.3e} (tol {TOL[torch.bfloat16]})")
    if err > TOL[torch.bfloat16]:
        raise AssertionError(f"attention's backward disagrees with its plain version: {err}")
    del q, k, v, g, leaves, out, got, ref
    print("gradients through the forward-only kernels' wrappers:")
    check_twin_gradients()
    check_training_forward_backward()

    if importlib.util.find_spec("PIL") is not None:
        from PIL import Image

        with tempfile.TemporaryDirectory() as tmp:
            data = os.path.join(tmp, "data")
            os.makedirs(data)
            for i in range(2):
                Image.fromarray(np.full((64, 64, 3), 40 * i, np.uint8)).save(
                    os.path.join(data, f"img{i}.png"))
            train_cli.main(["--outdir", os.path.join(tmp, "runs"), "--data", data, "--arch",
                            "adm", "--augment", "0", "--bf16", "1", "--dry-run"])
    else:
        print("training CLI dry run left out: it reads a PNG folder and PIL is not installed")

    fwd_rows = [r for r in edm_line["shapes"]
                if r["shape"][0] == micro and r["dtype"] == "bfloat16"]
    run = check_training_loop(tag, fwd_rows, main_rows)
    per_backward = lambda key: sum(r[key] * n for r, (_, _, n) in zip(main_rows, SITES))
    edm_line["training_launches"] = run["forward_launches"]
    return {
        "name": "attention_bwd", "route": "cuda",
        "source": "diffusion_tts_torch/csrc/attention_bwd.cu",
        "replaces": "diffusion_tts_tpu/ops/pallas/attention.py:303",
        "launches": run["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times: the 22 attention sites of one bf16 backward at the training
        # micro-batch (16), summed; each call is its two launches plus the
        # row term delta. "route" names the language (CUDA); "routes" counts
        # the training run's launches per design ("mma": the tensor cores),
        # and fma_ms times the first design on the same inputs
        "ms": per_backward("ms"), "plain_ms": per_backward("plain_ms"),
        "bound_ms": per_backward("bound_ms"),
        "bound_by": max(main_rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": per_backward("library_ms"), "fma_ms": per_backward("fma_ms"),
        "routes": run["routes"],
        "train_step_ms": run["step_ms"], "train_img_per_s": run["img_per_s"],
        "train_peak_gib": run["peak_gib"], "shapes": rows,
    }


# ------------------------------------------------------- CIFAR-10 DDPM++


def check_forward(name: str, make, x: torch.Tensor, sigma: torch.Tensor,
                  labels: torch.Tensor) -> tuple[float, float]:
    """One forward of ``make(dtype, device)``'s net (random weights from a
    numpy seed, eval mode) in fp32 and in bf16 on the card against fp32 on
    the CPU: (fp32 err, bf16 err), each the largest difference over the
    largest magnitude, within 1e-3 and 5e-2."""
    with torch.no_grad():
        y_ref = make(torch.float32, "cpu")(x, sigma, labels)
        ys = [make(dtype, "cuda")(x.cuda(), sigma.cuda(), labels.cuda()).cpu()
              for dtype in (torch.float32, torch.bfloat16)]
    torch.cuda.empty_cache()
    scale = y_ref.abs().max().item()
    e32, e16 = ((y - y_ref).abs().max().item() / scale for y in ys)
    print(f"{name} forward {list(x.shape)} vs fp32 on the CPU (max abs err / max abs): "
          f"fp32 card {e32:.3e}, bf16 card {e16:.3e}")
    if not (e32 < 1e-3 and e16 < 5e-2 and torch.isfinite(ys[1]).all()):
        raise AssertionError(f"{name}: full-width forward disagrees with the CPU: fp32 {e32}, "
                             f"bf16 {e16}")
    return e32, e16


def seeded_net(cfg: dict, precond):
    """make(dtype, device): ``precond`` over ``cfg``'s net in eval mode,
    random weights from numpy seed 0."""
    def make(dtype, device):
        net = precond(dtype=dtype, **cfg)
        return load_into(net, random_state_dict(net, 0)).to(device).eval()
    return make


def cifar_phase(tag: str) -> tuple[list[dict], dict]:
    """Phase 4d: the CIFAR-10 DDPM++ serving path. Returns (the searches'
    lines, the d = 256 attention summary for the kernel line)."""
    print("CIFAR-10 DDPM++: qkv attention at d = 256 vs plain:")
    rows = [check_attention(N * SAMPLES, t, heads, dtype, tag, d=CIFAR_D)
            for dtype in (torch.bfloat16, torch.float32) for t, heads, _ in CIFAR_SITES]
    main_rows = rows[:len(CIFAR_SITES)]

    g = torch.Generator().manual_seed(6)
    sigma = torch.tensor([80.0, 0.5])
    x = torch.randn((2, 32, 32, 3), generator=g) * sigma.view(2, 1, 1, 1)
    labels = torch.eye(10)[[3, 7]]
    check_forward("CIFAR-10 DDPM++ (EDMPrecond)", lambda dtype, device: load_network(
        "cifar10", dtype=dtype, device=device, seed=0), x, sigma, labels)
    check_forward("NCSN++ (VEPrecond, the ncsnpp preset at 32x32)",
                  seeded_net(NCSNPP_CIFAR, VEPrecond), x, sigma, labels)
    x64 = torch.randn((2, 64, 64, 3), generator=g) * sigma.view(2, 1, 1, 1)
    check_forward("ImageNet-64 ADM (iDDPMPrecond)", lambda dtype, device: load_network(
        "imagenet64", precond="iddpm", dtype=dtype, device=device, seed=0), x64, sigma,
        torch.eye(1000)[[3, 977]])

    t0 = time.perf_counter()
    net = load_network("cifar10", dtype=torch.bfloat16, device="cuda", seed=0)
    load_s = time.perf_counter() - t0
    params = SearchParams(N=N, K=K)
    search = lambda: generate_image_grid(
        arch="cifar10", scorer=BrightnessScorer(), method="eps_greedy", params=params, seed=0,
        gridw=SAMPLES, num_steps=STEPS, dtype=torch.bfloat16, device="cuda", net=net)
    reset_launches()
    result, first_s = timed_run(search)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, routes = read_launches(), read_routes()
    _, again_s = timed_run(search)  # the same request again: steady state, not counted
    calls, _ = method_calls("eps_greedy", "edm", STEPS, params, SAMPLES)
    expected = sum(n for _, _, n in CIFAR_SITES) * sum(calls.values())
    nfe = nfe_per_sample("eps_greedy", STEPS, params) * SAMPLES
    print(f"CIFAR-10 DDPM++ path: eps_greedy 18 steps B={SAMPLES} N={N} K={K} bf16: load "
          f"{load_s:.2f} s, search {first_s:.3f} s first / {again_s:.3f} s again, {nfe} NFE, "
          f"{nfe / first_s:.2f} / {nfe / again_s:.2f} NFE/s, peak memory {peak:.2f} GiB, "
          f"scores {result.score.tolist()}, launches {{'qkv_attention': "
          f"{launches['attention']}}} [{tag}]")
    for name, n in launches.items():
        if n != (expected if name == "attention" else 0):
            raise AssertionError(f"{name} launched {n} times on the CIFAR-10 path, expected "
                                 f"{expected if name == 'attention' else 0}")
    check_routes("CIFAR-10", routes, {"attention": expected})
    if not (torch.isfinite(result.score).all() and torch.isfinite(result.x).all()
            and result.images.shape == (SAMPLES, 32, 32, 3)
            and 0 <= result.images.min() <= result.images.max() <= 1):
        raise AssertionError("CIFAR-10 path output is not finite images in [0, 1]")
    searches = edm_methods_phase(net, tag, arch="cifar10", sites_of=CIFAR_SITES, d=CIFAR_D)
    del net
    torch.cuda.empty_cache()
    per_forward = lambda key: sum(r[key] * n for r, (_, _, n) in zip(main_rows, CIFAR_SITES))
    eps = dict(path="EDM cifar10", method="eps_greedy", steps=STEPS, N=N, K=K, samples=SAMPLES,
               wall_s=first_s, again_s=again_s, nfe=nfe, nfe_per_s=nfe / first_s,
               peak_gib=peak, launches={"qkv_attention": launches["attention"]})
    return [eps] + searches, {
        "launches": launches["attention"],
        # times: the 6 attention sites of one bf16 forward at the search's
        # batch (N * samples), summed
        "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"), "library_ms": per_forward("library_ms"),
        "fma_ms": per_forward("fma_ms"), "max_abs_err": max(r["max_abs_err"] for r in rows),
        "method_launches": {r["method"]: r["launches"]["qkv_attention"] for r in searches},
        "nfe_per_s": nfe / again_s, "shapes": rows,
    }


def cifar_training_phase(tag: str) -> dict:
    """Phase 5b: the DDPM++ / VP training path (the training CLI's --arch
    ddpmpp --precond vp --cond 1 --bf16 1 --augment 0 at full width). Returns
    the d = 256 backward summary for the kernel line."""
    print("attention backward kernels at d = 256 vs plain:")
    micro = CIFAR_TRAIN_BATCH // TRAIN_ROUNDS
    main_rows = [check_attention_bwd(micro, t, heads, torch.bfloat16, tag, d=CIFAR_D)
                 for t, heads, _ in CIFAR_SITES]
    rows = main_rows + [check_attention_bwd(micro, 256, 1, torch.float32, tag, d=CIFAR_D)]
    fwd_rows = [check_attention(micro, t, heads, torch.bfloat16, tag, d=CIFAR_D)
                for t, heads, _ in CIFAR_SITES]
    check_training_forward_backward(DDPMPP_TRAIN, VPPrecond, VPLoss())

    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        for i in range(2):
            Image.fromarray(np.full((32, 32, 3), 40 * i, np.uint8)).save(
                os.path.join(data, f"img{i}.png"))
        train_cli.main(["--outdir", os.path.join(tmp, "runs"), "--data", data, "--arch",
                        "ddpmpp", "--precond", "vp", "--augment", "0", "--bf16", "1",
                        "--dry-run"])
    run = check_training_loop(
        tag, fwd_rows, main_rows, cfg=DDPMPP_TRAIN, precond=VPPrecond, precond_name="vp",
        loss_fn=VPLoss(), batch=CIFAR_TRAIN_BATCH, sites_of=CIFAR_SITES,
        routes_of={"attention_bwd": qk.backward_route(torch.bfloat16, CIFAR_D)},
        label="CIFAR-10 DDPM++")
    per_backward = lambda key: sum(r[key] * n for r, (_, _, n) in zip(main_rows, CIFAR_SITES))
    return {
        "launches": run["launches"], "forward_launches": run["forward_launches"],
        # times: the 6 sites of one bf16 backward at the micro-batch (32), summed
        "ms": per_backward("ms"), "plain_ms": per_backward("plain_ms"),
        "bound_ms": per_backward("bound_ms"), "library_ms": per_backward("library_ms"),
        "max_abs_err": max(r["max_abs_err"] for r in rows), "routes": run["routes"],
        "train_step_ms": run["step_ms"], "train_img_per_s": run["img_per_s"],
        "train_peak_gib": run["peak_gib"], "shapes": rows + fwd_rows,
    }


def augment_draws(n: int, seed: int) -> dict:
    """Post-gate values of every option of the EDM pipe for n images, about
    half of each gated to 0 (the pipe's ``draws=`` names)."""
    g = np.random.default_rng(seed)
    gate = lambda *shape: g.uniform(size=shape) < 0.5
    f = lambda a: np.asarray(a, np.float32)
    return dict(xflip=f(g.integers(0, 2, n)), yflip=f(g.integers(0, 2, n) * gate(n)),
                scale=f(g.standard_normal(n) * gate(n)),
                rotate_frac=f(g.uniform(-np.pi, np.pi, n) * gate(n)),
                aniso_w=f(g.standard_normal(n) * gate(n)),
                aniso_r=f(g.uniform(-np.pi, np.pi, n) * gate(n)),
                translate_frac=f(g.standard_normal((2, n)) * gate(1, n)))


def augmented_training_phase(tag: str, ddpmpp: dict) -> dict:
    """Phase 5c: the DDPM++ / VP training path at the training CLI's
    defaults (--arch ddpmpp --precond vp --cond 1 --bf16 1, --augment 0.12):
    the EDM augment pipe on the card against the CPU under injected draws
    (fp32, TF32 off), its time per call, the CLI's dry run, and
    training_loop at full width as in 5b with the pipe; ``ddpmpp`` is 5b's
    summary, whose step times are printed beside. Returns the phase's
    numbers."""
    pipe = edm_augment_pipe(0.12)
    g = torch.Generator().manual_seed(50)
    call_ms, worst = {}, 0.0
    for shape in ((32, 32, 32, 3), (16, 64, 64, 3)):
        x = torch.rand(shape, generator=g) * 2 - 1
        draws = augment_draws(shape[0], sum(shape))
        want, want_lab = pipe(x, draws=draws)
        got, got_lab = pipe(x.cuda(), draws=draws)
        err = rel_err(got.cpu(), want)[1]
        worst = max(worst, err)
        if not (err <= 1e-5 and torch.equal(got_lab.cpu(), want_lab)):
            raise AssertionError(f"augment pipe {list(shape)} on the card disagrees with the "
                                 f"CPU: images {err}, labels equal "
                                 f"{torch.equal(got_lab.cpu(), want_lab)}")
        xc, gen = x.cuda(), torch.Generator(device="cuda").manual_seed(0)
        call_ms[shape] = time_ms(lambda: pipe(xc, gen))
        print(f"  augment pipe {list(shape)}: card vs CPU under injected draws, images max "
              f"err / max {err:.3e} (limit 1e-5), labels equal; {call_ms[shape]:.3f} ms a call "
              f"with the card's draws [{tag}]")

    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        for i in range(2):
            Image.fromarray(np.full((32, 32, 3), 40 * i, np.uint8)).save(
                os.path.join(data, f"img{i}.png"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_cli.main(["--outdir", os.path.join(tmp, "runs"), "--data", data, "--arch",
                            "ddpmpp", "--precond", "vp", "--bf16", "1", "--dry-run"])
        opts = json.loads(out.getvalue().split("--dry-run")[0])
    if not (opts["augment"] == 0.12 and opts["net_config"]["model_kwargs"]["augment_dim"] == 9):
        raise AssertionError(f"the training CLI's defaults did not build the pipe: {opts}")

    cfg = dict(DDPMPP_TRAIN, model_kwargs=dict(DDPMPP_TRAIN["model_kwargs"], augment_dim=9))
    sites = len(CIFAR_SITES)  # 5b's rows: the bf16 backward ones first, the forward ones last
    run = check_training_loop(
        tag, ddpmpp["shapes"][-sites:], ddpmpp["shapes"][:sites], cfg=cfg, precond=VPPrecond,
        precond_name="vp", loss_fn=VPLoss(),
        batch=CIFAR_TRAIN_BATCH, sites_of=CIFAR_SITES,
        routes_of={"attention_bwd": qk.backward_route(torch.bfloat16, CIFAR_D)},
        label="CIFAR-10 DDPM++ augmented", augment_fn=pipe)
    timed = sorted(run["step_ms"][1:])
    median = (timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    micro = (CIFAR_TRAIN_BATCH // TRAIN_ROUNDS, 32, 32, 3)
    share = TRAIN_ROUNDS * call_ms[micro] / median
    print(f"augmented DDPM++ / VP step: median {median:.1f} ms = {run['img_per_s']:.2f} img/s "
          f"(5b, unaugmented, this call: steps {[round(m, 1) for m in ddpmpp['train_step_ms']]} "
          f"ms, {ddpmpp['train_img_per_s']:.2f} img/s); the pipe {TRAIN_ROUNDS} x "
          f"{call_ms[micro]:.3f} ms = {share:.1%} of a step [{tag}]")
    return {"step_ms": run["step_ms"], "img_per_s": run["img_per_s"], "peak_gib": run["peak_gib"],
            "pipe_ms": {"x".join(map(str, k)): v for k, v in call_ms.items()},
            "pipe_share": share, "pipe_max_rel_err": worst,
            "launches": run["launches"], "forward_launches": run["forward_launches"]}


def resnet_routing(n: collections.Counter, block: sd_layers.ResnetBlock2D, hw: int) -> None:
    """Adds one resnet's kernel calls at hw x hw to ``n``: each conv on the
    conv kernel with its GroupNorm's statistics, or its GroupNorm alone."""
    cin, cout = block.conv1.in_channels, block.conv1.out_channels
    for c in (cin, cout):  # conv1 is cin -> cout, conv2 cout -> cout
        fused = cv.conv3_shape_eligible(hw, hw, c, cout)
        n["conv3x3_same"] += fused
        n["group_norm_stats" if fused else "group_norm_silu"] += 1


def encode_routing(vae: sd_vae.AutoencoderKL, hw: int) -> dict:
    """Kernel calls of one VAE encode of hw x hw images, from the encoder's
    modules in forward order and the routing predicates."""
    n = collections.Counter()
    enc = vae.encoder
    for conv in (enc.conv_in, enc.conv_out):  # 3 and 8 channels: never routed
        if cv.conv3_shape_eligible(hw, hw, conv.in_channels, conv.out_channels):
            raise AssertionError("conv_in / conv_out are not expected on the kernel route")
    for block in enc.down_blocks:
        for res in block.resnets:
            resnet_routing(n, res, hw)
        if hasattr(block, "downsamplers"):
            hw //= 2
    for block in enc.mid_block.resnets:
        resnet_routing(n, block, hw)
    n["attention"] += len(enc.mid_block.attentions)
    n["group_norm_silu"] += sum(isinstance(m, sd_layers.GroupNorm)
                                for m in enc.mid_block.attentions.modules())
    n["group_norm_silu"] += 1  # conv_norm_out
    return dict(n)


def decode_routing(vae: sd_vae.AutoencoderKL, hw: int) -> dict:
    """Kernel calls of one VAE decode of hw x hw latents, from the decoder's
    modules in forward order and the routing predicates."""
    n = collections.Counter()
    dec = vae.decoder

    def up2(conv: sd_layers.Conv3x3, hw: int) -> bool:
        return cv.up2_eligible(torch.empty((1, conv.in_channels, hw, hw), device="meta"),
                               conv.weight)

    for conv in (dec.conv_in, dec.conv_out):  # neither has 128-multiple channels on both sides
        if cv.conv3_shape_eligible(8 * hw, 8 * hw, conv.in_channels, conv.out_channels):
            raise AssertionError("conv_in / conv_out are not expected on the kernel route")
    for block in dec.mid_block.resnets:
        resnet_routing(n, block, hw)
    n["group_norm_silu"] += sum(isinstance(m, sd_layers.GroupNorm)
                                for m in dec.mid_block.attentions.modules())
    for block in dec.up_blocks:
        for res in block.resnets:
            resnet_routing(n, res, hw)
        if hasattr(block, "upsamplers"):
            n["conv3x3_up2"] += up2(block.upsamplers[0].conv, hw)
            hw *= 2
    n["group_norm_silu"] += 1  # conv_norm_out
    return dict(n)


def sd_forward_checks(ref, pipe32, pipe16) -> None:
    """One UNet forward (CFG-shaped batch 2, 77-token context) and one VAE
    decode (batch 1) on the card in fp32 and bf16 against fp32 on the CPU,
    which runs the same route through the plain versions."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 4, 64, 64), generator=g)
    t = torch.tensor([981, 501])
    ctx = torch.randn((2, CLIP_TOKENS, 768), generator=g)
    z = torch.randn((1, 4, 64, 64), generator=g) / ref.vae.scaling_factor
    with torch.no_grad():
        want = {"unet": ref.unet(x, t, ctx), "decode": ref.vae.decode(z)}
        for name, pipe, limit in (("fp32", pipe32, 1e-3), ("bf16", pipe16, 5e-2)):
            got = {"unet": pipe.unet(x.cuda(), t.cuda(), ctx.cuda()).cpu(),
                   "decode": pipe.vae.decode(z.cuda()).cpu()}
            for part in ("unet", "decode"):
                err = rel_err(got[part], want[part])[1]
                print(f"SD {part} {list(got[part].shape)} {name} card vs fp32 CPU "
                      f"(max abs err / max abs): {err:.3e} (limit {limit})")
                if not (err <= limit and torch.isfinite(got[part]).all()):
                    raise AssertionError(f"SD {part} in {name} disagrees with the CPU: {err}")



SD_CHECKS = {"attention": check_sd_attention, "group_norm_silu": check_group_norm,
             "geglu_ff": check_geglu, "group_norm_stats": check_group_norm_stats,
             "conv3x3_same": check_conv_same, "conv3x3_up2": check_conv_up2}


def sd_phases(tag: str) -> tuple[list[dict], list[dict], dict]:
    """Phases 6, 6b and 7: the SD main path, the other searches, then the
    SD kernels at the main path's shapes. Returns (the searches' lines,
    the kernel lines, {kernel: the bf16 shape keys checked})."""
    t0 = time.perf_counter()
    ref = StableDiffusionSearchPipeline.random(SD15_UNET, SD15_VAE, seed=0, dtype=torch.float32,
                                               device="cpu")
    pipe16 = sd_pipeline_like(ref, torch.bfloat16)
    load_s = time.perf_counter() - t0
    pipe32 = sd_pipeline_like(ref, torch.float32)
    sd_forward_checks(ref, pipe32, pipe16)
    del ref, pipe32
    torch.cuda.empty_cache()

    # calls per UNet forward and per VAE decode, from the architecture and the
    # routing predicates (the UNet never exceeds 64x64: none of its convs is
    # routed, every GroupNorm module of it is one standalone call)
    count = lambda mod, cls: sum(isinstance(m, cls) for m in mod.modules())
    zero = {"attention_bwd": 0, "group_norm_stats": 0, "conv3x3_same": 0, "conv3x3_up2": 0}
    per_unet = {"attention": count(pipe16.unet, sd_layers.BasicTransformerBlock),
                "group_norm_silu": count(pipe16.unet, sd_layers.GroupNorm),
                "geglu_ff": count(pipe16.unet, sd_layers.FeedForward), **zero}
    per_decode = {"attention": count(pipe16.vae.decoder, sd_vae.VAEAttention), "attention_bwd": 0,
                  "geglu_ff": 0, **decode_routing(pipe16.vae, SD15_UNET["sample_size"])}
    if per_unet != SD_PER_UNET or per_decode != SD_PER_DECODE:
        raise AssertionError(f"unexpected SD-1.5 architecture or routing: {per_unet} {per_decode}")
    if count(pipe16.vae.decoder, sd_layers.GroupNorm) != 30:
        raise AssertionError("the VAE decoder should hold 30 GroupNorm modules")
    per_call = launches_per_call()
    forwards, decodes = SD_STEPS * (1 + SD_K), SD_STEPS * SD_K + 1

    params = SearchParams(N=SD_N, K=SD_K)
    g = torch.Generator(device="cuda").manual_seed(11)
    emb = torch.randn((SD_PROMPTS, CLIP_TOKENS, 768), device="cuda", generator=g)
    search = lambda: pipe16(prompt_embeds=emb, num_inference_steps=SD_STEPS,
                            score_function=BrightnessScorer(), method="eps_greedy",
                            params=params, seed=0)
    shapes = KernelShapes(pipe16)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images, scores = search()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, routes = read_launches(), read_routes()
    shapes.remove()
    t0 = time.perf_counter()
    search()  # the same request again: steady state, not counted
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    nfe = nfe_per_sample("eps_greedy", SD_STEPS, params, backend="sd") * SD_PROMPTS
    print(f"SD main path: eps_greedy {SD_STEPS} steps B={SD_PROMPTS} N={SD_N} K={SD_K} bf16 "
          f"512x512: load {load_s:.2f} s, search {first_s:.3f} s first / {again_s:.3f} s again, "
          f"{nfe} NFE, {nfe / first_s:.2f} / {nfe / again_s:.2f} NFE/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"scores {scores.tolist()}, launches {launches} [{tag}]")
    for name, n in launches.items():
        want = (per_unet[name] * forwards + per_decode[name] * decodes) * per_call[name]
        if n != want:
            raise AssertionError(f"{name} launched {n} times on the SD main path, "
                                 f"expected {want}")
    check_routes("SD", routes, {name: launches[name] for name in
                                ("attention", "geglu_ff", "conv3x3_same", "conv3x3_up2",
                                 "group_norm_silu")})
    if not (torch.isfinite(scores).all() and torch.isfinite(images).all()
            and images.shape == (SD_PROMPTS, 512, 512, 3)
            and 0 <= images.min() <= images.max() <= 1):
        raise AssertionError("SD main path output is not finite images in [0, 1]")
    del images
    searches = sd_methods_phase(pipe16, emb, shapes, per_unet, per_decode, per_call, tag)
    rewards = sd_rewards_phase(pipe16, per_unet, per_decode, per_call, tag)
    del pipe16
    torch.cuda.empty_cache()

    print("SD kernels vs plain, at every shape of the search:")
    fp32_shape = {"attention": (2, 1024, 8, 80),
                  "group_norm_silu": ((2, 640, 32, 32), 32, 1e-5, True),
                  "geglu_ff": (2048, 1280, 5120),
                  "group_norm_stats": ((2, 256, 128, 128), 32, 1e-6),
                  "conv3x3_same": ((2, 128, 128, 128), 128, True, True, "shortcut", 256),
                  "conv3x3_up2": ((2, 128, 64, 64), 128, True)}
    pallas = "diffusion_tts_tpu/ops/pallas/"
    sources = {"attention": ("qkv_attention.cu", pallas + "attention.py:424"),
               "group_norm_silu": ("groupnorm.cu", pallas + "groupnorm.py:144"),
               "geglu_ff": ("geglu_ff.cu", pallas + "geglu_ff.py:251"),
               "group_norm_stats": ("groupnorm.cu", pallas + "groupnorm.py:346"),
               "conv3x3_same": ("conv3x3.cu", pallas + "conv3x3.py:497"),
               "conv3x3_up2": ("conv3x3.cu", pallas + "conv3x3.py:811")}
    lines = []
    for name, check in SD_CHECKS.items():
        rows = []
        for key, calls in sorted(shapes.counts[name].items(), key=str):
            row = check(key, torch.bfloat16, tag)
            row["calls_per_search"] = calls
            rows.append(row)
        if sum(r["calls_per_search"] for r in rows) * per_call[name] != launches[name]:
            raise AssertionError(f"{name}: the recorded calls do not add up to its launches")
        rows.append(check(fp32_shape[name], torch.float32, tag))
        total = lambda k: sum(r[k] * r.get("calls_per_search", 0) for r in rows)
        lines.append({
            "name": name, "route": "cuda", "source": f"diffusion_tts_torch/csrc/{sources[name][0]}",
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # times: summed over every call of one SD search (bf16, by shape)
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": max(rows, key=lambda r: r["bound_ms"] * r.get("calls_per_search", 0))[
                "bound_by"],
            "library_ms": total("library_ms"), "shapes": rows,
        })
        for first in ("fma_ms", "v1_ms", "device_ms", "v1_device_ms", "library_device_ms"):
            if first in rows[0]:
                lines[-1][first] = total(first)
        if name in ROUTE_COUNTERS:  # launches of the search per design
            lines[-1]["routes"] = routes[name]
        lines[-1]["method_launches"] = {r["method"]: r["launches"][name] for r in searches}
    gn_line = next(line for line in lines if line["name"] == "group_norm_silu")
    gn_shapes = {tuple(r["shape"]) for r in gn_line["shapes"] if r["dtype"] == "bfloat16"}
    if not {(4, 128, 512, 512), (8, 960, 64, 64)} <= gn_shapes:
        raise AssertionError(f"the SD search did not give GroupNorm its largest shapes: {gn_shapes}")
    return searches + rewards, lines, {name: set(c) for name, c in shapes.counts.items()}


def sd_encoder_phase(tag: str, checked: dict) -> dict:
    """Phase 6d: the SD-1.5 VAE encoder on phase 6's VAE (SD15_VAE, random
    weights from numpy seed 1, as StableDiffusionSearchPipeline.random(seed=0)
    draws them): encode in fp32 and bf16 on the card against fp32 on the CPU
    at [1, 3, 256, 256], encode timed at 512x512 (batches 1 and 4, bf16) with
    its canonical FLOPs, its kernel launches held against the encoder's
    architecture and the routing predicates (each on its fast route), every
    kernel call of one 512x512 bf16 encode held against its plain version at
    its shape (those of ``checked``, phase 6's, are not checked again), and
    one encode -> sample -> decode round trip. Returns the launches of one
    512x512 encode, the predicted calls per encode, each kernel's largest
    error at the encoder's shapes and the timings."""
    from diffusion_tts_torch.utils.roofline import sd_vae_encode_flops

    ref = sd_vae.AutoencoderKL(**SD15_VAE)
    load_into(ref, random_state_dict(ref, 1)).eval()
    vaes = {}
    for dtype in (torch.float32, torch.bfloat16):
        with torch.device("cuda"):
            vaes[dtype] = sd_vae.AutoencoderKL(**SD15_VAE, dtype=dtype)
        vaes[dtype].load_state_dict(ref.state_dict())
        vaes[dtype].eval()
    g = torch.Generator().manual_seed(60)
    x = torch.rand((1, 3, 256, 256), generator=g) * 2 - 1
    with torch.no_grad():
        t0 = time.perf_counter()
        want = ref.encode(x)
        cpu_s = time.perf_counter() - t0
        for dtype, limit in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
            got = vaes[dtype].encode(x.cuda())
            err = rel_err((got.mean.cpu(), got.logvar.cpu()), (want.mean, want.logvar))[1]
            print(f"SD encode [1, 3, 256, 256] {str(dtype).split('.')[-1]} card vs fp32 CPU "
                  f"({cpu_s:.1f} s), mean and logvar max abs err / max abs: {err:.3e} "
                  f"(limit {limit})")
            if not (err <= limit and torch.isfinite(got.mean).all()
                    and torch.isfinite(got.logvar).all()):
                raise AssertionError(f"SD encode in {dtype} disagrees with the CPU: {err}")
    del ref, vaes[torch.float32]
    torch.cuda.empty_cache()

    vae = vaes[torch.bfloat16]
    per_call = launches_per_call()
    per_encode = {k: 0 for k in per_call}
    per_encode.update(encode_routing(vae, 512))
    want = {k: n * per_call[k] for k, n in per_encode.items()}
    x512 = torch.rand((4, 3, 512, 512), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(61)) * 2 - 1
    with torch.no_grad():
        vae.encode(x512[:1])  # warm
        torch.cuda.synchronize()
        shapes = KernelShapes(modules=(vae.encoder,))
        reset_launches()
        try:
            post = vae.encode(x512[:1])
            torch.cuda.synchronize()
        finally:
            shapes.remove()
        launches, routes = read_launches(), read_routes()
        if launches != want:
            raise AssertionError(f"one 512x512 encode launched {launches}, the encoder's "
                                 f"architecture and the routing predicates give {want}")
        check_routes("SD encode", routes, {k: n for k, n in want.items()
                                           if n and k in FAST_ROUTE})
        if post.mean.shape != (1, 4, 64, 64):
            raise AssertionError(f"a 512x512 encode gave latents {tuple(post.mean.shape)}")
        for name, calls in shapes.counts.items():
            if sum(calls.values()) * per_call[name] != launches[name]:
                raise AssertionError(f"{name}: the encoder's recorded calls {dict(calls)} do "
                                     f"not add up to its {launches[name]} launches")
        print("SD kernels vs plain at the encoder's shapes (512x512 bf16, untimed):")
        errs, seen = {}, 0
        for name, check in SD_CHECKS.items():
            seen += len(set(shapes.counts[name]) & checked[name])
            for key in sorted(set(shapes.counts[name]) - checked[name], key=str):
                row = check(key, torch.bfloat16, tag, timed=False)
                errs[name] = max(errs.get(name, 0.0), row["max_abs_err"])
            torch.cuda.empty_cache()
        print(f"  {sum(len(c) for c in shapes.counts.values())} shapes, {seen} of them "
              f"checked in phase 6 already")
        timing = {}
        for batch in (1, 4):
            xb = x512[:batch]
            ms = time_ms(lambda: vae.encode(xb), reps=5)
            flops = sd_vae_encode_flops(SD15_VAE, batch)["total_flops"]
            timing[batch] = {"ms": ms, "flops": flops, "tflops": flops / ms / 1e9}
            print(f"SD encode [{batch}, 3, 512, 512] bf16: {ms:.3f} ms, {flops} canonical FLOP, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s [{tag}]")
        torch.cuda.reset_peak_memory_stats()
        out = vae(x512[:1], torch.Generator(device="cuda").manual_seed(62))
        peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches per 512x512 encode {per_encode}; round trip encode -> sample -> decode "
          f"{list(out.shape)} {out.dtype}, peak memory {peak:.2f} GiB [{tag}]")
    if out.shape != x512[:1].shape or not torch.isfinite(out).all():
        raise AssertionError(f"the encode -> sample -> decode round trip gave {tuple(out.shape)}")
    del vae, vaes, x512, post, out
    torch.cuda.empty_cache()
    return {"launches": launches, "per_encode": per_encode, "max_abs_err": errs,
            "timing": timing}


# ------------------------------------------------------- the other searches


class EntryCapture:
    """Stands in for ``module.run_search`` and records what the entry point
    handed it (backend, latents, key) and what it returned, so that a
    search run through the entry point can be checked afterwards."""

    def __init__(self, module):
        self.module, self.run = module, module.run_search
        module.run_search = self

    def __call__(self, method, backend, z, key, *args, **kwargs):
        self.backend, self.z, self.key = backend, z, key
        self.result = self.run(method, backend, z, key, *args, **kwargs)
        return self.result

    def remove(self) -> None:
        self.module.run_search = self.run


def method_calls(method: str, backend: str, steps: int, p: SearchParams,
                 samples: int) -> tuple[collections.Counter, collections.Counter]:
    """(model calls, VAE decodes) of one search, each {batch: calls}, from
    the method's structure (search/naive.py, beam.py, mcts.py with one
    phase, zero_order.py, whose eps-greedy and zero-order make the same
    calls). EDM: the denoiser, twice a Heun step, no decode. SD: the UNet,
    each batch CFG-doubled; rejection and beam decode their candidates at
    the end, eps-greedy each lookahead, and run_search the result."""
    n, m, s, k, c = p.N, p.B, p.S, p.K, collections.Counter
    method = "eps_greedy" if method == "zero_order" else method
    if backend == "edm":
        calls = {"naive": c({samples: 2 * steps}), "rejection": c({n * samples: 2 * steps}),
                 "beam": c({n * m * samples: 2 * steps}),
                 "mcts": c({n * samples: 2 * (s + 1) * steps}) + c({s * samples: 2 * steps * steps}),
                 "eps_greedy": c({n * samples: 2 * steps * k})}
        return calls[method], c()
    unet = {"naive": c({2 * samples: steps}), "rejection": c({2 * n * samples: steps}),
            "beam": c({2 * m * samples: steps}) + c({2 * n * m * samples: steps}),
            "mcts": c({2 * n * samples: (s + 1) * steps}) + c({2 * s * samples: steps * steps}),
            "eps_greedy": c({2 * samples: steps}) + c({2 * n * samples: steps * k})}
    decode = {"naive": c({samples: 1}), "rejection": c({n * samples: 1}) + c({samples: 1}),
              "beam": c({n * m * samples: steps}) + c({m * samples: 1}) + c({samples: 1}),
              "mcts": c({s * samples: steps}) + c({samples: 1}),
              "eps_greedy": c({n * samples: steps * k}) + c({samples: 1})}
    return unet[method], decode[method]


def check_rejection(capture: EntryCapture, p: SearchParams, steps: int, tag: str) -> None:
    """Rejection's x against replay_trajectory of the chosen candidate's
    noise: the N candidates' draws recorded as the search makes them
    (record_step_draws, same key and device), replayed as one batch and
    scored; the best per sample must be x within bf16's tolerance of x's
    largest magnitude, and its score the returned one within 1e-4."""
    backend, z, x = capture.backend, capture.z, capture.result.x
    n, b = p.N, z.shape[0]
    noise = record_step_draws(capture.key, steps, (n * b,) + tuple(z.shape[1:]),
                              z.device).step_noise
    every = replay_trajectory(backend, z.repeat((n,) + (1,) * (z.ndim - 1)), noise)
    scores = backend.score(backend.final_images(every)).reshape(n, b)
    best = torch.argmax(scores, dim=0)
    rows = torch.arange(b, device=z.device)
    err = rel_err(x, every.reshape((n, b) + every.shape[1:])[best, rows])[1]
    score_err = (scores[best, rows] - capture.result.score).abs().max().item()
    print(f"  rejection vs replay_trajectory of the chosen candidates {best.tolist()}: x max_rel="
          f"{err:.3e} (tol {TOL[torch.bfloat16]}), score max_abs={score_err:.3e} (tol 1e-4) [{tag}]")
    if not (err <= TOL[torch.bfloat16] and score_err <= 1e-4):
        raise AssertionError("rejection's result is not the replay of its best candidate")


def check_search_output(path: str, capture: EntryCapture, images, scores, shape) -> None:
    """Finite images of ``shape`` in [0, 1], and the returned score equal
    to score(final_images(x)) computed again, within 1e-4."""
    backend = capture.backend
    again = backend.score(backend.final_images(capture.result.x))
    if not (torch.isfinite(scores).all() and torch.isfinite(images).all()
            and tuple(images.shape) == shape and 0 <= images.min() <= images.max() <= 1):
        raise AssertionError(f"{path}: the output is not finite images {shape} in [0, 1]")
    if (again - scores).abs().max().item() > 1e-4:
        raise AssertionError(f"{path}: returned scores {scores.tolist()}, computed again "
                             f"{again.tolist()}")


def search_line(path: str, method: str, p: SearchParams, steps: int, samples: int, wall: float,
                nfe: int, launches: dict, scores, tag: str, **extra) -> dict:
    """One search's line; ``extra`` (the reward phases' scorer and its
    share of wall time) is printed and kept beside the rest."""
    peak = torch.cuda.max_memory_allocated() / 2**30
    knobs = {"rejection": ("N",), "beam": ("B", "N"), "mcts": ("N", "S"),
             "eps_greedy": ("N", "K")}[method]
    knobs = {k: getattr(p, k) for k in knobs}
    print(f"{path} search {method} {steps} steps samples={samples} "
          f"{' '.join(f'{k}={v}' for k, v in knobs.items())} bf16: {wall:.3f} s, {nfe} NFE, "
          f"{nfe / wall:.2f} NFE/s, peak memory {peak:.2f} GiB, scores {scores.tolist()}, "
          f"launches {launches}{''.join(f', {k} {v}' for k, v in extra.items())} [{tag}]")
    return {"path": path, "method": method, "steps": steps, **knobs, "samples": samples,
            "wall_s": wall, "nfe": nfe, "nfe_per_s": nfe / wall, "peak_gib": peak,
            "launches": launches, **extra}


def timed_run(run) -> tuple[object, float]:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@torch.no_grad()
def edm_methods_phase(net: torch.nn.Module, tag: str, arch: str = "imagenet64",
                      sites_of: tuple = SITES, d: int = 64) -> list[dict]:
    """Phases 4b and 4d: rejection, beam and MCTS through generate_image_grid
    on the ``arch`` net (attention sites ``sites_of``, heads of width ``d``),
    each run's launches held against its structure, then the qkv attention
    kernel against its plain version at the batches these searches give it
    and eps-greedy's does not."""
    sites = sum(n for _, _, n in sites_of)
    res = edm_entry.NET_CONFIGS[arch]["img_resolution"]
    path = "EDM" if arch == "imagenet64" else f"EDM {arch}"
    lines, batches = [], set()
    capture = EntryCapture(edm_entry)
    try:
        for method, p, steps in EDM_METHOD_RUNS:
            run = lambda: generate_image_grid(
                arch=arch, scorer=BrightnessScorer(), method=method, params=p, seed=0,
                gridw=SAMPLES, num_steps=steps, dtype=torch.bfloat16, device="cuda", net=net)
            calls, _ = method_calls(method, "edm", steps, p, SAMPLES)
            nfe = nfe_per_sample(method, steps, p) * SAMPLES
            if sum(b * n for b, n in calls.items()) != nfe:
                raise AssertionError(f"EDM {method}: the calls {calls} do not add up to {nfe} NFE")
            batches |= set(calls)
            reset_launches()
            result, wall = timed_run(run)
            launches, routes = read_launches(), read_routes()
            want = {"attention": sites * sum(calls.values())}
            lines.append(search_line(path, method, p, steps, SAMPLES, wall, nfe,
                                     {"qkv_attention": launches["attention"]}, result.score, tag))
            for name, n in launches.items():
                if n != want.get(name, 0):
                    raise AssertionError(f"{name} launched {n} times by {path} {method}, "
                                         f"expected {want.get(name, 0)}")
            check_routes(f"{path} {method}", routes, want)
            check_search_output(f"{path} {method}", capture, result.images, result.score,
                                (SAMPLES, res, res, 3))
            if method == "rejection":
                check_rejection(capture, p, steps, tag)
            if method == "mcts":
                again, wall2 = timed_run(run)
                lines[-1]["again_s"] = wall2
                print(f"  the same request again: {wall2:.3f} s, bit-identical "
                      f"{torch.equal(again.x, result.x)}")
                if not torch.equal(again.x, result.x):
                    raise AssertionError(f"two {path} MCTS runs from one seed differ")
    finally:
        capture.remove()
    print(f"{path} kernels vs plain at the other searches' batches (untimed):")
    for b in sorted(batches - {N * SAMPLES}):
        for t, heads, _ in sites_of:
            check_attention(b, t, heads, torch.bfloat16, tag, timed=False, d=d)
    return lines


@torch.no_grad()
def sd_methods_phase(pipe: StableDiffusionSearchPipeline, emb, eps_shapes: KernelShapes,
                     per_unet: dict, per_decode: dict, per_call: dict, tag: str) -> list[dict]:
    """Phase 6b: rejection, beam and MCTS through the pipeline's __call__,
    each run's launches held against its structure, then every kernel
    against its plain version at each shape these searches give it and
    eps-greedy's (``eps_shapes``) does not."""
    lines, fresh = [], {name: collections.Counter() for name in KernelShapes.NAMES}
    capture = EntryCapture(sd_pipeline)
    try:
        for method, p, steps in SD_METHOD_RUNS:
            run = lambda: pipe(prompt_embeds=emb, num_inference_steps=steps,
                               score_function=BrightnessScorer(), method=method, params=p, seed=0)
            unet, decodes = method_calls(method, "sd", steps, p, SD_PROMPTS)
            nfe = nfe_per_sample(method, steps, p, backend="sd") * SD_PROMPTS
            if sum(b * n for b, n in unet.items()) != 2 * nfe:
                raise AssertionError(f"SD {method}: the UNet calls {unet} do not add up to {nfe} NFE")
            shapes = KernelShapes(pipe)
            reset_launches()
            try:
                (images, scores), wall = timed_run(run)
            finally:
                shapes.remove()
            launches, routes = read_launches(), read_routes()
            lines.append(search_line("SD", method, p, steps, SD_PROMPTS, wall, nfe, launches,
                                     scores, tag))
            for name, n in launches.items():
                want = (per_unet[name] * sum(unet.values())
                        + per_decode[name] * sum(decodes.values())) * per_call[name]
                recorded = sum(shapes.counts[name].values()) * per_call[name] if \
                    name in shapes.counts else n
                if n != want or recorded != n:
                    raise AssertionError(f"{name} launched {n} times by SD {method} ({recorded} "
                                         f"from the recorded calls), expected {want}")
            check_routes(f"SD {method}", routes, {name: launches[name] for name in
                                                  ("attention", "geglu_ff", "conv3x3_same",
                                                   "conv3x3_up2", "group_norm_silu")})
            check_search_output(f"SD {method}", capture, images, scores,
                                (SD_PROMPTS, 512, 512, 3))
            for name in fresh:
                fresh[name].update(shapes.counts[name])
            if method == "rejection":
                check_rejection(capture, p, steps, tag)
            if method == "mcts":
                x = capture.result.x
                (again, _), wall2 = timed_run(run)
                lines[-1]["again_s"] = wall2
                same = torch.equal(again, images) and torch.equal(capture.result.x, x)
                print(f"  the same request again: {wall2:.3f} s, bit-identical {same}")
                if not same:
                    raise AssertionError("two SD MCTS runs from one seed differ")
    finally:
        capture.remove()
    print("SD kernels vs plain at the other searches' new shapes (untimed):")
    for name, check in SD_CHECKS.items():
        for key in sorted(set(fresh[name]) - set(eps_shapes.counts[name]), key=str):
            check(key, torch.bfloat16, tag, timed=False)
        torch.cuda.empty_cache()
    return lines


# ------------------------------------------------------------------ rewards


class TimedScorer:
    """Wraps a scorer and sums the wall time of its calls, each between two
    synchronizations: for the instrumented run of a reward search only, so
    that the timed run has no extra syncs."""

    def __init__(self, scorer):
        self.scorer, self.seconds = scorer, 0.0

    def __call__(self, images01, cond=None, timesteps=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.scorer(images01, cond, timesteps)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return out


def held(name: str, card: torch.Tensor, cpu: torch.Tensor, tol: float, tag: str,
         relative: bool = True) -> float:
    """The card's result against the CPU's: the largest difference over the
    CPU result's largest magnitude (``relative``) or absolute, within tol."""
    err = rel_err(card.cpu(), cpu)[1 if relative else 0]
    print(f"  {name}: card vs fp32 CPU {'max_rel' if relative else 'max_abs'}={err:.3e} "
          f"(tol {tol}) [{tag}]")
    if not err <= tol:
        raise AssertionError(f"{name} on the card disagrees with the CPU: {err} > {tol}")
    return err


def grid_images(shape, seed: int) -> torch.Tensor:
    """Random images01 on the uint8 grid, from a numpy seed."""
    g = np.random.default_rng(seed)
    return torch.from_numpy(np.floor(g.uniform(0, 256, shape)).astype(np.float32) / 255.0)


def check_compressibility(path: str, images: torch.Tensor, max_size: float, tag: str) -> None:
    """On images the card produced: the exact mode's sizes from the encoder
    that serves (native libjpeg, else PIL) and, where the native library is
    present, its sizes equal to PIL's byte for byte; the exact mode's scores
    against 1 - clip(PIL size / cap) element by element at the search's cap
    and at one above every size (so that a scorer of zeros fails); the dct
    mode's bits on the card against the CPU within 1e-4 relative."""
    import io

    from PIL import Image

    u8 = np.asarray(np.round(images.float().cpu().numpy() * 255.0), np.uint8)
    sizes = compressibility._host_jpeg_sizes(u8, 80)
    has_native = native.native_available()
    served = "native libjpeg" if has_native else "PIL (native library unavailable)"
    pil = []
    for im in u8:
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="JPEG", quality=80)
        pil.append(len(buf.getvalue()))
    print(f"  {path} compressibility jpeg on {len(u8)} card images: sizes {sizes.tolist()} "
          f"bytes from {served}; PIL {pil} [{tag}]")
    if not has_native:
        print(f"  {path}: native libjpeg against PIL not compared here (no native library)")
    if sizes.tolist() != pil:
        raise AssertionError(f"{path}: JPEG sizes {sizes.tolist()} differ from PIL's {pil}")
    if min(pil) >= max_size:
        print(f"  {path}: every returned image is over the {max_size:.0f}-byte cap and scores "
              f"0, so the search's choice by this reward was not exercised on the card")
    for cap in (max_size, 2.0 * max(pil)):
        got = CompressibilityScorer(max_size=cap)(images.cuda()).cpu()
        want = 1.0 - torch.clamp(torch.tensor(pil, dtype=torch.float32) / cap, 0.0, 1.0)
        err = (got - want).abs().max().item()
        print(f"  {path} compressibility scores at cap {cap:.0f}: {got.tolist()}, "
              f"max_abs vs 1 - clip(PIL size / cap) {err:.3e} (tol 1e-6) [{tag}]")
        if not err <= 1e-6:
            raise AssertionError(f"{path}: compressibility scores {got.tolist()} at cap {cap} "
                                 f"differ from {want.tolist()}")
    card = compressibility.jpeg_proxy_bits(images.cuda())
    cpu = compressibility.jpeg_proxy_bits(images.float().cpu())
    rel = ((card.cpu() - cpu).abs() / cpu.abs()).max().item()
    print(f"  {path} compressibility dct bits card {card.tolist()} vs CPU: max_rel={rel:.3e} "
          f"(tol 1e-4) [{tag}]")
    if not rel <= 1e-4:
        raise AssertionError(f"{path}: dct bits on the card disagree with the CPU: {rel}")


def reward_search(path: str, name: str, run, scorer, capture: EntryCapture, want: dict,
                  steps: int, p: SearchParams, samples: int, nfe: int, shape, tag: str):
    """One eps-greedy search with a reward: timed, its launches held against
    ``want`` ({kernel: launches}, every other kernel 0) on the fast routes,
    its output checked; then run again with the scorer timed for its share
    of the wall time. Returns (the search's line, the images)."""
    reset_launches()
    (images, scores), wall = timed_run(lambda: run(scorer))
    launches, routes = read_launches(), read_routes()
    for kernel, n in launches.items():
        if n != want.get(kernel, 0):
            raise AssertionError(f"{kernel} launched {n} times by {path} eps_greedy with {name}, "
                                 f"expected {want.get(kernel, 0)}")
    check_routes(f"{path} eps_greedy/{name}", routes,
                 {k: n for k, n in want.items() if k in FAST_ROUTE})
    check_search_output(f"{path} eps_greedy/{name}", capture, images, scores, shape)
    timed = TimedScorer(scorer)
    _, wall2 = timed_run(lambda: run(timed))
    line = search_line(path, "eps_greedy", p, steps, samples, wall, nfe,
                       {k: v for k, v in launches.items() if v}, scores, tag, scorer=name,
                       scorer_share=timed.seconds / wall2, instrumented_s=wall2)
    return line, images


@torch.no_grad()
def edm_rewards_phase(net: EDMPrecond, tag: str) -> list[dict]:
    """Phase 4c: the ImageNet classifier at full width against the CPU, then
    eps-greedy with the classifier and with compressibility through
    generate_image_grid on the phase 4 net, and compressibility's two modes
    on the images those searches produced."""
    print("EDM rewards:")
    card = ImageNetScorer(seed=0, device="cuda")
    cpu = ImageNetScorer(seed=0, device="cpu")
    images = grid_images((8, 64, 64, 3), 7)
    labels = torch.from_numpy(np.random.default_rng(8).integers(0, 1000, 8))
    zeros = torch.zeros(8)
    logits = card.model(images.cuda().permute(0, 3, 1, 2), zeros.cuda())
    logits_cpu = cpu.model(images.permute(0, 3, 1, 2), zeros)
    held("classifier logits [8, 1000] fp32", logits, logits_cpu, 1e-3, tag)
    held("classifier probabilities", torch.softmax(logits, -1), torch.softmax(logits_cpu, -1),
         1e-5, tag, relative=False)
    held("ImageNetScorer scores", card(images.cuda(), labels.cuda()), cpu(images, labels), 1e-5,
         tag, relative=False)
    del cpu
    params = SearchParams(N=N, K=K)
    calls, _ = method_calls("eps_greedy", "edm", STEPS, params, SAMPLES)
    nfe = nfe_per_sample("eps_greedy", STEPS, params) * SAMPLES
    if sum(b * n for b, n in calls.items()) != nfe:
        raise AssertionError(f"EDM eps_greedy: the calls {calls} do not add up to {nfe} NFE")
    want = {"attention": sum(n for _, _, n in SITES) * sum(calls.values())}
    lines, produced = [], []
    capture = EntryCapture(edm_entry)
    try:
        for name, scorer, needs_labels in (
                ("imagenet", card, True),
                ("compressibility", CompressibilityScorer(max_size=3000.0), False)):
            def run(s, needs_labels=needs_labels):
                result = generate_image_grid(
                    arch="imagenet64", scorer=s, scorer_needs_labels=needs_labels,
                    method="eps_greedy", params=params, seed=0, gridw=SAMPLES, num_steps=STEPS,
                    dtype=torch.bfloat16, device="cuda", net=net)
                return result.images, result.score

            line, images = reward_search("EDM", name, run, scorer, capture, want, STEPS, params,
                                         SAMPLES, nfe, (SAMPLES, 64, 64, 3), tag)
            lines.append(line)
            produced.append(images)
    finally:
        capture.remove()
    check_compressibility("EDM", torch.cat(produced), 3000.0, tag)
    return lines


@torch.no_grad()
def sd_rewards_phase(pipe: StableDiffusionSearchPipeline, per_unet: dict, per_decode: dict,
                     per_call: dict, tag: str) -> list[dict]:
    """Phase 6c: SD-1.5's text tower and CLIP ViT-L/14 at full width
    against the CPU, then eps-greedy on the phase 6 pipeline with prompt
    embeddings from the text tower, once with CLIP (the prompt's text
    features as scorer_cond, as the CLI passes them) and once with
    compressibility, and compressibility's two modes on the images those
    searches produced."""
    print("SD rewards:")
    text_cpu = CLIPTextModel(SD15_TEXT)
    load_into(text_cpu, random_state_dict(text_cpu, 1)).eval()
    text = copy.deepcopy(text_cpu).cuda()
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, SD15_TEXT.vocab_size, (2, 77)))
    held("SD-1.5 text tower last_hidden_state [2, 77, 768]", text(ids.cuda()), text_cpu(ids),
         1e-3, tag)
    del text_cpu
    clip_cpu = CLIPModel(CLIP_VIT_L14)
    load_into(clip_cpu, random_state_dict(clip_cpu, 2)).eval()
    clip = CLIPScorer(copy.deepcopy(clip_cpu), device="cuda")
    clip_ref = CLIPScorer(clip_cpu, device="cpu")
    images = grid_images((4, 512, 512, 3), 10)
    held("CLIP ViT-L/14 image features [4, 768]",
         clip.model.get_image_features(preprocess_images(images.cuda())),
         clip_ref.model.get_image_features(preprocess_images(images)), 1e-3, tag)
    held("CLIP ViT-L/14 text features [2, 768]", clip.model.get_text_features(ids.cuda()),
         clip_ref.model.get_text_features(ids), 1e-3, tag)
    held("CLIPScorer cosine scores [4]", clip(images.cuda(), ids[:1].cuda()),
         clip_ref(images, ids[:1]), 1e-4, tag, relative=False)
    del clip_ref, clip_cpu

    params = SearchParams(N=SD_N, K=SD_K)
    unet, decodes = method_calls("eps_greedy", "sd", SD_STEPS, params, SD_PROMPTS)
    nfe = nfe_per_sample("eps_greedy", SD_STEPS, params, backend="sd") * SD_PROMPTS
    if sum(b * n for b, n in unet.items()) != 2 * nfe:
        raise AssertionError(f"SD eps_greedy: the UNet calls {unet} do not add up to {nfe} NFE")
    want = {k: (per_unet[k] * sum(unet.values()) + per_decode[k] * sum(decodes.values()))
            * per_call[k] for k in per_call}
    prompt_ids = ids[:SD_PROMPTS].cuda()
    emb = text(prompt_ids)
    # the CLI's cond: normalized text features, so no call hashes the ids on the host
    features = clip.text_features(prompt_ids)
    lines, produced = [], []
    capture = EntryCapture(sd_pipeline)
    try:
        for name, scorer, cond in (
                ("clip", clip, features),
                ("compressibility", CompressibilityScorer(max_size=150000.0), None)):
            def run(s, cond=cond):
                return pipe(prompt_embeds=emb, num_inference_steps=SD_STEPS, score_function=s,
                            scorer_cond=cond, method="eps_greedy", params=params, seed=0)

            line, images = reward_search("SD", name, run, scorer, capture, want, SD_STEPS,
                                         params, SD_PROMPTS, nfe, (SD_PROMPTS, 512, 512, 3), tag)
            lines.append(line)
            produced.append(images)
    finally:
        capture.remove()
    check_compressibility("SD", torch.cat(produced), 150000.0, tag)
    return lines


def cli_phase(tag: str) -> None:
    """Phase 8: one call of the port's CLI on the card (EDM, the ImageNet
    classifier, eps-greedy, bf16), its PNG written to a temporary
    directory, its attention launches held against the search's structure."""
    from PIL import Image

    params = SearchParams(N=N, K=K)
    calls, _ = method_calls("eps_greedy", "edm", STEPS, params, 1)
    want = sum(n for _, _, n in SITES) * sum(calls.values())
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "edm_eps_greedy_imagenet.png")
        reset_launches()
        t0 = time.perf_counter()
        cli.main(["--backend", "edm", "--arch", "imagenet64", "--scorer", "imagenet", "--method",
                  "eps_greedy", "--N", str(N), "--K", str(K), "--dtype", "bf16", "--output", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        size = Image.open(out).size
    print(f"CLI: python -m diffusion_tts_torch.main --backend edm --arch imagenet64 --scorer "
          f"imagenet --method eps_greedy --N {N} --K {K} --dtype bf16: {wall:.3f} s with the "
          f"load, PNG {size}, launches {{'qkv_attention': {qk.LAUNCHES}}} [{tag}]")
    if size != (64, 64) or qk.LAUNCHES != want:
        raise AssertionError(f"the CLI run wrote a {size} PNG with {qk.LAUNCHES} attention "
                             f"launches, expected (64, 64) and {want}")


# ------------------------------------------------------- the ablation sampler


def ablation_nets() -> tuple:
    """Phase 9's rows: (name, make(dtype, device), config, attention sites,
    head width, sampler options), the EDM paper's three original samplers
    (edm/generate.py:270-283) on the nets the port serves."""
    return (
        ("VP", seeded_net(edm_entry.CIFAR10_DDPMPP, VPPrecond), edm_entry.CIFAR10_DDPMPP,
         CIFAR_SITES, CIFAR_D, dict(solver="euler", discretization="vp", schedule="vp",
                                    scaling="vp")),
        ("VE", seeded_net(NCSNPP_CIFAR, VEPrecond), NCSNPP_CIFAR, CIFAR_SITES, CIFAR_D,
         dict(solver="euler", discretization="ve", schedule="ve", scaling="none")),
        ("iDDPM", seeded_net(IMAGENET64_ADM, iDDPMPrecond), IMAGENET64_ADM, SITES, 64,
         dict(solver="euler", discretization="iddpm", schedule="linear", scaling="none")),
    )


def ablation_sampler(net, opts: dict, steps: int, labels: torch.Tensor) -> AblationSampler:
    """``opts`` at ``steps`` over ``net`` (labels repeated to the batch), the
    schedule clamped to the net's sigma range as the reference's sampler
    clamps it."""
    b = labels.shape[0]
    return AblationSampler(
        denoise=lambda x, sigma: net(x, sigma, labels.repeat(x.shape[0] // b, 1)),
        num_steps=steps, net_sigma_min=float(net.sigma_min), net_sigma_max=float(net.sigma_max),
        **opts)


@torch.no_grad()
def ablation_phase(tag: str) -> list[dict]:
    """Phase 9: each sampler 2 steps in fp32 at batch 2 on the card against
    the CPU, then 18 steps in bf16 at batch 8 timed with its launches; then
    eps-greedy through EDMSearchBackend with the iDDPM sampler."""
    lines = []
    for name, make, cfg, sites_of, d, opts in ablation_nets():
        res, label_dim = cfg["img_resolution"], cfg["label_dim"]
        sites = sum(n for _, _, n in sites_of)
        g = torch.Generator().manual_seed(9)
        z, eps = torch.randn((2, res, res, 3), generator=g), torch.randn((2, 2, res, res, 3),
                                                                         generator=g)
        labels = torch.eye(label_dim)[[3, 7]]
        outs = []
        for device in ("cpu", "cuda"):
            net = make(torch.float32, device)
            sampler = ablation_sampler(net, opts, 2, labels.to(device))
            outs.append(sampler.sample(z.to(device), eps.to(device)).cpu())
            del net
        torch.cuda.empty_cache()
        err = rel_err(outs[1], outs[0])[1]
        print(f"ablation {name} ({opts['solver']}, {opts['discretization']}, "
              f"{opts['schedule']}, {opts['scaling']}): 2 steps fp32 batch 2, card vs CPU "
              f"max_rel={err:.3e} (tol 1e-3) [{tag}]")
        if not (err <= 1e-3 and torch.isfinite(outs[1]).all()):
            raise AssertionError(f"the {name} ablation sampler disagrees with the CPU: {err}")

        net = make(torch.bfloat16, "cuda")
        b = N * SAMPLES
        g = torch.Generator(device="cuda").manual_seed(10)
        z = torch.randn((b, res, res, 3), device="cuda", generator=g)
        eps = torch.randn((STEPS, b, res, res, 3), device="cuda", generator=g)
        sampler = ablation_sampler(net, opts, STEPS, torch.eye(label_dim, device="cuda")[
            torch.arange(b, device="cuda") % label_dim])
        reset_launches()
        x, wall = timed_run(lambda: sampler.sample(z, eps))
        launches, routes = read_launches(), read_routes()
        peak = torch.cuda.max_memory_allocated() / 2**30
        _, again = timed_run(lambda: sampler.sample(z, eps))  # steady state, not counted
        want = sites * STEPS  # euler: one forward a step
        nfe = STEPS * b
        print(f"ablation {name} on {cfg['model_type']} {res}x{res} ({type(net).__name__}), "
              f"{STEPS} steps batch {b} bf16: {wall:.3f} s first / {again:.3f} s again, {nfe} "
              f"NFE, {nfe / wall:.2f} / {nfe / again:.2f} NFE/s, peak memory {peak:.2f} GiB, "
              f"launches {{'qkv_attention': {launches['attention']}}} at d = {d} [{tag}]")
        for kernel, n in launches.items():
            if n != (want if kernel == "attention" else 0):
                raise AssertionError(f"{kernel} launched {n} times by the {name} sampler, "
                                     f"expected {want if kernel == 'attention' else 0}")
        check_routes(f"ablation {name}", routes, {"attention": want})
        if not torch.isfinite(x).all():
            raise AssertionError(f"the {name} sampler's output is not finite")
        lines.append(dict(path=f"ablation {name}", method="sample", steps=STEPS, samples=b,
                          wall_s=wall, again_s=again, nfe=nfe, nfe_per_s=nfe / wall,
                          peak_gib=peak,
                          launches={"qkv_attention": launches["attention"]}, d=d))
        del sampler

    # eps-greedy through the search backend with the iDDPM sampler (the
    # last row's net, still held): euler, so one forward per candidate expansion
    steps, params = 6, SearchParams(N=N, K=K)
    labels = torch.eye(1000, device="cuda")[[3, 977]]
    backend = EDMSearchBackend(sampler=ablation_sampler(net, opts, steps, labels),
                               scorer=BrightnessScorer())
    z = torch.randn((SAMPLES, 64, 64, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(12))
    reset_launches()
    result, wall = timed_run(lambda: run_search("eps_greedy", backend, z, 0, params))
    launches, routes = read_launches(), read_routes()
    want = sum(n for _, _, n in SITES) * steps * K
    nfe = steps * K * N * SAMPLES
    lines.append(search_line("ablation iDDPM", "eps_greedy", params, steps, SAMPLES, wall, nfe,
                             {"qkv_attention": launches["attention"]}, result.score, tag))
    _, lines[-1]["again_s"] = timed_run(lambda: run_search("eps_greedy", backend, z, 0, params))
    print(f"  the same request again: {lines[-1]['again_s']:.3f} s")
    for kernel, n in launches.items():
        if n != (want if kernel == "attention" else 0):
            raise AssertionError(f"{kernel} launched {n} times by eps-greedy through the iDDPM "
                                 f"sampler, expected {want if kernel == 'attention' else 0}")
    check_routes("ablation iDDPM eps_greedy", routes, {"attention": want})
    if not (torch.isfinite(result.score).all() and result.images.shape == (SAMPLES, 64, 64, 3)
            and 0 <= result.images.min() <= result.images.max() <= 1):
        raise AssertionError("eps-greedy through the iDDPM sampler: not finite images in [0, 1]")
    del net, backend
    torch.cuda.empty_cache()
    return lines


# ------------------------------------------------------- the bench twins


def expected_launches(edm_runs=(), sd_runs=(), edm_forwards: int = 0) -> dict:
    """Each kernel's launches over searches of the port: ``edm_runs`` and
    ``sd_runs`` as (method, params, steps, samples, runs) on the ImageNet-64
    ADM and on SD-1.5, plus ``edm_forwards`` other ADM forwards."""
    per_call = launches_per_call()
    want = dict.fromkeys(per_call, 0)
    sites = sum(n for _, _, n in SITES)
    want["attention"] += sites * edm_forwards
    for method, p, steps, samples, runs in edm_runs:
        calls, _ = method_calls(method, "edm", steps, p, samples)
        want["attention"] += sites * sum(calls.values()) * runs
    for method, p, steps, samples, runs in sd_runs:
        unet, decodes = method_calls(method, "sd", steps, p, samples)
        for k in want:
            want[k] += (SD_PER_UNET[k] * sum(unet.values()) + SD_PER_DECODE[k]
                        * sum(decodes.values())) * per_call[k] * runs
    return want


def check_launches(path: str, got: dict, routes: dict, want: dict) -> None:
    for kernel, n in got.items():
        if n != want[kernel]:
            raise AssertionError(f"{kernel} launched {n} times by {path}, expected {want[kernel]}")
    check_routes(path, routes, {k: n for k, n in want.items() if n and k in FAST_ROUTE})


def bench_phase(tag: str) -> list[dict]:
    """Phase 10: the bench twins through their main(argv), on the card."""
    from diffusion_tts_torch import bench
    from diffusion_tts_torch.entry import BATCH, entry
    from diffusion_tts_torch.tools import reward_bench, sd_reward_bench
    from diffusion_tts_torch.utils.roofline import peak_flops

    lines = []
    # bench at its defaults: the flagship unit (1 warm-up + 4 repetitions of
    # 20 iterations, each a Heun pair at batch 16) and SD at the paper's
    # defaults, 2 calls
    reset_launches()
    t0 = time.perf_counter()
    out = bench.main([])
    wall = time.perf_counter() - t0
    sd_default = SearchParams(N=4, K=20)
    check_launches("bench", read_launches(), read_routes(), expected_launches(
        edm_forwards=5 * 20 * 2, sd_runs=[("eps_greedy", sd_default, 18, 1, 2)]))
    print(f"bench: {out['value']:.2f} NFE/s, vs_baseline {out['vs_baseline']:.5f} of "
          f"{peak_flops('cuda') / 1e12:.0f} TFLOP/s on {out['flops_per_image']} canonical FLOP "
          f"per image; SD "
          f"{out['sd']['value']:.2f} NFE/s (raw UNet forwards), sol {out['sd']['sol']:.5f}, "
          f"decode share {out['sd']['decode_flop_share']:.4f}; {wall:.1f} s with the loads [{tag}]")
    if out["flops_per_image"] != 219_315_105_792:
        raise AssertionError(f"the bench counted {out['flops_per_image']} FLOP per image, the "
                             "CPU test holds 219,315,105,792")
    if not (out["value"] > 0 and out["vs_baseline"] > 0 and out["sd"]["sol"] > 0):
        raise AssertionError(f"the bench line is not positive: {out}")
    lines.append(dict(path="bench", **out))

    # bench --sd at the short SD configuration (6 steps, N=4, K=2, 2 calls)
    reset_launches()
    sd = bench.main(["--sd", "--steps", str(SD_STEPS), "--N", str(SD_N), "--K", str(SD_K),
                     "--repeat", "2"])
    check_launches("bench --sd", read_launches(), read_routes(), expected_launches(
        sd_runs=[("eps_greedy", SearchParams(N=SD_N, K=SD_K), SD_STEPS, 1, 2)]))
    if not (sd["value"] > 0 and sd["sol"] > 0 and 0 < sd["decode_flop_share"] < 1):
        raise AssertionError(f"bench --sd: {sd}")
    lines.append(dict(path="bench --sd", **sd))

    # entry(): one forward at batch 4, zero weights
    reset_launches()
    fn, args = entry()
    y = fn(*args)
    torch.cuda.synchronize()
    check_launches("entry()", read_launches(), read_routes(), expected_launches(edm_forwards=1))
    print(f"entry(): forward {tuple(y.shape)} {y.dtype}, finite {bool(torch.isfinite(y).all())} "
          f"[{tag}]")
    if tuple(y.shape) != (BATCH, 64, 64, 3) or y.dtype != torch.float32 or \
            not torch.isfinite(y).all():
        raise AssertionError(f"entry()'s forward gave {tuple(y.shape)} {y.dtype}")
    del fn, args, y
    torch.cuda.empty_cache()

    # reward_bench on the flagship, all six methods
    rb_params = SearchParams(N=2, K=2, B=2, S=2)
    reset_launches()
    rows = reward_bench.main(["--arch", "imagenet64", "--dtype", "bf16", "--steps", "6",
                              "--N", "2", "--K", "2", "--B", "2", "--S", "2", "--seeds", "0,1"])
    methods = [r["method"] for r in rows]
    check_launches("reward_bench", read_launches(), read_routes(), expected_launches(
        edm_runs=[(m, rb_params, 6, 2, 1) for m in methods]))
    for row in rows:
        if row["nfe_per_sample"] != nfe_per_sample(row["method"], 6, rb_params) or \
                not np.isfinite(row["reward"]):
            raise AssertionError(f"reward_bench row {row}")
    if len(rows) != 6:
        raise AssertionError(f"reward_bench ran {methods}")
    print(json.dumps({"reward_bench": rows}))
    lines.append(dict(path="reward_bench", rows=rows))

    # sd_reward_bench: brightness, three methods of the matched-budget table
    sd_methods = ("naive", "rejection", "eps_greedy")
    reset_launches()
    sdr = sd_reward_bench.main(["--steps", str(SD_STEPS), "--seeds", "0", "--methods",
                                ",".join(sd_methods)])
    check_launches("sd_reward_bench", read_launches(), read_routes(), expected_launches(
        sd_runs=[(m, sd_reward_bench.METHOD_PARAMS[m], SD_STEPS, 1, 1) for m in sd_methods]))
    for row in sdr["rows"]:
        want = nfe_per_sample(row["method"], SD_STEPS, sd_reward_bench.METHOD_PARAMS[row["method"]],
                              backend="sd")
        if row["nfe_per_sample"] != want or not np.isfinite(row["reward"]):
            raise AssertionError(f"sd_reward_bench row {row}")
    print(json.dumps({"sd_reward_bench": sdr}))
    lines.append(dict(path="sd_reward_bench", **sdr))
    return lines + train_bench_runs(tag)


def train_bench_runs(tag: str) -> list[dict]:
    """Phase 10's train_bench runs on both nets: 1 warm-up step and 4 timed
    ones, each of ``rounds`` micro-batches; the attention launches are the
    net's sites per micro-batch forward (and twice that in the backward),
    each on the route the predicates give at the net's head width."""
    from diffusion_tts_torch.tools import train_bench

    lines = []
    for argv, sites_of, d in (
            (["--arch", "cifar10", "--batch", "128", "--steps", "4"], CIFAR_SITES, CIFAR_D),
            (["--arch", "imagenet64", "--batch", "16", "--rounds", "2", "--steps", "4"], SITES,
             64)):
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row = train_bench.main(argv)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 1
        calls = sum(n for _, _, n in sites_of) * rounds * (1 + 4 * row["chain"])
        want = dict.fromkeys(launches_per_call(), 0)
        want.update(attention=calls, attention_bwd=calls * qk.BWD_LAUNCHES_PER_CALL)
        got, routes = read_launches(), read_routes()
        if got != want:
            raise AssertionError(f"train_bench {row['arch']} launched {got}, expected {want}")
        check_routes(f"train_bench {row['arch']}", routes,
                     {"attention": want["attention"], "attention_bwd": want["attention_bwd"]},
                     {"attention": qk.forward_route(torch.bfloat16, d),
                      "attention_bwd": qk.backward_route(torch.bfloat16, d)})
        if not (row["img_per_s"] > 0 and row["sol"] > 0 and np.isfinite(row["loss"])):
            raise AssertionError(f"train_bench row {row}")
        print(f"train_bench {row['arch']}: batch {row['batch']} as {rounds} x "
              f"{row['batch'] // rounds}, {row['step_ms']:.1f} ms a step, "
              f"{row['img_per_s']:.2f} img/s, {row['step_gflops']:.1f} GFLOP a step, "
              f"{row['model_tflops_s']:.2f} TFLOP/s, sol {row['sol']:.5f}, peak memory "
              f"{peak:.2f} GiB [{tag}]")
        lines.append(dict(path="train_bench", peak_gib=peak, launches=got, **row))
        torch.cuda.empty_cache()
    return lines


# ------------------------------------------------------- parallelism (phase 12)

PAR_RANKS, PAR_STEPS = 2, 2  # 12c: two steps of 32 images, as 2 ranks x 16 (one round each)
PAR_MICRO = TRAIN_BATCH // PAR_RANKS
PAR_LR = dict(lr=1e-4, lr_rampup_kimg=2 * TRAIN_BATCH / 1000)  # step 2 moves the net


def par_train_inputs() -> tuple[torch.Tensor, torch.Tensor, list[dict]]:
    """12c's two batches of 32 (images, one-hot labels) and each step's
    injected loss draws, from a seed, on the CPU."""
    g = torch.Generator().manual_seed(12)
    images = torch.rand((PAR_STEPS, TRAIN_BATCH, 64, 64, 3), generator=g) * 2 - 1
    labels = torch.eye(1000)[torch.randint(0, 1000, (PAR_STEPS, TRAIN_BATCH), generator=g)]
    draws = [dict(u=torch.randn((TRAIN_BATCH, 1, 1, 1), generator=g),
                  noise=torch.randn((TRAIN_BATCH, 64, 64, 3), generator=g))
             for _ in range(PAR_STEPS)]
    return images, labels, draws


def par_rounds(t: torch.Tensor, rounds: int) -> torch.Tensor:
    return t.reshape((rounds, t.shape[0] // rounds) + t.shape[1:]).cuda()


def par_step(state: TrainState, cfg: TrainConfig, share, i: int) -> float:
    """train_step on ``share(t)`` of batch ``i`` and its draws (this rank's
    share, or all of it) as cfg's rounds; returns the step's ms."""
    images, labels, draws = par_train_inputs()
    r = cfg.grad_accum_rounds
    mine = {k: par_rounds(share(v), r) for k, v in draws[i].items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_step(state, par_rounds(share(images[i]), r), par_rounds(share(labels[i]), r),
               EDMLoss(), cfg, draws=[{k: v[j] for k, v in mine.items()} for j in range(r)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def flat_grads(net: torch.nn.Module) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1).float() for p in net.parameters()])


def adm_search(net: torch.nn.Module, shards=None):
    """Phase 4's eps-greedy (18 steps, 2 samples, N=4, K=2, brightness,
    seed 0: every rank and the unsharded run draw the same noise on the
    card) through generate_image_grid, optionally candidate-sharded."""
    return generate_image_grid(
        arch="imagenet64", scorer=BrightnessScorer(), method="eps_greedy",
        params=SearchParams(N=N, K=K), seed=0, gridw=SAMPLES, num_steps=STEPS,
        device=next(net.parameters()).device, net=net, record_noises=True,
        candidate_sharding=shards)


GENERATE_ARGS = ["--arch", "imagenet64", "--steps", "18", "--seeds", "0-7"]


def grad_agreement(got: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype) -> dict:
    """fp32: the largest error over the largest magnitude; bf16: the cosine,
    summed in float64 a chunk at a time (fp32 sums over 296M values are off
    by percents)."""
    if dtype == torch.float32:
        return {"fp32_grad_err": ((got - ref).abs().max() / ref.abs().max()).item()}
    dot = aa = bb = 0.0
    for a, b in zip(got.split(1 << 24), ref.split(1 << 24)):
        a, b = a.double(), b.double()
        dot, aa, bb = dot + (a * b).sum().item(), aa + (a * a).sum().item(), bb + (b * b).sum().item()
    return {"bf16_grad_cosine": dot / (aa * bb) ** 0.5}


def rank_worker(workdir: str) -> None:
    """One of phase 12's two gloo ranks on cuda:0 (started by
    parallel_phase through parallel.distributed.launch): 12c's DDP steps,
    12d's candidate-sharded search, 12e's generate share. Raises on any
    disagreement; writes its numbers to workdir/rank{r}.json."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with process_group("gloo", timeout=300, device="cuda"):
        rank_phases(workdir)


def rank_phases(workdir: str) -> None:
    rank, out = dist.get_rank(), {}
    share = lambda t: t[rank * PAR_MICRO:(rank + 1) * PAR_MICRO]
    mesh = make_mesh(device_type="cuda")
    # -- 12c. the ADM's DDP steps: gradients against one process's, ranks alike
    for dtype, steps in ((torch.float32, 1), (torch.bfloat16, PAR_STEPS)):
        ref = None
        if rank == 0:  # the reference: one process, 32 images as 2 rounds of 16
            cfg = TrainConfig(**PAR_LR, grad_accum_rounds=TRAIN_ROUNDS, total_batch=TRAIN_BATCH)
            state = TrainState.create(training_net(dtype, "cuda"), cfg)
            par_step(state, cfg, lambda t: t, 0)
            ref = flat_grads(state.net)
            del state
            torch.cuda.empty_cache()
        cfg = TrainConfig(**PAR_LR, grad_accum_rounds=1, total_batch=TRAIN_BATCH)
        state = shard_train_step(TrainState.create(training_net(dtype, "cuda"), cfg), mesh)
        reset_launches()
        ms, peak = [], 0.0
        for i in range(steps):
            torch.cuda.reset_peak_memory_stats()
            ms.append(par_step(state, cfg, share, i))
            peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
            if i == 0 and ref is not None:
                out.update(grad_agreement(flat_grads(state.net), ref, dtype))
            check_consistency(state.net)
            check_consistency(state.ema)
        del ref
        if dtype == torch.float32:
            del state
            torch.cuda.empty_cache()
            continue
        if rank == 0 and not (out["fp32_grad_err"] <= 1e-3 and out["bf16_grad_cosine"] >= 0.99):
            raise AssertionError(f"the DDP gradients disagree with one process's: {out}")
        launches, routes = read_launches(), read_routes()
        sites = sum(n for _, _, n in SITES)
        want = {"attention": sites * PAR_STEPS,
                "attention_bwd": sites * qk.BWD_LAUNCHES_PER_CALL * PAR_STEPS}
        if {k: v for k, v in launches.items() if v} != want:
            raise AssertionError(f"rank {rank}: DDP training launched {launches}, want {want}")
        check_routes(f"rank {rank} DDP training", routes, want)
        out["train"] = dict(step_ms=ms, peak_gib=peak, launches=want)
        # the sync's cost: the same step with DDP's all-reduce skipped, and one
        # all_reduce of the gradient's 296M fp32 values alone
        ddp = state.parallel.module
        state.parallel.round = lambda last: ddp.no_sync()
        out["train"]["no_sync_step_ms"] = par_step(state, cfg, share, 1)
        grads = flat_grads(state.net)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(grads)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["train"]["allreduce_ms"] = min(times)
        out["train"]["grad_mb"] = grads.numel() * 4 / 1e6
        del state, ddp, grads
        torch.cuda.empty_cache()
    # -- 12d. candidate-sharded eps-greedy: phase 4's selections in fp32, timed in bf16
    shards = CandidateShards()
    want = torch.load(os.path.join(workdir, "search_fp32.pt"))
    got = adm_search(load_network("imagenet64", device="cuda", seed=0), shards)
    same = torch.equal(got.best_noises.cpu(), want["best_noises"])
    score_err = ((got.score.cpu() - want["score"]).abs() / want["score"].abs()).max().item()
    out["search_fp32"] = dict(same_selections=same, score_rel_err=score_err)
    if not (same and score_err <= 1e-4):
        raise AssertionError(f"rank {rank}: the sharded fp32 search left phase 4's selections: "
                             f"{out['search_fp32']}")
    net = load_network("imagenet64", dtype=torch.bfloat16, device="cuda", seed=0)
    adm_search(net, shards)  # warm
    reset_launches()
    result, wall = timed_run(lambda: adm_search(net, shards))
    launches, routes = read_launches(), read_routes()
    want = STEPS * K * 2 * sum(n for _, _, n in SITES)  # 1584, each at batch 4
    if launches["attention"] != want:
        raise AssertionError(f"rank {rank}: the sharded search launched {launches}")
    check_routes(f"rank {rank} candidate-sharded search", routes, {"attention": want})
    nfe = nfe_per_sample("eps_greedy", STEPS, SearchParams(N=N, K=K)) * SAMPLES
    out["search_bf16"] = dict(wall_s=wall, nfe=nfe, nfe_per_s=nfe / wall,
                              peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                              launches=launches["attention"], scores=result.score.tolist())
    del net, result
    torch.cuda.empty_cache()
    # -- 12e. this rank's share of generate at --batch 2
    t0 = time.perf_counter()
    generate.main(GENERATE_ARGS + ["--batch", "2", "--dist-backend", "gloo", "--outdir",
                                   os.path.join(workdir, "two")])
    out["generate_s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def device_ms(fn) -> tuple[float, int]:
    """(the summed duration of the card's kernels, their count) in one call
    of ``fn``, from a torch.profiler trace (tools/torch_forward_profile.py's
    accounting, less the ranges that ``record_function`` annotations, such
    as DistributedDataParallel.forward, leave on the card's timeline)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    return sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3, len(kernels)


def nccl_world_one() -> dict:
    """12c's steps in this process over a real NCCL group of one rank (32
    images as 2 rounds of 16 through the DDP wrapper), in turns with the
    same steps of a state outside any group: one step of each batch each;
    then one more step of each under the profiler, for the device time the
    wrapper adds (the host's spread between steps is wider than its cost)."""
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        cfg = TrainConfig(**PAR_LR, grad_accum_rounds=TRAIN_ROUNDS, total_batch=TRAIN_BATCH)
        states = {"plain": TrainState.create(training_net(torch.bfloat16, "cuda"), cfg),
                  "nccl": shard_train_step(
                      TrainState.create(training_net(torch.bfloat16, "cuda"), cfg),
                      make_mesh(device_type="cuda"))}
        ms = {name: [] for name in states}
        for i in range(PAR_STEPS):
            for name in ("plain", "nccl") if i % 2 == 0 else ("nccl", "plain"):
                ms[name].append(par_step(states[name], cfg, lambda t: t, i))
        dev = {name: device_ms(lambda: par_step(state, cfg, lambda t: t, 0))
               for name, state in states.items()}
        del states
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return dict(backend="nccl", world=1, step_ms=ms["nccl"], plain_step_ms=ms["plain"],
                device_ms=dev["nccl"][0], plain_device_ms=dev["plain"][0],
                kernels=dev["nccl"][1], plain_kernels=dev["plain"][1])


def parallel_phase(tag: str, phase5_step_ms: float) -> dict:
    """Phase 12: the parallel slice on the card (see the module docstring)."""
    def timed_dryrun(n: int) -> tuple[str, float]:
        t0 = time.perf_counter()
        return dryrun_multichip(n), time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        # -- 12a, 12b. dryrun_multichip over NCCL at one rank and two gloo ranks
        # on cuda:0, their processes running beside the untimed references:
        # phase 4's search unsharded in fp32, generate at --batch 8
        runs = {n: pool.submit(timed_dryrun, n) for n in (1, 2)}
        want = adm_search(load_network("imagenet64", device="cuda", seed=0))
        torch.save({"best_noises": want.best_noises.cpu(), "score": want.score.cpu()},
                   os.path.join(tmp, "search_fp32.pt"))
        generate.main(GENERATE_ARGS + ["--batch", "8", "--outdir", os.path.join(tmp, "one")])
        del want
        torch.cuda.empty_cache()
        dryrun = {n: run.result()[0] for n, run in runs.items()}
        dryrun_s = {n: run.result()[1] for n, run in runs.items()}
        if "(cuda, nccl)" not in dryrun[1] or "gloo, 2 ranks sharing 1 card" not in dryrun[2]:
            raise AssertionError(f"dryrun_multichip took another transport: {dryrun}")
        nccl = nccl_world_one()
        t0 = time.perf_counter()
        # four host threads a rank (of the machine's eight) for building and
        # loading the full-width nets
        launch([sys.executable, os.path.abspath(__file__), "--rank-worker", tmp], PAR_RANKS,
               timeout=900, env=dict(os.environ, OMP_NUM_THREADS="4"))
        group_s = time.perf_counter() - t0
        ranks = []
        for r in range(PAR_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        from PIL import Image

        diffs = [np.abs(np.asarray(Image.open(os.path.join(tmp, "one", name)), np.int16)
                        - np.asarray(Image.open(os.path.join(tmp, "two", name)), np.int16))
                 for name in sorted(os.listdir(os.path.join(tmp, "one")))]
    gen = dict(images=len(diffs), max_level_diff=int(max(d.max() for d in diffs)),
               pixels_differing=int(sum((d > 0).sum() for d in diffs)),
               pixels=int(sum(d.size for d in diffs)))
    if gen["images"] != 8 or gen["max_level_diff"] > 1:
        raise AssertionError(f"generate at --batch 2 on two ranks left --batch 8's images: {gen}")
    for n, line in dryrun.items():
        print(f"  {line} ({dryrun_s[n]:.1f} s, beside the references)")
    r0 = ranks[0]
    print(f"12c DDP training, full-width ImageNet-64 ADM, 32 images as {PAR_RANKS} gloo ranks "
          f"x {PAR_MICRO} on cuda:0 vs one process's 2 rounds x {PAR_MICRO}: gradient cosine "
          f"{r0['bf16_grad_cosine']:.6f} (bf16, limit 0.99), err / max {r0['fp32_grad_err']:.3e} "
          f"(fp32, limit 1e-3); both ranks' parameters and EMA bit-identical after each step "
          f"[{tag}]")
    for r, out in enumerate(ranks):
        t = out["train"]
        print(f"  rank {r}: step ms {[round(m, 1) for m in t['step_ms']]}, no-sync step "
              f"{t['no_sync_step_ms']:.1f} ms, one all_reduce of {t['grad_mb']:.0f} MB "
              f"{t['allreduce_ms']:.1f} ms, peak {t['peak_gib']:.2f} GiB, launches {t['launches']}")
    print(f"  NCCL, world size 1, 32 as 2 x 16: step ms {[round(m, 1) for m in nccl['step_ms']]}, "
          f"the same steps outside a group in turns {[round(m, 1) for m in nccl['plain_step_ms']]} "
          f"(phase 5's median {phase5_step_ms:.1f} ms); one step's device time "
          f"{nccl['device_ms']:.2f} ms in {nccl['kernels']} kernels, outside a group "
          f"{nccl['plain_device_ms']:.2f} ms in {nccl['plain_kernels']}")
    for r, out in enumerate(ranks):
        s = out["search_bf16"]
        print(f"12d candidate-sharded eps-greedy rank {r}: fp32 {out['search_fp32']}; bf16 wall "
              f"{s['wall_s']:.3f} s, {s['nfe']} NFE, {s['nfe_per_s']:.2f} NFE/s, peak {s['peak_gib']:.2f} GiB, {s['launches']} "
              f"attention launches at batch {N * SAMPLES // PAR_RANKS}")
    print(f"12e generate --arch imagenet64 --steps 18 --seeds 0-7 fp32: --batch 8 in one process "
          f"vs --batch 2 on {PAR_RANKS} gloo ranks: {gen} [{tag}]")
    return dict(dryrun=list(dryrun.values()), dryrun_s=list(dryrun_s.values()),
                nccl_world1=nccl, ranks=ranks, generate=gen,
                group_s=group_s, phase5_step_ms=phase5_step_ms)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-json", default=None,
                        help="also write every kernel's per-shape rows to this file")
    parser.add_argument("--rank-worker", default=None, metavar="DIR",
                        help="run as one of phase 12's gloo ranks (the script starts them)")
    args = parser.parse_args()
    if args.rank_worker:
        rank_worker(args.rank_worker)
        return
    # -- 1. environment
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card")
    tag = gpu_tag()
    print(tag)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built) or 'nothing (cached)'}")
    for name, (secs, log) in built.items():
        print(f"  {name}: nvcc {secs:.2f} s\n" + "\n".join("    " + ln for ln in log.splitlines()))
    if "conv3x3" in built:  # the ring's kernels, by template <bool UP2, bool GN, bool SC>
        for entry, lines in ptxas_lines(built["conv3x3"][1], "conv3_ring_kernel").items():
            up2, prologue, shortcut = (f == "1" for f in re.search(
                r"ILb([01])ELb([01])ELb([01])E", entry).groups())
            kind = "conv3x3_up2" if up2 else (
                f"conv3x3_same[{'gn' if prologue else 'no gn'}, "
                f"{'shortcut' if shortcut else 'no shortcut'}]")
            print(f"ptxas, {kind} ring kernel: " + "; ".join(lines))
    for name in ("qkv_attention", "attention_bwd"):  # the kernels at the DDPM++ head, d = 256
        if name in built:
            for entry, lines in ptxas_lines(built[name][1], "Li256E").items():
                print(f"ptxas, {name} D = 256, {entry}: " + "; ".join(lines))

    phase_s = {"build": time.perf_counter() - t0}

    def timed(name, phase, *args):
        start = time.perf_counter()
        out = phase(*args)
        phase_s[name] = time.perf_counter() - start
        print(f"[{name}: {phase_s[name]:.1f} s]", flush=True)
        return out

    # -- 3, 4, 4b, 4c. EDM; 4d. CIFAR-10; 5. training; 5b. DDPM++ training;
    #    5c. augmented DDPM++ training; 6, 6b, 6c, 7. SD; 6d. the SD encoder; 8. the CLI
    edm_searches, edm_line = timed("3-4c EDM", edm_phases, tag)
    cifar_searches, edm_line["d256"] = timed("4d CIFAR-10", cifar_phase, tag)
    training_line = timed("5 training", training_phases, tag, edm_line)
    training_line["d256"] = timed("5b DDPM++ training", cifar_training_phase, tag)
    training_line["d256"]["augmented"] = timed("5c augmented DDPM++ training",
                                               augmented_training_phase, tag,
                                               training_line["d256"])
    sd_searches, sd_lines, sd_checked = timed("6-7 SD", sd_phases, tag)
    encoder = timed("6d SD encoder", sd_encoder_phase, tag, sd_checked)
    for line in sd_lines:  # each kernel's launches in one 512x512 encode, as counted there
        line["encode_launches"] = encoder["launches"][line["name"]]
        line["max_abs_err"] = max(line["max_abs_err"],
                                  encoder["max_abs_err"].get(line["name"], 0.0))
    timed("8 CLI", cli_phase, tag)
    # -- 9. the ablation sampler; 10. the bench twins
    edm_searches += timed("9 ablation", ablation_phase, tag)
    bench_lines = timed("10 benches", bench_phase, tag)
    # -- 12. parallelism through torch.distributed
    parallel = timed("12 parallel", parallel_phase, tag,
                     TRAIN_BATCH / training_line["train_img_per_s"] * 1e3)
    print(json.dumps({"phase_s": phase_s}))
    kernels = [edm_line, training_line] + sd_lines
    edm_searches += cifar_searches
    for line in (edm_line, training_line):
        line["max_abs_err"] = max(line["max_abs_err"], line["d256"]["max_abs_err"])

    # -- 11. the kernel line, then the result line
    if args.kernels_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.kernels_json)), exist_ok=True)
        with open(args.kernels_json, "w") as f:
            json.dump({"gpu": tag, "kernels": kernels, "searches": edm_searches + sd_searches,
                       "bench": bench_lines, "encoder": encoder, "parallel": parallel}, f,
                      indent=1)
    without_shapes = lambda d: {k: without_shapes(v) if isinstance(v, dict) else v
                                for k, v in d.items() if k != "shapes"}
    print(json.dumps({"kernels": [without_shapes(kern) for kern in kernels],
                      "parallel": parallel}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
