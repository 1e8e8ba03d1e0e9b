"""The flagship's forward as an entry point (counterpart of the repo's
__graft_entry__.py::entry and ::_flagship).

    from diffusion_tts_torch.entry import entry
    fn, args = entry()      # on the card; entry(device="cpu") on the CPU
    out = fn(*args)         # [4, 64, 64, 3] fp32 (EDMPrecond mixes in fp32)

``entry()`` returns one forward of the flagship (the full-width ImageNet-64
ADM under EDMPrecond, bf16, the reference's headline class-conditional
config, main.py:197-213) at batch 4 with zero weights, and its example
arguments.

``dryrun_multichip(n)`` is __graft_entry__.py::dryrun_multichip's four legs
on the tiny flagship over n ranks of torch.distributed: one training step,
data-parallel (DistributedDataParallel) or, when n >= 4 and even, data x
model (FSDP2 over a 2 x n/2 mesh), then candidate-sharded eps-greedy, beam
and tiny-geometry SD searches. Outside a process group it starts its n
ranks itself (as the JAX one re-executes itself): NCCL with one card each
when the machine has n cards, gloo with the ranks sharing the cards when it
has fewer, gloo on the CPU when ``device="cpu"``.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from diffusion_tts_torch.backends.edm_entry import IMAGENET64_ADM, TINY_ADM
from diffusion_tts_torch.models.preconds import EDMPrecond
from diffusion_tts_torch.utils.device import resolve_device

BATCH = 4


def _flagship(tiny: bool = False) -> tuple[dict, int, int]:
    """(the EDMPrecond config, resolution, label count) of the flagship, or
    of its architecture at test width."""
    cfg = TINY_ADM if tiny else IMAGENET64_ADM
    return cfg, cfg["img_resolution"], cfg["label_dim"]


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): ``fn(net, x, sigma, labels)`` is one denoiser
    forward; the net holds zeros in every parameter (made on the meta
    device, then zeroed on ``device``: no init is drawn; the ADM has no
    buffers)."""
    dev = resolve_device(device)
    cfg, res, label_dim = _flagship()
    with torch.device("meta"):
        net = EDMPrecond(dtype=torch.bfloat16, **cfg)
    net = net.to_empty(device=dev).eval()
    for p in net.parameters():
        p.detach().zero_()
    x = torch.zeros((BATCH, res, res, cfg["img_channels"]), device=dev)
    sigma = torch.full((BATCH,), 10.0, device=dev)
    labels = torch.eye(label_dim, device=dev)[torch.arange(BATCH, device=dev) % label_dim]

    @torch.no_grad()
    def fn(net, x, sigma, labels):
        return net(x, sigma, labels)

    return fn, (net, x, sigma, labels)


def dryrun_multichip(n: int, device: torch.device | str = "cuda", *,
                     timeout: float = 600.0) -> str:
    """One training step and three candidate-sharded searches on n ranks
    (see the module docstring); prints and returns rank 0's line. Inside a
    group of n ranks every rank must call it; outside one it starts them
    and raises if one fails or ``timeout`` seconds pass."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"dryrun_multichip({n}) inside a group of {dist.get_world_size()}")
        return _dryrun_legs(n, device, dist.get_backend())
    from diffusion_tts_torch.parallel.distributed import launch

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = "nccl" if dev.type == "cuda" and n <= cards else "gloo"
    code = ("from diffusion_tts_torch.entry import _dryrun_rank; "
            f"_dryrun_rank({n}, {dev.type!r}, {backend!r}, timeout={timeout})")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the package's parent
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    outs = launch([sys.executable, "-c", code], n, timeout=timeout,
                  env=dict(os.environ, PYTHONPATH=path))
    line = next(ln for ln in outs[0].splitlines() if ln.startswith("dryrun_multichip("))
    print(line, flush=True)
    return line


def _dryrun_rank(n: int, device: str, backend: str, timeout: float | None = None) -> str:
    """One rank's share of ``dryrun_multichip(n)``."""
    from diffusion_tts_torch.parallel.distributed import process_group

    with process_group(backend, timeout, device=device):
        return _dryrun_legs(n, device, backend)


def _dryrun_legs(n: int, device: str, backend: str) -> str:
    from diffusion_tts_torch.models.torch_import import load_into, random_state_dict
    from diffusion_tts_torch.parallel.distributed import rank_device
    from diffusion_tts_torch.parallel.mesh import (
        CandidateShards, candidate_rows, make_mesh, shard_array, shard_train_step,
    )
    from diffusion_tts_torch.parallel.sharding_rules import is_sharded, shard_state
    from diffusion_tts_torch.pipelines.sd_pipeline import StableDiffusionSearchPipeline
    from diffusion_tts_torch.samplers.edm import EDMHeunSampler
    from diffusion_tts_torch.scorers import BrightnessScorer
    from diffusion_tts_torch.search import EDMSearchBackend, run_search
    from diffusion_tts_torch.training.loss import EDMLoss
    from diffusion_tts_torch.training.train_step import TrainConfig, TrainState, train_step
    from diffusion_tts_torch.utils import rng as rng_paths
    from diffusion_tts_torch.utils.config import SearchParams

    dev = rank_device(resolve_device(device))
    r = dist.get_rank()
    # DP x TP when the rank count allows: the batch over every rank, the
    # parameters' output features over "model" (sharding_rules.param_spec)
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // tp
    mesh = make_mesh({"data": dp, "model": tp} if tp > 1 else {"data": dp},
                     device_type=dev.type)

    cfg, res, label_dim = _flagship(tiny=True)
    net = EDMPrecond(dtype=torch.bfloat16, param_dtype=torch.float32, **cfg)
    net = load_into(net, random_state_dict(net, 0)).to(dev)
    rounds, micro = 2, 2 * dp
    train_cfg = TrainConfig(lr=1e-3, grad_accum_rounds=rounds, total_batch=rounds * micro)
    state = TrainState.create(net, train_cfg)
    state = (shard_state(state, mesh, axis="model", min_size=2) if tp > 1
             else shard_train_step(state, mesh))
    g = np.random.default_rng(0)
    images = torch.from_numpy(g.normal(size=(rounds, micro, res, res, 3)).astype(np.float32))
    labels = torch.from_numpy(
        np.eye(label_dim, dtype=np.float32)[g.integers(0, label_dim, (rounds, micro))])
    metrics = train_step(state, shard_array(images, mesh, 1).to(dev),
                         shard_array(labels, mesh, 1).to(dev), EDMLoss(), train_cfg,
                         rng_paths.generator(1, r, device=dev))
    loss = metrics["loss"].reshape(1).float()
    dist.all_reduce(loss)  # the mean over the ranks' shares: the global batch's loss
    n_sharded = sum(is_sharded(p) for p in state.net.parameters())
    net = state.net.eval()

    # the inference legs: the flattened candidate batch over every rank
    shards = CandidateShards()
    b_search = 2
    sp = SearchParams(N=max(n // b_search, 1), K=2)
    z = torch.from_numpy(g.normal(size=(b_search, res, res, 3)).astype(np.float32)).to(dev)
    slabels = torch.eye(label_dim, device=dev)[torch.arange(b_search, device=dev) % label_dim]
    sampler = EDMHeunSampler(denoise=lambda x, s: net(x, s, candidate_rows(slabels, x.shape[0])),
                             num_steps=3, S_churn=40.0, S_min=0.05, S_max=50.0)
    search = EDMSearchBackend(sampler=sampler, scorer=BrightnessScorer(),
                              candidate_sharding=shards)
    with torch.no_grad():
        result = run_search("eps_greedy", search, z, 7, sp)
        sp_beam = SearchParams(N=2, K=2, B=max(n // 4, 1))
        r_beam = run_search("beam", search, z, 8, sp_beam)
        pipe = StableDiffusionSearchPipeline.tiny_random(seed=0, device=dev)
        emb = torch.from_numpy(g.normal(size=(1, 7, 32)).astype(np.float32))
        _, sd_scores = pipe(prompt_embeds=emb, num_inference_steps=3, method="eps_greedy",
                            score_function=BrightnessScorer(), params=SearchParams(N=n, K=2),
                            seed=13, candidate_sharding=shards)
    where = (f"{dev.type}, {backend}" if backend == "nccl" or dev.type == "cpu" else
             f"cuda, gloo, {n} ranks sharing {torch.cuda.device_count()} card(s)")
    line = (f"dryrun_multichip({n}) ok: mesh=data:{dp}xmodel:{tp} ({where}) "
            f"loss={float(loss) / n:.4f} nimg={state.nimg} "
            f"model-sharded params={n_sharded} "
            f"search(eps_greedy N={sp.N} K={sp.K} candidate-sharded) "
            f"score={float(result.score[0]):.4f} "
            f"search(beam N={sp_beam.N} B={sp_beam.B} K={sp_beam.K} candidate-sharded) "
            f"score={float(r_beam.score[0]):.4f} "
            f"sd-search(eps_greedy N={n} K=2 tiny-geometry candidate-sharded) "
            f"score={float(sd_scores[0]):.4f}")
    if r == 0:
        print(line, flush=True)
    return line


__all__ = ["entry", "dryrun_multichip", "BATCH"]
