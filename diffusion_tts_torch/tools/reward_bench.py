"""Reward at a given NFE: every search method on one EDM configuration
(counterpart of the repo's tools/reward_bench.py).

Runs each method through ``run_search`` on the same seeds, counts denoiser
forwards per sample with search/nfe.py, and reports per method the mean
reward, its spread over the seeds, the NFE, the wall time of the last
repetition and the reward's gain over naive sampling.

    python -m diffusion_tts_torch.tools.reward_bench [--arch tiny|tiny_adm|cifar10|imagenet64]
        [--weights ckpt.npz] [--scorer brightness|compressibility|compressibility_dct]
        [--dtype fp32|bf16] [--steps 18] [--N 4] [--K 5] [--B 2] [--S 4]
        [--seeds 0,1] [--methods naive,...] [--repeat 1] [--profile DIR] [--json out.json]
        [--device cuda]

On the card unless ``--device cpu`` is given. The JAX tool's ``--dispatch``
and ``--chunk_steps`` are left out: they work around the TPU's program
size, and PyTorch runs each step eagerly. Each seed's latents are drawn
with its own torch generator.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

METHODS = "naive,rejection,beam,zero_order,eps_greedy,mcts"


def seeded_backend(net, arch: str, seeds: list[int], steps: int, scorer,
                   dev: torch.device):
    """The reward tools' EDM search: ``net`` with one class label per seed
    (seed mod label_dim, tiled to the candidate rows), the Heun sampler
    with churn 40, and each seed's latents from its own generator.
    Returns (backend, latents [len(seeds), res, res, ch])."""
    from diffusion_tts_torch.backends.edm_entry import NET_CONFIGS
    from diffusion_tts_torch.parallel.mesh import candidate_rows
    from diffusion_tts_torch.samplers.edm import EDMHeunSampler
    from diffusion_tts_torch.search.backend import EDMSearchBackend
    from diffusion_tts_torch.utils import rng

    cfg = NET_CONFIGS[arch]
    res, ch, label_dim = cfg["img_resolution"], cfg["img_channels"], cfg["label_dim"]
    labels = (torch.eye(label_dim, device=dev)[torch.tensor(seeds, device=dev) % label_dim]
              if label_dim else None)

    def denoise(x, sigma):
        return net(x, sigma, None if labels is None else candidate_rows(labels, x.shape[0]))

    backend = EDMSearchBackend(
        sampler=EDMHeunSampler(denoise=denoise, num_steps=steps, S_churn=40.0, S_min=0.05,
                               S_max=50.0, S_noise=1.003),
        scorer=scorer)
    return backend, torch.stack([rng.normal(s, (), (res, res, ch), dev) for s in seeds])


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--scorer", default="brightness",
                    choices=["brightness", "compressibility", "compressibility_dct"])
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                    help="model compute dtype; bf16 is the bench's flagship unit's")
    ap.add_argument("--steps", type=int, default=18)
    ap.add_argument("--N", type=int, default=4)
    ap.add_argument("--K", type=int, default=5)
    ap.add_argument("--B", type=int, default=2)
    ap.add_argument("--S", type=int, default=4)
    ap.add_argument("--eps", type=float, default=0.4)
    ap.add_argument("--lambda_", type=float, default=0.15)
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--methods", default=METHODS)
    ap.add_argument("--mcts_rollout_batch", type=int, default=None,
                    help="rollouts sharing pre-phase UCB stats (None = S, the reference's "
                         "batched form; 1 = textbook sequential)")
    ap.add_argument("--mcts_fresh_expansion", action="store_true",
                    help="draw new expansion noise per (timestep, phase, iteration) instead "
                         "of the reference's per-depth table")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run each method this many times; the wall time is the last run's")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of each method's last run into DIR")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    from diffusion_tts_torch.backends.edm_entry import load_network
    from diffusion_tts_torch.scorers import BrightnessScorer, CompressibilityScorer
    from diffusion_tts_torch.search.api import run_search
    from diffusion_tts_torch.search.nfe import nfe_per_sample
    from diffusion_tts_torch.utils.config import SearchParams
    from diffusion_tts_torch.utils.device import profiled, resolve_device

    dev = resolve_device(args.device)
    net = load_network(args.arch, args.weights, device=dev,
                       dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.scorer == "brightness":
        scorer = BrightnessScorer()
    else:  # jpeg: exact sizes on the host in every call; dct: the on-device proxy
        scorer = CompressibilityScorer(mode="jpeg" if args.scorer == "compressibility"
                                       else "dct")
    params = SearchParams(N=args.N, K=args.K, B=args.B, S=args.S, eps=args.eps,
                          lambda_=args.lambda_)
    backend, z = seeded_backend(net, args.arch, seeds, args.steps, scorer, dev)

    rows, base_reward = [], None
    for method in args.methods.split(","):
        walls = []
        reps = max(args.repeat, 1)
        for rep in range(reps):
            with profiled(args.profile if rep == reps - 1 else None, method, dev):
                t0 = time.perf_counter()
                r = run_search(method, backend, z, 1234, params,
                               mcts_rollout_batch=args.mcts_rollout_batch,
                               mcts_fresh_expansion=args.mcts_fresh_expansion)
                per_seed = r.score.double().cpu().numpy()  # waits for the device
                walls.append(time.perf_counter() - t0)
        if reps > 1:
            print(f"  walls: {', '.join(f'{w:.3f}' for w in walls)} s")
        reward = float(per_seed.mean())
        nfe = nfe_per_sample(method, args.steps, params, backend="edm")
        if method == "naive":
            base_reward = reward
        rows.append(dict(
            method=method, reward=reward, reward_std=float(per_seed.std()),
            per_seed=[float(v) for v in per_seed], nfe_per_sample=nfe, wallclock_s=walls[-1],
            reward_gain_vs_naive=((reward - base_reward) / max(abs(base_reward), 1e-9)
                                  if base_reward is not None else None)))
        print(f"{method:11s} reward {reward:.5f}  NFE {nfe:6d}  wall {walls[-1]:7.3f} s")
    if args.json:
        meta = dict(config=vars(args),
                    weights=args.weights or "random, from numpy seed 0 (no checkpoint)",
                    final_score_exact=args.scorer != "compressibility_dct",
                    device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
        with open(args.json, "w") as f:
            json.dump(dict(**meta, rows=rows), f, indent=2)
        print(f"wrote {args.json}")
    return rows


if __name__ == "__main__":
    main()
