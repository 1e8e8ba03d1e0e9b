"""SD reward at matched NFE: the search methods of the reference's
text-to-image experiment at one denoiser budget (counterpart of the repo's
tools/sd_reward_bench.py), at the full SD-1.5 geometry with random weights
from a numpy seed, bf16.

Every method at a matched budget of CFG-combined denoiser calls per sample
(search/nfe.py, backend "sd"; tools/sd_e2e_bench.py counts raw UNet
forwards, twice these at the same configuration):

    naive                         18 NFE   (the no-search row)
    rejection  N=21              378 NFE
    zero_order K=5  N=4          378 NFE
    eps_greedy K=5  N=4          378 NFE
    beam       B=2  N=9          360 NFE   (the closest lattice point)
    mcts       N=4  S=2          864 NFE   (not in the default set: the
                                            closest point above the budget)

``--curve`` sweeps eps-greedy's K over ``--curve-K`` for the reward-vs-NFE
curve. Scorers: brightness, dct (the on-device JPEG-compressibility
proxy), clip (CLIP ViT-L/14 with random weights and the text features of
random token ids).

    python -m diffusion_tts_torch.tools.sd_reward_bench --scorer brightness --seeds 0,1,2,3
    python -m diffusion_tts_torch.tools.sd_reward_bench --curve --json curve.json

On the card unless ``--device cpu`` is given; on the CPU (or with
``--tiny``) the tiny random pipeline and CLIP run. The JAX tool's
``--dispatch`` is left out (a TPU program-size workaround).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from diffusion_tts_torch.utils.config import SearchParams

# The matched-budget method table at 18 steps (the JAX tool's METHOD_PARAMS)
METHOD_PARAMS = {
    "naive": SearchParams(),
    "rejection": SearchParams(N=21),
    "zero_order": SearchParams(N=4, K=5, lambda_=0.15),
    "eps_greedy": SearchParams(N=4, K=5, eps=0.4, lambda_=0.15),
    "beam": SearchParams(B=2, N=9),
    "mcts": SearchParams(N=4, S=2),
}


def build_pipeline(tiny: bool, device: torch.device):
    from diffusion_tts_torch.pipelines.sd_pipeline import (
        SD15_UNET,
        SD15_VAE,
        StableDiffusionSearchPipeline,
    )

    if tiny:
        return StableDiffusionSearchPipeline.tiny_random(seed=0, device=device)
    return StableDiffusionSearchPipeline.random(SD15_UNET, SD15_VAE, seed=0,
                                                dtype=torch.bfloat16, device=device)


def build_scorer(name: str, tiny: bool, device: torch.device):
    """(scorer, scorer_cond)."""
    from diffusion_tts_torch.models.clip import CLIP_VIT_L14, CLIPModel
    from diffusion_tts_torch.models.torch_import import load_into, random_state_dict
    from diffusion_tts_torch.scorers import BrightnessScorer, CLIPScorer, CompressibilityScorer

    if name == "brightness":
        return BrightnessScorer(), None
    if name == "dct":
        return CompressibilityScorer(mode="dct"), None
    if name == "clip":
        if tiny:
            scorer = CLIPScorer.random_init(seed=7, device=device)
        else:
            model = CLIPModel(CLIP_VIT_L14)
            scorer = CLIPScorer(load_into(model, random_state_dict(model, 7)), device=device)
        ids = np.random.default_rng(7).integers(0, scorer.model.config.text.vocab_size, (1, 16))
        return scorer, scorer.text_features(ids)
    raise ValueError(f"unknown scorer {name!r}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scorer", default="brightness", choices=["brightness", "dct", "clip"])
    ap.add_argument("--steps", type=int, default=18)  # sd/main.py:49
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--methods", default="naive,rejection,zero_order,eps_greedy,beam")
    ap.add_argument("--curve", action="store_true",
                    help="the eps_greedy reward-vs-NFE sweep instead of the method table")
    ap.add_argument("--curve-K", default="1,2,5,10,20")
    ap.add_argument("--tiny", action="store_true", help="the tiny random pipeline")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    from diffusion_tts_torch.search.nfe import nfe_per_sample
    from diffusion_tts_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    tiny = args.tiny or dev.type == "cpu"
    pipe = build_pipeline(tiny, dev)
    ctx_dim = pipe.unet.cross_attention_dim
    scorer, scorer_cond = build_scorer(args.scorer, tiny, dev)
    seeds = [int(s) for s in args.seeds.split(",")]
    t_all = time.perf_counter()

    def hb(msg):
        print(f"[sd_reward_bench +{time.perf_counter() - t_all:.0f}s] {msg}", file=sys.stderr,
              flush=True)

    def run(method, sp, seed):
        emb = np.random.default_rng(10_000 + seed).standard_normal((1, 77, ctx_dim))
        emb = torch.from_numpy(emb.astype(np.float32)).to(dev)
        t0 = time.perf_counter()
        _, scores = pipe(prompt_embeds=emb, num_inference_steps=args.steps, method=method,
                         score_function=scorer, scorer_cond=scorer_cond, params=sp,
                         seed=1234 + seed)
        score = float(scores[0])  # waits for the device
        return score, time.perf_counter() - t0

    if args.curve:
        jobs = [("eps_greedy", SearchParams(N=4, K=int(k), eps=0.4, lambda_=0.15),
                 f"eps_greedy_K{k}") for k in args.curve_K.split(",")]
    else:
        jobs = [(m, METHOD_PARAMS[m], m) for m in args.methods.split(",")]

    rows, base_reward = [], None
    for method, sp, label in jobs:
        per_seed, walls = [], []
        for i, seed in enumerate(seeds):
            s, w = run(method, sp, seed)
            per_seed.append(s)
            walls.append(w)
            hb(f"{label} seed {seed}: reward {s:.5f} wall {w:.3f} s"
               + (" (the first call)" if i == 0 else ""))
        reward = float(np.mean(per_seed))
        if label == "naive":
            base_reward = reward
        nfe = nfe_per_sample(method, args.steps, sp, backend="sd")
        rows.append(dict(
            method=label, reward=reward, reward_std=float(np.std(per_seed)), per_seed=per_seed,
            nfe_per_sample=nfe, params={"N": sp.N, "K": sp.K, "B": sp.B, "eps": sp.eps},
            wall_first_s=walls[0], wall_steady_s=min(walls[1:]) if len(walls) > 1 else walls[0],
            reward_gain_vs_naive=((reward - base_reward) / max(abs(base_reward), 1e-9)
                                  if base_reward is not None else None)))
        print(f"{label:16s} reward {reward:.5f}  NFE {nfe:5d}  "
              f"steady {rows[-1]['wall_steady_s']:7.3f} s")

    out = dict(
        config=dict(scorer=args.scorer, steps=args.steps, seeds=seeds, curve=args.curve),
        weights="random, from numpy seeds (no checkpoint); the full SD-1.5 geometry "
                "(and CLIP ViT-L/14 for --scorer clip) unless tiny",
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", rows=rows)
    print(json.dumps({"rows": len(rows), "scorer": args.scorer}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
