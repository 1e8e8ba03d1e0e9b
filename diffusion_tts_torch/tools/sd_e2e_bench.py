"""SD end-to-end search wall time: the whole pipeline at the full SD-1.5
geometry (counterpart of the repo's tools/sd_e2e_bench.py).

Runs ``StableDiffusionSearchPipeline.__call__``: prompt embeddings ->
DDIM schedule -> the search -> VAE decode -> scorer, at the 860M UNet and
the VAE decoder with random weights from a numpy seed, bf16, and reports
the wall time of each of ``--repeat`` calls and the steady one (the least
after the first).

NFE convention: raw UNet forwards, steps x (1 + K*N*2) x batch for
eps-greedy and zero-order, a CFG pair counting 2: twice search/nfe.py's
count (one CFG-combined call per candidate), as the JAX tool counts. The
output names it. ``sol`` is the canonical matmul FLOPs of the search
(utils/roofline.py) over the steady wall time and the card's dense bf16
peak, with the decode's share of those FLOPs.

    python -m diffusion_tts_torch.tools.sd_e2e_bench [--steps 18] [--K 5] [--N 4]
        [--method eps_greedy] [--repeat 3] [--batch 1] [--profile DIR] [--device cuda]

On the card unless ``--device cpu`` is given; on the CPU (or with
``--tiny``) the tiny random pipeline runs and no ``sol`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

NFE_CONVENTION = ("raw UNet forwards: steps x (1 + K*N*2) x batch, a CFG pair counting 2 "
                  "(twice search/nfe.py's count)")


def search_flops(unet_config: dict, vae_config: dict, *, steps: int, K: int, N: int,
                 b: int) -> dict:
    """Canonical matmul FLOPs of one eps-greedy / zero-order SD search: per
    step one base CFG UNet forward at batch 2b, then K iterations of a CFG
    lookahead at 2Nb and a scoring decode at Nb; then the final decode at b
    (the JAX tool's ``_search_flops``). Every product scales with the batch,
    so each net is counted once, at batch 1."""
    from diffusion_tts_torch.utils.roofline import sd_unet_flops, sd_vae_decode_flops

    unet = sd_unet_flops(unet_config, 1)["total_flops"]
    decode = sd_vae_decode_flops(vae_config, 1)["total_flops"]
    unet_total = unet * (2 * b * steps + 2 * N * b * steps * K)
    decode_total = decode * (N * b * steps * K + b)
    return {"total_flops": unet_total + decode_total,
            "decode_flop_share": decode_total / (unet_total + decode_total)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=18)
    ap.add_argument("--K", type=int, default=5)
    ap.add_argument("--N", type=int, default=4)
    ap.add_argument("--eps", type=float, default=0.4)
    ap.add_argument("--method", default="eps_greedy")
    ap.add_argument("--batch", type=int, default=1, help="prompt batch")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--tiny", action="store_true", help="the tiny random pipeline")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--json", default=None)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the last repeat into DIR")
    args = ap.parse_args(argv)

    from diffusion_tts_torch.pipelines.sd_pipeline import (
        SD15_UNET,
        SD15_VAE,
        StableDiffusionSearchPipeline,
    )
    from diffusion_tts_torch.scorers import BrightnessScorer
    from diffusion_tts_torch.utils.config import SearchParams
    from diffusion_tts_torch.utils.device import profiled, resolve_device
    from diffusion_tts_torch.utils.roofline import peak_flops

    dev = resolve_device(args.device)
    tiny = args.tiny or dev.type == "cpu"
    t_start = time.perf_counter()

    def hb(msg):
        print(f"[sd_e2e_bench +{time.perf_counter() - t_start:.0f}s] {msg}", file=sys.stderr,
              flush=True)

    if tiny:
        pipe = StableDiffusionSearchPipeline.tiny_random(seed=0, device=dev)
    else:
        pipe = StableDiffusionSearchPipeline.random(SD15_UNET, SD15_VAE, seed=0,
                                                    dtype=torch.bfloat16, device=dev)
    ctx_dim = pipe.unet.cross_attention_dim
    emb = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch, 77, ctx_dim)).astype(np.float32)).to(dev)
    sp = SearchParams(N=args.N, K=args.K, eps=args.eps)
    scorer = BrightnessScorer()
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    hb(f"start: {args.method} steps={args.steps} K={args.K} N={args.N} on {device_name}")

    walls, score = [], None
    reps = max(args.repeat, 1)
    for rep in range(reps):
        with profiled(args.profile if rep == reps - 1 else None, "sd_e2e_bench", dev):
            t0 = time.perf_counter()
            _, scores = pipe(prompt_embeds=emb, num_inference_steps=args.steps,
                             method=args.method, score_function=scorer, params=sp, seed=42)
            score = float(scores[0])  # waits for the device
            walls.append(time.perf_counter() - t0)
        hb(f"rep {rep + 1}/{reps} wall {walls[-1]:.3f} s")

    steady = min(walls[1:]) if len(walls) > 1 else walls[0]
    nfe = args.steps * (1 + args.K * args.N * 2) * args.batch
    out = {
        "metric": ("sd15_e2e_search_NFE_per_s_per_chip" if not tiny else
                   "sd_tiny_e2e_search_NFE_per_s" + (" (cpu smoke)" if dev.type == "cpu" else "")),
        "unit": "NFE/s", "method": args.method, "steps": args.steps, "K": args.K, "N": args.N,
        "batch": args.batch, "nfe": nfe, "nfe_convention": NFE_CONVENTION,
        "walls_s": walls, "steady_wall_s": steady, "value": nfe / steady, "score": score,
        "device": device_name, "weights": "random, from numpy seed 0 (no checkpoint)",
    }
    if not tiny and args.method in ("eps_greedy", "zero_order"):
        fl = search_flops(SD15_UNET, SD15_VAE, steps=args.steps, K=args.K, N=args.N,
                          b=args.batch)
        out["sol"] = fl["total_flops"] / steady / peak_flops(dev)
        out["vs_baseline"] = out["sol"]
        out["decode_flop_share"] = fl["decode_flop_share"]
        out["total_matmul_flops"] = fl["total_flops"]
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
