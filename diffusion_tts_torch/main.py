"""Unified CLI of the port (counterpart of the repo's main.py):

    python -m diffusion_tts_torch.main --backend edm --scorer brightness \\
        --method eps_greedy --N 4 --K 20 --dtype bf16
    python -m diffusion_tts_torch.main --backend sd --scorer brightness \\
        --method eps_greedy --sd-path <diffusers dir> --dtype bf16

Runs on the card unless ``--device cpu`` is given. SD without ``--sd-path``
runs the tiny random pipeline. Text encoding is not ported yet, so SD's
prompt embeddings are random, from ``--seed``: one [77, D] set per
'||'-separated prompt.
"""
from __future__ import annotations

import argparse

import torch

# Scorers of the JAX package that later slices of the port bring.
_NOT_YET_PORTED = {
    "compressibility": "ROADMAP.md Queue 1 item 10",
    "imagenet": "ROADMAP.md Queue 1 item 10",
    "clip": "ROADMAP.md Queue 1 item 10",
}
# Salt of the random SD prompt embeddings' draw
SALT_PROMPT = 0x5D1
CLIP_TOKENS = 77


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Unified Diffusion Image Generator (EDM/SD), PyTorch/CUDA",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--backend", choices=["edm", "sd"], required=True)
    parser.add_argument("--scorer", choices=["brightness", "compressibility", "clip", "imagenet"],
                        required=True)
    parser.add_argument("--method", default="naive", help="naive, zero_order, eps_greedy")
    parser.add_argument("--prompt", default="YOUR PROMPT HERE",
                        help="SD prompts, '||'-separated; their count sets the batch")
    parser.add_argument("--output", default=None, help="Output filename (default: auto)")
    parser.add_argument("--N", type=int, default=4)
    parser.add_argument("--lambda_", type=float, default=0.15)
    parser.add_argument("--eps", type=float, default=0.4)
    parser.add_argument("--K", type=int, default=20)
    parser.add_argument("--B", type=int, default=2)
    parser.add_argument("--S", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--arch", default="imagenet64", help="EDM arch: imagenet64|tiny_adm")
    parser.add_argument("--weights", default=None,
                        help="EDM reference state dict .npz (tools/export_edm_checkpoint.py)")
    parser.add_argument("--sd-path", default=None, help="local SD-1.5 diffusers directory")
    parser.add_argument("--num-steps", type=int, default=None,
                        help="EDM default 18, SD default 50")
    parser.add_argument("--record-noises", action="store_true",
                        help="return the selected noise trajectories")
    parser.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32",
                        help="model compute dtype")
    args = parser.parse_args(argv)

    if args.backend == "sd" and args.scorer == "imagenet":
        raise ValueError("imagenet scorer is only available for edm backend")
    if args.backend == "edm" and args.scorer == "clip":
        raise ValueError("clip scorer is only available for sd backend")
    if args.scorer in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"{args.scorer!r} is not ported yet ({_NOT_YET_PORTED[args.scorer]})")

    from diffusion_tts_torch.scorers import BrightnessScorer
    from diffusion_tts_torch.utils.config import SearchParams

    params = SearchParams(N=args.N, K=args.K, B=args.B, S=args.S,
                          lambda_=args.lambda_, eps=args.eps)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if args.backend == "sd":
        _run_sd(args, params, BrightnessScorer(), dtype)
        return
    from diffusion_tts_torch.backends.edm_entry import generate_image_grid

    outname = args.output or f"edm_{args.method}_{args.scorer}.png"
    generate_image_grid(
        arch=args.arch, weights=args.weights, dest_path=outname, scorer=BrightnessScorer(),
        method=args.method, params=params, seed=args.seed, num_steps=args.num_steps or 18,
        S_churn=40, S_min=0.05, S_max=50, S_noise=1.003, dtype=dtype,
        record_noises=args.record_noises, device=args.device,
    )
    print(f"\n[EDM] Saved: {outname}\n")


def _run_sd(args, params, scorer, dtype: torch.dtype) -> None:
    import numpy as np
    from PIL import Image

    from diffusion_tts_torch.pipelines import StableDiffusionSearchPipeline
    from diffusion_tts_torch.utils import rng

    if args.sd_path:
        pipe = StableDiffusionSearchPipeline.from_pretrained(args.sd_path, dtype=dtype,
                                                             device=args.device)
    else:
        print("WARNING: no --sd-path; using a tiny random SD pipeline")
        pipe = StableDiffusionSearchPipeline.tiny_random(seed=args.seed, dtype=dtype,
                                                         device=args.device)
    prompts = [p.strip() for p in args.prompt.split("||")]
    emb = rng.normal(args.seed, (SALT_PROMPT,),
                     (len(prompts), CLIP_TOKENS, pipe.unet.cross_attention_dim), pipe.device)
    images, scores = pipe(prompt_embeds=emb, num_inference_steps=args.num_steps or 50,
                          score_function=scorer, method=args.method, params=params,
                          seed=args.seed, record_noises=args.record_noises)
    outname = args.output or f"sd_{args.method}_{args.scorer}.png"
    base, ext = (outname.rsplit(".", 1) + ["png"])[:2]
    for i, img in enumerate((images.float().cpu().numpy() * 255.0).astype(np.uint8)):
        Image.fromarray(img).save(outname if i == 0 else f"{base}_p{i}.{ext}")
    best = ", ".join(f"{float(s):.5f}" for s in scores)
    print(f"\n[SD] Saved: {outname} ({len(prompts)} prompt(s))\nBest score(s): {best}\n")


if __name__ == "__main__":
    main()
