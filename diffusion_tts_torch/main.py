"""Unified CLI of the port, EDM path (counterpart of the repo's main.py):

    python -m diffusion_tts_torch.main --backend edm --scorer brightness \\
        --method eps_greedy --N 4 --K 20 --dtype bf16

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

# Scorers and backends of the JAX package that later slices of the port bring.
_NOT_YET_PORTED = {
    "compressibility": "ROADMAP.md Queue 1 item 10",
    "imagenet": "ROADMAP.md Queue 1 item 10",
    "clip": "ROADMAP.md Queue 1 item 10",
    "sd": "ROADMAP.md Queue 1 item 11",
}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Unified Diffusion Image Generator (EDM), PyTorch/CUDA",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--backend", choices=["edm", "sd"], required=True)
    parser.add_argument("--scorer", choices=["brightness", "compressibility", "clip", "imagenet"],
                        required=True)
    parser.add_argument("--method", default="naive", help="naive, zero_order, eps_greedy")
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
    parser.add_argument("--num-steps", type=int, default=18)
    parser.add_argument("--record-noises", action="store_true",
                        help="return the selected noise trajectories")
    parser.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32",
                        help="model compute dtype")
    args = parser.parse_args(argv)

    if args.backend == "edm" and args.scorer == "clip":
        raise ValueError("clip scorer is only available for sd backend")
    for name in (args.backend, args.scorer):
        if name in _NOT_YET_PORTED:
            raise NotImplementedError(f"{name!r} is not ported yet ({_NOT_YET_PORTED[name]})")

    from diffusion_tts_torch.backends.edm_entry import generate_image_grid
    from diffusion_tts_torch.scorers import BrightnessScorer
    from diffusion_tts_torch.utils.config import SearchParams

    params = SearchParams(N=args.N, K=args.K, B=args.B, S=args.S,
                          lambda_=args.lambda_, eps=args.eps)
    outname = args.output or f"edm_{args.method}_{args.scorer}.png"
    generate_image_grid(
        arch=args.arch, weights=args.weights, dest_path=outname, scorer=BrightnessScorer(),
        method=args.method, params=params, seed=args.seed, num_steps=args.num_steps,
        S_churn=40, S_min=0.05, S_max=50, S_noise=1.003,
        dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
        record_noises=args.record_noises, device=args.device,
    )
    print(f"\n[EDM] Saved: {outname}\n")


if __name__ == "__main__":
    main()
