"""Unified CLI of the port (counterpart of the repo's main.py):

    python -m diffusion_tts_torch.main --backend edm --scorer brightness \\
        --method eps_greedy --N 4 --K 20 --dtype bf16
    python -m diffusion_tts_torch.main --backend edm --scorer imagenet \\
        --method eps_greedy --classifier-weights 64x64_classifier.pt --dtype bf16
    python -m diffusion_tts_torch.main --backend edm --arch cifar10 --scorer brightness \\
        --method eps_greedy --dtype bf16
    python -m diffusion_tts_torch.main --backend sd --scorer clip \\
        --method eps_greedy --sd-path <diffusers dir> --clip-path <CLIP dir> --dtype bf16

Runs on the card unless ``--device cpu`` is given. SD without ``--sd-path``
runs the tiny random pipeline. Where the pipeline has a tokenizer and text
encoder (``--sd-path`` with ``tokenizer/`` and ``text_encoder/``), the
prompts are encoded and, for ``--scorer clip``, the CLIP text features of
the tokenized prompts condition the reward. Without them SD's prompt
embeddings are random, from ``--seed`` (one [77, D] set per prompt), and
CLIP has no text to score against: it scores 0, as in the JAX package.
"""
from __future__ import annotations

import argparse

import torch

# Salt of the random SD prompt embeddings' draw
SALT_PROMPT = 0x5D1
CLIP_TOKENS = 77


def get_scorer(backend: str, name: str, args):
    """(scorer, needs_cond): the reward named by ``--scorer`` on
    ``args.device``, and whether it reads the class labels (EDM)."""
    from diffusion_tts_torch import scorers

    if name == "brightness":
        return scorers.BrightnessScorer(), False
    if name == "compressibility":
        # EDM 64x64 -> max_size 3000 (edm/scorers.py:177); SD 512 -> 150000
        # (sd/scorers.py:79)
        max_size = 3000.0 if backend == "edm" else 150000.0
        return scorers.CompressibilityScorer(quality=80, max_size=max_size,
                                             mode=args.compressibility_mode), False
    if name == "imagenet":
        from diffusion_tts_torch.backends.edm_entry import CLASSIFIER_CONFIGS

        if args.arch not in CLASSIFIER_CONFIGS:
            raise ValueError(f"the imagenet scorer has no classifier for --arch {args.arch}; "
                             f"it serves {', '.join(CLASSIFIER_CONFIGS)}")
        kw = dict(device=args.device, **CLASSIFIER_CONFIGS[args.arch])
        if args.classifier_weights:
            return scorers.ImageNetScorer.from_torch_checkpoint(args.classifier_weights,
                                                                **kw), True
        print("WARNING: no --classifier-weights; the ImageNet scorer uses random weights")
        return scorers.ImageNetScorer(**kw), True
    if name == "clip":
        if args.clip_path:
            return scorers.CLIPScorer.from_pretrained(args.clip_path, device=args.device), True
        print("WARNING: no --clip-path; the CLIP scorer uses a tiny random model")
        return scorers.CLIPScorer.random_init(device=args.device), True
    raise ValueError(f"unknown scorer {name}")


def main(argv=None):
    from diffusion_tts_torch.backends.edm_entry import NET_CONFIGS

    parser = argparse.ArgumentParser(
        description="Unified Diffusion Image Generator (EDM/SD), PyTorch/CUDA",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--backend", choices=["edm", "sd"], required=True)
    parser.add_argument("--scorer", choices=["brightness", "compressibility", "clip", "imagenet"],
                        required=True)
    parser.add_argument("--method", default="naive",
                        help="naive, rejection, beam, mcts, zero_order, eps_greedy")
    parser.add_argument("--prompt", default="YOUR PROMPT HERE",
                        help="SD prompts, '||'-separated; their count sets the batch")
    parser.add_argument("--prompt-repeat", type=int, default=1,
                        help="replicate the SD prompt batch this many times")
    parser.add_argument("--output", default=None, help="Output filename (default: auto)")
    parser.add_argument("--N", type=int, default=4)
    parser.add_argument("--lambda_", type=float, default=0.15)
    parser.add_argument("--eps", type=float, default=0.4)
    parser.add_argument("--K", type=int, default=20)
    parser.add_argument("--B", type=int, default=2)
    parser.add_argument("--S", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--arch", default="imagenet64", choices=sorted(NET_CONFIGS),
                        help="EDM arch: the ImageNet-64 ADM, the CIFAR-10 DDPM++ SongUNet, "
                             "or either at test width")
    parser.add_argument("--weights", default=None,
                        help="EDM reference state dict .npz (tools/export_edm_checkpoint.py)")
    parser.add_argument("--sd-path", default=None, help="local SD-1.5 diffusers directory")
    parser.add_argument("--classifier-weights", default=None,
                        help="local 64x64_classifier.pt (guided-diffusion state dict)")
    parser.add_argument("--clip-path", default=None,
                        help="local Hugging Face CLIP directory (config.json + weights)")
    parser.add_argument("--num-steps", type=int, default=None,
                        help="EDM default 18, SD default 50")
    parser.add_argument("--compressibility-mode", choices=["jpeg", "dct"], default="jpeg",
                        help="jpeg: exact sizes on the host; dct: the on-device proxy")
    parser.add_argument("--record-noises", action="store_true",
                        help="return the selected noise trajectories")
    parser.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32",
                        help="model compute dtype")
    args = parser.parse_args(argv)

    if args.backend == "sd" and args.scorer == "imagenet":
        raise ValueError("imagenet scorer is only available for edm backend")
    if args.backend == "edm" and args.scorer == "clip":
        raise ValueError("clip scorer is only available for sd backend")

    from diffusion_tts_torch.utils.config import SearchParams

    params = SearchParams(N=args.N, K=args.K, B=args.B, S=args.S,
                          lambda_=args.lambda_, eps=args.eps)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    scorer, needs_cond = get_scorer(args.backend, args.scorer, args)
    if args.backend == "sd":
        _run_sd(args, params, scorer, dtype)
        return
    from diffusion_tts_torch.backends.edm_entry import generate_image_grid

    outname = args.output or f"edm_{args.method}_{args.scorer}.png"
    generate_image_grid(
        arch=args.arch, weights=args.weights, dest_path=outname, scorer=scorer,
        scorer_needs_labels=needs_cond, method=args.method, params=params, seed=args.seed,
        num_steps=args.num_steps or 18, S_churn=40, S_min=0.05, S_max=50, S_noise=1.003,
        dtype=dtype, record_noises=args.record_noises, device=args.device,
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
    prompts = [p.strip() for p in args.prompt.split("||")] * max(args.prompt_repeat, 1)
    scorer_cond = None
    if pipe.tokenizer is not None:
        if args.scorer == "clip":
            tok = pipe.tokenizer(prompts, padding="max_length", truncation=True,
                                 max_length=CLIP_TOKENS, return_tensors="np")
            scorer_cond = scorer.text_features(tok["input_ids"])
        prompt_kw = {"prompt": prompts}
    else:
        if args.scorer == "clip":
            print("WARNING: the SD pipeline has no tokenizer/text encoder; the prompt "
                  "embeddings are random and CLIP has no text to score against (it scores 0)")
        prompt_kw = {"prompt_embeds": rng.normal(
            args.seed, (SALT_PROMPT,), (len(prompts), CLIP_TOKENS, pipe.unet.cross_attention_dim),
            pipe.device)}
    images, scores = pipe(num_inference_steps=args.num_steps or 50, score_function=scorer,
                          scorer_cond=scorer_cond, method=args.method, params=params,
                          seed=args.seed, record_noises=args.record_noises, **prompt_kw)
    outname = args.output or f"sd_{args.method}_{args.scorer}.png"
    base, ext = (outname.rsplit(".", 1) + ["png"])[:2]
    for i, img in enumerate((images.float().cpu().numpy() * 255.0).astype(np.uint8)):
        Image.fromarray(img).save(outname if i == 0 else f"{base}_p{i}.{ext}")
    best = ", ".join(f"{float(s):.5f}" for s in scores)
    print(f"\n[SD] Saved: {outname} ({len(prompts)} prompt(s))\nBest score(s): {best}\n")


if __name__ == "__main__":
    main()
