"""Standalone SD example: one prompt through all three SD scorers
(counterpart of the repo's examples/sd_all_scorers.py, the reference's
sd/main.py).

Loads the SD pipeline, runs brightness, compressibility and CLIP in turn
at 18 inference steps with the reference's MASTER_PARAMS
(sd/main.py:24-39, 49), saves one PNG per scorer and prints each best
score.

    python -m diffusion_tts_torch.examples.sd_all_scorers --sd-path <diffusers dir> \\
        [--clip-path <HF CLIP dir>] --prompt "A beautiful landscape" [--method eps_greedy]
        [--steps 18] [--seed 0] [--outdir .] [--device cuda]

Without ``--sd-path`` (or with ``--tiny``) the tiny random pipeline runs,
without ``--clip-path`` the tiny random CLIP. On the card unless
``--device cpu`` is given. A pipeline without a tokenizer gets random
prompt embeddings, and CLIP random token ids, each from a torch generator
seeded from ``--seed``: statistically the JAX example's draws.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

# MASTER_PARAMS (sd/main.py:32-39)
MASTER = dict(N=4, K=20, B=2, S=8, lambda_=0.15, eps=0.4)


def run(pipe, clip, *, prompt: str, method: str, steps: int, seed: int,
        outdir: str) -> dict[str, float]:
    """Brightness, compressibility (max_size 150000) and CLIP, in that
    order, on ``pipe`` with the MASTER_PARAMS search; one PNG per scorer in
    ``outdir``. Returns {scorer: best score}."""
    from PIL import Image

    from diffusion_tts_torch.scorers import BrightnessScorer, CompressibilityScorer
    from diffusion_tts_torch.utils.config import SearchParams

    scorers = {
        "brightness": (BrightnessScorer(), None),
        "compressibility": (CompressibilityScorer(max_size=150000.0), None),
        "clip": (clip, None),
    }
    params = SearchParams(**MASTER)
    kwargs = {}
    if pipe.tokenizer is not None:
        kwargs["prompt"] = prompt
        tok = pipe.tokenizer([prompt], padding="max_length", truncation=True, max_length=77,
                             return_tensors="np")
        scorers["clip"] = (clip, clip.text_features(tok["input_ids"]))
    else:
        kwargs["prompt_embeds"] = torch.randn(
            (1, 7, pipe.unet.cross_attention_dim),
            generator=torch.Generator().manual_seed(seed + 1)).to(pipe.device)
        # no tokenizer: random token ids give the CLIP reward a text side, so
        # that the tiny demo still runs the text-image similarity path
        ids = torch.randint(0, 999, (1, 8), generator=torch.Generator().manual_seed(seed + 2))
        scorers["clip"] = (clip, clip.text_features(ids))

    os.makedirs(outdir, exist_ok=True)
    best = {}
    for name, (scorer, cond) in scorers.items():
        images, scores = pipe(num_inference_steps=steps, score_function=scorer,
                              scorer_cond=cond, method=method, params=params, seed=seed,
                              **kwargs)
        out = os.path.join(outdir, f"sd_{method}_{name}.png")
        Image.fromarray((images[0].float().cpu().numpy() * 255).astype(np.uint8)).save(out)
        best[name] = float(scores[0])
        print(f"[{name}] saved {out}  best score: {best[name]:.5f}")
    return best


def main(argv=None) -> dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sd-path", default=None)
    p.add_argument("--clip-path", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--prompt", default="A beautiful landscape")
    p.add_argument("--method", default="eps_greedy")
    p.add_argument("--steps", type=int, default=18)  # sd/main.py:49
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--outdir", default=".")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    args = p.parse_args(argv)

    from diffusion_tts_torch.pipelines import StableDiffusionSearchPipeline
    from diffusion_tts_torch.scorers import CLIPScorer
    from diffusion_tts_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.tiny or not args.sd_path:
        pipe = StableDiffusionSearchPipeline.tiny_random(device=dev)
    else:
        pipe = StableDiffusionSearchPipeline.from_pretrained(args.sd_path, device=dev)
    clip = (CLIPScorer.from_pretrained(args.clip_path, device=dev) if args.clip_path
            else CLIPScorer.random_init(device=dev))
    return run(pipe, clip, prompt=args.prompt, method=args.method, steps=args.steps,
               seed=args.seed, outdir=args.outdir)


if __name__ == "__main__":
    main()
