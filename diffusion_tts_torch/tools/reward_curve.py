"""Reward-vs-NFE curves: sweep each method's search budget on one EDM
configuration (counterpart of the repo's tools/reward_curve.py).

Reward at a growing NFE budget per method family: K for the iterated
methods, N for rejection, B for beam, S for MCTS, every point one row with
the mean reward over the seeds, its spread, the NFE per sample
(search/nfe.py) and the wall time.

    python -m diffusion_tts_torch.tools.reward_curve [--arch cifar10]
        [--scorer compressibility|brightness] [--steps 18] [--seeds 0,...,7]
        [--json out.json] [--quick] [--device cuda]

On the card unless ``--device cpu`` is given. The JAX tool's
``dispatch="auto"`` is left out: it works around the TPU's program size,
and PyTorch runs each step eagerly. Each seed's latents are drawn with its
own torch generator; each row's search takes key 1234.
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def sweep(quick: bool) -> list[tuple[str, dict]]:
    """(method, SearchParams overrides) of each row, the JAX tool's order."""
    if quick:
        return [("eps_greedy", dict(K=2)), ("rejection", dict(N=2))]
    return ([("naive", {})]
            + [("rejection", dict(N=n)) for n in (2, 4, 8)]
            + [("beam", dict(B=b, N=4)) for b in (2, 4)]
            + [("zero_order", dict(K=k, N=4)) for k in (2, 5, 20)]
            + [("eps_greedy", dict(K=k, N=4)) for k in (2, 5, 20)]
            + [("mcts", dict(S=s, N=4)) for s in (4, 8)])


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="cifar10")
    ap.add_argument("--scorer", default="compressibility", choices=["compressibility",
                                                                    "brightness"])
    ap.add_argument("--steps", type=int, default=18)
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--json", default=None)
    ap.add_argument("--quick", action="store_true", help="tiny sweep (CPU smoke)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    from diffusion_tts_torch.backends.edm_entry import load_network
    from diffusion_tts_torch.scorers import BrightnessScorer, CompressibilityScorer
    from diffusion_tts_torch.search.api import run_search
    from diffusion_tts_torch.search.nfe import nfe_per_sample
    from diffusion_tts_torch.tools.reward_bench import seeded_backend
    from diffusion_tts_torch.utils.config import SearchParams
    from diffusion_tts_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    net = load_network(args.arch, device=dev)
    seeds = [int(s) for s in args.seeds.split(",")]
    scorer = (BrightnessScorer() if args.scorer == "brightness"
              else CompressibilityScorer(mode="jpeg"))
    backend, z = seeded_backend(net, args.arch, seeds, args.steps, scorer, dev)

    rows = []
    for method, over in sweep(args.quick):
        p = SearchParams().replace(**over)
        t0 = time.perf_counter()
        r = run_search(method, backend, z, 1234, p)
        per_seed = r.score.double().cpu().numpy()  # waits for the device
        wall = time.perf_counter() - t0
        row = dict(
            method=method, **over,
            reward=round(float(per_seed.mean()), 5),
            reward_std=round(float(per_seed.std()), 5),
            nfe_per_sample=nfe_per_sample(method, args.steps, p, backend="edm"),
            wallclock_s=round(wall, 2),
        )
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.json:
        meta = dict(
            config=vars(args),
            weights="RANDOM-INIT (random weights from numpy seed 0, no checkpoint)",
            device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            rows=rows,
        )
        with open(args.json, "w") as f:
            json.dump(meta, f, indent=2)
        print(f"wrote {args.json}")
    return rows


if __name__ == "__main__":
    main()
