"""Benchmark: denoiser throughput of the flagship search unit (counterpart of
the repo's bench.py).

    python -m diffusion_tts_torch.bench [--no-sd] [--profile DIR]
    python -m diffusion_tts_torch.bench --sd [sd_e2e_bench's options]
    python -m diffusion_tts_torch.bench --device cpu      # the tiny smoke

Measures NFE/s for the eps-greedy candidate expansion on the full-width
ImageNet-64 ADM under EDMPrecond in bf16 (random weights from a numpy
seed): 2 samples x N = 8 candidates stepped through the Heun pair at step
3, scored by brightness, the best taken as the next pivot, 20 times in a
row (bench.py:101-262); the best of 4 repetitions, after one warm-up.
NFE = iterations x N x samples x 2.

vs_baseline = NFE/s x the canonical matmul FLOPs of one forward per image
(utils/roofline.py) / the card's dense bf16 peak: the fraction of the
speed of light. An unknown card raises; a FLOP count of 0 raises.

Prints ONE JSON line, {"metric", "value", "unit", "vs_baseline"} (with the
FLOPs per image and the NFE beside them), and by default an "sd"
sub-object: tools/sd_e2e_bench.py at the paper's defaults (18 steps, K=20,
N=4, 2 calls). ``--sd`` runs that bench alone, its options after ``--sd``
(defaults 18 steps, K=20, N=4, 3 calls; on the CPU the tiny pipeline,
6 steps, K=2, N=4, 2 calls). Heartbeats go to stderr.
``--device cpu`` runs the architecture at test width, 1 sample x 2
candidates, 3 iterations, one repetition, no SD: without a card and
without that flag the script raises.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time

import torch

# bench.py:264-302: the SD sub-object's run and the keys it keeps
SD_DEFAULT_ARGS = ["--steps", "18", "--K", "20", "--N", "4", "--repeat", "2"]
SD_ALONE_ARGS = ["--steps", "18", "--K", "20", "--N", "4", "--repeat", "3"]
SD_CPU_ARGS = ["--steps", "6", "--K", "2", "--N", "4", "--repeat", "2"]  # the tiny smoke
SD_KEYS = ("metric", "value", "unit", "steady_wall_s", "sol", "decode_flop_share")


def _heartbeat(t0: float):
    def hb(msg: str) -> None:
        print(f"[bench +{time.perf_counter() - t0:.0f}s] {msg}", file=sys.stderr, flush=True)
    return hb


def flagship_unit(dev: torch.device, profile: str | None, hb) -> dict:
    """The EDM flagship's eps-greedy expansion unit on ``dev``."""
    from diffusion_tts_torch.backends.edm_entry import load_network
    from diffusion_tts_torch.entry import _flagship
    from diffusion_tts_torch.samplers.edm import EDMHeunSampler
    from diffusion_tts_torch.scorers import BrightnessScorer
    from diffusion_tts_torch.search.backend import EDMSearchBackend
    from diffusion_tts_torch.utils import rng
    from diffusion_tts_torch.utils.device import profiled
    from diffusion_tts_torch.utils.roofline import denoiser_flops, peak_flops

    on_card = dev.type == "cuda"
    cfg, res, label_dim = _flagship(tiny=not on_card)
    batch, n_cand = (2, 8) if on_card else (1, 2)
    iters, reps = (20, 4) if on_card else (3, 1)
    peak = peak_flops(dev)
    flops = denoiser_flops(cfg)["total_flops"]  # per image
    if not flops:
        raise RuntimeError("the canonical FLOP count of the flagship is 0")

    net = load_network("imagenet64" if on_card else "tiny_adm", dtype=torch.bfloat16,
                       device=dev, seed=1)
    labels = torch.eye(label_dim, device=dev)[torch.arange(batch, device=dev) % label_dim]
    sampler = EDMHeunSampler(
        denoise=lambda x, s: net(x, s, labels.repeat(x.shape[0] // batch, 1)), num_steps=18,
        sigma_min=0.002, sigma_max=80.0, S_churn=40.0, S_min=0.05, S_max=50.0, S_noise=1.003)
    backend = EDMSearchBackend(sampler=sampler, scorer=BrightnessScorer())
    x_cur = backend.init_latents(rng.normal(2, (), (batch, res, res, 3), dev))
    eps = rng.normal(3, (), (n_cand, batch, res, res, 3), dev)
    rows = torch.arange(batch, device=dev)

    @torch.no_grad()
    def run_iters() -> torch.Tensor:
        pivot = torch.zeros_like(x_cur)
        for k in range(iters):
            cands = eps + 0.01 * pivot[None] * k  # the candidates vary by iteration
            _, images = backend.expand(x_cur, 3, None, cands)
            best = torch.argmax(backend.score(images).reshape(n_cand, batch), dim=0)
            pivot = cands[best, rows]
        return pivot

    hb(f"start: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}, "
       f"{flops} canonical FLOP per image")
    float(run_iters()[0, 0, 0, 0])  # warm-up
    best_dt = float("inf")
    with profiled(profile, "bench", dev):
        for rep in range(reps):
            t0 = time.perf_counter()
            float(run_iters()[0, 0, 0, 0])  # a value fetch: waits for the device
            dt = time.perf_counter() - t0
            best_dt = min(best_dt, dt)
            hb(f"rep {rep + 1}/{reps} wall {dt:.3f} s")
    nfe = iters * n_cand * batch * 2  # the Heun pair of every candidate
    nfe_per_s = nfe / best_dt
    return {
        "metric": "edm_imagenet64_eps_greedy_expand_NFE_per_s_per_chip" if on_card
                  else "edm_tiny_eps_greedy_expand_NFE_per_s (cpu smoke)",
        "value": nfe_per_s, "unit": "NFE/s", "vs_baseline": nfe_per_s * flops / peak,
        "flops_per_image": flops, "nfe": nfe,
    }


def main(argv=None) -> dict:
    from diffusion_tts_torch.tools import sd_e2e_bench
    from diffusion_tts_torch.utils.device import resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu (the tiny smoke)")
    if "--sd" in argv:
        argv.remove("--sd")
        cpu = resolve_device(ap.parse_known_args(argv)[0].device).type == "cpu"
        return sd_e2e_bench.main((SD_CPU_ARGS if cpu else SD_ALONE_ARGS) + argv)
    ap.add_argument("--no-sd", action="store_true", help="leave out the SD sub-object")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the timed repetitions into DIR")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    hb = _heartbeat(time.perf_counter())
    out = flagship_unit(dev, args.profile, hb)
    if dev.type == "cuda" and not args.no_sd:
        hb("SD end to end at the paper's defaults, 2 calls")
        with contextlib.redirect_stdout(io.StringIO()):
            sd = sd_e2e_bench.main(SD_DEFAULT_ARGS + ["--device", str(dev)])
        out["sd"] = {k: sd[k] for k in SD_KEYS}
    hb("done")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
