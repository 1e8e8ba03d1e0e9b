"""SD-backend throughput: the eps-greedy lookahead unit on SD-1.5 geometry
(counterpart of the repo's tools/sd_bench.py).

The SD counterpart of the flagship unit: each of ``--iters`` iterations
perturbs N candidate latents, runs one CFG'd UNet forward over all of them
at t = 500, forms pred_x0, decodes it with the VAE, scores each candidate by
its mean pixel and keeps the best, the unit the reference runs as a Python
loop with a host sync per candidate (pipeline_stable_diffusion.py:1371-1425).
Here the loop makes no host sync: the argmax and the pick stay on the
device, so the host enqueues every iteration without waiting.

Full width: SD-1.5's UNet and VAE (``SD15_UNET`` / ``SD15_VAE``) in bf16,
the latents carried in fp32 between iterations; ``--tiny`` (implied by
``--device cpu``) the JAX tool's tiny geometry. Every parameter is
``numpy.random.default_rng(0).standard_normal(shape) * 0.02`` in the
port's parameter order: statistically the JAX tool's draw, not the same
numbers.

NFE convention: UNet forwards with a CFG pair counting 2, iters x n x
batch x 2 (the JAX tool's, tools/sd_bench.py:133-134). search/nfe.py and
``bench --sd`` count a CFG pair as one.

    python -m diffusion_tts_torch.tools.sd_bench [--batch 1] [--n 4] [--iters 4]
        [--tiny] [--profile DIR] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# The JAX tool's tiny geometry (tools/sd_bench.py:48-57)
TINY_UNET = dict(sample_size=8, block_out_channels=(32, 64), layers_per_block=1,
                 cross_attention_dim=64, attention_head_dim=8,
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
TINY_VAE = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)
GUIDANCE, T, STEP = 7.5, 500.0, 0.05


@torch.no_grad()
def fill_random(module: torch.nn.Module, rng: np.random.Generator) -> torch.nn.Module:
    """Every parameter of ``module`` drawn from N(0, 0.02^2), in order."""
    for p in module.parameters():
        p.copy_(torch.from_numpy(rng.standard_normal(p.shape, dtype=np.float32) * 0.02))
    return module


@torch.no_grad()
def lookahead(unet, vae, lat: torch.Tensor, eps: torch.Tensor, ctx: torch.Tensor,
              iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` lookahead iterations (tools/sd_bench.py:92-108) from the
    latents ``lat`` [B, 4, h, w] with the candidates' directions ``eps``
    [N, B, 4, h, w] and the context ``ctx`` [2B, L, D]. The UNet batch is
    the CFG pair of the N*B candidates; its row i takes ``ctx[i % 2B]``
    (``jnp.tile``'s order). Returns the final latents and each iteration's
    scores [iters, N, B]."""
    n, b = eps.shape[:2]
    cc = ctx.repeat(n, 1, 1)
    tt = torch.full((2 * n * b,), T, device=lat.device)
    rows = torch.arange(b, device=lat.device)
    scores = []
    for k in range(iters):
        cands = lat[None] + STEP * eps * (k + 1.0)  # [N, B, ...]
        flat = cands.reshape((n * b,) + tuple(lat.shape[1:]))
        uncond, cond = unet(torch.cat([flat, flat]), tt, cc).chunk(2)
        noise_pred = uncond + GUIDANCE * (cond - uncond)
        pred_x0 = flat - 0.8 * noise_pred
        images = vae.decode(pred_x0 / 0.18215)
        scores.append(images.mean(dim=(1, 2, 3)).reshape(n, b))
        best = torch.argmax(scores[-1], dim=0)
        lat = cands[best, rows].to(lat.dtype)
    return lat, torch.stack(scores)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1, help="prompt batch")
    ap.add_argument("--n", type=int, default=4, help="candidates per iteration")
    ap.add_argument("--iters", type=int, default=4, help="iterations per call")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one steady call into DIR")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    from diffusion_tts_torch.models.sd_unet import UNet2DConditionModel
    from diffusion_tts_torch.models.sd_vae import AutoencoderKL
    from diffusion_tts_torch.pipelines.sd_pipeline import SD15_UNET, SD15_VAE
    from diffusion_tts_torch.utils.device import profiled, resolve_device

    dev = resolve_device(args.device)
    tiny = args.tiny or dev.type == "cpu"
    unet_cfg, vae_cfg = (TINY_UNET, TINY_VAE) if tiny else (SD15_UNET, SD15_VAE)
    dtype = torch.float32 if tiny else torch.bfloat16
    res, ctx_dim = unet_cfg["sample_size"], unet_cfg["cross_attention_dim"]
    b, n = args.batch, args.n
    rng = np.random.default_rng(0)
    with torch.device(dev):
        unet = fill_random(UNet2DConditionModel(**unet_cfg, dtype=dtype), rng).eval()
        vae = fill_random(AutoencoderKL(**vae_cfg, dtype=dtype), rng).eval()
    draw = lambda shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
    ctx = draw((2 * b, 77, ctx_dim))
    lat = draw((b, 4, res, res))
    eps = draw((n, b, 4, res, res))

    def run():
        out, _ = lookahead(unet, vae, lat, eps, ctx, args.iters)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    t0 = time.perf_counter()
    run()
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(4 if not tiny else 1):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    if args.profile:
        with profiled(args.profile, "sd_bench", dev):
            run()

    nfe = args.iters * n * b * 2  # a CFG pair counts 2 forwards, as the JAX tool counts
    out = dict(
        metric="sd15_eps_greedy_lookahead_NFE_per_s_per_chip" if not tiny
               else "sd_tiny (cpu smoke)",
        value=round(nfe / best, 2), unit="NFE/s",
        batch=b, n_candidates=n, compile_s=round(compile_s, 1),
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
