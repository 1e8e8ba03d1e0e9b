"""One rank of the port's torch.distributed tests on the CPU
(tests/test_torch_parallel.py, tests/test_torch_candidate_sharding.py).

    python tests/_torch_dist_worker.py CASE DIR

runs with torchrun's environment (``parallel.distributed.launch`` sets it),
reads DIR/CASE.inputs.pt, which the test wrote, starts a gloo group with a
120 s collective timeout, and writes what it found to DIR/CASE.rank{r}.pt
for the test to hold against the JAX package. It imports no JAX: the test
makes every draw the JAX side makes and passes it in.
"""
from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from diffusion_tts_torch.parallel.distributed import process_group  # noqa: E402
from diffusion_tts_torch.parallel.mesh import (  # noqa: E402
    CandidateShards,
    candidate_rows,
    check_consistency,
    make_mesh,
    shard_array,
    shard_train_step,
)

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _tiny_net(inp):
    from diffusion_tts_torch.models.preconds import EDMPrecond

    net = EDMPrecond(img_resolution=16, img_channels=3, label_dim=10,
                     model_kwargs=inp["net_kw"], param_dtype=torch.float32)
    net.load_state_dict(inp["state_dict"])
    return net


def _steps(state, inp, mesh, loss_fn, cfg):
    """The injected steps of ``inp`` on this rank's share of each batch."""
    from diffusion_tts_torch.training.train_step import train_step

    losses = []
    for images, labels, draws in zip(inp["images"], inp["labels"], inp["draws"]):
        mine = [{k: shard_array(_t(v), mesh) for k, v in d.items()} for d in draws]
        metrics = train_step(state, shard_array(_t(images), mesh, 1),
                             shard_array(_t(labels), mesh, 1), loss_fn, cfg, draws=mine)
        losses.append(float(metrics["loss"]))
    return losses


def case_train(inp) -> dict:
    """Stats sync, report0, the rank-strided sampler, make_mesh's refusal and
    the DDP step (2 ranks)."""
    from diffusion_tts_torch.training.dataset import InfiniteSampler
    from diffusion_tts_torch.training.loss import EDMLoss
    from diffusion_tts_torch.training.train_step import TrainConfig, TrainState
    from diffusion_tts_torch.utils.stats import Collector

    r, world = dist.get_rank(), dist.get_world_size()
    out = {"world": world}
    sampler = iter(InfiniteSampler(10, shard=r, num_shards=world, shuffle=False))
    out["sampler_idxs"] = [next(sampler) for _ in range(8)]
    col = Collector()
    col.report("loss", [1.0, 2.0] if r == 0 else [5.0])
    col.report0("lr", 0.125)
    col.sync()
    out["stats"] = col.as_dict()
    try:
        make_mesh({"data": world + 1}, device_type="cpu")
    except ValueError as e:
        out["mesh_error"] = str(e)

    cfg = TrainConfig(**inp["cfg"])
    state = TrainState.create(_tiny_net(inp), cfg)
    mesh = make_mesh(device_type="cpu")
    state = shard_train_step(state, mesh)
    out["losses"] = _steps(state, inp, mesh, EDMLoss(), cfg)
    check_consistency(state.net)
    check_consistency(state.ema)
    out["net"] = {k: v.clone() for k, v in state.net.state_dict().items()}
    out["ema"] = {k: v.clone() for k, v in state.ema.state_dict().items()}
    out["nimg"] = state.nimg
    return out


def case_hsdp(inp) -> dict:
    """The same injected steps under DP over 4 ranks and under HSDP
    (data 2 x model 2): full parameters and EMA of both, gathered."""
    from diffusion_tts_torch.parallel.sharding_rules import (
        describe_sharding, is_sharded, shard_state,
    )
    from diffusion_tts_torch.training.loss import EDMLoss
    from diffusion_tts_torch.training.train_step import TrainConfig, TrainState

    cfg = TrainConfig(**inp["cfg"])
    out = {}
    dp_mesh = make_mesh(device_type="cpu")
    dp = shard_train_step(TrainState.create(_tiny_net(inp), cfg), dp_mesh)
    out["dp_losses"] = _steps(dp, inp, dp_mesh, EDMLoss(), cfg)
    mesh = make_mesh({"data": 2, "model": 2}, device_type="cpu")
    hsdp = shard_state(TrainState.create(_tiny_net(inp), cfg), mesh, min_size=2)
    out["sharded_names"] = sorted(n for n, p in hsdp.net.named_parameters() if is_sharded(p))
    out["hsdp_losses"] = _steps(hsdp, inp, mesh, EDMLoss(), cfg)
    full = lambda p: p.full_tensor() if hasattr(p, "full_tensor") else p
    for name, state in (("dp", dp), ("hsdp", hsdp)):
        for part in ("net", "ema"):
            out[f"{name}_{part}"] = {n: full(p).detach().clone()
                                     for n, p in getattr(state, part).named_parameters()}
    out["n_sharded_ema"] = sum(is_sharded(p) for p in hsdp.ema.parameters())
    out["described"] = describe_sharding(hsdp.net, max_rows=2)
    return out


def _edm_backend(net, labels, steps, shards):
    from diffusion_tts_torch.samplers.edm import EDMHeunSampler
    from diffusion_tts_torch.scorers import BrightnessScorer
    from diffusion_tts_torch.search import EDMSearchBackend

    sampler = EDMHeunSampler(
        denoise=lambda x, s: net(x, s, candidate_rows(labels, x.shape[0])),
        num_steps=steps, S_churn=40.0, S_min=0.05, S_max=50.0, S_noise=1.003)
    return EDMSearchBackend(sampler=sampler, scorer=BrightnessScorer(),
                            candidate_sharding=shards)


def _result(r) -> dict:
    keep = {"x": r.x, "score": r.score, "images": r.images}
    if getattr(r, "best_noises", None) is not None:
        keep["best_noises"] = r.best_noises
    return {k: v.clone() for k, v in keep.items()}


def case_search(inp) -> dict:
    """The candidate-sharded searches (EDM eps-greedy, beam, MCTS; SD
    eps-greedy through the backend and through __call__), their unsharded
    runs, and the refusal of a candidate count the ranks do not divide."""
    from diffusion_tts_torch.models.sd_unet import UNet2DConditionModel
    from diffusion_tts_torch.models.sd_vae import AutoencoderKL
    from diffusion_tts_torch.pipelines import StableDiffusionSearchPipeline
    from diffusion_tts_torch.scorers import BrightnessScorer
    from diffusion_tts_torch.search import InjectedNoise, mcts, run_search
    from diffusion_tts_torch.utils.config import SearchParams

    shards = CandidateShards()
    net = _tiny_net(inp).eval()
    labels, z, steps = _t(inp["labels"]), _t(inp["z"]), inp["steps"]
    sharded, plain = (_edm_backend(net, labels, steps, s) for s in (shards, None))
    noise = lambda d: InjectedNoise(**{k: _t(v) for k, v in d.items()})
    picks = inp["mcts_picks"]
    mcts.pick_draw = lambda key, i, phase, q, bsz, b_exp, device: torch.as_tensor(
        picks[(i, phase, q)], dtype=torch.long)
    out = {}
    with torch.no_grad():
        for method, p, draws in inp["edm_runs"]:
            params = SearchParams(**p)
            out[method] = _result(run_search(method, sharded, z, 99, params, noise=noise(draws),
                                             record_noises=method != "mcts"))
            out[f"{method}_plain"] = _result(run_search(method, plain, z, 99, params,
                                                        noise=noise(draws),
                                                        record_noises=method != "mcts"))
        # 3 lanes a rank: rank 1's slice starts inside a sample's row of labels
        odd = SearchParams(N=3, K=1)
        out["odd"] = _result(run_search("eps_greedy", sharded, z, 4, odd, record_noises=True))
        out["odd_plain"] = _result(run_search("eps_greedy", plain, z, 4, odd, record_noises=True))
        calls = []
        counting = _edm_backend(lambda x, s, lab: calls.append(x.shape[0]) or x, labels, steps,
                                shards)
        try:
            run_search("eps_greedy", counting, z[:1], 5, SearchParams(N=3, K=1))
        except ValueError as e:
            out["refusal"] = (str(e), list(calls))

        unet = UNet2DConditionModel(**inp["unet_kw"])
        unet.load_state_dict(inp["unet"])
        vae = AutoencoderKL(**inp["vae_kw"])
        vae.load_state_dict(inp["vae"])
        pipe = StableDiffusionSearchPipeline(unet=unet.eval(), vae=vae.eval())
        cond = _t(inp["sd_cond"])
        p = SearchParams(**inp["sd_params"])
        backend = pipe.make_backend(cond, torch.zeros_like(cond), BrightnessScorer(),
                                    num_inference_steps=inp["sd_steps"], candidate_sharding=shards)
        out["sd"] = _result(run_search("eps_greedy", backend, _t(inp["sd_z"]), 99, p,
                                       noise=noise(inp["sd_draws"]), record_noises=True))
        kw = dict(prompt_embeds=cond, num_inference_steps=inp["sd_steps"],
                  score_function=BrightnessScorer(), method="eps_greedy", params=p, seed=5)
        out["sd_call"] = pipe(candidate_sharding=shards, **kw)
        out["sd_call_plain"] = pipe(**kw)
    return out


def case_stats_nonfinite(inp) -> dict:
    """Rank 0's losses are all NaN, rank 1's finite: both ranks must get
    through sync() and hold the same moments (2 ranks)."""
    from diffusion_tts_torch.utils.stats import Collector

    col = Collector()
    col.report("Loss/loss", [float("nan")] * 4 if dist.get_rank() == 0 else [1.0, 2.0])
    col.report0("Timing/sec_per_kimg", 3.0)
    col.sync()
    return {"stats": col.as_dict()}


def case_lost_peer(inp) -> dict:
    """Rank 1 leaves without joining rank 0's all_reduce, which must raise."""
    if dist.get_rank() == 1:
        os._exit(0)
    dist.all_reduce(torch.ones(1))
    return {"all_reduce": "returned"}


CASES = {"train": case_train, "hsdp": case_hsdp, "search": case_search,
         "stats_nonfinite": case_stats_nonfinite, "lost_peer": case_lost_peer}


def main() -> None:
    case, workdir = sys.argv[1], sys.argv[2]
    with process_group("gloo", timeout=120, device="cpu"):
        inp = torch.load(os.path.join(workdir, f"{case}.inputs.pt"), weights_only=False)
        out = CASES[case](inp)
        torch.save(out, os.path.join(workdir, f"{case}.rank{dist.get_rank()}.pt"))


if __name__ == "__main__":
    main()
