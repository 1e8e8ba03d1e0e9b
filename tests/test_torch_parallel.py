"""The port's torch.distributed parallelism (diffusion_tts_torch/parallel)
against the JAX package's (diffusion_tts_tpu/parallel) on the CPU.

Two gloo groups run in subprocesses through tests/_torch_dist_worker.py
while the JAX side runs here on the 8 virtual CPU devices: 2 ranks (stats
sync, report0, the rank-strided sampler, make_mesh's refusal, two DDP
steps) and 4 ranks (the same steps under DP over 4 ranks and under HSDP,
data 2 x model 2). Each rank has one torch thread, a 120 s collective
timeout, and the group 180 s to finish.

Tolerances: the DDP steps against JAX's shard_train_step on a 2-device
mesh as tests/test_torch_training.py's test_three_train_steps_match_jax
(loss rtol 1e-5; parameters and EMA within 1e-5 of the largest magnitude,
the k third of every qkv bias left out: its gradient is round-off that
Adam normalizes); HSDP against DP within 2e-5, with the same exception.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from diffusion_tts_torch.models.torch_import import state_dict_from_flax
from diffusion_tts_torch.parallel.sharding_rules import param_spec
from diffusion_tts_tpu.parallel.mesh import make_mesh as j_make_mesh
from diffusion_tts_tpu.parallel.mesh import shard_train_step as j_shard_train_step
from diffusion_tts_tpu.parallel.sharding_rules import param_spec as j_param_spec
from diffusion_tts_tpu.training import loss as j_loss
from diffusion_tts_tpu.training import train_step as j_step

from _torch_port import TINY_ADM_KW, rank_results, start_ranks, tiny_pair
from test_torch_training import CFG, _batches, _step_draws, _without_k_bias

torch.set_num_threads(1)

STEPS = 2  # the first step's learning rate is 0 (nimg = 0): the second moves the net


def _inputs(params0, images, labels, keys):
    return dict(cfg=CFG, net_kw=TINY_ADM_KW, state_dict=state_dict_from_flax(params0),
                images=images[:STEPS], labels=labels[:STEPS],
                draws=[[{k: v.numpy() for k, v in d.items()} for d in
                        _step_draws(keys[i], images.shape[2:], CFG["grad_accum_rounds"])]
                       for i in range(STEPS)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' outputs and JAX's sharded steps on the same inputs."""
    workdir = tmp_path_factory.mktemp("dist")
    j_net, variables, _ = tiny_pair(seed=21)
    images, labels = _batches(STEPS)
    keys = jax.random.split(jax.random.key(22), STEPS)
    inputs = _inputs(variables["params"], images, labels, keys)
    futs = {"train": start_ranks("train", 2, workdir, inputs),
            "hsdp": start_ranks("hsdp", 4, workdir, inputs)}

    cfg = j_step.TrainConfig(**CFG)
    tx = j_step.make_optimizer(cfg)
    apply = lambda p, x, s, lab, al, rng=None: j_net.apply({"params": p}, x, s, lab,
                                                           augment_labels=al)
    mesh = j_make_mesh({"data": 2}, devices=jax.devices()[:2])
    step = j_shard_train_step(j_step.make_train_step(j_loss.EDMLoss(), apply, cfg, tx), mesh)
    state = j_step.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]), tx)
    losses = []
    for i in range(STEPS):
        state, metrics = step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]), keys[i])
        losses.append(float(metrics["loss"]))
    flags = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, float(j_param_spec(a, "model", 2, 2) != P()), np.float32),
        variables["params"])
    return dict(train=rank_results("train", 2, workdir, futs["train"]),
                hsdp=rank_results("hsdp", 4, workdir, futs["hsdp"]),
                jax_state=jax.device_get(state), jax_losses=losses,
                jax_sharded=sorted(n for n, v in state_dict_from_flax(flags).items()
                                   if v.reshape(-1)[0] == 1))


class _Leaf:  # a fake tensor: param_spec reads the shape only
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("shape,min_size,want", [
    ((16, 16, 3, 3), 2, Shard(0)),    # conv weight [O, I, kh, kw]: O = 16 shards
    ((16, 8), 2, Shard(0)),           # linear weight [out, in]
    ((16,), 64, Replicate()),         # too small for min_size
    ((15, 16, 3, 3), 2, Replicate()),  # O not divisible by the axis
    ((), 2, Replicate()),             # a scalar
])
def test_param_spec_rules(shape, min_size, want):
    """JAX's rule (tests/test_parallel.py::test_param_spec_rules) in torch's
    layout: the output features are dim 0, where JAX has them last."""
    assert param_spec(_Leaf(shape), 2, min_size) == want
    jax_shape = shape[2:][::-1] + shape[1::-1] if len(shape) == 4 else shape[::-1]
    assert (j_param_spec(_Leaf(jax_shape), "model", 2, min_size) != P()) == (want == Shard(0))


def test_make_mesh_refuses_a_size_that_is_not_the_world(runs):
    for out in runs["train"]:
        assert "mesh {'data': 3} needs 3 ranks, have 2" in out["mesh_error"]


def test_stats_sync_and_report0(runs):
    """Both ranks hold the same merged moments (tests/_dist_worker.py's
    check for JAX): loss = {1, 2} on rank 0 and {5} on rank 1; lr reported
    by rank 0 only."""
    for out in runs["train"]:
        assert out["world"] == 2
        loss, lr = out["stats"]["loss"], out["stats"]["lr"]
        assert loss["num"] == 3
        np.testing.assert_allclose(loss["mean"], 8.0 / 3.0, rtol=1e-12)
        np.testing.assert_allclose(loss["std"], np.std([1.0, 2.0, 5.0]), rtol=1e-12)
        assert lr["num"] == 1 and lr["mean"] == 0.125


def test_sampler_shards_are_disjoint_and_rank_strided(runs):
    idx0, idx1 = (out["sampler_idxs"] for out in runs["train"])
    assert all(i % 2 == 0 for i in idx0) and all(i % 2 == 1 for i in idx1)
    assert not set(idx0) & set(idx1)


def _assert_close(got: dict, want: dict, tol: float, what: str) -> None:
    """Every tensor of ``want`` within ``tol`` of its largest magnitude in
    ``got``, the k third of each qkv bias left out."""
    scale = max(float(v.abs().max()) for v in want.values())
    worst = max(float(_without_k_bias(n, got[n] - want[n]).abs().max()) for n in want)
    assert worst <= tol * scale, f"{what}: {worst} vs scale {scale}"


def _jax_tree(runs, part):
    state = runs["jax_state"]
    return state_dict_from_flax(state.params if part == "net" else state.ema_params)


@pytest.mark.parametrize("part", ["net", "ema"])
def test_ddp_steps_match_jax_shard_train_step(runs, part):
    """Two steps of train_step on 2 gloo ranks (DDP, each rank its half of
    every round's batch and of JAX's draws) against make_train_step under
    shard_train_step on a 2-device mesh."""
    want = _jax_tree(runs, part)
    for out in runs["train"]:
        assert out["nimg"] == int(runs["jax_state"].nimg) == STEPS * CFG["total_batch"]
        _assert_close(out[part], want, 1e-5, part)


def test_ddp_loss_is_the_global_mean(runs):
    """Each rank's loss is its half's; their mean is JAX's global loss."""
    got = np.mean([out["losses"] for out in runs["train"]], axis=0)
    np.testing.assert_allclose(got, runs["jax_losses"], rtol=1e-5)
    assert runs["train"][0]["losses"] != runs["train"][1]["losses"]


@pytest.mark.parametrize("part", ["net", "ema"])
def test_ddp_ranks_end_bit_identical(runs, part):
    """check_ddp_consistency ran on both ranks; the saved states agree too."""
    a, b = (out[part] for out in runs["train"])
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("part", ["net", "ema"])
def test_hsdp_matches_dp(runs, part):
    """HSDP (data 2 x model 2) against DP over 4 ranks, the same injected
    steps: within 2e-5 of the largest magnitude, on every rank."""
    for out in runs["hsdp"]:
        _assert_close(out[f"hsdp_{part}"], out[f"dp_{part}"], 2e-5, part)
        np.testing.assert_allclose(out["hsdp_losses"], out["dp_losses"], rtol=1e-5)


@pytest.mark.parametrize("part", ["net", "ema"])
def test_dp_over_4_ranks_matches_jax(runs, part):
    """The global batch split 4 ways takes JAX's step too."""
    _assert_close(runs["hsdp"][0][f"dp_{part}"], _jax_tree(runs, part), 1e-5, part)


def test_shard_state_shards_what_the_jax_rule_shards(runs):
    """The parameters shard_state shards (min_size 2, model axis of 2),
    mapped to torch names, are the leaves JAX's rule shards at the same
    tiny net; the EMA is sharded alike."""
    got = runs["hsdp"][0]["sharded_names"]
    assert got == runs["jax_sharded"] and len(got) > 100
    assert runs["hsdp"][0]["n_sharded_ema"] == len(got)
    described = runs["hsdp"][0]["described"].splitlines()
    assert len(described) == 3 and "Shard(dim=0)" in described[0]
    assert described[2] == f"... {len(got) - 2} more sharded parameters"


def test_a_lost_peer_fails_the_collective_and_the_launch(tmp_path):
    """Rank 1 exits before rank 0's all_reduce: the collective raises on
    rank 0 (it does not wait out its timeout) and launch reports it."""
    with pytest.raises(RuntimeError, match="rank 0 exited 1"):
        rank_results("lost_peer", 2, tmp_path, start_ranks("lost_peer", 2, tmp_path, {}))


TORCHRUN_ENV = dict(RANK="1", WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT="1")


@pytest.mark.parametrize("env,device,cards,error", [
    (None, "cuda", 1, None),                        # no torchrun: no group, nothing touched
    ({"LOCAL_RANK": "1"}, "cuda", 1, "use the gloo backend"),  # NCCL: more ranks than cards
    ({"LOCAL_RANK": "0"}, "cuda", 0, "CUDA is not available"),  # no card: no fall to the CPU
    ({"LOCAL_RANK": "0"}, "cpu", 0, "NCCL needs CUDA"),          # NCCL on the CPU
])
def test_distributed_init_refuses_what_it_cannot_start(monkeypatch, env, device, cards, error):
    """Every refusal comes before a group is started."""
    from diffusion_tts_torch.parallel import distributed

    for k in distributed.ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in ({} if env is None else dict(TORCHRUN_ENV, **env)).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if error is None:
        assert distributed.distributed_init("nccl", device=device) is False
    else:
        with pytest.raises((RuntimeError, ValueError), match=error):
            distributed.distributed_init("nccl", device=device)
    assert not torch.distributed.is_initialized()
