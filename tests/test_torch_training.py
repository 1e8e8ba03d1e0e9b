"""The port's training stack (diffusion_tts_torch/training) against the JAX
package on the CPU: losses, the ADM's training-only inputs, the train step
as a whole, the state carried across from a JAX run, the dataset streams and
the checkpoints.

torch cannot reproduce JAX's threefry bits, so wherever a draw matters the
test makes it with the JAX key the JAX function would use and injects it
into the port. Weights are random in every layer (tests/_torch_port.py):
from the architecture's init, which zeroes conv1, proj and out_conv, no
gradient would reach an attention site in the first step.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.models.edm_nets import DhariwalUNet
from diffusion_tts_torch.models.preconds import EDMPrecond
from diffusion_tts_torch.models.torch_import import (
    flax_from_state_dict,
    load_into,
    random_state_dict,
    state_dict_from_flax,
)
from diffusion_tts_torch.training import checkpoints, dataset, loss as t_loss
from diffusion_tts_torch.training.train_step import TrainConfig, TrainState, train_step
from diffusion_tts_torch.utils import rng
from diffusion_tts_tpu.models.edm_nets import DhariwalUNet as JDhariwalUNet
from diffusion_tts_tpu.training import dataset as j_dataset
from diffusion_tts_tpu.training import loss as j_loss
from diffusion_tts_tpu.training import train_step as j_step

from _torch_port import TINY_ADM_KW, random_flax_params, tiny_pair

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _loss_draws(key, shape, uniform):
    """The draws the JAX losses make from ``key`` (loss.py:33-38)."""
    k1, k2, _ = jax.random.split(key, 3)
    draw = jax.random.uniform if uniform else jax.random.normal
    return dict(u=_t(draw(k1, (shape[0], 1, 1, 1))), noise=_t(jax.random.normal(k2, shape)))


@pytest.mark.parametrize("name", ["EDMLoss", "VPLoss", "VELoss"])
def test_losses_match_jax(name):
    """Each loss on an analytic denoiser, with JAX's draws injected: 1e-5 of
    the largest loss value (fp32 on both sides)."""
    images = np.random.default_rng(0).uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    key = jax.random.key(2)
    denoise_j = lambda x, s, lab, al: x * (0.9 / (1.0 + s.reshape(-1, 1, 1, 1)))
    want = np.asarray(getattr(j_loss, name)()(denoise_j, jnp.asarray(images), None, key))
    draws = _loss_draws(key, images.shape, uniform=name != "EDMLoss")
    got = getattr(t_loss, name)()(denoise_j, _t(images), None, **draws).numpy()
    assert got.shape == images.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_loss_draws_come_from_the_generator():
    images = torch.zeros((3, 4, 4, 3))
    denoise = lambda x, s, lab, al: x
    run = lambda seed: t_loss.EDMLoss()(denoise, images, None, rng.generator(seed))
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def _adm_pair(label_dropout, seed):
    kw = dict(TINY_ADM_KW, augment_dim=9, label_dropout=label_dropout)
    j_net = JDhariwalUNet(img_resolution=16, in_channels=3, out_channels=3, label_dim=10, **kw)
    shapes = jax.eval_shape(lambda: j_net.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)),
        jnp.zeros((1, 10)), jnp.zeros((1, 9))))
    params = random_flax_params(shapes["params"], seed)
    t_net = load_into(DhariwalUNet(img_resolution=16, in_channels=3, out_channels=3,
                                   label_dim=10, **kw), state_dict_from_flax(params))
    return j_net, params, t_net


@pytest.mark.parametrize("label_dropout", [0.0, 1.0])
def test_adm_augment_and_label_dropout_match_flax(label_dropout):
    """augment_dim=9 (map_augment) and label_dropout in train mode. With
    rate 1 every label is dropped whatever the draw, so both packages give
    the unconditional embedding; with rate 0 none is."""
    j_net, params, t_net = _adm_pair(label_dropout, seed=11)
    g = np.random.default_rng(12)
    x = g.standard_normal((2, 16, 16, 3)).astype(np.float32)
    noise = np.array([-0.3, 0.8], np.float32)
    labels = np.eye(10, dtype=np.float32)[[2, 5]]
    aug = g.standard_normal((2, 9)).astype(np.float32)
    want = j_net.apply({"params": params}, x, noise, labels, aug, train=True,
                       rngs={"label_dropout": jax.random.key(1)})
    t_net.train()
    got = t_net(_t(x).permute(0, 3, 1, 2), _t(noise), _t(labels), _t(aug), rng.generator(0))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=2e-4, rtol=2e-4)
    # the augment labels matter, and so do the class labels unless dropped
    other = t_net(_t(x).permute(0, 3, 1, 2), _t(noise), _t(labels[::-1].copy()), _t(aug),
                  rng.generator(0))
    assert torch.equal(other, got) == (label_dropout == 1.0)
    assert not torch.equal(t_net(_t(x).permute(0, 3, 1, 2), _t(noise), _t(labels), _t(-aug),
                                 rng.generator(0)), got)


def test_label_dropout_and_dropout_need_a_generator():
    _, _, t_net = _adm_pair(0.5, seed=1)
    x, noise, labels = torch.zeros((4, 3, 16, 16)), torch.zeros(4), torch.eye(10)[:4]
    t_net.train()
    with pytest.raises(ValueError, match="generator"):
        t_net(x, noise, labels)
    kept = [t_net(x, noise, labels, None, rng.generator(s)) for s in range(2)]
    assert all(torch.isfinite(k).all() for k in kept)
    net = DhariwalUNet(img_resolution=16, in_channels=3, out_channels=3,
                       **dict(TINY_ADM_KW, dropout=0.5))
    load_into(net, random_state_dict(net, 2)).train()
    x = torch.randn(x.shape, generator=rng.generator(5))
    with pytest.raises(ValueError, match="generator"):
        net(x, noise)
    a, b, c = (net(x, noise, generator=rng.generator(s)) for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(net.eval()(x, noise), net(x, noise))  # eval: no dropout, no generator


def test_flax_from_state_dict_inverts_state_dict_from_flax():
    _, params, t_net = _adm_pair(0.0, seed=2)
    back = flax_from_state_dict(t_net.state_dict())
    flat = lambda tree: {jax.tree_util.keystr(k): v
                         for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(params), flat(back)
    assert want.keys() == got.keys() and any("map_augment" in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32))


def test_param_dtype_keeps_fp32_parameters_under_bf16_compute():
    kw = dict(img_resolution=16, img_channels=3, label_dim=10, model_kwargs=TINY_ADM_KW)
    serve = EDMPrecond(dtype=torch.bfloat16, **kw)
    train = EDMPrecond(dtype=torch.bfloat16, param_dtype=torch.float32, **kw)
    assert {p.dtype for n, p in serve.named_parameters() if "norm" not in n} == {torch.bfloat16}
    assert {p.dtype for p in train.parameters()} == {torch.float32}
    load_into(train, random_state_dict(train, 0))
    x = torch.randn((2, 16, 16, 3), generator=rng.generator(0))
    out = train(x, torch.tensor([0.5, 2.0]), torch.eye(10)[:2])
    out.square().mean().backward()
    grads = [p.grad for p in train.parameters()]
    assert all(g is not None and g.dtype == torch.float32 for g in grads)
    assert sum(float(g.abs().sum()) > 0 for g in grads) > 0.9 * len(grads)


# ------------------------------------------------------- the slice as a whole

CFG = dict(lr=1e-3, grad_accum_rounds=2, total_batch=8, lr_rampup_kimg=0.016,
           ema_halflife_kimg=0.1)


def _batches(n, seed=20):
    g = np.random.default_rng(seed)
    images = g.uniform(-1, 1, (n, 2, 4, 16, 16, 3)).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[g.integers(0, 10, (n, 2, 4))]
    return images, labels


def _step_draws(key, shape, rounds):
    """The draws of one JAX step (train_step.py:80-90, loss.py:69-75)."""
    return [_loss_draws(jax.random.split(k)[0], shape, uniform=False)
            for k in jax.random.split(key, rounds)]


def _jax_training(steps):
    """(flax net, list of (state, metrics) after each JAX step, keys)."""
    j_net, variables, _ = tiny_pair(seed=21)
    cfg = j_step.TrainConfig(**CFG)
    tx = j_step.make_optimizer(cfg)
    apply = lambda p, x, s, lab, al, rng=None: j_net.apply({"params": p}, x, s, lab,
                                                           augment_labels=al)
    step = jax.jit(j_step.make_train_step(j_loss.EDMLoss(), apply, cfg, tx))
    state = j_step.TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                                     tx)
    images, labels = _batches(steps)
    keys = jax.random.split(jax.random.key(22), steps)
    history = []
    for i in range(steps):
        state, metrics = step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]), keys[i])
        history.append((jax.device_get(state), jax.device_get(metrics)))
    return variables["params"], history, keys


@pytest.fixture(scope="module")
def jax_run():
    return _jax_training(4)


def _tiny_port_net(dtype=torch.float32, **model_kw):
    return EDMPrecond(img_resolution=16, img_channels=3, label_dim=10,
                      model_kwargs=dict(TINY_ADM_KW, **model_kw), dtype=dtype,
                      param_dtype=torch.float32)


def _without_k_bias(name, value):
    """The k third of a qkv bias has no gradient mathematically (a shift of
    every key moves every score of a row alike, and softmax ignores it), so
    what reaches Adam there is round-off, which Adam, dividing by the
    gradient's own magnitude, turns into a step of a fraction of lr with a
    sign that differs between the packages. That third is left out of the
    comparison; test_k_bias_gradient_is_round_off shows it is round-off."""
    if not name.endswith("qkv.bias"):
        return value
    c = value.shape[0] // 3
    return torch.cat([value[:c], value[2 * c:]])


def _assert_tree_close(module, tree, what):
    """Every parameter within 1e-5 of the tree's largest magnitude."""
    want = state_dict_from_flax(tree)
    scale = max(float(v.abs().max()) for v in want.values())
    worst = max(float(_without_k_bias(n, p.detach() - want[n]).abs().max())
                for n, p in module.named_parameters())
    assert worst <= 1e-5 * scale, f"{what}: {worst} vs scale {scale}"


def test_k_bias_gradient_is_round_off(jax_run):
    _, history, _ = jax_run
    mu = state_dict_from_flax(history[2][0].opt_state.inner_state[0].mu)
    biases = {n: v for n, v in mu.items() if n.endswith("qkv.bias")}
    assert len(biases) == 4
    for n, v in biases.items():
        c = v.shape[0] // 3
        assert float(v[c:2 * c].abs().max()) < 1e-6 * float(v.abs().max()), n


def test_three_train_steps_match_jax(jax_run):
    """3 steps of train_step (R = 2, fp32, dropout 0, same weights, same
    draws) against make_train_step: the loss of every step, lr and ema_beta,
    and parameters and EMA at the end. The LR ramp is short enough that
    steps 2 and 3 have a non-zero rate (at step 1 nimg is 0, so the rate is
    0 and only Adam's moments and the EMA's ramp move)."""
    params0, history, keys = jax_run
    cfg = TrainConfig(**CFG)
    state = TrainState.create(load_into(_tiny_port_net(), state_dict_from_flax(params0)), cfg)
    images, labels = _batches(4)
    for i in range(3):
        draws = _step_draws(keys[i], images.shape[2:], cfg.grad_accum_rounds)
        metrics = train_step(state, _t(images[i]), _t(labels[i]), t_loss.EDMLoss(), cfg,
                             draws=draws)
        want = history[i][1]
        np.testing.assert_allclose(float(metrics["loss"]), float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(metrics["lr"], float(want["lr"]), rtol=1e-6)
        np.testing.assert_allclose(metrics["ema_beta"], float(want["ema_beta"]), rtol=1e-6)
    assert [h[1]["lr"] > 0 for h in history[:3]] == [False, True, True]
    final = history[2][0]
    assert state.nimg == int(final.nimg) == 24
    _assert_tree_close(state.net, final.params, "parameters")
    _assert_tree_close(state.ema, final.ema_params, "EMA")
    moved = max(float((p.detach() - state_dict_from_flax(params0)[n]).abs().max())
                for n, p in state.net.named_parameters())
    assert moved > 1e-4  # the comparison is of a net that trained


def test_train_state_from_flax_continues_a_jax_run(jax_run):
    """A JAX TrainState after 3 steps, carried across (parameters, EMA,
    Adam's moments and count, nimg), takes the 4th step in the port and
    lands where JAX's 4th step does."""
    _, history, keys = jax_run
    after3, after4 = history[2][0], history[3][0]
    adam = after3.opt_state.inner_state[0]
    cfg = TrainConfig(**CFG)
    state = checkpoints.train_state_from_flax(
        _tiny_port_net(), cfg, after3.params, after3.ema_params, adam.mu, adam.nu,
        int(adam.count), int(after3.nimg))
    assert state.nimg == 24
    images, labels = _batches(4)
    metrics = train_step(state, _t(images[3]), _t(labels[3]), t_loss.EDMLoss(), cfg,
                         draws=_step_draws(keys[3], images.shape[2:], 2))
    np.testing.assert_allclose(float(metrics["loss"]), float(history[3][1]["loss"]), rtol=1e-5)
    _assert_tree_close(state.net, after4.params, "parameters")
    _assert_tree_close(state.ema, after4.ema_params, "EMA")


def test_train_step_scrubs_non_finite_gradients():
    cfg = TrainConfig(lr=1e-3, grad_accum_rounds=1, total_batch=4, lr_rampup_kimg=0.0)
    state = TrainState.create(load_into(_tiny_port_net(), random_state_dict(_tiny_port_net(), 0)),
                              cfg)
    state.nimg = 4
    images, labels = _batches(1)
    bad = lambda *a, **kw: t_loss.EDMLoss()(*a, **kw) * float("inf")
    train_step(state, _t(images[0][:1]), _t(labels[0][:1]), bad, cfg, rng.generator(0))
    assert all(torch.isfinite(p).all() for p in state.net.parameters())


# ------------------------------------------------------- data and checkpoints


@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 3)])
def test_sampler_stream_matches_jax(shard, num_shards):
    kw = dict(shard=shard, num_shards=num_shards, seed=5)
    ours, theirs = (iter(m.InfiniteSampler(37, **kw)) for m in (dataset, j_dataset))
    assert [next(ours) for _ in range(200)] == [next(theirs) for _ in range(200)]


def test_batches_match_jax():
    g = np.random.default_rng(6)
    images = g.integers(0, 255, (20, 8, 8, 3), dtype=np.uint8)
    labels = g.integers(0, 5, (20,))
    its = [m.batch_iterator(m.ImageDataset(images, labels, xflip=True, max_size=12), 6, seed=3)
           for m in (dataset, j_dataset)]
    for _ in range(5):
        (xa, la), (xb, lb) = next(its[0]), next(its[1])
        assert xa.dtype == np.float32 and xa.shape == (6, 8, 8, 3) and la.shape == (6, 5)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(la, lb)


def _fresh_state(cfg, dropout=0.1):
    net = _tiny_port_net(dropout=dropout)
    return TrainState.create(load_into(net, random_state_dict(net, 7)), cfg)


def _run_steps(state, cfg, first, last):
    images, labels = _batches(4, seed=30)
    for i in range(first, last):
        gen = rng.generator(9, state.nimg)  # as the loop seeds every step
        train_step(state, _t(images[i]), _t(labels[i]), t_loss.EDMLoss(), cfg, gen)
    return state


def test_state_round_trip_and_bit_identical_resume(tmp_path):
    """2 steps, a state dump, a load into a fresh state, 2 more steps: bit
    for bit the 4 uninterrupted steps (dropout on, so the generator's
    addressing by nimg is part of what is checked)."""
    cfg = TrainConfig(**dict(CFG, lr_rampup_kimg=0.0))
    straight = _run_steps(_fresh_state(cfg), cfg, 0, 4)
    half = _run_steps(_fresh_state(cfg), cfg, 0, 2)
    path = str(tmp_path / "training-state-000000.pt")
    checkpoints.save_state(path, half)
    resumed = checkpoints.load_state(path, like=_fresh_state(cfg))
    assert resumed.nimg == 16
    for a, b in zip(resumed.net.parameters(), half.net.parameters()):
        assert torch.equal(a, b)
    _run_steps(resumed, cfg, 2, 4)
    assert resumed.nimg == straight.nimg == 32
    for mod in ("net", "ema"):
        for (n, a), b in zip(getattr(resumed, mod).named_parameters(),
                             getattr(straight, mod).parameters()):
            assert torch.equal(a, b), f"{mod}.{n} differs after the resume"
    for a, b in zip(resumed.opt.state.values(), straight.opt.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]) and a["step"] == b["step"]


def test_snapshot_round_trip_and_format_version(tmp_path):
    cfg = TrainConfig(**CFG)
    state = _fresh_state(cfg)
    path = str(tmp_path / "run" / "network-snapshot-000012.pt")
    config = dict(precond="edm", img_resolution=16, model_kwargs=dict(TINY_ADM_KW))
    checkpoints.save_snapshot(path, state.ema.state_dict(), config)
    loaded, got_config = checkpoints.load_snapshot(path)
    assert got_config["ckpt_format_version"] == checkpoints.CKPT_FORMAT_VERSION == 2
    assert got_config["img_resolution"] == 16
    for k, v in state.ema.state_dict().items():
        assert torch.equal(loaded[k], v)
    assert checkpoints.parse_kimg_from_name(path) == 12
    assert checkpoints.parse_kimg_from_name("runs/training-state-000345") == 345

    with open(path + ".config.json") as f:
        stale = json.load(f)
    stale["ckpt_format_version"] = 1
    with open(path + ".config.json", "w") as f:
        json.dump(stale, f)
    with pytest.raises(ValueError, match="parameter-layout version 1"):
        checkpoints.load_snapshot(path)

    dump = str(tmp_path / "training-state-000000.pt")
    checkpoints.save_state(dump, state)
    payload = torch.load(dump, weights_only=True)
    del payload["ckpt_format_version"]
    torch.save(payload, dump)
    with pytest.raises(ValueError, match="parameter-layout version None"):
        checkpoints.load_state(dump, like=_fresh_state(cfg))
