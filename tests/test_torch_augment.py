"""The port's augmentation pipe (diffusion_tts_torch/training/augment.py)
against the JAX pipe on the CPU, and three augmented train steps against
make_train_step.

torch cannot replay JAX's threefry bits, so both pipes get the same
post-gate parameter values through their ``draws=`` hook. Tolerances: the
images within 1e-5 of their largest magnitude (fp32 in both, the warp's
convolutions and grid sample summed in another order); the labels equal,
except that a label made of a cos or a sin may differ in its last place:
the port takes cos and sin in float64 rounded to float32 (so that the card
and the CPU agree bit for bit) and XLA's float32 cos and sin differ from
that rounding on about 1% of arguments, so those columns hold 1e-6 (one
float32 ulp of a value under 8). The train steps hold the tolerances of
tests/test_torch_training.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.models.torch_import import (
    load_into,
    random_state_dict,
    state_dict_from_flax,
)
from diffusion_tts_torch.training import checkpoints
from diffusion_tts_torch.training import augment as t_aug
from diffusion_tts_torch.training import loss as t_loss
from diffusion_tts_torch.training.train_step import TrainConfig, TrainState, train_step
from diffusion_tts_torch.utils import rng
from diffusion_tts_tpu.models import preconds as j_preconds
from diffusion_tts_tpu.training import augment as j_aug
from diffusion_tts_tpu.training import loss as j_loss
from diffusion_tts_tpu.training import train_step as j_step

from _torch_port import TINY_ADM_KW, random_flax_params
from test_torch_training import CFG, _assert_tree_close, _batches, _loss_draws, _t, _tiny_port_net

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

PIXEL = ("xflip", "yflip", "rotate_int", "translate_int")
GEOMETRIC = ("scale", "rotate_frac", "aniso", "translate_frac")
COLOR = ("brightness", "contrast", "lumaflip", "hue", "saturation")
# label columns of each option; True where the column is made of a cos or sin
TRIG = {"rotate_frac": (True, True), "aniso": (True, True), "hue": (True, True)}
SHAPES = ((4, 16, 16, 3), (4, 16, 16, 1), (4, 12, 20, 3), (4, 13, 17, 3))


def _draws(seed, n):
    """Post-gate values of every option, about a third of them gated to 0."""
    g = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    gate = lambda *shape: g.uniform(size=shape[-1:]) < 0.7
    return dict(
        xflip=f(g.integers(0, 2, n)), yflip=f(g.integers(0, 2, n)),
        rotate_int=f(g.integers(0, 4, n) * gate(n)),
        translate_int=f(g.uniform(-1, 1, (2, n)) * gate(2, n)),
        scale=f(g.standard_normal(n) * gate(n)),
        rotate_frac=f(g.uniform(-np.pi, np.pi, n) * gate(n)),
        aniso_w=f(g.standard_normal(n) * gate(n)), aniso_r=f(g.uniform(-np.pi, np.pi, n) * gate(n)),
        translate_frac=f(g.standard_normal((2, n)) * gate(2, n)),
        brightness=f(g.standard_normal(n) * gate(n)), contrast=f(g.standard_normal(n) * gate(n)),
        lumaflip=f(g.integers(0, 2, n)), hue=f(g.uniform(-np.pi, np.pi, n) * gate(n)),
        saturation=f(g.standard_normal(n) * gate(n)))


def _trig_columns(pipe):
    """Per label column, whether it is made of a cos or a sin (JAX order)."""
    cols = []
    for attr, width in (("xflip", 1), ("yflip", 1), ("rotate_int", 2), ("translate_int", 2),
                        ("scale", 1), ("rotate_frac", 2), ("aniso", 2), ("translate_frac", 2),
                        ("brightness", 1), ("contrast", 1), ("lumaflip", 1), ("hue", 2),
                        ("saturation", 1)):
        if getattr(pipe, attr) > 0:
            cols += list(TRIG.get(attr, (False,) * width))
    return np.asarray(cols, bool)


def _assert_pipes_agree(kw, x, draws):
    want, want_lab = j_aug.AugmentPipe(**kw)(jnp.asarray(x), jax.random.key(0), draws=draws)
    pipe = t_aug.AugmentPipe(**kw)
    got, got_lab = pipe(torch.from_numpy(x), draws=draws)
    want, want_lab = np.asarray(want), np.asarray(want_lab)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    trig = _trig_columns(pipe)
    assert got_lab.shape == want_lab.shape == (x.shape[0], pipe.label_dim) == (x.shape[0],
                                                                               len(trig))
    np.testing.assert_array_equal(got_lab.numpy()[:, ~trig], want_lab[:, ~trig])
    np.testing.assert_allclose(got_lab.numpy()[:, trig], want_lab[:, trig], rtol=0, atol=1e-6)
    return got


def _cases():
    for opt in PIXEL + GEOMETRIC + COLOR:
        shapes = SHAPES if opt not in COLOR else SHAPES[:2]
        for shape in shapes:
            if opt == "rotate_int" and shape[1] != shape[2]:
                shape = (4, 15, 15, 3)  # rotate_int needs square images: the odd square
            for filtered in ((True, False) if opt in GEOMETRIC else (True,)):
                yield pytest.param(opt, shape, filtered,
                                   id=f"{opt}-{'x'.join(map(str, shape))}-"
                                      f"{'filtered' if filtered else 'bilinear'}")


@pytest.mark.parametrize("opt,shape,filtered", list(_cases()))
def test_each_option_matches_jax(opt, shape, filtered):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    out = _assert_pipes_agree({opt: 1.0, "filtered": filtered}, x, _draws(len(opt), shape[0]))
    if not (opt in ("hue", "saturation") and shape[-1] == 1):  # those leave gray images be
        assert not torch.equal(out, torch.from_numpy(x))  # the option moved something


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("filtered", [True, False])
def test_edm_pipe_matches_jax(shape, filtered):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    kw = {f.name: getattr(t_aug.edm_augment_pipe(), f.name)
          for f in t_aug.AugmentPipe.__dataclass_fields__.values()}
    kw["filtered"] = filtered
    _assert_pipes_agree(kw, x, _draws(3, shape[0]))


def test_all_options_together_match_jax():
    kw = dict.fromkeys(PIXEL + GEOMETRIC + COLOR, 1.0)
    x = np.random.default_rng(8).standard_normal((4, 16, 16, 3)).astype(np.float32)
    _assert_pipes_agree(kw, x, _draws(4, 4))


@pytest.mark.parametrize("opts", [(), ("xflip",), ("rotate_int", "translate_int"),
                                  GEOMETRIC, COLOR, PIXEL + GEOMETRIC + COLOR])
def test_label_dim_matches_jax(opts):
    kw = dict.fromkeys(opts, 0.5)
    pipe = t_aug.AugmentPipe(**kw)
    assert pipe.label_dim == j_aug.AugmentPipe(**kw).label_dim
    _, labels = pipe(torch.zeros((2, 8, 8, 3)), rng.generator(0))
    assert labels.shape == (2, pipe.label_dim)
    assert t_aug.edm_augment_pipe().label_dim == j_aug.edm_augment_pipe().label_dim == 9
    assert t_aug.edm_augment_pipe(0.3) == t_aug.AugmentPipe(
        p=0.3, xflip=1e8, yflip=1, scale=1, rotate_frac=1, aniso=1, translate_frac=1)


def test_identity_keeps_a_constant_image():
    """Zero draws: the sym6 up and down cascade has unit DC gain, so a
    constant image stays constant (1e-3, as the JAX package's own test);
    every label is 0."""
    x = torch.full((2, 12, 12, 3), 0.625)
    zero = {k: np.zeros_like(v) for k, v in _draws(0, 2).items()}
    out, labels = t_aug.edm_augment_pipe()(x, draws=zero)
    assert out.shape == x.shape
    torch.testing.assert_close(out, x, atol=1e-3, rtol=0)
    assert not labels.any()
    out, _ = t_aug._filtered_warp(x, torch.eye(3).expand(2, 3, 3)), None
    torch.testing.assert_close(out, x, atol=1e-3, rtol=0)


def test_same_seed_same_output():
    x = torch.randn((8, 16, 16, 3), generator=rng.generator(1))
    pipe = t_aug.AugmentPipe(p=0.5, **dict.fromkeys(PIXEL + GEOMETRIC + COLOR, 1.0))
    a, b, c = (pipe(x, rng.generator(s)) for s in (5, 5, 6))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])


def _within_4_sigma(name, hits, p):
    n = hits.numel()
    freq = hits.float().mean().item()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(freq - p) <= 4 * sigma, f"{name}: {freq:.4f} vs {p:.4f} +- 4 x {sigma:.4f}"


def test_edm_pipe_gate_frequencies():
    """4096 samples through the EDM pipe at p = 0.12: xflip (1e8, always
    past its gate) is a fair coin; yflip flips at p/2; scale, rotate_frac,
    aniso and translate_frac fire at p, aniso's rotation at p/2 and
    translate_frac's x and y together."""
    n, p = 4096, 0.12
    _, lab = t_aug.edm_augment_pipe(p)(torch.zeros((n, 4, 4, 3)), rng.generator(3))
    xflip, yflip, scale, rot_c, rot_s, an_c, an_s, tx, ty = lab.unbind(1)
    _within_4_sigma("xflip", xflip == 1, 0.5)
    _within_4_sigma("yflip", yflip == 1, p / 2)
    _within_4_sigma("scale", scale != 0, p)
    _within_4_sigma("rotate_frac", rot_s != 0, p)
    _within_4_sigma("aniso", an_c != 0, p)
    _within_4_sigma("aniso rotation", an_s != 0, p / 2)
    _within_4_sigma("translate_frac", tx != 0, p)
    assert torch.equal(tx != 0, ty != 0)


def test_other_options_gate_frequencies():
    """4096 samples, every other option at probability 1 and p = 0.5:
    rotate_int turns in 3 of 4 draws past its gate; brightness, contrast,
    hue and saturation fire at p; lumaflip flips at p/2; translate_int
    (x and y behind one gate) moves a 64x64 image unless both of its
    uniform draws round to 0 pixels (|w| * 8 < 1/2: 1 in 16 each)."""
    n, p = 4096, 0.5
    pipe = t_aug.AugmentPipe(p=p, rotate_int=1, translate_int=1, **dict.fromkeys(COLOR, 1.0))
    _, lab = pipe(torch.zeros((n, 64, 64, 3)), rng.generator(4))
    rx, ry, tx, ty, bright, contrast, luma, hue_c, hue_s, sat = lab.unbind(1)
    _within_4_sigma("rotate_int", (rx != 0) | (ry != 0), p * 3 / 4)
    _within_4_sigma("translate_int", (tx != 0) | (ty != 0), p * (1 - 1 / 16**2))
    for name, col in (("brightness", bright), ("contrast", contrast), ("hue", hue_s),
                      ("saturation", sat)):
        _within_4_sigma(name, col != 0, p)
    _within_4_sigma("lumaflip", luma == 1, p / 2)


# ------------------------------------------------------- augmented train steps


def _augment_draws(key, n):
    """The JAX wrapper's draws from the pipe's key: every EDM-pipe option
    with about half of each gated to 0 (post-gate values)."""
    ks = jax.random.split(key, 8)
    gate = lambda k, shape: (jax.random.uniform(k, shape) < 0.5).astype(jnp.float32)
    return dict(
        xflip=jax.random.randint(ks[0], (n,), 0, 2).astype(jnp.float32),
        yflip=jax.random.randint(ks[1], (n,), 0, 2).astype(jnp.float32) * gate(ks[2], (n,)),
        scale=jax.random.normal(ks[3], (n,)) * gate(ks[2], (n,))[::-1],
        rotate_frac=jax.random.uniform(ks[4], (n,), minval=-np.pi, maxval=np.pi),
        aniso_w=jax.random.normal(ks[5], (n,)),
        aniso_r=jax.random.uniform(ks[6], (n,), minval=-np.pi, maxval=np.pi),
        translate_frac=jax.random.normal(ks[7], (2, n)) * gate(ks[0], (1, n)))


def _step_draws_with_augment(key, shape, rounds):
    """One JAX step's draws (train_step.py:80-90, loss.py:69-75), the pipe's
    from its key k3 included."""
    out = []
    for k in jax.random.split(key, rounds):
        k_loss = jax.random.split(k)[0]
        draws = _loss_draws(k_loss, shape, uniform=False)
        k3 = jax.random.split(k_loss, 3)[2]
        draws["augment_draws"] = {name: np.asarray(v)
                                  for name, v in _augment_draws(k3, shape[0]).items()}
        out.append(draws)
    return out


@pytest.fixture(scope="module")
def jax_augmented_run():
    """3 JAX steps of the tiny EDMPrecond with augment_dim 9 under the EDM
    pipe at p = 1, its draws made from the pipe's key by _augment_draws."""
    kw = dict(img_resolution=16, img_channels=3, label_dim=10, model_type="DhariwalUNet",
              model_kwargs=dict(TINY_ADM_KW, augment_dim=9))
    j_net = j_preconds.EDMPrecond(**kw)
    shapes = jax.eval_shape(lambda: j_net.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)),
        jnp.zeros((1, 10)), jnp.zeros((1, 9))))
    params = random_flax_params(shapes["params"], 31)
    pipe = j_aug.edm_augment_pipe(p=1.0)
    augment_fn = lambda images, key: pipe(images, key,
                                          draws=_augment_draws(key, images.shape[0]))
    cfg = j_step.TrainConfig(**CFG)
    tx = j_step.make_optimizer(cfg)
    apply = lambda p, x, s, lab, al, rng=None: j_net.apply({"params": p}, x, s, lab,
                                                           augment_labels=al)
    step = jax.jit(j_step.make_train_step(j_loss.EDMLoss(), apply, cfg, tx, augment_fn))
    state = j_step.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    images, labels = _batches(3, seed=32)
    keys = jax.random.split(jax.random.key(33), 3)
    history = []
    for i in range(3):
        state, metrics = step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]), keys[i])
        history.append((jax.device_get(state), jax.device_get(metrics)))
    return params, history, keys


def test_three_augmented_train_steps_match_jax(jax_augmented_run):
    """3 steps of train_step with the port's EDM pipe (R = 2, fp32) against
    make_train_step with the JAX pipe, the loss's and the pipe's draws
    injected: each step's loss, lr and ema_beta, the parameters and the EMA
    at the end, map_augment's among them."""
    params0, history, keys = jax_augmented_run
    cfg = TrainConfig(**CFG)
    net = load_into(_tiny_port_net(augment_dim=9), state_dict_from_flax(params0))
    state = TrainState.create(net, cfg)
    images, labels = _batches(3, seed=32)
    pipe = t_aug.edm_augment_pipe(p=1.0)
    for i in range(3):
        draws = _step_draws_with_augment(keys[i], images.shape[2:], cfg.grad_accum_rounds)
        metrics = train_step(state, _t(images[i]), _t(labels[i]), t_loss.EDMLoss(), cfg,
                             augment_fn=pipe, draws=draws)
        want = history[i][1]
        np.testing.assert_allclose(float(metrics["loss"]), float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(metrics["lr"], float(want["lr"]), rtol=1e-6)
        np.testing.assert_allclose(metrics["ema_beta"], float(want["ema_beta"]), rtol=1e-6)
    final = history[2][0]
    assert state.nimg == int(final.nimg) == 24
    _assert_tree_close(state.net, final.params, "parameters")
    _assert_tree_close(state.ema, final.ema_params, "EMA")
    start = state_dict_from_flax(params0)["model.map_augment.weight"]
    assert float((state.net.model.map_augment.weight.detach() - start).abs().max()) > 1e-4


def test_loss_draws_the_pipe_from_its_generator():
    """Without injected draws the pipe draws from the loss's generator: the
    same seed gives the same loss, another seed another."""
    images = torch.rand((4, 8, 8, 3), generator=rng.generator(0)) * 2 - 1
    seen = []
    denoise = lambda x, s, lab, al: seen.append(al) or x * 0.5
    pipe = t_aug.edm_augment_pipe(p=1.0)
    run = lambda seed: t_loss.EDMLoss()(denoise, images, None, rng.generator(seed), pipe)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert seen[0].shape == (4, 9) and torch.equal(seen[0], seen[1])


def test_augmented_resume_is_bit_identical(tmp_path):
    """2 augmented steps, a state dump, a load, 2 more: bit for bit the 4
    uninterrupted steps, the pipe drawing from each step's generator,
    seeded from (seed, nimg) as the loop seeds it."""
    cfg = TrainConfig(**dict(CFG, lr_rampup_kimg=0.0))
    pipe = t_aug.edm_augment_pipe(p=0.5)
    images, labels = _batches(4, seed=34)

    def fresh():
        net = _tiny_port_net(augment_dim=9)
        return TrainState.create(load_into(net, random_state_dict(net, 8)), cfg)

    def run(state, first, last):
        for i in range(first, last):
            train_step(state, _t(images[i]), _t(labels[i]), t_loss.EDMLoss(), cfg,
                       rng.generator(9, state.nimg), pipe)
        return state

    straight = run(fresh(), 0, 4)
    path = str(tmp_path / "training-state-000000.pt")
    checkpoints.save_state(path, run(fresh(), 0, 2))
    resumed = run(checkpoints.load_state(path, like=fresh()), 2, 4)
    for (name, a), b in zip(resumed.net.named_parameters(), straight.net.parameters()):
        assert torch.equal(a, b), f"{name} differs after the resume"
