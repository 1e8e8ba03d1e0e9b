"""The port's SongUNet (DDPM++ / NCSN++, diffusion_tts_torch/models) against
the reference goldens and the JAX package on the CPU: the three golden
variants, the same variants with random weights carried across from flax,
the d = 256 attention of its single head (the plain twins of kernels #1 and
#3 against the Pallas kernel in interpret mode), three train steps under
the VP and VE losses, the eps-greedy search at ``--arch tiny`` and the CLI.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch import main as t_main
from diffusion_tts_torch.backends import edm_entry
from diffusion_tts_torch.models.edm_nets import SongUNet
from diffusion_tts_torch.models.preconds import EDMPrecond, VEPrecond, VPPrecond
from diffusion_tts_torch.models.torch_import import (
    flax_buffers_from_state_dict,
    flax_from_state_dict,
    load_into,
    load_reference_state_dict,
    random_state_dict,
    state_dict_from_flax,
)
from diffusion_tts_torch.ops.kernels import qkv_attention as t_kernel
from diffusion_tts_torch.samplers.edm import EDMHeunSampler
from diffusion_tts_torch.scorers import BrightnessScorer
from diffusion_tts_torch.search import EDMSearchBackend, InjectedNoise, run_search
from diffusion_tts_torch.training import loss as t_loss
from diffusion_tts_torch.training.train_step import TrainConfig, TrainState, train_step
from diffusion_tts_torch.utils import rng
from diffusion_tts_torch.utils.config import SearchParams
from diffusion_tts_tpu.models import edm_nets as j_nets
from diffusion_tts_tpu.models import preconds as j_preconds
from diffusion_tts_tpu.ops.pallas.attention import _qkv_attention_reference, qkv_self_attention
from diffusion_tts_tpu.samplers.edm import EDMHeunSampler as JEDMHeunSampler
from diffusion_tts_tpu.scorers.brightness import BrightnessScorer as JBrightnessScorer
from diffusion_tts_tpu.search.api import run_search as j_run_search
from diffusion_tts_tpu.search.backend import EDMSearchBackend as JEDMSearchBackend
from diffusion_tts_tpu.search.noise import record_zero_order_draws
from diffusion_tts_tpu.training import loss as j_loss
from diffusion_tts_tpu.training import train_step as j_step
from diffusion_tts_tpu.utils.config import SearchParams as JSearchParams

from _torch_port import GOLDENS, random_flax_params
from test_torch_training import CFG, _batches, _loss_draws, _t, _without_k_bias

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

# tests/test_edm_nets_parity.py's SongUNet geometry
SONG_KW = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,),
               dropout=0.0)
VARIANTS = {
    "songunet_ddpmpp": dict(label_dim=10),
    "songunet_ncsnpp": dict(label_dim=0, embedding_type="fourier", channel_mult_noise=2,
                            encoder_type="residual", decoder_type="skip",
                            resample_filter=(1, 3, 3, 1)),
    "songunet_skipenc": dict(label_dim=0, encoder_type="skip"),
}


def _golden(name):
    with np.load(os.path.join(GOLDENS, f"{name}.npz")) as f:
        data = {k: f[k] for k in f.files}
    state = {k[4:]: v for k, v in data.items() if k.startswith("sd::")}
    inputs = {k[4:]: v for k, v in data.items() if k.startswith("in::")}
    return state, inputs, data["out::y"]


def _song(name, **extra):
    return SongUNet(img_resolution=16, in_channels=3, out_channels=3,
                    **dict(SONG_KW, **VARIANTS[name], **extra))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_song_unet_golden(name):
    """The reference's forward on its own weights (tools/make_goldens.py),
    at the JAX parity test's tolerance."""
    state, inputs, golden = _golden(name)
    net = load_into(_song(name), load_reference_state_dict(state)).eval()
    labels = inputs.get("class_labels")
    with torch.no_grad():
        y = net(torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["noise_labels"]),
                None if labels is None else torch.from_numpy(labels))
    np.testing.assert_allclose(y.numpy(), golden, atol=2e-4, rtol=2e-4)


def _flax_pair(name, seed, **extra):
    """The variant in both packages with the same random weights (every
    layer random, the Fourier table scale * N(0, 1)): (flax module, flax
    variables, port module)."""
    kw = dict(SONG_KW, **VARIANTS[name], **extra)
    j_net = j_nets.SongUNet(img_resolution=16, in_channels=3, out_channels=3, **kw)
    label_dim, augment_dim = kw["label_dim"], kw.get("augment_dim", 0)
    shapes = jax.eval_shape(lambda: j_net.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)),
        jnp.zeros((1, label_dim)) if label_dim else None,
        jnp.zeros((1, augment_dim)) if augment_dim else None))
    variables = {"params": random_flax_params(shapes["params"], seed)}
    if "buffers" in shapes:
        g = np.random.default_rng(seed + 1)
        variables["buffers"] = jax.tree_util.tree_map(
            lambda s: (16.0 * g.standard_normal(s.shape)).astype(np.float32), shapes["buffers"])
    t_net = load_into(_song(name, **extra), state_dict_from_flax(variables["params"],
                                                                 variables.get("buffers")))
    return j_net, variables, t_net.eval()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_tiny_song_unet_from_flax_matches_jax(name):
    """Each variant with the same random weights: the port against
    j_net.apply at 2e-4, and the output is the net's (not a near-zero
    residue of a zero-initialised last layer)."""
    j_net, variables, t_net = _flax_pair(name, seed=3)
    g = np.random.default_rng(4)
    x = g.standard_normal((2, 16, 16, 3)).astype(np.float32)
    noise = np.array([-0.7, 1.3], np.float32)
    labels = np.eye(10, dtype=np.float32)[[1, 7]] if VARIANTS[name]["label_dim"] else None
    y_j = np.asarray(j_net.apply(variables, x, noise, labels))
    with torch.no_grad():
        y_t = t_net(_t(x).permute(0, 3, 1, 2), _t(noise),
                    None if labels is None else _t(labels)).permute(0, 2, 3, 1)
    assert np.abs(y_j).max() > 0.1
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=2e-4, rtol=2e-4)


def test_flax_round_trip_keeps_buffers():
    """flax_from_state_dict / flax_buffers_from_state_dict invert
    state_dict_from_flax on the NCSN++ variant (its Fourier table included),
    and random_state_dict draws the table at the embedding's scale."""
    _, variables, t_net = _flax_pair("songunet_ncsnpp", seed=5)
    state = t_net.state_dict()
    flat = lambda tree: {jax.tree_util.keystr(k): v
                         for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    for got, want in ((flax_from_state_dict(state), variables["params"]),
                      (flax_buffers_from_state_dict(state), variables["buffers"])):
        got, want = flat(got), flat(want)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32))
    freqs = random_state_dict(t_net, 0)["map_noise.freqs"]
    assert freqs.shape == (16,) and 4.0 < float(freqs.std()) < 40.0


@pytest.mark.parametrize("label_dropout", [0.0, 1.0])
def test_song_unet_augment_and_label_dropout_match_flax(label_dropout):
    """augment_dim=9 and label_dropout in train mode: with rate 1 every label
    is dropped whatever the draw, so both packages give the unconditional
    embedding; with rate 0 none is."""
    j_net, variables, t_net = _flax_pair("songunet_ddpmpp", seed=6, augment_dim=9,
                                         label_dropout=label_dropout)
    g = np.random.default_rng(7)
    x = g.standard_normal((2, 16, 16, 3)).astype(np.float32)
    noise = np.array([-0.3, 0.8], np.float32)
    labels = np.eye(10, dtype=np.float32)[[2, 5]]
    aug = g.standard_normal((2, 9)).astype(np.float32)
    want = j_net.apply(variables, x, noise, labels, aug, train=True,
                       rngs={"label_dropout": jax.random.key(1)})
    t_net.train()
    run = lambda lab: t_net(_t(x).permute(0, 3, 1, 2), _t(noise), _t(lab), _t(aug),
                            rng.generator(0))
    got = run(labels)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=2e-4, rtol=2e-4)
    assert torch.equal(run(labels[::-1].copy()), got) == (label_dropout == 1.0)


def test_song_unet_bf16_runs_close_to_fp32():
    """The bf16 forward keeps the fp32 cast points (GN statistics, softmax):
    the net's output stays within 5e-2 of the fp32 forward's largest
    magnitude on the same weights."""
    net32, net16 = _song("songunet_ddpmpp"), _song("songunet_ddpmpp", dtype=torch.bfloat16)
    state = random_state_dict(net32, 8)
    load_into(net32, state).eval(), load_into(net16, state).eval()
    x = torch.randn((2, 3, 16, 16), generator=rng.generator(9))
    noise, labels = torch.tensor([-0.7, 1.3]), torch.eye(10)[:2]
    with torch.no_grad():
        y32, y16 = net32(x, noise, labels), net16(x, noise, labels)
    assert y16.dtype == torch.bfloat16 and torch.isfinite(y16).all()
    assert float((y16.float() - y32).abs().max()) <= 5e-2 * float(y32.abs().max())


# --------------------------------------------- the single head's attention, d = 256


def test_qkv_attention_plain_at_d256_matches_the_pallas_reference():
    """Kernel #1's twin at the DDPM++ net's width (one head of 256), fp32,
    against the JAX reference and the Pallas kernel in interpret mode."""
    x = np.random.default_rng(10).standard_normal((2, 64, 768)).astype(np.float32)
    got = t_kernel.qkv_self_attention_plain(torch.from_numpy(x), 1).numpy()
    np.testing.assert_allclose(got, np.asarray(_qkv_attention_reference(jnp.asarray(x), 1)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(qkv_self_attention(jnp.asarray(x), 1,
                                                                  interpret=True)),
                               atol=1e-5, rtol=1e-5)


def test_attention_bwd_plain_at_d256_matches_the_pallas_vjp():
    """Kernel #3's twin (through qkv_self_attention_bwd on the CPU) at d = 256
    against the VJP of the JAX qkv_self_attention run in interpret mode."""
    g = np.random.default_rng(11)
    x = g.standard_normal((2, 64, 768)).astype(np.float32)
    cot = g.standard_normal((2, 64, 256)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: qkv_self_attention(a, 1, interpret=True), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(cot))
    qkv = torch.from_numpy(x)
    got = t_kernel.qkv_self_attention_bwd(qkv, t_kernel.qkv_self_attention_plain(qkv, 1),
                                          torch.from_numpy(cot), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- training


def _precond_pair(cls_name, seed):
    kw = dict(img_resolution=16, img_channels=3, label_dim=10, model_type="SongUNet",
              model_kwargs=SONG_KW)
    j_net = getattr(j_preconds, cls_name)(**kw)
    shapes = jax.eval_shape(lambda: j_net.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)),
        jnp.zeros((1, 10))))
    params = random_flax_params(shapes["params"], seed)
    t_net = {"VPPrecond": VPPrecond, "VEPrecond": VEPrecond}[cls_name](
        param_dtype=torch.float32, **kw)
    return j_net, params, load_into(t_net, state_dict_from_flax(params))


@pytest.mark.parametrize("loss_name,cls_name", [("VPLoss", "VPPrecond"),
                                                ("VELoss", "VEPrecond")])
def test_three_song_unet_train_steps_match_jax(loss_name, cls_name):
    """3 steps of train_step (R = 2, fp32, dropout 0, same weights, same
    draws) of the tiny SongUNet under its loss and precond against
    make_train_step: each step's loss, lr and ema_beta; Adam's first moment
    after each step within 2e-4 of each tensor's largest (the gradients are
    summed in another order by each framework: 1.0e-4 under the VP loss,
    whose 1/sigma^2 weights span orders of magnitude, 1.2e-5 under VE); then
    parameters and EMA at test_torch_training.py's tolerance (1e-5 of the
    largest magnitude, the k third of every qkv bias left out). Adam divides
    each gradient by its own magnitude, so an element whose first moment is
    of the size of that round-off takes a step of a fraction of lr with a
    sign the two packages need not share. Such an element, one whose first
    moment differs between the packages by more than a tenth of itself at
    some step, is left out of the parameter comparison, and the test holds
    that such elements are few (186 / 108 of the net's 189,523)."""
    j_net, params0, t_net = _precond_pair(cls_name, seed=21)
    jcfg = j_step.TrainConfig(**CFG)
    tx = j_step.make_optimizer(jcfg)
    apply = lambda p, x, s, lab, al, rng=None: j_net.apply({"params": p}, x, s, lab,
                                                           augment_labels=al)
    step = jax.jit(j_step.make_train_step(getattr(j_loss, loss_name)(), apply, jcfg, tx))
    j_state = j_step.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params0), tx)
    cfg = TrainConfig(**CFG)
    state = TrainState.create(t_net, cfg)
    params = dict(state.net.named_parameters())
    round_off = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in params.items()}
    images, labels = _batches(3)
    keys = jax.random.split(jax.random.key(22), 3)
    for i in range(3):
        j_state, want = step(j_state, jnp.asarray(images[i]), jnp.asarray(labels[i]), keys[i])
        draws = [_loss_draws(jax.random.split(k)[0], images.shape[2:], uniform=True)
                 for k in jax.random.split(keys[i], cfg.grad_accum_rounds)]
        got = train_step(state, _t(images[i]), _t(labels[i]), getattr(t_loss, loss_name)(), cfg,
                         draws=draws)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
        np.testing.assert_allclose(got["ema_beta"], float(want["ema_beta"]), rtol=1e-6)
        mu = state_dict_from_flax(jax.device_get(j_state).opt_state.inner_state[0].mu)
        for n, p in params.items():
            err = (state.opt.state[p]["exp_avg"] - mu[n]).abs()
            assert float(err.max()) <= 2e-4 * float(mu[n].abs().max()), (i, n)
            round_off[n] |= err > 0.1 * mu[n].abs()
    final = jax.device_get(j_state)
    n_round_off = sum(int(m.sum()) for m in round_off.values())
    assert n_round_off <= 1e-3 * sum(p.numel() for p in params.values())
    for module, tree in ((state.net, final.params), (state.ema, final.ema_params)):
        want = state_dict_from_flax(tree)
        scale = max(float(v.abs().max()) for v in want.values())
        for n, p in module.named_parameters():
            diff = (p.detach() - want[n]).masked_fill(round_off[n], 0.0)
            assert float(_without_k_bias(n, diff).abs().max()) <= 1e-5 * scale, n
    moved = max(float((p.detach() - state_dict_from_flax(params0)[n]).abs().max())
                for n, p in state.net.named_parameters())
    assert moved > 1e-4  # the comparison is of a net that trained


# ------------------------------------------------------- search and the CLI

STEPS, N, K, B = 3, 2, 2, 2
CHURN = dict(num_steps=STEPS, S_churn=40.0, S_min=0.05, S_max=50.0, S_noise=1.003)


def test_tiny_eps_greedy_search_matches_jax():
    """eps-greedy on ``--arch tiny`` (the SongUNet at test width under
    EDMPrecond, edm_entry.load_network's random weights carried to the JAX
    package), fp32, one fully populated InjectedNoise: the same selections,
    scores within 1e-5."""
    t_net = edm_entry.load_network("tiny", device="cpu", seed=13)
    cfg = edm_entry.NET_CONFIGS["tiny"]
    j_net = j_preconds.EDMPrecond(**cfg)
    variables = {"params": flax_from_state_dict(t_net.state_dict())}
    g = np.random.default_rng(14)
    z = g.standard_normal((B, 16, 16, 3)).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[[3, 8]]
    j_backend = JEDMSearchBackend(
        sampler=JEDMHeunSampler(
            denoise=lambda x, s: j_net.apply(variables, x, s,
                                             jnp.tile(labels, (x.shape[0] // B, 1))),
            **CHURN),
        scorer=JBrightnessScorer())
    t_labels = torch.from_numpy(labels)
    t_backend = EDMSearchBackend(
        sampler=EDMHeunSampler(
            denoise=lambda x, s: t_net(x, s, t_labels.repeat(x.shape[0] // B, 1)), **CHURN),
        scorer=BrightnessScorer())
    draws = record_zero_order_draws(jax.random.key(15), STEPS, JSearchParams(N=N, K=K), z.shape)
    explore = np.asarray(draws.explore01) < SearchParams().eps
    assert explore.any() and not explore.all()  # both kinds of candidate slot occur
    j = j_run_search("eps_greedy", j_backend, jnp.asarray(z), jax.random.key(99),
                     JSearchParams(N=N, K=K), noise=draws, record_noises=True)
    inj = InjectedNoise(**{f: torch.from_numpy(np.array(getattr(draws, f)))
                           for f in ("pivots", "directions", "fresh", "scales01", "explore01")})
    with torch.no_grad():
        t = run_search("eps_greedy", t_backend, torch.from_numpy(z), 99,
                       SearchParams(N=N, K=K), noise=inj, record_noises=True)
    assert t.best_noises.shape == (STEPS, K, B, 16, 16, 3)
    np.testing.assert_allclose(t.best_noises.numpy(), np.asarray(j.best_noises), atol=1e-5)
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score), atol=1e-5)


@pytest.mark.parametrize("arch", ["tiny", "tiny_adm"])
def test_cli_serves_the_test_width_arches(arch, tmp_path, capsys):
    out = str(tmp_path / "grid.png")
    t_main.main(["--backend", "edm", "--arch", arch, "--scorer", "brightness", "--method",
                 "eps_greedy", "--device", "cpu", "--N", "2", "--K", "1", "--num-steps", "2",
                 "--output", out])
    assert os.path.exists(out) and "Average score" in capsys.readouterr().out


def test_cli_imagenet_scorer_names_the_arches_it_serves(tmp_path):
    with pytest.raises(ValueError, match="no classifier for --arch cifar10"):
        t_main.main(["--backend", "edm", "--arch", "cifar10", "--scorer", "imagenet",
                     "--device", "cpu", "--output", str(tmp_path / "x.png")])


def test_cifar10_config_is_the_reference_ddpmpp():
    """edm_entry's CIFAR-10 net: the JAX package's CIFAR10_DDPMPP, about 56M
    parameters (the reference's DDPM++ at 32x32 with 10 classes)."""
    from diffusion_tts_tpu.backends import edm_entry as j_entry

    assert edm_entry.NET_CONFIGS["cifar10"] == j_entry.CIFAR10_DDPMPP
    assert edm_entry.NET_CONFIGS["tiny"] == j_entry.TINY_SMOKE
    with torch.device("meta"):
        net = EDMPrecond(**edm_entry.NET_CONFIGS["cifar10"])
    assert 55e6 < sum(p.numel() for p in net.parameters()) < 57e6
