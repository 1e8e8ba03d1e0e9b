"""The port's SD lookahead bench (diffusion_tts_torch/tools/sd_bench.py)
against the JAX tool (tools/sd_bench.py).

The unit: ``sd_bench.lookahead`` on tests/_torch_port.py's golden-geometry
UNet and VAE with shared weights, fp32, 3 iterations, against the JAX
tool's scan body (tools/sd_bench.py:93-108; the tool exposes no function,
so it is restated here with the JAX modules). Each iteration's scores agree
within 1e-4 of their largest magnitude and the final latents within 1e-4
of theirs; the picks are equal wherever the top two scores differ by more
than that tolerance. Then the CPU line's keys against the JAX tool's
``out = dict(...)`` and the tiny geometry's parameter counts against the
JAX tool's tiny modules (tools/sd_bench.py:48-57)."""
import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.models.sd_unet import UNet2DConditionModel
from diffusion_tts_torch.models.sd_vae import AutoencoderKL
from diffusion_tts_torch.tools import sd_bench
from diffusion_tts_tpu.models.sd_unet import UNet2DConditionModel as JUNet
from diffusion_tts_tpu.models.sd_vae import AutoencoderKL as JVAE

from _torch_port import tiny_sd_pair

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
N, B, ITERS, RES, CTX_DIM = 3, 2, 3, 16, 32


def jax_step(j_unet, j_vae, n, b, ctx):
    """One iteration of the JAX tool's scan body (tools/sd_bench.py:93-108)
    as a jitted (params, lat, eps, k) -> (new latents, scores [N, B])."""
    def body(up, vp, lat, eps, k):
        cands = lat[None] + 0.05 * eps * (k + 1.0)
        flat = cands.reshape((n * b,) + lat.shape[1:])
        inp = jnp.concatenate([flat, flat])
        tt = jnp.full((2 * n * b,), 500.0)
        cc = jnp.tile(ctx, (n, 1, 1))
        pred = j_unet.apply({"params": up}, inp, tt, cc)
        uncond, cond = jnp.split(pred, 2)
        noise_pred = uncond + 7.5 * (cond - uncond)
        pred_x0 = flat - 0.8 * noise_pred
        images = j_vae.apply({"params": vp}, pred_x0 / 0.18215, method=j_vae.decode)
        scores = images.mean(axis=(1, 2, 3)).reshape(n, b)
        best = jnp.argmax(scores, axis=0)
        new_lat = jnp.take_along_axis(cands, best.reshape((1, b, 1, 1, 1)), axis=0)[0]
        return new_lat.astype(lat.dtype), scores

    return jax.jit(body)


def test_lookahead_matches_the_jax_body():
    j_unet, up, j_vae, vp, t_unet, t_vae = tiny_sd_pair(seed=3)
    g = np.random.default_rng(4)
    lat = g.standard_normal((B, RES, RES, 4)).astype(np.float32)
    eps = g.standard_normal((N, B, RES, RES, 4)).astype(np.float32)
    ctx = g.standard_normal((2 * B, 7, CTX_DIM)).astype(np.float32)

    step = jax_step(j_unet, j_vae, N, B, jnp.asarray(ctx))
    j_lat, j_scores = jnp.asarray(lat), []
    for k in range(ITERS):
        j_lat, s = step(up, vp, j_lat, jnp.asarray(eps), jnp.float32(k))
        j_scores.append(np.asarray(s))
    j_scores, j_lat = np.stack(j_scores), np.asarray(j_lat)

    t_lat, t_scores = sd_bench.lookahead(
        t_unet, t_vae, torch.from_numpy(lat).permute(0, 3, 1, 2),
        torch.from_numpy(eps).permute(0, 1, 4, 2, 3), torch.from_numpy(ctx), ITERS)
    t_scores, t_lat = t_scores.numpy(), t_lat.permute(0, 2, 3, 1).numpy()

    assert t_scores.shape == j_scores.shape == (ITERS, N, B)
    for k in range(ITERS):
        scale = np.abs(j_scores[k]).max()
        assert np.abs(t_scores[k] - j_scores[k]).max() <= TOL * scale, k
        top2 = np.sort(j_scores[k], axis=0)[-2:]
        clear = top2[1] - top2[0] > TOL * scale
        np.testing.assert_array_equal(t_scores[k].argmax(0)[clear], j_scores[k].argmax(0)[clear])
        assert clear.all(), f"iteration {k}: a near tie leaves the pick untested"
    assert np.abs(t_lat - j_lat).max() <= TOL * np.abs(j_lat).max()


def _jax_out_keys() -> set[str]:
    with open(os.path.join(ROOT, "tools", "sd_bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "out"
                and isinstance(node.value, ast.Call)):
            return {kw.arg for kw in node.value.keywords}
    raise AssertionError("no out = dict(...) in tools/sd_bench.py")


def test_cpu_line_has_the_jax_tools_keys(capsys):
    out = sd_bench.main(["--device", "cpu", "--iters", "1"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert lines == [out]
    assert set(out) == _jax_out_keys()
    assert out["metric"] == "sd_tiny (cpu smoke)" and out["unit"] == "NFE/s"
    assert out["value"] > 0 and out["batch"] == 1 and out["n_candidates"] == 4
    assert out["device"] == "cpu"


def _jax_count(module, *args, **kw) -> int:
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.key(0)}, *args, **kw))
    return sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("part", ["unet", "vae"])
def test_tiny_geometry_has_the_jax_tools_parameter_counts(part):
    """The JAX tool's tiny modules (tools/sd_bench.py:48-57); the VAE's
    decode path (post_quant_conv and the decoder), which is all that its
    ``init(..., method=vae.decode)`` creates."""
    if part == "unet":
        mine = UNet2DConditionModel(**sd_bench.TINY_UNET)
        want = _jax_count(JUNet(**sd_bench.TINY_UNET), jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,)),
                          jnp.zeros((2, 77, 64)))
        got = sum(p.numel() for p in mine.parameters())
    else:
        mine = AutoencoderKL(**sd_bench.TINY_VAE)
        j_vae = JVAE(**sd_bench.TINY_VAE)
        want = _jax_count(j_vae, jnp.zeros((1, 8, 8, 4)), method=j_vae.decode)
        got = sum(p.numel() for m in (mine.post_quant_conv, mine.decoder)
                  for p in m.parameters())
    assert got == want
