"""The port's attention backward and the gradients of its kernel wrappers
against the JAX package, on the CPU.

On the CPU the wrappers' backward is the plain twin of the CUDA backward
kernels (``attention_bwd_plain``); it is held against the JAX package's
``_attention_bwd_explicit`` and against its Pallas flash backward in
interpret mode, with the JAX test's own tolerances
(tests/test_pallas_attention.py: fp32 2e-5, bf16 4e-2). The forward-only
kernels' wrappers take their twin's gradient; each is held against
``jax.grad`` through the JAX function's jnp reference. The CUDA kernels are
held against the twins on the card (tests/test_torch_kernels_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.ops import attention as t_attention
from diffusion_tts_torch.ops.kernels import conv3x3 as t_conv
from diffusion_tts_torch.ops.kernels import geglu_ff as t_geglu
from diffusion_tts_torch.ops.kernels import groupnorm as t_gn
from diffusion_tts_torch.ops.kernels import qkv_attention as t_kernel
from diffusion_tts_tpu.ops import attention as j_attention
from diffusion_tts_tpu.ops.pallas import conv3x3 as j_conv
from diffusion_tts_tpu.ops.pallas import geglu_ff as j_geglu
from diffusion_tts_tpu.ops.pallas import groupnorm as j_gn
from diffusion_tts_tpu.ops.pallas.attention import (
    _attention_bwd_explicit,
    _attention_reference,
    _flash_attention_vjp,
)

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 4e-2}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 256, 2, 64), (1, 256, 1, 40), (1, 128, 6, 64),
                                   (1, 128, 1, 256)])
def test_attention_bwd_plain_matches_jax(shape, dtype):
    """The twin against the explicit jnp backward and against the Pallas
    flash backward (stats -> dQ -> dK/dV, interpret mode); (1, 128, 6, 64)
    is the ADM training path's width (6 heads of 64 at its T = 1024 sites),
    (1, 128, 1, 256) the DDPM++ net's single head."""
    td, jd = DTYPES[dtype]
    arrays = [_rand(shape, s) for s in range(4)]
    q, k, v, g = (torch.from_numpy(a).to(td) for a in arrays)
    qj, kj, vj, gj = (jnp.asarray(a, jd) for a in arrays)
    got = t_kernel.attention_bwd_plain(q, k, v, t_kernel.attention_plain(q, k, v), g)
    explicit = _attention_bwd_explicit(qj, kj, vj, gj)
    flash = _flash_attention_vjp(qj, kj, vj, _attention_reference(qj, kj, vj), gj,
                                 tq=128, tk=128, interpret=True)
    for a, e, f in zip(got, explicit, flash):
        assert a.dtype == td and a.shape == shape
        _close(a, e, TOL[dtype])
        _close(a, f, TOL[dtype])


def test_attention_functions_pass_gradcheck():
    """The autograd Functions' CPU path in float64: forward attention_plain,
    backward attention_bwd_plain."""
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((2, 6, 3 * 2 * 4), dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: t_kernel.qkv_self_attention(x, 2), (qkv,))
    q, k, v = (torch.randn((2, 6, 2, 4), dtype=torch.float64, generator=g, requires_grad=True)
               for _ in range(3))
    assert torch.autograd.gradcheck(t_kernel.attention, (q, k, v))


@pytest.mark.parametrize("t,heads,d", [pytest.param(64, 3, 64, id="64-3"),
                                        pytest.param(256, 2, 64, id="256-2"),
                                        pytest.param(64, 1, 256, id="64-1-256")])
def test_fused_qkv_gradient_matches_jax(t, heads, d):
    """d sum(out^2) / d qkv through the port's wrapper (its Function's
    backward) against jax.grad through the JAX wrapper; the last case is the
    DDPM++ net's one head of 256 at its 8x8 site, [2, 64, 768]."""
    x = _rand((2, t, 3 * heads * d), seed=t + heads)
    qkv = torch.from_numpy(x).requires_grad_(True)
    out = t_attention.fused_qkv_self_attention(qkv, heads)
    assert out.grad_fn is not None and "QKVAttention" in type(out.grad_fn).__name__
    (out ** 2).sum().backward()
    want = jax.grad(lambda a: jnp.sum(
        j_attention.fused_qkv_self_attention(a, heads, use_pallas=False) ** 2))(jnp.asarray(x))
    _close(qkv.grad, want, 2e-5)


def test_no_grad_saves_nothing():
    qkv = torch.from_numpy(_rand((1, 64, 3 * 64), 3)).requires_grad_(True)
    with torch.no_grad():
        out = t_attention.fused_qkv_self_attention(qkv, 1)
    assert out.grad_fn is None and not out.requires_grad


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _grads(fn, tensors, cot):
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(outs, leaves, cot if isinstance(cot, tuple) else (cot,))


def _rel_close(got, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("pre", [False, True], ids=["plain", "prebias"])
def test_group_norm_gradient_matches_jax(pre):
    b, h, w, c, groups = 2, 6, 5, 32, 8
    x, scale, bias = _rand((b, h, w, c), 0, 2.0) + 0.5, _rand((c,), 1) + 1.0, _rand((c,), 2)
    p = _rand((b, c), 3) if pre else None
    cot = _rand((b, h, w, c), 4)
    ref = lambda x, s, bb, *pp: jnp.sum(j_gn._gn_reference(
        x, s, bb, groups, 1e-5, True, *pp) * cot)
    args = (x, scale, bias) + ((p,) if pre else ())
    want = jax.grad(ref, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    if pre:
        fn = lambda x, s, bb, pp: t_gn.group_norm_silu_prebias(x, s, bb, pp, groups=groups)
    else:
        fn = lambda x, s, bb: t_gn.group_norm_silu(x, s, bb, groups=groups)
    got = _grads(fn, (_nchw(x),) + tuple(torch.from_numpy(a) for a in args[1:]), _nchw(cot))
    _rel_close(got[0].permute(0, 2, 3, 1), want[0])
    for a, r in zip(got[1:], want[1:]):
        _rel_close(a, r)


def test_group_norm_stats_gradient_matches_jax():
    b, h, w, c = 2, 6, 5, 32
    x, cm, cr = _rand((b, h, w, c), 5, 2.0) + 0.5, _rand((b, c), 6), _rand((b, c), 7)

    def ref(x):
        mean, rstd = j_gn._gn_stats_reference(x, 8, 1e-5)
        return jnp.sum(mean * cm) + jnp.sum(rstd * cr)

    want = jax.grad(ref)(jnp.asarray(x))
    (got,) = _grads(lambda x: t_gn.group_norm_stats(x, groups=8), (_nchw(x),),
                    (torch.from_numpy(cm), torch.from_numpy(cr)))
    _rel_close(got.permute(0, 2, 3, 1), want)


def test_geglu_gradient_matches_jax():
    m, c, f = 24, 16, 32
    x, w0, b0 = _rand((m, c), 8), _rand((c, 2 * f), 9, c ** -0.5), _rand((2 * f,), 10, 0.1)
    w2, b2, cot = _rand((f, c), 11, f ** -0.5), _rand((c,), 12, 0.1), _rand((m, c), 13)
    want = jax.grad(lambda *a: jnp.sum(j_geglu._geglu_reference(*a) * cot),
                    argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, w0, b0, w2, b2)))
    port = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w0.T, b0, w2.T, b2)]
    got = _grads(t_geglu.geglu_ff, port, torch.from_numpy(cot))
    for a, r, transposed in zip(got, want, (False, True, False, True, False)):
        _rel_close(a.T if transposed else a, r)


def test_conv3x3_same_gradient_matches_jax():
    b, h, w, c, k, cres = 2, 6, 5, 8, 12, 4
    a = dict(x=_rand((b, h, w, c), 14), kernel=_rand((3, 3, c, k), 15, 0.2), bias=_rand((k,), 16),
             gn_scale=_rand((b, c), 17, 0.3) + 1.0, gn_shift=_rand((b, c), 18, 0.1),
             sc_x=_rand((b, h, w, cres), 19), sc_w=_rand((cres, k), 20, 0.3))
    cot = _rand((b, h, w, k), 21)
    names = list(a)
    want = jax.grad(lambda *v: jnp.sum(j_conv._conv3_reference(
        v[0], v[1], v[2], None, v[3], v[4], v[5], v[6]) * cot),
        argnums=tuple(range(7)))(*(jnp.asarray(a[n]) for n in names))
    port = (_nchw(a["x"]), torch.from_numpy(np.ascontiguousarray(
        np.transpose(a["kernel"], (3, 2, 0, 1)))), torch.from_numpy(a["bias"]),
        torch.from_numpy(a["gn_scale"]), torch.from_numpy(a["gn_shift"]), _nchw(a["sc_x"]),
        torch.from_numpy(np.ascontiguousarray(a["sc_w"].T)))
    got = _grads(lambda x, wt, bb, s, sh, sx, sw: t_conv.conv3x3_same(
        x, wt, bb, gn_scale=s, gn_shift=sh, shortcut=(sx, sw)), port, _nchw(cot))
    back = (lambda g: g.permute(0, 2, 3, 1), lambda g: g.permute(2, 3, 1, 0), None, None, None,
            lambda g: g.permute(0, 2, 3, 1), lambda g: g.T)
    for g, r, f in zip(got, want, back):
        _rel_close(f(g) if f else g, r)


def test_conv3x3_up2_gradient_matches_jax():
    b, h, w, c, k = 2, 5, 4, 8, 12
    x, ker, bias, cot = (_rand((b, h, w, c), 22), _rand((3, 3, c, k), 23, 0.2), _rand((k,), 24),
                         _rand((b, 2 * h, 2 * w, k), 25))
    want = jax.grad(lambda *v: jnp.sum(j_conv._up2_reference(*v) * cot), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, ker, bias)))
    port = (_nchw(x), torch.from_numpy(np.ascontiguousarray(np.transpose(ker, (3, 2, 0, 1)))),
            torch.from_numpy(bias))
    got = _grads(t_conv.conv3x3_up2, port, _nchw(cot))
    _rel_close(got[0].permute(0, 2, 3, 1), want[0])
    _rel_close(got[1].permute(2, 3, 1, 0), want[1])
    _rel_close(got[2], want[2])
