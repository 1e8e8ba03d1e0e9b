"""The plain twins of the SD slice's CUDA kernels against the Pallas kernels
they replace, run in interpret mode on the CPU (as tests/test_pallas_*.py
run them), on the same numpy inputs. On the CPU the port's wrappers take
the twins; the kernels themselves are held against the twins on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances are relative to the output's largest magnitude: fp32 1e-5
(GEGLU 1e-4: its Pallas kernel's erf is a polynomial with 1.5e-7 error,
carried through a 1024-deep product), bf16 2e-2 (one bf16 rounding of the
output, taken at other points).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_tts_tpu.ops.pallas.geglu_ff as pallas_geglu
from diffusion_tts_torch.ops.kernels import geglu_ff as t_geglu
from diffusion_tts_torch.ops.kernels import groupnorm as t_gn
from diffusion_tts_torch.ops.kernels import qkv_attention as t_attn
from diffusion_tts_tpu.ops.pallas.attention import flash_attention
from diffusion_tts_tpu.ops.pallas.groupnorm import group_norm_silu, group_norm_silu_prebias

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(x, dtype):
    td, jd = DTYPES[dtype]
    return torch.from_numpy(x).to(td), jnp.asarray(x, jd)


def _rel_err(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["affine_c_silu", "affine_c_plain", "affine_bc", "prebias"])
def test_group_norm_twin_matches_pallas(case, dtype):
    b, h, w, c, groups = 2, 8, 8, 128, 32
    x_t, x_j = _both(_rand((b, h, w, c), 0, 3.0) + 1.0, dtype)
    per_sample = case == "affine_bc"
    scale = _rand((b, c) if per_sample else (c,), 1)
    bias = _rand(scale.shape, 2)
    silu = case != "affine_c_plain"
    nchw = x_t.permute(0, 3, 1, 2).contiguous()
    if case == "prebias":
        pre = _rand((b, c), 3)
        want = group_norm_silu_prebias(x_j, scale, bias, pre, groups=groups, eps=1e-6,
                                       interpret=True)
        got = t_gn.group_norm_silu_prebias(nchw, torch.from_numpy(scale),
                                           torch.from_numpy(bias), torch.from_numpy(pre),
                                           groups=groups, eps=1e-6)
    else:
        want = group_norm_silu(x_j, scale, bias, groups=groups, eps=1e-5, apply_silu=silu,
                               interpret=True)
        got = t_gn.group_norm_silu(nchw, torch.from_numpy(scale), torch.from_numpy(bias),
                                   groups=groups, eps=1e-5, apply_silu=silu)
    assert got.dtype == x_t.dtype and got.shape == nchw.shape
    assert _rel_err(got.permute(0, 2, 3, 1), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [40, 80])
def test_attention_twin_matches_pallas_flash(d, dtype):
    """The SD UNet's head widths at T = 256 with 128-row tiles (two q and
    two k tiles in the Pallas kernel)."""
    q, k, v = (_both(_rand((1, 256, 2, d), s), dtype) for s in range(3))
    want = flash_attention(q[1], k[1], v[1], tq=128, tk=128, interpret=True)
    got = t_attn.attention(q[0], k[0], v[0])
    assert got.dtype == q[0].dtype and got.shape == q[0].shape
    assert _rel_err(got, want) <= TOL[dtype]


def _geglu_inputs(m, c, f, dtype, seed):
    """(port tensors with [out, in] weights, JAX arrays with [in, out] ones)."""
    x, w0, b0, w2, b2 = (_rand((m, c), seed), _rand((c, 2 * f), seed + 1, c ** -0.5),
                         _rand((2 * f,), seed + 2, 0.1), _rand((f, c), seed + 3, f ** -0.5),
                         _rand((c,), seed + 4, 0.1))
    td, jd = DTYPES[dtype]
    port = [torch.from_numpy(np.ascontiguousarray(a)).to(td) for a in (x, w0.T, b0, w2.T, b2)]
    return port, [jnp.asarray(a, jd) for a in (x, w0, b0, w2, b2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["resident", "streamed"])
def test_geglu_twin_matches_pallas(form, dtype, monkeypatch):
    if form == "streamed":
        # the monkeypatch tests/test_pallas_geglu.py uses: a budget too small
        # for resident weights forces the F-streamed kernel
        monkeypatch.setattr(pallas_geglu, "_VMEM_BUDGET", 2 * 2**20)
        m, c, f = 64, 256, 1024
        assert pallas_geglu._pick_tm(m, c, f, 4) == 0
    else:
        m, c, f = 64, 128, 256
    port, jax_args = _geglu_inputs(m, c, f, dtype, seed=10)
    run = pallas_geglu._geglu_fwd_only if form == "streamed" else pallas_geglu.geglu_ff
    want = run(*jax_args, interpret=True)
    got = t_geglu.geglu_ff(*port)
    assert got.dtype == port[0].dtype and got.shape == (m, c)
    assert _rel_err(got, want) <= (1e-4 if dtype == "float32" else TOL[dtype])
