"""The port's attention (diffusion_tts_torch/ops) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch version; it is held
against the JAX ``fused_qkv_self_attention`` (the XLA path on the CPU) and
against the Pallas kernel in interpret mode, on the same numpy inputs. The
CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_kernels_cuda.py; the fp32 route's arithmetic (three tf32
products a product) is emulated here in torch and held to the card's gate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.ops import attention as t_attention
from diffusion_tts_torch.ops.kernels import qkv_attention as t_kernel
from diffusion_tts_tpu.ops import attention as j_attention
from diffusion_tts_tpu.ops.pallas.attention import flash_attention as pallas_flash
from diffusion_tts_tpu.ops.pallas.attention import qkv_self_attention as pallas_qkv

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

# fp32: both sides compute fp32 scores and softmax, in another summation
# order; bf16: the weights are rounded to bf16 before P.V at different
# points (normalised in the reference, unnormalised in the kernels).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    td, jd = DTYPES[dtype]
    return torch.from_numpy(x).to(td), jnp.asarray(x, jd)


def _close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                                          np.float32),
                               np.asarray(b, np.float32), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [1, 2, 3])
@pytest.mark.parametrize("t", [64, 256])
def test_fused_qkv_matches_jax(t, heads, dtype):
    qkv_t, qkv_j = _both(_inputs((2, t, 3 * heads * 64), seed=t + heads), dtype)
    out = t_attention.fused_qkv_self_attention(qkv_t, heads)
    assert out.shape == (2, t, heads * 64) and out.dtype == qkv_t.dtype
    _close(out, j_attention.fused_qkv_self_attention(qkv_j, heads, use_pallas=False), dtype)
    _close(out, pallas_qkv(qkv_j, heads, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multihead_attention_matches_jax(dtype):
    q, k, v = (_both(_inputs((2, 64, 3, 64), seed=s), dtype) for s in range(3))
    out = t_attention.multihead_attention_fp32(q[0], k[0], v[0])
    _close(out, j_attention.multihead_attention_fp32(q[1], k[1], v[1], use_pallas=False), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [128, 200])
def test_vae_head_width_matches_jax(t, dtype):
    """The SD VAE mid-block's one head of width 512 (the wgmma route's
    widest, two warpgroups splitting O's columns on the card), at T = 128
    and a T that is no multiple of 64: the port's multihead_attention_fp32
    against the JAX package's XLA path and its Pallas flash kernel in
    interpret mode."""
    q, k, v = (_both(_inputs((2, t, 1, 512), seed=512 + t + s), dtype) for s in range(3))
    out = t_attention.multihead_attention_fp32(q[0], k[0], v[0])
    assert out.shape == (2, t, 1, 512) and out.dtype == q[0].dtype
    _close(out, j_attention.multihead_attention_fp32(q[1], k[1], v[1], use_pallas=False), dtype)
    _close(out, pallas_flash(q[1], k[1], v[1], interpret=True), dtype)


def test_wrapper_takes_plain_version_only_on_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor is refused before any launch."""
    qkv = torch.empty((1, 64, 3 * 64), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_kernel.qkv_self_attention(qkv, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_kernel.attention(*(torch.empty((1, 64, 1, 64), device="meta"),) * 3)


# --------------------------------------- the tf32x3 route's arithmetic on the CPU

_LOG2E = 1.4426950408889634


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 by bit masking: fp32 rounded to the nearest value
    with 10 mantissa bits (ties away from zero), low 13 bits zero."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32)


def _tf32_product(a, b, eq, passes):
    """einsum ``eq`` of fp32 ``a`` and ``b`` as the tensor cores take it:
    three tf32 products (x = hi + lo, lo.hi + hi.lo + hi.hi, the small terms
    first) in fp32, or one (hi.hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def _tf32x3_attention(q, k, v, key_rows, passes=3):
    """The tf32x3 kernel's arithmetic (csrc/qkv_attention.cu's
    attention_tf32_kernel) on [B, T, H, D] fp32: S from three tf32 products,
    the online softmax over K/V tiles of ``key_rows`` keys in the log2
    domain (the scale folded into exp2, the row sum from the unrounded
    weights), P.V from three tf32 products of P and V, O / l at the end."""
    b, t, h, d = q.shape
    scale_log2e = _LOG2E / np.sqrt(d)
    s = _tf32_product(q, k, "bqhd,bkhd->bhqk", passes)
    m = torch.full((b, h, t), -np.inf)
    l, o = torch.zeros((b, h, t)), torch.zeros((b, h, t, d))
    for j in range(0, t, key_rows):
        sj = s[..., j:j + key_rows]
        m_new = torch.maximum(m, sj.amax(-1) * scale_log2e)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sj * scale_log2e - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _tf32_product(p, v[:, j:j + key_rows], "bhqk,bkhd->bhqd",
                                                 passes)
        m = m_new
    return (o / l[..., None]).permute(0, 2, 1, 3)


def _fp64_attention(q, k, v):
    q, k, v = (x.double() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _rel_to_largest(out, ref):
    return ((out.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


@pytest.mark.parametrize("shape", [(2, 256, 2, 64), (2, 1024, 1, 64), (2, 200, 1, 256),
                                   (2, 256, 1, 256)])
def test_tf32x3_arithmetic_holds_the_fp32_gate(shape):
    """The tf32x3 route's numerical plan before the card runs it, at the
    ADM's d = 64 (32-key tiles) and the DDPM++ net's d = 256 (16-key tiles,
    a ragged T): within the card's fp32 gate, 1e-4 of the largest output,
    of attention in float64, and within the fp32 tolerance of the JAX
    package's fp32 attention (XLA on the CPU) on the same inputs; one tf32
    product alone (about 11 bits) misses the gate, which is why each
    product takes three."""
    d = shape[-1]
    key_rows = t_kernel.TF32X3_KEY_ROWS[d]
    assert t_kernel.forward_route(torch.float32, d) == "tf32x3"
    q, k, v = (_both(_inputs(shape, seed=d + s), "float32") for s in range(3))
    ref = _fp64_attention(q[0], k[0], v[0])
    got = _tf32x3_attention(q[0], k[0], v[0], key_rows)
    assert got.dtype == torch.float32 and got.shape == shape
    assert _rel_to_largest(got, ref) <= 1e-4
    _close(got, j_attention.multihead_attention_fp32(q[1], k[1], v[1], use_pallas=False),
           "float32")
    assert _rel_to_largest(_tf32x3_attention(q[0], k[0], v[0], key_rows, passes=1), ref) > 1e-4


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """_tf32 keeps 10 mantissa bits, rounds to the nearest and a tie away
    from zero (cvt.rna), on both signs; hi + lo carries about 22 bits."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 4, -(1.0 + one_ulp / 2),
                      1.0 + 3 * one_ulp / 4], dtype=torch.float32)
    assert _tf32(x).tolist() == [1.0, 1.0 + one_ulp, 1.0, -(1.0 + one_ulp), 1.0 + one_ulp]
    y = torch.from_numpy(_inputs((4096,), seed=5))
    hi = _tf32(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    err = ((hi + _tf32(y - hi)).double() - y.double()).abs() / y.double().abs()
    assert err.max().item() <= 2.0 ** -21
