"""The port's attention (diffusion_tts_torch/ops) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch version; it is held
against the JAX ``fused_qkv_self_attention`` (the XLA path on the CPU) and
against the Pallas kernel in interpret mode, on the same numpy inputs. The
CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tts_torch.ops import attention as t_attention
from diffusion_tts_torch.ops.kernels import qkv_attention as t_kernel
from diffusion_tts_tpu.ops import attention as j_attention
from diffusion_tts_tpu.ops.pallas.attention import qkv_self_attention as pallas_qkv

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


def test_wrapper_takes_plain_version_only_on_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor is refused before any launch."""
    qkv = torch.empty((1, 64, 3 * 64), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_kernel.qkv_self_attention(qkv, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_kernel.attention(*(torch.empty((1, 64, 1, 64), device="meta"),) * 3)
