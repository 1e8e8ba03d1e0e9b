"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no NVIDIA card. The file
imports only torch, so it runs where JAX is not installed; run it there
without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from diffusion_tts_torch.ops.kernels import qkv_attention as qk

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, t, heads, dtype, device):
    g = torch.Generator(device=device).manual_seed(t * 31 + heads)
    return torch.randn((b, t, 3 * heads * 64), generator=g, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,heads", [(64, 12), (256, 9), (1024, 6), (100, 3), (1, 1)])
def test_qkv_attention_matches_plain(card, t, heads, dtype):
    qkv = _qkv(2, t, heads, dtype, card)
    before = qk.LAUNCHES
    out = qk.qkv_self_attention(qkv, heads)
    torch.cuda.synchronize()
    assert qk.LAUNCHES == before + 1
    assert out.shape == (2, t, heads * 64) and out.dtype == dtype
    torch.testing.assert_close(out.float(), qk.qkv_self_attention_plain(qkv, heads).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bthd_attention_matches_plain(card, dtype):
    q, k, v = (x.reshape(2, 256, 9, 64).contiguous()
               for x in _qkv(2, 256, 9, dtype, card).chunk(3, dim=-1))
    out = qk.attention(q, k, v)
    torch.testing.assert_close(out.float(), qk.attention_plain(q, k, v).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        qk.qkv_self_attention(_qkv(1, 64, 1, torch.float16, card), 1)
    with pytest.raises(ValueError, match="head width"):
        qk.qkv_self_attention(torch.zeros((1, 64, 3 * 128), device=card), 1)
    with pytest.raises(ValueError, match="contiguous"):
        qk.qkv_self_attention(_qkv(1, 64, 2, torch.float32, card)[:, ::2], 2)
