"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no NVIDIA card. The file
imports only torch, so it runs where JAX is not installed; run it there
without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from diffusion_tts_torch.ops.kernels import conv3x3 as cv
from diffusion_tts_torch.ops.kernels import geglu_ff as gg
from diffusion_tts_torch.ops.kernels import groupnorm as gn
from diffusion_tts_torch.ops.kernels import qkv_attention as qk

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm_silu(torch.zeros((1, 30, 4, 4), device=card), torch.ones(30),
                           torch.zeros(30), groups=32)
    with pytest.raises(ValueError, match="w2"):
        x = torch.zeros((4, 16), device=card)
        gg.geglu_ff(x, torch.zeros((32, 16), device=card), torch.zeros(32, device=card),
                    torch.zeros((32, 16), device=card), torch.zeros(16, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        qk.qkv_self_attention(_qkv(1, 64, 2, torch.float32, card)[:, ::2], 2)


def _randn(shape, dtype, device, seed, scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,heads,d", [(256, 8, 40), (100, 8, 80), (64, 8, 160), (300, 1, 512),
                                        (77, 4, 8)])
def test_attention_any_width_matches_plain(card, t, heads, d, dtype):
    """The SD UNet's widths (40, 80, 160), the VAE's single d = 512 head
    and a test-width net's d = 8, with a ragged last tile where T is not a
    multiple of the tile."""
    q, k, v = (_randn((2, t, heads, d), dtype, card, s) for s in range(3))
    before = qk.LAUNCHES
    out = qk.attention(q, k, v)
    torch.cuda.synchronize()
    assert qk.LAUNCHES == before + 1 and out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), qk.attention_plain(q, k, v).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["affine_c", "affine_bc_no_silu", "prebias", "two_chunks"])
def test_group_norm_matches_plain(card, case, dtype):
    b, c, h, w, groups = (1, 8, 100, 100, 2) if case == "two_chunks" else (3, 64, 9, 7, 32)
    x = _randn((b, c, h, w), dtype, card, 1, scale=3.0) + 1
    per_sample = case == "affine_bc_no_silu"
    scale = _randn((b, c) if per_sample else (c,), torch.float32, card, 2)
    bias = _randn(scale.shape, torch.float32, card, 3)
    pre = _randn((b, c), torch.float32, card, 4) if case == "prebias" else None
    silu = not per_sample
    before = gn.LAUNCHES
    if pre is None:
        out = gn.group_norm_silu(x, scale, bias, groups=groups, eps=1e-5, apply_silu=silu)
    else:
        out = gn.group_norm_silu_prebias(x, scale, bias, pre, groups=groups, eps=1e-6)
    torch.cuda.synchronize()
    assert gn.LAUNCHES == before + gn.LAUNCHES_PER_CALL and out.dtype == dtype
    want = gn.group_norm_silu_plain(x, scale, bias, groups=groups,
                                    eps=1e-5 if pre is None else 1e-6, apply_silu=silu, pre=pre)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,f", [(128, 320, 1280), (100, 80, 96)])
def test_geglu_ff_matches_plain(card, m, c, f, dtype):
    x = _randn((m, c), dtype, card, 5)
    w0 = _randn((2 * f, c), dtype, card, 6, scale=c ** -0.5)
    b0 = _randn((2 * f,), dtype, card, 7, scale=0.1)
    w2 = _randn((c, f), dtype, card, 8, scale=f ** -0.5)
    b2 = _randn((c,), dtype, card, 9, scale=0.1)
    before = gg.LAUNCHES
    out = gg.geglu_ff(x, w0, b0, w2, b2)
    torch.cuda.synchronize()
    assert gg.LAUNCHES == before + gg.LAUNCHES_PER_CALL and out.shape == (m, c)
    torch.testing.assert_close(out.float(), gg.geglu_ff_plain(x, w0, b0, w2, b2).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _rel_err(out, want):
    return ((out.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 128, 16, 24), 32), ((1, 8, 100, 100), 2),
                                          ((3, 96, 5, 7), 32)])
def test_group_norm_stats_matches_plain(card, shape, groups, dtype):
    """One chunk, two chunks per channel (10,000 pixels), and odd sizes."""
    x = _randn(shape, dtype, card, 11, scale=3.0) + 1
    before, before_gn = gn.STATS_LAUNCHES, gn.LAUNCHES
    mean, rstd = gn.group_norm_stats(x, groups=groups, eps=1e-6)
    torch.cuda.synchronize()
    assert gn.STATS_LAUNCHES == before + gn.LAUNCHES_PER_CALL and gn.LAUNCHES == before_gn
    assert mean.shape == rstd.shape == shape[:2] and mean.dtype == rstd.dtype == torch.float32
    want_mean, want_rstd = gn.group_norm_stats_plain(x, groups=groups, eps=1e-6)
    assert _rel_err(mean, want_mean) <= 1e-5 and _rel_err(rstd, want_rstd) <= 1e-5


def _conv_case(case, b, c, k, h, w, cres, dtype, device, seed):
    kw = {}
    if case != "plain":
        kw["bias"] = _randn((k,), dtype, device, seed + 2)
    if case.endswith("residual"):
        kw["residual"] = _randn((b, k, h, w), dtype, device, seed + 3)
    if case.startswith("prologue"):
        kw["gn_scale"] = 1 + _randn((b, c), torch.float32, device, seed + 4, scale=0.5)
        kw["gn_shift"] = _randn((b, c), torch.float32, device, seed + 5, scale=0.1)
    if case.endswith("shortcut"):
        kw["shortcut"] = (_randn((b, cres, h, w), dtype, device, seed + 6),
                          _randn((k, cres), dtype, device, seed + 7, scale=0.05))
    return kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["plain", "bias_residual", "prologue_bias",
                                  "prologue_bias_residual", "prologue_bias_shortcut"])
@pytest.mark.parametrize("b,c,k,h,w,cres", [(2, 128, 128, 16, 16, 256), (1, 256, 128, 8, 40, 128),
                                            (2, 40, 72, 9, 35, 24)])
def test_conv3x3_same_matches_plain(card, b, c, k, h, w, cres, case, dtype):
    """Whole tiles, a ragged tile in W, and ragged everything (C, K and Cres
    not multiples of 16 or 128, odd H and W)."""
    x = _randn((b, c, h, w), dtype, card, 20)
    weight = _randn((k, c, 3, 3), dtype, card, 21, scale=0.05)
    kw = _conv_case(case, b, c, k, h, w, cres, dtype, card, 22)
    before = cv.SAME_LAUNCHES
    out = cv.conv3x3_same(x, weight, **kw)
    torch.cuda.synchronize()
    assert cv.SAME_LAUNCHES == before + 1 and out.shape == (b, k, h, w) and out.dtype == dtype
    assert _rel_err(out, cv.conv3x3_same_plain(x, weight, **kw)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_same_pads_after_the_prologue(card, dtype):
    """With a large shift silu(shift) is far from 0; the border pixels still
    agree with the twin, which normalizes first and pads second."""
    b, c, k, h, w = 1, 128, 128, 8, 40
    x = _randn((b, c, h, w), dtype, card, 30)
    weight = _randn((k, c, 3, 3), dtype, card, 31, scale=0.05)
    scale = 1 + _randn((b, c), torch.float32, card, 32, scale=0.5)
    shift = torch.full((b, c), 6.0, device=card)
    out = cv.conv3x3_same(x, weight, gn_scale=scale, gn_shift=shift)
    want = cv.conv3x3_same_plain(x, weight, gn_scale=scale, gn_shift=shift)
    border = torch.ones((h, w), dtype=torch.bool, device=card)
    border[1:-1, 1:-1] = False
    err = (out.float() - want.float()).abs() / want.float().abs().max()
    assert err[..., border].max().item() <= TOL[dtype]
    assert err[..., ~border].max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("b,c,k,h,w", [(2, 128, 128, 16, 16), (1, 256, 128, 8, 40),
                                       (2, 40, 72, 9, 35)])
def test_conv3x3_up2_matches_plain(card, b, c, k, h, w, with_bias, dtype):
    x = _randn((b, c, h, w), dtype, card, 40)
    weight = _randn((k, c, 3, 3), dtype, card, 41, scale=0.05)
    bias = _randn((k,), dtype, card, 42) if with_bias else None
    before = cv.UP2_LAUNCHES
    out = cv.conv3x3_up2(x, weight, bias)
    torch.cuda.synchronize()
    assert cv.UP2_LAUNCHES == before + 1 and out.shape == (b, k, 2 * h, 2 * w)
    assert _rel_err(out, cv.conv3x3_up2_plain(x, weight, bias)) <= TOL[dtype]


@pytest.mark.cuda
def test_conv_kernels_refuse_what_they_do_not_take(card):
    x = torch.zeros((1, 128, 8, 8), device=card)
    w = torch.zeros((128, 128, 3, 3), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        cv.conv3x3_same(x.permute(0, 1, 3, 2)[:, :, ::2], w)
    with pytest.raises(TypeError, match="weight"):
        cv.conv3x3_same(x, w.bfloat16())
    with pytest.raises(ValueError, match="residual"):
        cv.conv3x3_same(x, w, residual=torch.zeros((1, 128, 4, 8), device=card))
    with pytest.raises(ValueError, match=r"\[K, C, 3, 3\]"):
        cv.conv3x3_up2(x, torch.zeros((128, 64, 3, 3), device=card))
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm_stats(torch.zeros((1, 30, 4, 4), device=card), groups=32)
