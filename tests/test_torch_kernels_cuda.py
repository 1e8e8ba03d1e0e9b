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
                                        (77, 4, 8), (256, 1, 256), (77, 2, 256)])
def test_attention_any_width_matches_plain(card, t, heads, d, dtype):
    """The SD UNet's widths (40, 80, 160), the VAE's single d = 512 head,
    the DDPM++ net's single d = 256 head and a test-width net's d = 8, with
    a ragged last tile where T is not a multiple of the tile."""
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
    # "two_chunks" is v1's: two chunks of pixels per channel (the slab takes
    # HW = 10,000 by default)
    route = "v1" if case == "two_chunks" else gn.gn_route(dtype, c, h * w, groups)
    before = gn.LAUNCHES
    if pre is None:
        out = gn.group_norm_silu(x, scale, bias, groups=groups, eps=1e-5, apply_silu=silu,
                                 route=route)
    else:
        out = gn.group_norm_silu_prebias(x, scale, bias, pre, groups=groups, eps=1e-6)
    torch.cuda.synchronize()
    assert gn.LAUNCHES == before + gn.LAUNCHES_PER_CALL[route] and out.dtype == dtype
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
    assert gn.STATS_LAUNCHES == before + gn.STATS_LAUNCHES_PER_CALL and gn.LAUNCHES == before_gn
    assert mean.shape == rstd.shape == shape[:2] and mean.dtype == rstd.dtype == torch.float32
    want_mean, want_rstd = gn.group_norm_stats_plain(x, groups=groups, eps=1e-6)
    assert _rel_err(mean, want_mean) <= 1e-5 and _rel_err(rstd, want_rstd) <= 1e-5



# ---------------------------------------------------- the GroupNorm slab route


def _gn_case(shape, dtype, device, seed, per_sample=False, with_pre=False):
    b, c = shape[:2]
    x = _randn(shape, dtype, device, seed, scale=3.0) + 1
    scale = 1 + _randn((b, c) if per_sample else (c,), torch.float32, device, seed + 1, 0.3)
    bias = _randn(scale.shape, torch.float32, device, seed + 2, 0.3)
    pre = _randn((b, c), torch.float32, device, seed + 3) if with_pre else None
    return x, scale, bias, pre


def _gn_slab_checked(x, scale, bias, pre, silu=True, route=None):
    """One call, its launches checked against its route's; returns (out, route)."""
    b, c = x.shape[:2]
    route = route or gn.gn_route(x.dtype, c, x[0, 0].numel(), 32)
    before, routes = gn.LAUNCHES, dict(gn.ROUTE_LAUNCHES)
    if pre is None:
        out = gn.group_norm_silu(x, scale, bias, groups=32, apply_silu=silu, route=route)
    else:
        out = gn.group_norm_silu_prebias(x, scale, bias, pre, groups=32, eps=1e-6,
                                         apply_silu=silu, route=route)
    torch.cuda.synchronize()
    n = gn.LAUNCHES_PER_CALL[route]
    assert gn.LAUNCHES == before + n and gn.ROUTE_LAUNCHES == {**routes, route: routes[route] + n}
    assert out.shape == x.shape and out.dtype == x.dtype
    return out, route


def _gn_plain(x, scale, bias, pre, silu=True):
    return gn.group_norm_silu_plain(x, scale, bias, groups=32, eps=1e-5 if pre is None else 1e-6,
                                    apply_silu=silu, pre=pre)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cs", [((8, 320, 64, 64), 1), ((8, 640, 64, 64), 2),
                                      ((2, 320, 64, 64), 4), ((1, 128, 512, 512), 8),
                                      ((8, 960, 64, 64), 4)])
def test_group_norm_slab_matches_plain(card, shape, cs, dtype):
    """Each cluster size, by the predicate's choice at bf16 (fp32 parts are
    twice as large). The 2 MB group of [1, 128, 512, 512] (4 MB in fp32)
    exceeds what eight CTAs hold: each keeps 96 KB resident and reads the
    rest twice."""
    b, c, h, w = shape
    assert gn.gn_slab_cluster(b, 32, c // 32, h * w, torch.bfloat16) == cs
    x, scale, bias, pre = _gn_case(shape, dtype, card, 80)
    out, route = _gn_slab_checked(x, scale, bias, pre)
    assert route == "slab"
    assert _rel_err(out, _gn_plain(x, scale, bias, pre)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["per_sample_affine", "pre", "pre_no_silu", "no_silu",
                                  "8x8"])
def test_group_norm_slab_variants_match_plain(card, case, dtype):
    """Per-sample affine, the pre-add, SiLU on and off, and an 8x8 input
    (the UNet's lowest level, 2 vectors of bf16 per channel row in fp32's 4)."""
    shape = (2, 1280, 8, 8) if case == "8x8" else (2, 640, 16, 16)
    x, scale, bias, pre = _gn_case(shape, dtype, card, 90, per_sample=case == "per_sample_affine",
                                   with_pre=case.startswith("pre"))
    silu = "no_silu" not in case
    out, route = _gn_slab_checked(x, scale, bias, pre, silu)
    assert route == "slab"
    assert _rel_err(out, _gn_plain(x, scale, bias, pre, silu)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 128, 512, 512), (8, 960, 64, 64), (2, 1280, 8, 8)])
def test_group_norm_slab_agrees_with_v1_and_repeats_bit_for_bit(card, shape):
    """The slab against forced v1 on the same bf16 inputs, within 2e-2 of
    the largest output; two slab calls bit-identical; one launch a call."""
    x, scale, bias, pre = _gn_case(shape, torch.bfloat16, card, 100, with_pre=True)
    slab, again = (_gn_slab_checked(x, scale, bias, pre, route="slab")[0] for _ in range(2))
    v1, _ = _gn_slab_checked(x, scale, bias, pre, route="v1")
    assert torch.equal(slab, again)
    assert _rel_err(slab, v1) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_group_norm_slab_refuses_what_it_cannot_take(card):
    before = (gn.LAUNCHES, dict(gn.ROUTE_LAUNCHES))
    ones, zeros = torch.ones(64, device=card), torch.zeros(64, device=card)
    ragged = _randn((1, 64, 5, 7), torch.bfloat16, card, 110)
    with pytest.raises(ValueError, match="slab route takes"):
        gn.group_norm_silu(ragged, ones, zeros, groups=32, route="slab")
    x = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16, device=card)[1:].view(1, 64, 8, 8)
    with pytest.raises(ValueError, match="16-byte"):
        gn.group_norm_silu(x, ones, zeros, groups=32)
    with pytest.raises(ValueError, match="route must be one of"):
        gn.group_norm_silu(x.contiguous(), ones, zeros, groups=32, route="ring")
    assert (gn.LAUNCHES, gn.ROUTE_LAUNCHES) == before
    out = gn.group_norm_silu(ragged, ones, zeros, groups=32)  # HW = 35 takes v1
    torch.cuda.synchronize()
    assert gn.ROUTE_LAUNCHES == {**before[1], "v1": before[1]["v1"] + 2}
    assert _rel_err(out, gn.group_norm_silu_plain(ragged, ones, zeros, groups=32)) <= 2e-2


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


def _conv_routes():
    return dict(cv.SAME_ROUTE_LAUNCHES), dict(cv.UP2_ROUTE_LAUNCHES)


def _same_checked(x, weight, kw, route=None):
    """conv3x3_same on its route (the predicate's, or ``route``): one launch,
    counted on that route, and the output's shape and dtype."""
    b, c, h, w = x.shape
    k = weight.shape[0]
    want = route or cv.same_route(x.dtype, c, k, w, kw["shortcut"][0].shape[1]
                                  if "shortcut" in kw else 0)
    before, routes = cv.SAME_LAUNCHES, dict(cv.SAME_ROUTE_LAUNCHES)
    out = cv.conv3x3_same(x, weight, route=route, **kw)
    torch.cuda.synchronize()
    assert cv.SAME_LAUNCHES == before + 1 and out.shape == (b, k, h, w) and out.dtype == x.dtype
    assert cv.SAME_ROUTE_LAUNCHES == {**routes, want: routes[want] + 1}
    return out, want


def _up2_checked(x, weight, bias, route=None):
    b, c, h, w = x.shape
    k = weight.shape[0]
    want = route or cv.up2_route(x.dtype, c, k, w)
    before, routes = cv.UP2_LAUNCHES, dict(cv.UP2_ROUTE_LAUNCHES)
    out = cv.conv3x3_up2(x, weight, bias, route=route)
    torch.cuda.synchronize()
    assert cv.UP2_LAUNCHES == before + 1 and out.shape == (b, k, 2 * h, 2 * w)
    assert cv.UP2_ROUTE_LAUNCHES == {**routes, want: routes[want] + 1}
    return out, want


CONV_CASES = ["plain", "bias_residual", "prologue_bias", "prologue_bias_residual",
              "prologue_bias_shortcut"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("b,c,k,h,w,cres", [(2, 128, 128, 16, 16, 256), (1, 256, 128, 8, 40, 128),
                                            (2, 40, 72, 9, 35, 24)])
def test_conv3x3_same_matches_plain(card, b, c, k, h, w, cres, case, dtype):
    """Whole tiles, a ragged tile in W, and ragged everything (C, K and Cres
    not multiples of 16 or 128, odd H and W). Each call takes the route its
    predicate gives: bf16 on wgmma but at the ragged shape, fp32 on v1."""
    x = _randn((b, c, h, w), dtype, card, 20)
    weight = _randn((k, c, 3, 3), dtype, card, 21, scale=0.05)
    kw = _conv_case(case, b, c, k, h, w, cres, dtype, card, 22)
    out, route = _same_checked(x, weight, kw)
    assert route == ("wgmma" if dtype == torch.bfloat16 and c % 16 == 0 else "v1")
    assert _rel_err(out, cv.conv3x3_same_plain(x, weight, **kw)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_same_pads_after_the_prologue(card, dtype):
    """With a large shift silu(shift) is far from 0; the border pixels still
    agree with the twin, which normalizes first and pads second (bf16 on
    wgmma, fp32 on v1)."""
    b, c, k, h, w = 1, 128, 128, 8, 40
    x = _randn((b, c, h, w), dtype, card, 30)
    weight = _randn((k, c, 3, 3), dtype, card, 31, scale=0.05)
    scale = 1 + _randn((b, c), torch.float32, card, 32, scale=0.5)
    shift = torch.full((b, c), 6.0, device=card)
    kw = dict(gn_scale=scale, gn_shift=shift)
    out, route = _same_checked(x, weight, kw)
    assert route == ("wgmma" if dtype == torch.bfloat16 else "v1")
    want = cv.conv3x3_same_plain(x, weight, **kw)
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
    out, route = _up2_checked(x, weight, bias)
    assert route == ("wgmma" if dtype == torch.bfloat16 and c % 16 == 0 and w % 8 == 0 else "v1")
    assert _rel_err(out, cv.conv3x3_up2_plain(x, weight, bias)) <= TOL[dtype]


# ------------------------------------------------- the conv's ring route
# (conv3x3_same's calls force it: its predicate gives wgmma at these shapes)

RING_SHAPES = [(2, 128, 128, 8, 64, 128),   # whole tiles in every dimension
               (1, 48, 72, 9, 40, 32),      # ragged H and K; W a multiple of 8, not of 32
               (1, 32, 256, 5, 24, 80)]     # two K blocks, W below one tile, Cres 80 (2 stages)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("b,c,k,h,w,cres", RING_SHAPES)
def test_conv3x3_same_ring_matches_plain(card, b, c, k, h, w, cres, case):
    x = _randn((b, c, h, w), torch.bfloat16, card, 50)
    weight = _randn((k, c, 3, 3), torch.bfloat16, card, 51, scale=0.05)
    kw = _conv_case(case, b, c, k, h, w, cres, torch.bfloat16, card, 52)
    out, route = _same_checked(x, weight, kw, "ring")
    assert route == "ring"
    assert _rel_err(out, cv.conv3x3_same_plain(x, weight, **kw)) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,k,h,w,cres", RING_SHAPES)
def test_conv3x3_same_ring_pads_after_the_prologue(card, b, c, k, h, w, cres):
    """The ring zeroes out-of-image pixels by position after the prologue:
    with shift 6 a zero-filled chunk alone would contribute silu(6)."""
    x = _randn((b, c, h, w), torch.bfloat16, card, 53)
    weight = _randn((k, c, 3, 3), torch.bfloat16, card, 54, scale=0.05)
    kw = dict(gn_scale=1 + _randn((b, c), torch.float32, card, 55, scale=0.5),
              gn_shift=torch.full((b, c), 6.0, device=card),
              shortcut=(_randn((b, cres, h, w), torch.bfloat16, card, 56),
                        _randn((k, cres), torch.bfloat16, card, 57, scale=0.05)))
    out, route = _same_checked(x, weight, kw, "ring")
    assert route == "ring"
    want = cv.conv3x3_same_plain(x, weight, **kw)
    border = torch.ones((h, w), dtype=torch.bool, device=card)
    border[1:-1, 1:-1] = False
    err = (out.float() - want.float()).abs() / want.float().abs().max()
    assert err[..., border].max().item() <= TOL[torch.bfloat16]
    assert err[..., ~border].max().item() <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("b,c,k,h,w", [(2, 128, 128, 16, 16), (1, 48, 72, 9, 40),
                                       (1, 16, 136, 3, 8)])
def test_conv3x3_up2_ring_matches_plain(card, b, c, k, h, w, with_bias):
    """Whole tiles, ragged K and H at a W that is no multiple of 32, and C
    below one 32-channel stage (the copy zero-fills its second half); the
    ring forced (the predicate gives wgmma at these shapes)."""
    x = _randn((b, c, h, w), torch.bfloat16, card, 60)
    weight = _randn((k, c, 3, 3), torch.bfloat16, card, 61, scale=0.05)
    bias = _randn((k,), torch.bfloat16, card, 62) if with_bias else None
    out, route = _up2_checked(x, weight, bias, "ring")
    assert route == "ring"
    assert _rel_err(out, cv.conv3x3_up2_plain(x, weight, bias)) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["same", "up2"])
def test_conv_ring_agrees_with_v1_and_repeats_bit_for_bit(card, kernel):
    """The ring against forced v1 on the same bf16 inputs, within 2e-2 of
    the largest output, and two ring calls bit-identical."""
    b, c, k, h, w, cres = 2, 128, 256, 12, 48, 256
    x = _randn((b, c, h, w), torch.bfloat16, card, 70)
    weight = _randn((k, c, 3, 3), torch.bfloat16, card, 71, scale=0.05)
    if kernel == "same":
        kw = _conv_case("prologue_bias_shortcut", b, c, k, h, w, cres, torch.bfloat16, card, 72)
        run = lambda route: _same_checked(x, weight, kw, route)[0]
    else:
        bias = _randn((k,), torch.bfloat16, card, 72)
        run = lambda route: _up2_checked(x, weight, bias, route)[0]
    ring, again, v1 = run("ring"), run("ring"), run("v1")
    assert torch.equal(ring, again)
    assert _rel_err(ring, v1) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_conv_ring_refuses_what_it_cannot_take(card):
    bf = torch.bfloat16
    before = (cv.SAME_LAUNCHES, cv.UP2_LAUNCHES, _conv_routes())
    x = torch.zeros(1 * 128 * 8 * 8 + 1, dtype=bf, device=card)[1:].view(1, 128, 8, 8)
    w = torch.zeros((128, 128, 3, 3), dtype=bf, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        cv.conv3x3_same(x, w)
    with pytest.raises(ValueError, match="16-byte"):
        cv.conv3x3_up2(x, w)
    with pytest.raises(ValueError, match="ring route takes bfloat16"):
        cv.conv3x3_same(torch.zeros((1, 128, 8, 8), device=card), w.float(), route="ring")
    with pytest.raises(ValueError, match="ring route takes bfloat16"):
        cv.conv3x3_up2(torch.zeros((1, 40, 8, 8), dtype=bf, device=card),
                       torch.zeros((128, 40, 3, 3), dtype=bf, device=card), route="ring")
    assert (cv.SAME_LAUNCHES, cv.UP2_LAUNCHES, _conv_routes()) == before


# ------------------------------------------------ the conv's wgmma route

WGMMA_SHAPES = [(2, 128, 128, 6, 128, 64),   # whole tiles: 2 row bands, 1 column tile, 2 K blocks
                (1, 48, 72, 7, 40, 32),      # H not a multiple of 3; K = 72; W below one tile
                (1, 64, 200, 5, 264, 96),    # W = 264: a last tile of 8 columns; K = 200;
                                             # 3 shortcut stages
                (2, 32, 256, 4, 136, 128)]   # 4 shortcut stages; a last tile of 8 columns


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("b,c,k,h,w,cres", WGMMA_SHAPES)
def test_conv3x3_same_wgmma_matches_plain(card, b, c, k, h, w, cres, case):
    """conv3x3_same on the route its predicate gives (wgmma) against the
    twin at every prologue / epilogue variant, within 2e-2 of the largest
    output."""
    x = _randn((b, c, h, w), torch.bfloat16, card, 80)
    weight = _randn((k, c, 3, 3), torch.bfloat16, card, 81, scale=0.05)
    kw = _conv_case(case, b, c, k, h, w, cres, torch.bfloat16, card, 82)
    out, route = _same_checked(x, weight, kw)
    assert route == "wgmma"
    assert _rel_err(out, cv.conv3x3_same_plain(x, weight, **kw)) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,k,h,w,cres", WGMMA_SHAPES)
def test_conv3x3_same_wgmma_pads_after_the_prologue(card, b, c, k, h, w, cres):
    """The transform zeroes out-of-image pixels by position after the
    prologue: with shift 6 the copy's zero fill alone would contribute
    silu(6)."""
    x = _randn((b, c, h, w), torch.bfloat16, card, 83)
    weight = _randn((k, c, 3, 3), torch.bfloat16, card, 84, scale=0.05)
    kw = dict(gn_scale=1 + _randn((b, c), torch.float32, card, 85, scale=0.5),
              gn_shift=torch.full((b, c), 6.0, device=card),
              shortcut=(_randn((b, cres, h, w), torch.bfloat16, card, 86),
                        _randn((k, cres), torch.bfloat16, card, 87, scale=0.05)))
    out, route = _same_checked(x, weight, kw, "wgmma")
    want = cv.conv3x3_same_plain(x, weight, **kw)
    border = torch.ones((h, w), dtype=torch.bool, device=card)
    border[1:-1, 1:-1] = False
    err = (out.float() - want.float()).abs() / want.float().abs().max()
    assert err[..., border].max().item() <= TOL[torch.bfloat16]
    assert err[..., ~border].max().item() <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["prologue_bias_residual", "prologue_bias_shortcut"])
def test_conv_wgmma_agrees_with_the_ring_and_repeats_bit_for_bit(card, case):
    """wgmma against the forced ring on the same inputs within 2e-2 of the
    largest output, and two wgmma calls bit-identical (no split depth, no
    atomics)."""
    b, c, k, h, w, cres = 2, 128, 256, 12, 48, 256
    x = _randn((b, c, h, w), torch.bfloat16, card, 90)
    weight = _randn((k, c, 3, 3), torch.bfloat16, card, 91, scale=0.05)
    kw = _conv_case(case, b, c, k, h, w, cres, torch.bfloat16, card, 92)
    wg, again = _same_checked(x, weight, kw)[0], _same_checked(x, weight, kw, "wgmma")[0]
    ring = _same_checked(x, weight, kw, "ring")[0]
    assert torch.equal(wg, again)
    assert _rel_err(wg, ring) <= TOL[torch.bfloat16]


# ------------------------------------------ the up-conv's wgmma route

UP2_WGMMA_SHAPES = [(1, 512, 512, 64, 64),    # the SD up-convs at batch 1: 2-row tiles
                    (1, 512, 512, 128, 128),  # 1-row tiles of 128 columns
                    (1, 256, 256, 256, 256),  # two column tiles a row
                    (1, 48, 40, 7, 24),       # K = 40, an odd H in 2-row tiles, W = 24, C = 48
                    (2, 32, 136, 9, 72),      # K over three blocks, W = 72 in one 128-column tile
                    (1, 16, 72, 3, 8),        # one stage, W = 8
                    (1, 64, 200, 5, 264)]     # W = 264: a last tile of 8 columns


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("b,c,k,h,w", UP2_WGMMA_SHAPES)
def test_conv3x3_up2_wgmma_matches_plain(card, b, c, k, h, w, with_bias):
    """conv3x3_up2 on the route its predicate gives (wgmma) against the twin
    within 2e-2 of the largest output, and two calls bit-identical (no split
    depth, no atomics)."""
    x = _randn((b, c, h, w), torch.bfloat16, card, 100)
    weight = _randn((k, c, 3, 3), torch.bfloat16, card, 101, scale=(9 * c) ** -0.5)
    bias = _randn((k,), torch.bfloat16, card, 102, scale=0.1) if with_bias else None
    out, route = _up2_checked(x, weight, bias)
    again, _ = _up2_checked(x, weight, bias, "wgmma")
    assert route == "wgmma"
    assert torch.equal(out, again)
    assert _rel_err(out, cv.conv3x3_up2_plain(x, weight, bias)) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_conv3x3_up2_wgmma_agrees_with_the_ring(card):
    """wgmma against the forced ring on the same inputs, within 2e-2 of the
    largest output."""
    b, c, k, h, w = 2, 128, 256, 12, 48
    x = _randn((b, c, h, w), torch.bfloat16, card, 103)
    weight = _randn((k, c, 3, 3), torch.bfloat16, card, 104, scale=0.05)
    bias = _randn((k,), torch.bfloat16, card, 105)
    wg, ring = _up2_checked(x, weight, bias)[0], _up2_checked(x, weight, bias, "ring")[0]
    assert _rel_err(wg, ring) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_conv3x3_up2_wgmma_refuses_what_it_cannot_take(card):
    """A forced "wgmma" at fp32, C = 40 or W = 12, or on a misaligned x:
    refused before any launch, nothing counted, no fall back."""
    bf = torch.bfloat16
    before = (cv.UP2_LAUNCHES, _conv_routes())
    cases = [(torch.zeros((1, 128, 8, 16), device=card), torch.float32, 128),
             (torch.zeros((1, 40, 8, 16), dtype=bf, device=card), bf, 40),
             (torch.zeros((1, 128, 8, 12), dtype=bf, device=card), bf, 128)]
    for x, dtype, c in cases:
        with pytest.raises(ValueError, match="wgmma route takes bfloat16"):
            cv.conv3x3_up2(x, torch.zeros((128, c, 3, 3), dtype=dtype, device=card),
                           route="wgmma")
    x = torch.zeros(128 * 8 * 16 + 1, dtype=bf, device=card)[1:].view(1, 128, 8, 16)
    with pytest.raises(ValueError, match="16-byte"):
        cv.conv3x3_up2(x, torch.zeros((128, 128, 3, 3), dtype=bf, device=card), route="wgmma")
    assert (cv.UP2_LAUNCHES, _conv_routes()) == before


@pytest.mark.cuda
def test_conv_wgmma_takes_the_twins_gradient(card):
    """The gradient of a wgmma call (bf16, C 16, Cres 32) is the twin's."""
    dtype = torch.bfloat16
    x, w, b = (_randn((2, 16, 6, 16), dtype, card, 93), _randn((72, 16, 3, 3), dtype, card, 94,
                                                                 1 / 12),
               _randn((72,), dtype, card, 95))
    gs = (1 + 0.3 * _randn((2, 16), torch.float32, card, 96),
          0.1 * _randn((2, 16), torch.float32, card, 97))
    sc = (_randn((2, 32, 6, 16), dtype, card, 98), _randn((72, 32), dtype, card, 99, 0.2))
    assert cv.same_route(dtype, 16, 72, 16, 32) == "wgmma"
    before = cv.SAME_ROUTE_LAUNCHES["wgmma"]
    _grads_match(
        lambda x, w, b, s, t, sx, sw: cv.conv3x3_same(x, w, b, gn_scale=s, gn_shift=t,
                                                      shortcut=(sx, sw)),
        lambda x, w, b, s, t, sx, sw: cv.conv3x3_same_plain(x, w, b, gn_scale=s, gn_shift=t,
                                                            shortcut=(sx, sw)),
        (x, w, b, *gs, *sc), dtype)
    assert cv.SAME_ROUTE_LAUNCHES["wgmma"] > before


@pytest.mark.cuda
def test_conv_wgmma_refuses_what_it_cannot_take(card):
    """Forced where its conditions fail (conv3x3_same's, or the up-conv's at
    W = 12), or on a misaligned operand: ValueError before any launch,
    nothing counted."""
    bf = torch.bfloat16
    before = (cv.SAME_LAUNCHES, cv.UP2_LAUNCHES, _conv_routes())
    w = torch.zeros((128, 128, 3, 3), dtype=bf, device=card)
    res = torch.zeros(128 * 64 + 1, dtype=bf, device=card)[1:].view(1, 128, 8, 8)
    with pytest.raises(ValueError, match="16-byte"):
        cv.conv3x3_same(torch.zeros((1, 128, 8, 8), dtype=bf, device=card), w, residual=res)
    with pytest.raises(ValueError, match="wgmma route takes"):
        cv.conv3x3_same(torch.zeros((1, 128, 8, 12), dtype=bf, device=card), w, route="wgmma")
    with pytest.raises(ValueError, match="wgmma route takes"):
        cv.conv3x3_same(torch.zeros((1, 128, 8, 8), device=card), w.float(), route="wgmma")
    with pytest.raises(ValueError, match="wgmma route takes"):
        cv.conv3x3_up2(torch.zeros((1, 128, 8, 12), dtype=bf, device=card), w, route="wgmma")
    assert (cv.SAME_LAUNCHES, cv.UP2_LAUNCHES, _conv_routes()) == before


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


# ------------------------------------------------------------- the backward


def _rel(a, b):
    """max |a - b| over the largest magnitude of b."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,heads,d", [(64, 12, 64), (256, 9, 64), (1024, 6, 64), (100, 3, 64),
                                        (3, 1, 64), (200, 2, 40), (77, 2, 160), (50, 3, 8),
                                        (256, 1, 256), (64, 1, 256), (100, 2, 256)])
def test_attention_bwd_matches_plain(card, t, heads, d, dtype):
    """dq, dk and dv of the backward kernels against the plain twin, each
    within the forward's tolerance of that gradient's largest magnitude; the
    row statistic comes from the forward kernel. Ragged tiles included. Each
    call takes the route its predicate gives: bf16 at d = 8 (and fp32
    everywhere) on the CUDA cores, the rest on the tensor cores."""
    q, k, v, g = (_randn((2, t, heads, d), dtype, card, s) for s in range(4))
    o = qk.attention(q, k, v)
    route = qk.backward_route(dtype, d)
    assert (route == "fma") == (dtype == torch.float32 or d == 8)
    before, routes = qk.BWD_LAUNCHES, _bwd_routes()
    got = qk.attention_bwd(q, k, v, o, g)
    torch.cuda.synchronize()
    assert qk.BWD_LAUNCHES == before + qk.BWD_LAUNCHES_PER_CALL
    assert _bwd_routes() == {**routes, route: routes[route] + qk.BWD_LAUNCHES_PER_CALL}
    for a, r in zip(got, qk.attention_bwd_plain(q, k, v, o, g)):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert _rel(a, r) <= TOL[dtype]


def _bwd_routes():
    return dict(qk.BWD_ROUTE_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [3, 100, 200])
@pytest.mark.parametrize("d", qk.BWD_MMA_HEAD_DIMS)
def test_attention_bwd_mma_route_matches_plain(card, d, t):
    """Every width of the backward's mma route, with T below one tile and
    ragged last tiles; forced at the wgmma widths (64, 256), where the
    predicate gives "wgmma"."""
    q, k, v, g = (_randn((2, t, 2, d), torch.bfloat16, card, 20 + s) for s in range(4))
    o = qk.attention(q, k, v)
    assert qk.backward_route(q.dtype, d) == ("wgmma" if d in qk.BWD_WGMMA_HEAD_DIMS else "mma")
    before = _bwd_routes()
    got = qk.attention_bwd(q, k, v, o, g, route="mma")
    torch.cuda.synchronize()
    assert _bwd_routes() == {**before, "mma": before["mma"] + qk.BWD_LAUNCHES_PER_CALL}
    for a, r in zip(got, qk.attention_bwd_plain(q, k, v, o, g)):
        assert a.shape == q.shape and a.dtype == q.dtype and torch.isfinite(a).all()
        assert _rel(a, r) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d", [(32, 200, 256), (2, 200, 256), (16, 130, 160)])
def test_attention_bwd_wide_form_matches_plain(card, b, t, d):
    """The mma route's wide form (d = 160, 256) with ragged last tiles at
    both of its block sizes on a 132-SM card: [32, 200] at d = 256 fills the
    card with 64-row blocks, [2, 200] takes 32-row ones, d = 160 always 64."""
    q, k, v, g = (_randn((b, t, 1, d), torch.bfloat16, card, 40 + s) for s in range(4))
    o = qk.attention(q, k, v)
    before = _bwd_routes()
    got = qk.attention_bwd(q, k, v, o, g, route="mma")  # d = 256's own route is wgmma
    torch.cuda.synchronize()
    assert _bwd_routes() == {**before, "mma": before["mma"] + qk.BWD_LAUNCHES_PER_CALL}
    for a, r in zip(got, qk.attention_bwd_plain(q, k, v, o, g)):
        assert a.shape == q.shape and torch.isfinite(a).all()
        assert _rel(a, r) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_attention_bwd_mma_route_at_the_training_shape(card):
    """The qkv form at the training path's heaviest site, [16, 1024, 1152]
    with 6 heads of 64, on the mma route forced (the site's own is wgmma):
    the thirds of one [B, T, 3C] gradient against the twin, and two runs
    bit-identical (no atomics on the mma route either)."""
    b, t, heads, d = 16, 1024, 6, 64
    qkv = _qkv(b, t, heads, torch.bfloat16, card)
    g = _randn((b, t, heads * d), torch.bfloat16, card, 31)
    lse = torch.empty((b, heads, t), device=card)
    out = qk._qkv_forward(qkv, heads, lse)
    before = _bwd_routes()
    got = qk.qkv_self_attention_bwd(qkv, out, g, heads, lse, route="mma")
    again = qk.qkv_self_attention_bwd(qkv, out, g, heads, lse, route="mma")
    torch.cuda.synchronize()
    assert _bwd_routes() == {**before, "mma": before["mma"] + 2 * qk.BWD_LAUNCHES_PER_CALL}
    assert torch.equal(got, again)
    split = lambda x: x.reshape(b, t, heads, d)
    ref = qk.attention_bwd_plain(*(split(x) for x in qkv.chunk(3, dim=-1)), split(out), split(g))
    for a, r in zip(got.chunk(3, dim=-1), ref):
        assert torch.isfinite(a).all() and _rel(split(a), r) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_attention_bwd_fma_route_forced_at_bf16(card):
    """bf16 sent to the CUDA-core backward (the first design, which
    chip_smoke.py times beside the tensor cores) still holds 2e-2, and the
    forced route carries from the forward to the backward."""
    q, k, v, g = (_randn((2, 300, 2, 64), torch.bfloat16, card, 40 + s) for s in range(4))
    o = qk.attention(q, k, v)
    before = _bwd_routes()
    got = qk.attention_bwd(q, k, v, o, g, route="fma")
    assert _bwd_routes() == {**before, "fma": before["fma"] + qk.BWD_LAUNCHES_PER_CALL}
    ref = qk.attention_bwd_plain(q, k, v, o, g)
    for a, r in zip(got, ref):
        assert _rel(a, r) <= TOL[torch.bfloat16]
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    before = _bwd_routes()
    via_autograd = torch.autograd.grad(qk.attention(*leaves, route="fma"), leaves, g)
    assert _bwd_routes() == {**before, "fma": before["fma"] + qk.BWD_LAUNCHES_PER_CALL}
    for a, r in zip(via_autograd, ref):
        assert _rel(a, r) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qkv_attention_gradient_on_the_card(card, dtype):
    """backward() through qkv_self_attention on the card: the gradient lands
    in one [B, T, 3C] tensor, equals the twin's, is the same from run to run
    (no atomics), and no_grad launches nothing but the forward."""
    qkv = _qkv(2, 256, 9, dtype, card).requires_grad_(True)
    g = _randn((2, 256, 9 * 64), dtype, card, 5).reshape(2, 16, 16, -1).permute(0, 3, 1, 2)
    g = g.permute(0, 2, 3, 1).reshape(2, 256, -1)  # as it arrives from the model's permute
    fwd, bwd = qk.LAUNCHES, qk.BWD_LAUNCHES
    out = qk.qkv_self_attention(qkv, 9)
    (grad,) = torch.autograd.grad(out, qkv, g)
    (again,) = torch.autograd.grad(qk.qkv_self_attention(qkv, 9), qkv, g)
    assert (qk.LAUNCHES, qk.BWD_LAUNCHES) == (fwd + 2, bwd + 2 * qk.BWD_LAUNCHES_PER_CALL)
    assert torch.equal(grad, again)
    x = qkv.detach().clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(qk.qkv_self_attention_plain(x, 9), x, g)
    limit = TOL[dtype] if dtype == torch.float32 else 4e-2  # autograd's bf16 cast points differ
    assert _rel(grad, ref) <= limit
    with torch.no_grad():
        qk.qkv_self_attention(qkv, 9)
    assert qk.BWD_LAUNCHES == bwd + 2 * qk.BWD_LAUNCHES_PER_CALL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t", [(8, 256), (8, 64), (32, 256)])
def test_qkv_attention_at_the_ddpmpp_width(card, b, t, dtype):
    """The CIFAR-10 DDPM++ net's attention, one head of 256 on [B, T, 768]
    (its 16x16 and 8x8 sites at the search's batch 8 and the training
    micro-batch 32): the forward and the qkv form's backward on their routes
    (bf16: "wgmma" forward, with the key split where wgmma_split picks one,
    and "wgmma" backward, which reads the forward's statistic; fp32: the
    "tf32x3" forward, whose statistic the "fma" backward reads), the
    backward's thirds against the twin and two runs bit-identical."""
    heads, d = 1, 256
    g = torch.Generator(device=card).manual_seed(b + t)
    qkv = torch.randn((b, t, 3 * d), generator=g, device=card).to(dtype)
    cot = _randn((b, t, d), dtype, card, 17)
    route = qk.forward_route(dtype, d)
    assert route == ("wgmma" if dtype == torch.bfloat16 else "tf32x3")
    before = _routes(qk)
    lse = torch.empty((b, heads, t), device=card)
    out = qk._qkv_forward(qkv, heads, lse)
    assert _routes(qk) == {**before, route: before[route] + 1}
    torch.testing.assert_close(out.float(), qk.qkv_self_attention_plain(qkv, heads).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert qk.backward_route(dtype, d) == ("wgmma" if dtype == torch.bfloat16 else "fma")
    got = qk.qkv_self_attention_bwd(qkv, out, cot, heads, lse)
    assert torch.equal(got, qk.qkv_self_attention_bwd(qkv, out, cot, heads, lse))
    split = lambda x: x.reshape(b, t, heads, d)
    ref = qk.attention_bwd_plain(*(split(x) for x in qkv.chunk(3, dim=-1)), split(out),
                                 split(cot))
    for a, r in zip(got.chunk(3, dim=-1), ref):
        assert torch.isfinite(a).all() and _rel(split(a), r) <= TOL[dtype]


def _wgmma_bwd_case(b, t, heads, d, form, device, seed):
    """One backward call's inputs at [B, T, heads, d] in the qkv form ([B, T,
    3C] thirds, the results written into the thirds of one gradient) or the
    [B, T, H, D] form, with the forward kernel's row statistic; returns
    (call(route), q, k, v, o, g) where call gives (dq, dk, dv) as
    [B, T, H, D] and the delta buffer the launches read."""
    c = heads * d
    if form == "qkv":
        qkv = _randn((b, t, 3 * c), torch.bfloat16, device, seed)
        lse = torch.empty((b, heads, t), device=device)
        out = qk._qkv_forward(qkv, heads, lse)
        g = _randn((b, t, c), torch.bfloat16, device, seed + 1)

        def call(route=None):
            dqkv = torch.empty_like(qkv)
            delta = qk._launch_bwd(*qk._thirds(qkv, c), out, g, lse, *qk._thirds(dqkv, c), d, b,
                                   heads, t, (t * 3 * c, 3 * c, d), (t * 3 * c, 3 * c, d), route)
            return tuple(x.reshape(b, t, heads, d) for x in dqkv.chunk(3, dim=-1)), delta

        split = lambda x: x.reshape(b, t, heads, d)
        return (call, *(split(x) for x in qkv.chunk(3, dim=-1)), split(out), split(g))
    q, k, v = (_randn((b, t, heads, d), torch.bfloat16, device, seed + i) for i in range(3))
    lse = torch.empty((b, heads, t), device=device)
    o = qk._bthd_forward(q, k, v, lse)
    g = _randn((b, t, heads, d), torch.bfloat16, device, seed + 3)
    s = (t * c, c, d)

    def call(route=None):
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        delta = qk._launch_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o, g, lse, dq.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), d, b, heads, t, s, s, route)
        return (dq, dk, dv), delta

    return call, q, k, v, o, g


WGMMA_BWD_SHAPES = ([(2, t, 3, 64) for t in (64, 256, 1024, 100, 200)]
                    + [(b, t, 1, 256) for b in (2, 32) for t in (64, 256, 200)])


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["qkv", "bthd"])
@pytest.mark.parametrize("b,t,heads,d", WGMMA_BWD_SHAPES)
def test_attention_bwd_wgmma_matches_plain(card, b, t, heads, d, form):
    """The wgmma backward (d = 64 and 256) against the plain twin within 2e-2
    of each gradient's largest magnitude, in both forms, whole and ragged
    tiles; two runs bit-identical; within the same tolerance of the mma
    route forced on the same inputs; and the delta its dQ launch writes
    equal to (g o).sum(-1) in fp32 (sums in another order: 1e-5 of the
    largest)."""
    call, q, k, v, o, g = _wgmma_bwd_case(b, t, heads, d, form, card, 100 + t + d)
    assert qk.backward_route(torch.bfloat16, d) == "wgmma"
    before = _bwd_routes()
    got, delta = call()
    again, _ = call()
    mma, _ = call("mma")
    torch.cuda.synchronize()
    assert _bwd_routes() == {**before, "wgmma": before["wgmma"] + 2 * qk.BWD_LAUNCHES_PER_CALL,
                             "mma": before["mma"] + qk.BWD_LAUNCHES_PER_CALL}
    ref = qk.attention_bwd_plain(q, k, v, o, g)
    for a, a2, m, r in zip(got, again, mma, ref):
        assert a.shape == (b, t, heads, d) and torch.isfinite(a).all()
        assert torch.equal(a, a2)
        assert _rel(a, r) <= TOL[torch.bfloat16]
        assert _rel(a, m) <= TOL[torch.bfloat16]
    want = (g.float() * o.float()).sum(-1).permute(0, 2, 1)
    assert delta.shape == (b, heads, t)
    assert _rel(delta, want) <= 1e-5


@pytest.mark.cuda
def test_attention_bwd_wgmma_through_autograd(card):
    """backward() through both wrappers at the training widths takes the
    wgmma route (two launches a call) and matches the twin's gradient."""
    for d, heads, t in ((64, 3, 200), (256, 1, 256)):
        x = _randn((2, t, 3 * heads * d), torch.bfloat16, card, d).requires_grad_(True)
        cot = _randn((2, t, heads * d), torch.bfloat16, card, d + 1)
        before = _bwd_routes()
        (grad,) = torch.autograd.grad(qk.qkv_self_attention(x, heads), x, cot)
        assert _bwd_routes() == {**before, "wgmma": before["wgmma"] + qk.BWD_LAUNCHES_PER_CALL}
        split = lambda y: y.detach().reshape(2, t, heads, d)
        out = qk.qkv_self_attention(x.detach(), heads)
        ref = qk.attention_bwd_plain(*(split(y) for y in x.chunk(3, dim=-1)), split(out),
                                     split(cot))
        for a, r in zip(grad.chunk(3, dim=-1), ref):
            assert _rel(split(a), r) <= TOL[torch.bfloat16]
        leaves = [split(y).clone().requires_grad_(True) for y in x.chunk(3, dim=-1)]
        before = _bwd_routes()
        got = torch.autograd.grad(qk.attention(*leaves), leaves, split(cot))
        assert _bwd_routes() == {**before, "wgmma": before["wgmma"] + qk.BWD_LAUNCHES_PER_CALL}
        for a, r in zip(got, ref):
            assert _rel(a, r) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_attention_bwd_refuses_the_vae_head(card):
    q = _randn((1, 64, 1, 512), torch.bfloat16, card, 0).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="head widths"):
        qk.attention(q, q, q).sum().backward()


def _grads_match(kernel_fn, plain_fn, tensors, dtype):
    """backward() through a kernel wrapper reaches every tensor and equals
    the twin's gradient."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    out = kernel_fn(*leaves)
    outs = (out,) if isinstance(out, torch.Tensor) else out
    gs = [_randn(o.shape, o.dtype, o.device, 11 + i) for i, o in enumerate(outs)]
    got = torch.autograd.grad(outs, leaves, gs)
    ref_leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    ref_out = plain_fn(*ref_leaves)
    ref = torch.autograd.grad((ref_out,) if isinstance(ref_out, torch.Tensor) else ref_out,
                              ref_leaves, gs)
    for a, r in zip(got, ref):
        assert a is not None and torch.isfinite(a).all()
        assert _rel(a, r) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_only_kernels_take_the_twins_gradient(card, dtype):
    x = _randn((2, 64, 12, 12), dtype, card, 1)
    w, b, pre = (_randn(s, torch.float32, card, i) for i, s in ((2, (64,)), (3, (64,)),
                                                                 (4, (2, 64))))
    _grads_match(lambda x, w, b: gn.group_norm_silu(x, w, b, groups=8),
                 lambda x, w, b: gn.group_norm_silu_plain(x, w, b, groups=8), (x, w, b), dtype)
    _grads_match(lambda x, w, b, p: gn.group_norm_silu_prebias(x, w, b, p, groups=8),
                 lambda x, w, b, p: gn.group_norm_silu_plain(x, w, b, groups=8, pre=p),
                 (x, w, b, pre), dtype)
    _grads_match(lambda x: gn.group_norm_stats(x, groups=8),
                 lambda x: gn.group_norm_stats_plain(x, groups=8), (x,), dtype)
    m, c, f = 48, 64, 128  # bf16 on the wgmma route
    ff = (_randn((m, c), dtype, card, 5), _randn((2 * f, c), dtype, card, 6, c ** -0.5),
          _randn((2 * f,), dtype, card, 7, 0.1), _randn((c, f), dtype, card, 8, f ** -0.5),
          _randn((c,), dtype, card, 9, 0.1))
    _grads_match(gg.geglu_ff, gg.geglu_ff_plain, ff, dtype)
    cx, cw, cb = (_randn((2, 16, 10, 12), dtype, card, 10),
                  _randn((24, 16, 3, 3), dtype, card, 11, 1 / 12), _randn((24,), dtype, card, 12))
    sc = (_randn((2, 8, 10, 12), dtype, card, 13), _randn((24, 8), dtype, card, 14, 0.3))
    gs = (1 + 0.3 * _randn((2, 16), torch.float32, card, 15),
          0.1 * _randn((2, 16), torch.float32, card, 16))
    _grads_match(
        lambda x, w, b, s, t, sx, sw: cv.conv3x3_same(x, w, b, gn_scale=s, gn_shift=t,
                                                      shortcut=(sx, sw)),
        lambda x, w, b, s, t, sx, sw: cv.conv3x3_same_plain(x, w, b, gn_scale=s, gn_shift=t,
                                                            shortcut=(sx, sw)),
        (cx, cw, cb, *gs, *sc), dtype)
    _grads_match(cv.conv3x3_up2, cv.conv3x3_up2_plain, (cx, cw, cb), dtype)


# ------------------------------------------------------- the two routes


def _routes(module):
    return dict(module.ROUTE_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 77, 300, 1000])
@pytest.mark.parametrize("d", qk.MMA_HEAD_DIMS)
def test_attention_mma_route_matches_plain(card, d, t):
    """Every width of the mma route, with T = 1 and ragged last tiles: the
    call takes the route its predicate gives, and at the wgmma widths the mma
    route is still served when asked for (route="mma", the earlier design)."""
    q, k, v = (_randn((2, t, 2, d), torch.bfloat16, card, s) for s in range(3))
    assert qk.forward_route(q.dtype, d) == ("wgmma" if d in qk.WGMMA_HEAD_DIMS else "mma")
    before = _routes(qk)
    out = qk.attention(q, k, v, route="mma")
    torch.cuda.synchronize()
    assert _routes(qk) == {**before, "mma": before["mma"] + 1}
    assert out.shape == q.shape and out.dtype == q.dtype
    torch.testing.assert_close(out.float(), qk.attention_plain(q, k, v).float(),
                               atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4096, 8, 40), (1, 4096, 1, 512)])
def test_attention_mma_route_at_full_sd_shapes(card, shape):
    """The SD UNet's largest self-attention (on "mma" when asked for; its
    own route is "wgmma") and the VAE mid-block's head."""
    q, k, v = (_randn(shape, torch.bfloat16, card, s) for s in range(3))
    out = qk.attention(q, k, v, route="mma")
    assert _rel_err(out, qk.attention_plain(q, k, v)) <= TOL[torch.bfloat16]


LSE_CASES = ([(route, t, d) for route in ("fma", "mma")
              for t, d in [(77, 40), (300, 64), (200, 512), (200, 256)]]
             + [("wgmma", t, d) for t, d in [(77, 40), (300, 64), (200, 80), (100, 160),
                                             (200, 256), (64, 256), (200, 512)]])


@pytest.mark.cuda
@pytest.mark.parametrize("route,t,d", LSE_CASES)
def test_attention_lse_is_the_log2_sum_exp2_of_the_scores(card, route, t, d):
    """The row statistic the backward kernels read, on every route: log2 of
    the sum of exp of the scaled scores, from fp32 scores on the same bf16
    inputs (fp32 sums in another order: 1e-4 absolute, about 1e-5 of it)."""
    b, h = 2, 2
    q, k, v = (_randn((b, t, h, d), torch.bfloat16, card, s) for s in range(3))
    lse = torch.full((b, h, t), float("nan"), device=card)
    qk._bthd_forward(q, k, v, lse, route)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    want = torch.logsumexp(scores, dim=-1) * 1.4426950408889634
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)


# ------------------------------------------------------- the wgmma route

WGMMA_CASES = [(d, t) for d in qk.WGMMA_HEAD_DIMS for t in (64, 77, 256, 1024)] + [(40, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bthd", "qkv"])
@pytest.mark.parametrize("d,t", WGMMA_CASES)
def test_attention_wgmma_route_matches_plain(card, d, t, layout):
    """Every width of the wgmma route in both layouts ([B, T, H, D] through
    ``attention``, [B, T, 3C] through ``qkv_self_attention``), at T = 64
    (one consumer warpgroup), 77 (a ragged edge), 256, 1024 and, at d = 40,
    the SD UNet's 4096: within 2e-2 of the largest output, on the route its
    predicate gives."""
    b, h = (2, 3) if t < 4096 else (1, 8)
    before = _routes(qk)
    if layout == "bthd":
        q, k, v = (_randn((b, t, h, d), torch.bfloat16, card, s) for s in range(3))
        out, want = qk.attention(q, k, v), qk.attention_plain(q, k, v)
    else:
        qkv = _randn((b, t, 3 * h * d), torch.bfloat16, card, 3)
        out, want = qk.qkv_self_attention(qkv, h), qk.qkv_self_attention_plain(qkv, h)
    torch.cuda.synchronize()
    assert qk.forward_route(torch.bfloat16, d) == "wgmma"
    assert _routes(qk) == {**before, "wgmma": before["wgmma"] + 1}
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert _rel_err(out, want) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("d,t", [(40, 77), (64, 1024), (80, 256), (160, 64), (160, 300),
                                 (256, 77), (256, 256), (256, 1000)])
def test_attention_wgmma_lse_and_repeat(card, d, t):
    """The training statistic (log2-sum-exp2, fp32 [B, H, T]) within 1e-3 of
    the mma route's on the same qkv, and two runs of the wgmma route bit for
    bit the same, output and statistic."""
    b, h = 2, 2
    qkv = _randn((b, t, 3 * h * d), torch.bfloat16, card, 4)
    lse, lse_mma, lse2 = (torch.full((b, h, t), float("nan"), device=card) for _ in range(3))
    out = qk._qkv_forward(qkv, h, lse)
    again = qk._qkv_forward(qkv, h, lse2)
    out_mma = qk._qkv_forward(qkv, h, lse_mma, route="mma")
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    assert (lse - lse_mma).abs().max().item() <= 1e-3
    assert _rel_err(out, out_mma) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pointer", "token_stride"])
def test_attention_wgmma_refuses_a_misaligned_input(card, case):
    """TMA reads 16-byte-aligned rows: a q|k|v that starts 2 bytes off, or a
    token stride of 42 elements (84 bytes), is refused before any launch;
    nothing falls back to another route."""
    b, t, h, d = 1, 64, 2, 40
    if case == "pointer":
        flat = torch.zeros(b * t * h * d + 1, dtype=torch.bfloat16, device=card)
        q = flat[1:].view(b, t, h, d)
        before = _routes(qk)
        with pytest.raises(ValueError, match="16-byte"):
            qk.attention(q, q, q)
        with pytest.raises(ValueError, match="16-byte"):
            qk.attention(q, q, q, route="mma")
    else:
        out = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=card)
        ptr = out.data_ptr()
        before = _routes(qk)
        with pytest.raises(ValueError, match="16-byte"):
            qk._launch_kernel(ptr, ptr, ptr, out, d, b, h, t, (t * 42, 42, d),
                              (t * h * d, h * d, d))
    assert _routes(qk) == before


# ------------------------------------------- the wgmma route at d = 256

D256_CASES = [(b, t) for b in (1, 8, 32, 128) for t in (1, 64, 77, 256, 300, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, *qk.WGMMA_SPLITS])
@pytest.mark.parametrize("layout", ["bthd", "qkv"])
@pytest.mark.parametrize("b,t", D256_CASES)
def test_attention_wgmma_256_matches_plain(card, b, t, layout, split):
    """d = 256 on its route, "wgmma", at T = 1 ... 1000 and batches 1 ... 128
    in both layouts, through the public wrappers with the plan wgmma_plan
    picks (None) and with each factor forced through the layouts' forwards
    (a factor above the key tiles leaves CTAs without keys): within 2e-2 of
    the largest output, and a second call bit for bit the same."""
    d, h = 256, 1
    before = _routes(qk)
    if layout == "bthd":
        q, k, v = (_randn((b, t, h, d), torch.bfloat16, card, s) for s in range(3))
        run = ((lambda: qk.attention(q, k, v)) if split is None
               else lambda: qk._bthd_forward(q, k, v, None, split=split))
        want = qk.attention_plain(q, k, v)
    else:
        qkv = _randn((b, t, 3 * h * d), torch.bfloat16, card, 3)
        run = ((lambda: qk.qkv_self_attention(qkv, h)) if split is None
               else lambda: qk._qkv_forward(qkv, h, None, split=split))
        want = qk.qkv_self_attention_plain(qkv, h)
    out, again = run(), run()
    torch.cuda.synchronize()
    assert _routes(qk) == {**before, "wgmma": before["wgmma"] + 2}
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert _rel_err(out, want) <= TOL[torch.bfloat16]
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("split", qk.WGMMA_SPLITS)
@pytest.mark.parametrize("t", [1, 77, 256, 300])
def test_attention_wgmma_256_lse_every_split(card, t, split):
    """The training statistic at d = 256 with each key split forced: the
    log2-sum-exp2 of the scaled fp32 scores (1e-4 absolute, as on every
    route), the one CTA 0 of a cluster writes after the merge, bit for bit
    the same on a second run."""
    b, h, d = 4, 1, 256
    q, k, v = (_randn((b, t, h, d), torch.bfloat16, card, s) for s in range(3))
    lse, lse2 = (torch.full((b, h, t), float("nan"), device=card) for _ in range(2))
    out = qk._bthd_forward(q, k, v, lse, split=split)
    again = qk._bthd_forward(q, k, v, lse2, split=split)
    torch.cuda.synchronize()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    want = torch.logsumexp(scores, dim=-1) * 1.4426950408889634
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
    assert torch.equal(lse, lse2) and torch.equal(out, again)
    assert _rel_err(out, qk.attention_plain(q, k, v)) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("t", [256, 300])
def test_attention_wgmma_256_lse_two_consumers(card, t):
    """The training statistic at d = 256 in the two-consumer layout (a
    producer warpgroup, setmaxnreg 40 / 232, a 2-stage ring), the plan of
    train_bench's batch 128, whose backward reads it: at b = 128 the
    128-row tiles fill the card, so wgmma_plan takes (1, 2). lse within
    1e-4 of the fp32 log2-sum-exp2 of the scores, O within 2e-2, both bit
    for bit the same on a second run."""
    b, h, d = 128, 1, 256
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert b * h * -(-t // 128) >= sms
    assert qk.wgmma_plan(d, b, h, t, *qk.card_limits(torch.device(card))) == (1, 2)
    q, k, v = (_randn((b, t, h, d), torch.bfloat16, card, s) for s in range(3))
    lse, lse2 = (torch.full((b, h, t), float("nan"), device=card) for _ in range(2))
    out = qk._bthd_forward(q, k, v, lse)
    again = qk._bthd_forward(q, k, v, lse2)
    torch.cuda.synchronize()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    want = torch.logsumexp(scores, dim=-1) * 1.4426950408889634
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
    assert torch.equal(lse, lse2) and torch.equal(out, again)
    assert _rel_err(out, qk.attention_plain(q, k, v)) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pointer", "token_stride", "split"])
def test_attention_wgmma_256_refuses_what_it_cannot_take(card, case):
    """At d = 256: a q|k|v that starts 2 bytes off, a token stride of 772
    elements (1544 bytes) or a split of 3 is refused before any launch, on
    the route's own call and on a forced mma call; nothing falls back to
    another route."""
    b, t, h, d = 8, 256, 1, 256
    before = _routes(qk)
    if case == "pointer":
        flat = torch.zeros(b * t * h * d + 1, dtype=torch.bfloat16, device=card)
        q = flat[1:].view(b, t, h, d)
        for route in (None, "mma"):
            with pytest.raises(ValueError, match="16-byte"):
                qk.attention(q, q, q, route=route)
    elif case == "token_stride":
        out = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=card)
        ptr = out.data_ptr()
        with pytest.raises(ValueError, match="16-byte"):
            qk._launch_kernel(ptr, ptr, ptr, out, d, b, h, t, (t * 772, 772, d),
                              (t * h * d, h * d, d))
    else:
        qkv = _randn((b, t, 3 * d), torch.bfloat16, card, 3)
        with pytest.raises(ValueError, match="key split takes"):
            qk._qkv_forward(qkv, 1, None, split=3)
        with pytest.raises(ValueError, match="key split takes"):
            qk._qkv_forward(qkv, 1, None, route="mma", split=2)
    assert _routes(qk) == before


# ------------------------------------------- the tf32x3 route (fp32)

# [B, T, heads, d] of the fp32 route: the ADM's sites at the search's batch
# 8 and the training micro-batch 16, the DDPM++ net's [8, 256, 768],
# [8, 64, 768] and [32, 256, 768], ragged T (200, 77), one token.
TF32X3_SHAPES = [(8, 1024, 6, 64), (8, 256, 9, 64), (8, 64, 12, 64), (16, 1024, 6, 64),
                 (2, 200, 3, 64), (1, 1, 1, 64), (8, 256, 1, 256), (8, 64, 1, 256),
                 (32, 256, 1, 256), (2, 200, 1, 256), (4, 77, 1, 256), (1, 1, 1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["qkv", "bthd"])
@pytest.mark.parametrize("b,t,heads,d", TF32X3_SHAPES)
def test_attention_tf32x3_matches_plain(card, b, t, heads, d, layout):
    """fp32 at d = 64 and 256 on its route, "tf32x3" (three tf32 products
    on the tensor cores), in both layouts through the public wrappers:
    within 1e-4 of the largest output with TF32 off, one launch on the
    route, and a second call bit for bit the same."""
    before = _routes(qk)
    if layout == "bthd":
        q, k, v = (_randn((b, t, heads, d), torch.float32, card, s) for s in range(3))
        run, want = (lambda: qk.attention(q, k, v)), qk.attention_plain(q, k, v)
    else:
        qkv = _randn((b, t, 3 * heads * d), torch.float32, card, 3)
        run = lambda: qk.qkv_self_attention(qkv, heads)
        want = qk.qkv_self_attention_plain(qkv, heads)
    out, again = run(), run()
    torch.cuda.synchronize()
    assert qk.forward_route(torch.float32, d) == "tf32x3"
    assert _routes(qk) == {**before, "tf32x3": before["tf32x3"] + 2}
    assert out.shape == want.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert _rel_err(out, want) <= TOL[torch.float32]
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("split", qk.WGMMA_SPLITS)
@pytest.mark.parametrize("b,t", [(8, 256), (8, 64), (4, 300), (2, 17)])
def test_attention_tf32x3_256_every_split(card, b, t, split):
    """d = 256's key split forced on the tf32x3 route (clusters of 2 and 4
    merging fp32 partials; a factor above the 16-key tiles leaves CTAs
    without keys): output within 1e-4, the statistic CTA 0 writes within
    1e-4 of the fp32 log2-sum-exp2 of the scores, both bit for bit the same
    on a second run."""
    h, d = 1, 256
    q, k, v = (_randn((b, t, h, d), torch.float32, card, s) for s in range(3))
    lse, lse2 = (torch.full((b, h, t), float("nan"), device=card) for _ in range(2))
    out = qk._bthd_forward(q, k, v, lse, split=split)
    again = qk._bthd_forward(q, k, v, lse2, split=split)
    torch.cuda.synchronize()
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    want = torch.logsumexp(scores, dim=-1) * 1.4426950408889634
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
    assert torch.equal(lse, lse2) and torch.equal(out, again)
    assert _rel_err(out, qk.attention_plain(q, k, v)) <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(77, 64), (300, 64), (1024, 64), (200, 256), (64, 256)])
def test_attention_tf32x3_lse_is_the_log2_sum_exp2_of_the_scores(card, t, d):
    """The row statistic the fma backward reads in fp32 training, from the
    tf32x3 forward: log2 of the sum of exp of the scaled fp32 scores (1e-4
    absolute, as on every route), and the fma forward's within 1e-4 of it."""
    b, h = 2, 2
    q, k, v = (_randn((b, t, h, d), torch.float32, card, s) for s in range(3))
    lse, lse_fma = (torch.full((b, h, t), float("nan"), device=card) for _ in range(2))
    qk._bthd_forward(q, k, v, lse)
    qk._bthd_forward(q, k, v, lse_fma, route="fma")
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    want = torch.logsumexp(scores, dim=-1) * 1.4426950408889634
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
    assert (lse - lse_fma).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["qkv", "bthd"])
@pytest.mark.parametrize("b,t,heads,d", [(2, 256, 9, 64), (2, 100, 3, 64), (8, 256, 1, 256),
                                         (2, 200, 1, 256)])
def test_attention_tf32x3_forward_fma_backward_through_autograd(card, b, t, heads, d, layout):
    """fp32 training's attention: backward() through the wrappers runs the
    tf32x3 forward (one launch, with the statistic) and the fma backward
    (two launches), each gradient within 1e-4 of its largest magnitude of
    autograd through the plain version."""
    fwd, bwd = _routes(qk), _bwd_routes()
    g = _randn((b, t, heads * d), torch.float32, card, 9)
    if layout == "qkv":
        qkv = _randn((b, t, 3 * heads * d), torch.float32, card, 3).requires_grad_(True)
        (got,) = torch.autograd.grad(qk.qkv_self_attention(qkv, heads), qkv, g)
        x = qkv.detach().clone().requires_grad_(True)
        (want,) = torch.autograd.grad(qk.qkv_self_attention_plain(x, heads), x, g)
        pairs = [(got, want)]
    else:
        leaves = [_randn((b, t, heads, d), torch.float32, card, s).requires_grad_(True)
                  for s in range(3)]
        g = g.reshape(b, t, heads, d)
        got = torch.autograd.grad(qk.attention(*leaves), leaves, g)
        plain = [x.detach().clone().requires_grad_(True) for x in leaves]
        want = torch.autograd.grad(qk.attention_plain(*plain), plain, g)
        pairs = list(zip(got, want))
    torch.cuda.synchronize()
    assert _routes(qk) == {**fwd, "tf32x3": fwd["tf32x3"] + 1}
    assert _bwd_routes() == {**bwd, "fma": bwd["fma"] + qk.BWD_LAUNCHES_PER_CALL}
    for a, r in pairs:
        assert torch.isfinite(a).all() and _rel(a, r) <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pointer", "token_stride", "split", "mma", "bf16"])
def test_attention_tf32x3_refuses_what_it_cannot_take(card, case):
    """On the card as on the CPU: an fp32 q|k|v that starts 4 bytes off, a
    token stride of 770 floats (3080 bytes), a key split at d = 64, "mma"
    forced in fp32 or "tf32x3" forced in bf16 is refused before any launch;
    nothing falls back to another route."""
    b, t, h, d = 2, 64, 2, 64
    before = _routes(qk)
    if case == "pointer":
        flat = torch.zeros(b * t * h * d + 1, device=card)
        q = flat[1:].view(b, t, h, d)
        with pytest.raises(ValueError, match="16-byte"):
            qk.attention(q, q, q)
    elif case == "token_stride":
        out = torch.empty((b, t, h, d), device=card)
        ptr = out.data_ptr()
        with pytest.raises(ValueError, match="16-byte"):
            qk._launch_kernel(ptr, ptr, ptr, out, d, b, h, t, (t * 770, 770, d),
                              (t * h * d, h * d, d))
    elif case == "split":
        qkv = _randn((b, t, 3 * h * d), torch.float32, card, 3)
        with pytest.raises(ValueError, match="key split takes"):
            qk._qkv_forward(qkv, h, None, split=2)
    else:
        dtype = torch.float32 if case == "mma" else torch.bfloat16
        q = _randn((b, t, h, d), dtype, card, 1)
        with pytest.raises(ValueError, match=f"{'mma' if case == 'mma' else 'tf32x3'} route"):
            qk.attention(q, q, q, route="mma" if case == "mma" else "tf32x3")
    assert _routes(qk) == before


# ------------------------------------------- the wgmma route at d = 512

# The SD VAE mid-block's head at decode batches 1 and 4, and a ragged T.
D512_SHAPES = [(1, 4096, 1, 512), (4, 4096, 1, 512), (2, 300, 1, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", D512_SHAPES)
def test_attention_wgmma_512_matches_plain(card, shape):
    """d = 512 on its route, "wgmma" (two warpgroups splitting O's columns,
    S's depth halves exchanged), at the plan wgmma_plan picks (no key
    split): within 2e-2 of the largest output of attention_plain and of the
    mma.sync design (forced); two calls bit for bit the same."""
    b, t, h, d = shape
    q, k, v = (_randn(shape, torch.bfloat16, card, s) for s in range(3))
    before = _routes(qk)
    out, again = qk.attention(q, k, v), qk.attention(q, k, v)
    torch.cuda.synchronize()
    assert _routes(qk) == {**before, "wgmma": before["wgmma"] + 2}
    assert qk.wgmma_plan(d, b, h, t, *qk.card_limits(torch.device(card))) == (1, 2)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all() and torch.equal(out, again)
    assert _rel_err(out, qk.attention_plain(q, k, v)) <= TOL[torch.bfloat16]
    assert _rel_err(out, qk.attention(q, k, v, route="mma")) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 32, 77, 300, 1024])
def test_attention_wgmma_512_lse_and_repeat(card, t):
    """The row statistic at d = 512, written by warpgroup 0 of the two that
    share the rows: the log2-sum-exp2 of the scaled fp32 scores (1e-4
    absolute, as on every route); output and statistic bit for bit the same
    on a second run, the output within 2e-2 of plain."""
    b, h, d = 2, 1, 512
    q, k, v = (_randn((b, t, h, d), torch.bfloat16, card, s) for s in range(3))
    lse, lse2 = (torch.full((b, h, t), float("nan"), device=card) for _ in range(2))
    out = qk._bthd_forward(q, k, v, lse)
    again = qk._bthd_forward(q, k, v, lse2)
    torch.cuda.synchronize()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    want = torch.logsumexp(scores, dim=-1) * 1.4426950408889634
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
    assert torch.equal(lse, lse2) and torch.equal(out, again)
    assert _rel_err(out, qk.attention_plain(q, k, v)) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pointer", "token_stride", "split"])
def test_attention_wgmma_512_refuses_what_it_cannot_take(card, case):
    """At d = 512: a q|k|v that starts 2 bytes off, a token stride of 516
    elements (1032 bytes, no multiple of 16) or a key split (d = 256's
    alone) is refused before any launch, on the route's own call and on a
    forced mma call; nothing falls back to another route."""
    b, t, h, d = 1, 256, 1, 512
    before = _routes(qk)
    if case == "pointer":
        flat = torch.zeros(b * t * h * d + 1, dtype=torch.bfloat16, device=card)
        q = flat[1:].view(b, t, h, d)
        for route in (None, "mma"):
            with pytest.raises(ValueError, match="16-byte"):
                qk.attention(q, q, q, route=route)
    elif case == "token_stride":
        out = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=card)
        ptr = out.data_ptr()
        with pytest.raises(ValueError, match="16-byte"):
            qk._launch_kernel(ptr, ptr, ptr, out, d, b, h, t, (t * 516, 516, d),
                              (t * h * d, h * d, d))
    else:
        q = _randn((b, t, h, d), torch.bfloat16, card, 0)
        for route in (None, "mma"):
            with pytest.raises(ValueError, match="key split takes"):
                qk._bthd_forward(q, q, q, None, route=route, split=2)
    assert _routes(qk) == before


def _ff(m, c, f, card, dtype=torch.bfloat16):
    return (_randn((m, c), dtype, card, 5), _randn((2 * f, c), dtype, card, 6, scale=c ** -0.5),
            _randn((2 * f,), dtype, card, 7, scale=0.1), _randn((c, f), dtype, card, 8,
                                                                 scale=f ** -0.5),
            _randn((c,), dtype, card, 9, scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 100, 300, 4096])
def test_geglu_mma_route_matches_plain(card, m):
    """The first tensor-core design, forced at an SD width (the route takes
    it there only when asked): C = 320 (no multiple of the 128-wide tile),
    F = 1280, ragged M."""
    ff = _ff(m, 320, 1280, card)
    before = _routes(gg)
    out = gg.geglu_ff(*ff, route="mma")
    torch.cuda.synchronize()
    assert _routes(gg) == {**before, "mma": before["mma"] + gg.LAUNCHES_PER_CALL}
    torch.testing.assert_close(out.float(), gg.geglu_ff_plain(*ff).float(),
                               atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 100, 128, 300, 512, 2048])
@pytest.mark.parametrize("c", [320, 640, 1280])
def test_geglu_wgmma_route_matches_plain(card, c, m):
    """The SD-1.5 widths (F = 4C) on their route, "wgmma": 64- and 128-row
    tiles, ragged M, launch 2's 160-wide tiles at C = 320 and its split depth
    at C = 1280 and small M; within 2e-2 of the largest output, and two
    calls give the same bits."""
    ff = _ff(m, c, 4 * c, card)
    before = _routes(gg)
    out = gg.geglu_ff(*ff)
    again = gg.geglu_ff(*ff)
    torch.cuda.synchronize()
    assert _routes(gg) == {**before, "wgmma": before["wgmma"] + 2 * gg.LAUNCHES_PER_CALL}
    assert out.shape == (m, c) and torch.equal(out, again)
    want = gg.geglu_ff_plain(*ff).float()
    err = (out.float() - want).abs().max() / want.abs().max()
    assert err <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_geglu_wgmma_split_depth_is_bit_identical(card):
    """A shape whose launch 2 splits the depth (C = 1280 at M = 128): the
    partials are summed in a fixed order, so ten calls give one result."""
    m, c, f = 128, 1280, 5120
    assert gg.wgmma_plan(m, c, f, torch.cuda.get_device_properties(0).multi_processor_count)[3] > 1
    ff = _ff(m, c, f, card)
    outs = [gg.geglu_ff(*ff) for _ in range(10)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fma_route_holds_its_tolerance(card, dtype):
    """fp32 takes the CUDA-core route by its predicate, and holds 1e-4 with
    TF32 off; bf16 sent there (the first design, which chip_smoke.py times
    beside the tensor cores) holds 2e-2."""
    forced = None if dtype == torch.float32 else "fma"
    q, k, v = (_randn((2, 300, 2, 80), dtype, card, s) for s in range(3))
    before = _routes(qk)
    out = qk.attention(q, k, v, route=forced)
    assert _routes(qk) == {**before, "fma": before["fma"] + 1}
    torch.testing.assert_close(out.float(), qk.attention_plain(q, k, v).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    m, c, f = 300, 320, 1280
    ff = (_randn((m, c), dtype, card, 5), _randn((2 * f, c), dtype, card, 6, c ** -0.5),
          _randn((2 * f,), dtype, card, 7, 0.1), _randn((c, f), dtype, card, 8, f ** -0.5),
          _randn((c,), dtype, card, 9, 0.1))
    before = _routes(gg)
    out = gg.geglu_ff(*ff, route=forced)
    assert _routes(gg) == {**before, "fma": before["fma"] + gg.LAUNCHES_PER_CALL}
    torch.testing.assert_close(out.float(), gg.geglu_ff_plain(*ff).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_mma_routes_refuse_misaligned_inputs(card):
    bf = torch.bfloat16
    q = torch.zeros(1 * 64 * 2 * 40 + 1, dtype=bf, device=card)[1:].view(1, 64, 2, 40)
    before = (qk.LAUNCHES, gg.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        qk.attention(q, q, q)
    x = torch.zeros(4 * 32 + 1, dtype=bf, device=card)[1:].view(4, 32)
    w0, b0 = torch.zeros((128, 32), dtype=bf, device=card), torch.zeros(128, dtype=bf, device=card)
    w2, b2 = torch.zeros((32, 64), dtype=bf, device=card), torch.zeros(32, dtype=bf, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        gg.geglu_ff(x, w0, b0, w2, b2)
    x = torch.zeros((4, 36), dtype=bf, device=card)
    with pytest.raises(ValueError, match="multiples of 8"):
        gg.geglu_ff(x, torch.zeros((128, 36), dtype=bf, device=card), b0,
                    torch.zeros((36, 64), dtype=bf, device=card),
                    torch.zeros(36, dtype=bf, device=card))
    assert (qk.LAUNCHES, gg.LAUNCHES) == before


# ------------------------------------- GEGLU's tf32x3 route (fp32)


@pytest.mark.cuda
def test_tensor_cores_read_the_top_19_bits_of_an_fp32_operand(card):
    """The tf32x3 route takes each fp32 operand as it lies for its hi: the
    tensor cores must read it as tf32 with its low 13 mantissa bits dropped.
    A product of raw operands is bit-equal to the same product of the
    operands with those bits cleared, and that is the product of the
    cleared operands (fp32 accumulation)."""
    a, b = _randn((64, 32), torch.float32, card, 1), _randn((32, 32), torch.float32, card, 2)
    mask = lambda t: (t.view(torch.int32) & -8192).view(torch.float32)
    raw, masked = gg.tf32_product(a, b), gg.tf32_product(mask(a), mask(b))
    torch.cuda.synchronize()
    assert torch.equal(raw, masked)
    want = mask(a).double() @ mask(b).double().T
    assert ((masked.double() - want).abs().max() / want.abs().max()).item() <= 1e-6
    assert not torch.equal(a, mask(a))  # the inputs do have low bits to drop


SD_FF_SHAPES = [(128, 1280, 5120), (512, 1280, 5120), (2048, 1280, 5120), (2048, 640, 2560)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 100, 128, 300, 512, 2048])
@pytest.mark.parametrize("c", [320, 640, 1280])
def test_geglu_tf32x3_route_matches_plain(card, c, m):
    """fp32 at the SD-1.5 widths (F = 4C) on their route, "tf32x3": 64- and
    128-row tiles, ragged M, launch 2's 160-wide tiles and its
    split depth (C = 1280 at M = 128); within 1e-4 of the largest output with
    TF32 off, and two calls give the same bits."""
    ff = _ff(m, c, 4 * c, card, torch.float32)
    before = _routes(gg)
    out, again = gg.geglu_ff(*ff), gg.geglu_ff(*ff)
    torch.cuda.synchronize()
    assert gg.route(torch.float32, c, 4 * c) == "tf32x3"
    assert _routes(gg) == {**before, "tf32x3": before["tf32x3"] + 2 * gg.LAUNCHES_PER_CALL}
    assert out.shape == (m, c) and out.dtype == torch.float32 and torch.isfinite(out).all()
    assert _rel_err(out, gg.geglu_ff_plain(*ff)) <= TOL[torch.float32]
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,f", [(100, 32, 128), (64, 96, 384), (300, 64, 96), (7, 320, 1280)])
def test_geglu_tf32x3_at_multiples_of_32(card, m, c, f):
    """Widths that are multiples of 32 but not of 64 (launch 1's last
    64-column tile half past F) and F not 4C: the route masks what lies past
    the output."""
    ff = _ff(m, c, f, card, torch.float32)
    assert gg.route(torch.float32, c, f) == "tf32x3"
    out = gg.geglu_ff(*ff)
    assert _rel_err(out, gg.geglu_ff_plain(*ff)) <= TOL[torch.float32]


@pytest.mark.cuda
def test_geglu_tf32x3_split_depth_is_bit_identical(card):
    """Launch 2's split depth (C = 1280 at M = 128) sums its partials in a
    fixed order: ten calls give one result."""
    m, c, f = 128, 1280, 5120
    assert gg.tf32x3_plan(m, c, f, torch.cuda.get_device_properties(0).multi_processor_count)[3] > 1
    ff = _ff(m, c, f, card, torch.float32)
    outs = [gg.geglu_ff(*ff) for _ in range(10)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,f", SD_FF_SHAPES)
def test_geglu_tf32x3_every_plan(card, m, c, f, monkeypatch):
    """Every launch-1 tile (64 or 128 rows) and launch-2 tile (64 or 128
    rows by 128 or 160 columns), each with one and with two depth shares,
    against the plain version at the SD shapes."""
    ff = _ff(m, c, f, card, torch.float32)
    want = gg.geglu_ff_plain(*ff)
    for rows1 in (64, 128):
        for rows2, bn2 in ((64, 128), (64, 160), (128, 128), (128, 160)):
            for split in (1, 2):
                plan = (rows1, rows2, bn2, split)
                monkeypatch.setattr(gg, "tf32x3_plan", lambda *args: plan)
                err = _rel_err(gg.geglu_ff(*ff), want)
                assert err <= TOL[torch.float32], plan


@pytest.mark.cuda
def test_geglu_tf32x3_takes_the_twins_gradient(card):
    """backward() through the route reaches x and every weight and bias and
    equals the plain twin's gradient."""
    m, c, f = 100, 320, 1280
    ff = _ff(m, c, f, card, torch.float32)
    before = _routes(gg)
    _grads_match(gg.geglu_ff, gg.geglu_ff_plain, ff, torch.float32)
    assert _routes(gg)["tf32x3"] > before["tf32x3"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pointer", "bias", "bf16", "width", "plan"])
def test_geglu_tf32x3_refuses_what_it_cannot_take(card, case, monkeypatch):
    """An fp32 operand or bias not 16-byte aligned, "tf32x3" asked for in
    bf16 or at C = 40, or a plan the C entry does not take: refused before
    any launch, or by the C entry with nothing launched. Nothing falls back
    to "fma"."""
    c = 40 if case == "width" else 64
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    x, w0, b0, w2, b2 = _ff(4, c, 4 * c, card, dtype)
    if case == "pointer":
        x = torch.zeros(4 * c + 1, dtype=dtype, device=card)[1:].view(4, c)
    if case == "bias":
        b0 = torch.zeros(8 * c + 1, dtype=dtype, device=card)[1:]
    if case == "plan":  # 192-row tiles: the wgmma route's, not this route's
        monkeypatch.setattr(gg, "tf32x3_plan", lambda *args: (192, 64, 128, 1))
    before = (gg.LAUNCHES, _routes(gg))
    forced = "tf32x3" if case in ("bf16", "width") else None
    kind = RuntimeError if case == "plan" else ValueError
    match = {"pointer": "16-byte", "bias": "16-byte", "plan": "launch failed"}.get(
        case, "tf32x3 route takes float32")
    with pytest.raises(kind, match=match):
        gg.geglu_ff(x, w0, b0, w2, b2, route=forced)
    assert (gg.LAUNCHES, _routes(gg)) == before
