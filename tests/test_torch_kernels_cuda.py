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


# ------------------------------------------------------------- the backward


def _rel(a, b):
    """max |a - b| over the largest magnitude of b."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,heads,d", [(64, 12, 64), (256, 9, 64), (1024, 6, 64), (100, 3, 64),
                                        (3, 1, 64), (200, 2, 40), (77, 2, 160), (50, 3, 8)])
def test_attention_bwd_matches_plain(card, t, heads, d, dtype):
    """dq, dk and dv of the backward kernels against the plain twin, each
    within the forward's tolerance of that gradient's largest magnitude; the
    row statistic comes from the forward kernel. Ragged tiles included. Each
    call takes the route its predicate gives: bf16 at d = 8 and 160 (and
    fp32 everywhere) on the CUDA cores, the rest on the tensor cores."""
    q, k, v, g = (_randn((2, t, heads, d), dtype, card, s) for s in range(4))
    o = qk.attention(q, k, v)
    route = qk.backward_route(dtype, d)
    assert (route == "fma") == (dtype == torch.float32 or d in (8, 160))
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
    """Every width of the backward's tensor-core route, with T below one
    tile and ragged last tiles."""
    q, k, v, g = (_randn((2, t, 2, d), torch.bfloat16, card, 20 + s) for s in range(4))
    o = qk.attention(q, k, v)
    assert qk.backward_route(q.dtype, d) == "mma"
    before = _bwd_routes()
    got = qk.attention_bwd(q, k, v, o, g)
    torch.cuda.synchronize()
    assert _bwd_routes() == {**before, "mma": before["mma"] + qk.BWD_LAUNCHES_PER_CALL}
    for a, r in zip(got, qk.attention_bwd_plain(q, k, v, o, g)):
        assert a.shape == q.shape and a.dtype == q.dtype and torch.isfinite(a).all()
        assert _rel(a, r) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_attention_bwd_mma_route_at_the_training_shape(card):
    """The qkv form at the training path's heaviest site, [16, 1024, 1152]
    with 6 heads of 64: the thirds of one [B, T, 3C] gradient against the
    twin, and two runs bit-identical (no atomics on the mma route either)."""
    b, t, heads, d = 16, 1024, 6, 64
    qkv = _qkv(b, t, heads, torch.bfloat16, card)
    g = _randn((b, t, heads * d), torch.bfloat16, card, 31)
    lse = torch.empty((b, heads, t), device=card)
    out = qk._qkv_forward(qkv, heads, lse)
    before = _bwd_routes()
    got = qk.qkv_self_attention_bwd(qkv, out, g, heads, lse)
    again = qk.qkv_self_attention_bwd(qkv, out, g, heads, lse)
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
    m, c, f = 48, 32, 64
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
    """Every width of the tensor-core route, with T = 1 and ragged last tiles;
    the call takes the route its predicate gives."""
    q, k, v = (_randn((2, t, 2, d), torch.bfloat16, card, s) for s in range(3))
    assert qk.forward_route(q.dtype, d) == "mma"
    before = _routes(qk)
    out = qk.attention(q, k, v)
    torch.cuda.synchronize()
    assert _routes(qk) == {**before, "mma": before["mma"] + 1}
    assert out.shape == q.shape and out.dtype == q.dtype
    torch.testing.assert_close(out.float(), qk.attention_plain(q, k, v).float(),
                               atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4096, 8, 40), (1, 4096, 1, 512)])
def test_attention_mma_route_at_full_sd_shapes(card, shape):
    """The SD UNet's largest self-attention and the VAE mid-block's head."""
    q, k, v = (_randn(shape, torch.bfloat16, card, s) for s in range(3))
    out = qk.attention(q, k, v)
    assert _rel_err(out, qk.attention_plain(q, k, v)) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fma", "mma"])
@pytest.mark.parametrize("t,d", [(77, 40), (300, 64), (200, 512)])
def test_attention_lse_is_the_log2_sum_exp2_of_the_scores(card, route, t, d):
    """The row statistic the backward kernels read, on both routes: log2 of
    the sum of exp of the scaled scores, from fp32 scores on the same bf16
    inputs (fp32 sums in another order: 1e-4 absolute, about 1e-5 of it)."""
    b, h = 2, 2
    q, k, v = (_randn((b, t, h, d), torch.bfloat16, card, s) for s in range(3))
    lse = torch.full((b, h, t), float("nan"), device=card)
    qk._bthd_forward(q, k, v, lse, route)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    want = torch.logsumexp(scores, dim=-1) * 1.4426950408889634
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 100, 300, 4096])
def test_geglu_mma_route_matches_plain(card, m):
    """C = 320 (no multiple of the 128-wide tile), F = 1280, ragged M."""
    c, f = 320, 1280
    x = _randn((m, c), torch.bfloat16, card, 5)
    w0 = _randn((2 * f, c), torch.bfloat16, card, 6, scale=c ** -0.5)
    b0 = _randn((2 * f,), torch.bfloat16, card, 7, scale=0.1)
    w2 = _randn((c, f), torch.bfloat16, card, 8, scale=f ** -0.5)
    b2 = _randn((c,), torch.bfloat16, card, 9, scale=0.1)
    before = _routes(gg)
    out = gg.geglu_ff(x, w0, b0, w2, b2)
    torch.cuda.synchronize()
    assert _routes(gg) == {**before, "mma": before["mma"] + gg.LAUNCHES_PER_CALL}
    torch.testing.assert_close(out.float(), gg.geglu_ff_plain(x, w0, b0, w2, b2).float(),
                               atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


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
