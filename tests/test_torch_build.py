"""The CUDA kernels' build and routing, on the CPU: no card and no nvcc.

``ops/kernels/build.py`` names each library after a hash of its source and of
every ``csrc`` header the source includes, so an edited header is rebuilt and
a stale library is never loaded. The wrappers of the attention (forward and
backward) and GEGLU kernels pick a route in Python (``forward_route``,
``backward_route``, ``route``; the forward's four: "wgmma", "mma",
"tf32x3" (fp32 on the tensor cores), "fma"; GEGLU's four, the same) and refuse, before
any launch, what the tensor-core routes cannot take; so do the conv kernels (``same_route``: "wgmma", "ring" or "v1";
``up2_route``, the up-conv's: "wgmma", "ring" or "v1"). The kernels themselves
are held against their plain versions on the card by
tests/test_torch_kernels_cuda.py.
"""
import re
import shutil

import pytest
import torch

from diffusion_tts_torch.ops.kernels import _launch, build
from diffusion_tts_torch.ops.kernels import conv3x3 as cv
from diffusion_tts_torch.ops.kernels import geglu_ff as gg
from diffusion_tts_torch.ops.kernels import qkv_attention as qk

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

SD_FF_WIDTHS = (320, 640, 1280)  # the SD-1.5 UNet's transformer widths; F = 4C


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc that the build module reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def _append(path, text="\n// edited\n"):
    path.write_text(path.read_text() + text)


@pytest.mark.parametrize("name", build.SOURCES)
def test_library_path_follows_the_source_and_its_headers(csrc, name):
    before = build.library_path(name)
    assert build.library_path(name) == before  # a pure function of the files
    for header in [p for p in build.sources(name) if p.suffix == ".cuh"]:
        _append(header)
        after = build.library_path(name)
        assert after != before, f"{header.name} changed but {name}'s library did not"
        before = after
    _append(csrc / f"{name}.cu")
    assert build.library_path(name) != before


def test_the_tensor_core_kernels_include_the_shared_header():
    """mma_bf16.cuh (the mma.sync helpers) and hopper.cuh (mbarriers, TMA,
    wgmma, the tensor-map encoder) in all four tensor-core sources: each has
    a wgmma route."""
    for name in ("qkv_attention", "attention_bwd", "geglu_ff", "conv3x3"):
        assert [p.name for p in build.sources(name)] == [f"{name}.cu", "hopper.cuh",
                                                         "mma_bf16.cuh"]


def test_library_path_follows_a_header_included_by_a_header(csrc):
    (csrc / "extra.cuh").write_text("#pragma once\n")
    _append(csrc / "mma_bf16.cuh", '\n#include "extra.cuh"\n')
    before = build.library_path("geglu_ff")
    _append(csrc / "extra.cuh")
    assert build.library_path("geglu_ff") != before
    assert [p.name for p in build.sources("geglu_ff")] == ["geglu_ff.cu", "hopper.cuh",
                                                           "mma_bf16.cuh", "extra.cuh"]


def test_library_path_ignores_headers_not_included(csrc):
    before = build.library_path("groupnorm")
    _append(csrc / "mma_bf16.cuh")
    assert build.library_path("groupnorm") == before


def _mma_widths_in_source(name="qkv_attention", macro="DTTS_ATTN_MMA", route="mma", code=1,
                          dtype="bf16"):
    """A tensor-core route's widths as csrc/<name>.cu states them in its
    header ("<route> (route <code>): <dtype> at d = ...,") and as its C entry
    dispatches them (the ``macro(d)`` cases)."""
    src = (build.CSRC / f"{name}.cu").read_text()
    stated = re.search(rf"\b{route} \(route {code}\): {dtype} at d = ([\d, ]+),", src).group(1)
    cases = re.findall(rf"{macro}\((\d+)\)", src)
    return tuple(int(d) for d in stated.split(", ")), tuple(int(d) for d in cases)


@pytest.mark.parametrize("d", qk.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_route_is_the_one_the_source_states(dtype, d):
    """Four routes: bf16 on "wgmma" at the widths csrc/qkv_attention.cu
    states and dispatches for route 2 (the ADM's 64, the SD UNet's 40, 80,
    160, the DDPM++ net's 256, the VAE's 512), on "mma" at the other mma
    widths (the test nets' 16 and 32; the mma kernel still takes every one
    of its widths, for ``route="mma"``); fp32 on "tf32x3" at the widths it
    states and dispatches for route 3 (the ADM's 64 and the DDPM++ net's
    256), on "fma" at the others (the SD UNet's and the VAE's among them)."""
    stated, dispatched = _mma_widths_in_source()
    assert stated == dispatched == qk.MMA_HEAD_DIMS
    wg_stated, wg_dispatched = _mma_widths_in_source(macro="DTTS_ATTN_WGMMA", route="wgmma",
                                                     code=2)
    assert wg_stated == wg_dispatched == qk.WGMMA_HEAD_DIMS
    assert set(wg_stated) <= set(stated) and 256 in wg_stated and 512 in wg_stated
    tf_stated, tf_dispatched = _mma_widths_in_source(macro="DTTS_ATTN_TF32X3", route="tf32x3",
                                                     code=3, dtype="fp32")
    assert tf_stated == tf_dispatched == qk.TF32X3_HEAD_DIMS == (64, 256)
    if dtype == torch.bfloat16:
        want = "wgmma" if d in wg_stated else "mma" if d in stated else "fma"
    else:
        want = "tf32x3" if d in tf_stated else "fma"
    assert qk.forward_route(dtype, d) == want


def test_attention_route_codes_follow_the_source():
    """The forward's, the backward's and GEGLU's route codes are their C
    entries' (0 fma, 1 mma, 2 wgmma; the forward's and GEGLU's 3 tf32x3);
    _launch.ROUTES keeps the two shared ones, the backward the first three."""
    assert qk.ROUTE_CODES == gg.ROUTE_CODES == {"fma": 0, "mma": 1, "wgmma": 2, "tf32x3": 3}
    assert set(qk.ROUTE_LAUNCHES) == set(qk.ROUTES) == {"fma", "mma", "wgmma", "tf32x3"}
    assert set(gg.ROUTE_LAUNCHES) == set(gg.ROUTES) == {"fma", "mma", "wgmma", "tf32x3"}
    assert set(qk.BWD_ROUTE_LAUNCHES) == set(qk.BWD_ROUTES) == {"fma", "mma", "wgmma"}
    assert set(_launch.ROUTES) == {"fma", "mma"}
    for name in ("qkv_attention", "attention_bwd", "geglu_ff"):
        src = (build.CSRC / f"{name}.cu").read_text()
        assert "if (route == 2) {" in src and "if (route == 1) {" in src
    for name in ("qkv_attention", "geglu_ff"):
        assert "if (route == 3) {" in (build.CSRC / f"{name}.cu").read_text()


@pytest.mark.parametrize("d", qk.BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_route_is_the_one_the_source_states(dtype, d):
    """csrc/attention_bwd.cu's mma and wgmma widths, as stated and as
    dispatched: bf16 on "wgmma" at the ADM training path's d = 64 and the
    DDPM++ training path's d = 256, on "mma" at the other mma widths (the SD
    UNet's widest d = 160 among them; the mma kernels still take 64 and 256,
    for ``route="mma"``), fp32 on "fma"."""
    stated, dispatched = _mma_widths_in_source("attention_bwd", "DTTS_ATTN_BWD_MMA")
    assert stated == dispatched == qk.BWD_MMA_HEAD_DIMS
    assert 64 in stated and 160 in stated and 256 in stated
    wg_stated, wg_dispatched = _mma_widths_in_source("attention_bwd", "DTTS_ATTN_BWD_WGMMA",
                                                     route="wgmma", code=2)
    assert wg_stated == wg_dispatched == qk.BWD_WGMMA_HEAD_DIMS == (64, 256)
    assert set(wg_stated) <= set(stated)
    want = "fma"
    if dtype == torch.bfloat16:
        want = "wgmma" if d in wg_stated else "mma" if d in stated else "fma"
    assert qk.backward_route(dtype, d) == want


@pytest.mark.parametrize("c", SD_FF_WIDTHS + (32, 64, 40, 96))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geglu_route_at_the_sd_and_test_widths(dtype, c):
    """The SD-1.5 UNet's (C, 4C) and the test nets' widths: bf16 on "wgmma"
    where C and F are multiples of 64 (every SD width), on "mma" at the
    other multiples of 8; fp32 on the tensor cores, "tf32x3", where C and F
    are multiples of 32 (every SD width again), on the CUDA cores, "fma", at
    the test nets' C = 40 (csrc/geglu_ff.cu's header)."""
    if dtype == torch.bfloat16:
        want = "wgmma" if c % 64 == 0 else "mma"
    else:
        want = "tf32x3" if c % 32 == 0 else "fma"
    assert gg.route(dtype, c, 4 * c) == want
    if c in SD_FF_WIDTHS:
        assert want == ("wgmma" if dtype == torch.bfloat16 else "tf32x3")
    if c == 40:
        assert want == ("mma" if dtype == torch.bfloat16 else "fma")


def test_geglu_wgmma_widths_are_the_ones_the_source_states():
    """csrc/geglu_ff.cu states the wgmma route's widths and checks them in its
    C entry; the wrapper's predicate agrees."""
    src = (build.CSRC / "geglu_ff.cu").read_text()
    stated = re.search(r"wgmma \(route 2\): bf16, C and F multiples of (\d+)", src).group(1)
    assert int(stated) == gg.WGMMA_MULTIPLE == 64
    assert f"c % {stated} || f % {stated}" in src
    assert re.search(r"kWgDepth = (\d+);", src).group(1) == stated


def test_geglu_tf32x3_widths_are_the_ones_the_source_states():
    """csrc/geglu_ff.cu states the tf32x3 route's widths (a TMA box row is 32
    floats) and checks them in its C entry for route 3; the wrapper's
    predicate agrees, and the route's K per stage is a box row."""
    src = (build.CSRC / "geglu_ff.cu").read_text()
    stated = re.search(r"tf32x3 \(route 3\): fp32, C and F multiples of (\d+)", src).group(1)
    assert int(stated) == gg.TF32X3_MULTIPLE == 32
    entry = src[src.index("if (route == 3) {"):src.index("if (route == 2) {")]
    assert f"c % {stated} || f % {stated}" in entry and "dtype != 0" in entry
    assert re.search(r"kTfDepth = (\d+);", src).group(1) == stated
    for c, f in ((32, 96), (96, 384), (320, 1280)):
        assert gg.route(torch.float32, c, f) == "tf32x3"
    for c, f in ((40, 160), (320, 1284), (48, 192)):
        assert gg.route(torch.float32, c, f) == "fma"


# (M, C, F) of the SD-1.5 UNet's GEGLU calls of one SD search, and the
# wgmma plan (rows1, rows2, bn2, split) each takes on a 132-SM card: the
# plans the card's sweep found fastest, or within 3% of it
# (tools/torch_geglu_probe.py --sweep)
SD_FF_PLANS = {(32768, 320, 1280): (192, 128, 160, 1), (8192, 320, 1280): (192, 128, 160, 1),
               (8192, 640, 2560): (192, 128, 160, 1), (2048, 640, 2560): (128, 64, 160, 1),
               (2048, 1280, 5120): (192, 128, 160, 1), (512, 1280, 5120): (192, 64, 128, 1),
               (128, 1280, 5120): (64, 64, 128, 3)}


@pytest.mark.parametrize("m,c,f", list(SD_FF_PLANS) + [(1, 320, 1280), (100, 640, 2560),
                                                       (300, 1280, 5120), (64, 64, 256)])
def test_geglu_wgmma_plan(m, c, f):
    """The wgmma route's plan on a 132-SM card: launch 1's 64-row tiles
    where 128-row ones would not give every SM one, else 128 or 192 rows,
    whichever loads fewer rows into the busiest SM; launch 2's tile (64 or
    128 rows, 128 or 160 columns) with the least work on the busiest SM; a
    depth split only
    where launch 2's tiles fill under a quarter of the block slots, in at
    most 4 shares of at least 4 depth steps. Of the SD calls only the
    C = 1280 one at M = 128 splits."""
    sms = 132
    plan = gg.wgmma_plan(m, c, f, sms)
    rows1, rows2, bn2, split = plan
    waves = lambda rows: -(-(-(-m // rows) * (f // 64)) // sms)
    if -(-m // 128) * (f // 64) >= sms:
        assert rows1 == min((128, 192), key=lambda r: waves(r) * (r + 128))
    else:
        assert rows1 == 64
    work = lambda rows, bn: -(-(-(-m // rows) * -(-c // bn)) // sms) * rows * bn
    assert rows2 in (64, 128) and bn2 in (128, 160)
    assert work(rows2, bn2) == min(work(r, b) for r in (64, 128) for b in (128, 160))
    tiles = -(-m // rows2) * -(-c // bn2)
    slots = sms * (1 if rows2 == 128 else 2)
    assert 1 <= split <= 4 and (split == 1 or f // 64 // split >= 4)
    assert (split > 1) == (8 * tiles <= slots and f // 64 >= 8)
    if (m, c, f) in SD_FF_PLANS:
        assert plan == SD_FF_PLANS[m, c, f]


# The tf32x3 plan (rows1, rows2, bn2, split) of each SD call on a 132-SM card
SD_FF_TF32_PLANS = {(32768, 320, 1280): (128, 128, 160, 1), (8192, 320, 1280): (128, 128, 160, 1),
                    (8192, 640, 2560): (128, 128, 160, 1), (2048, 640, 2560): (128, 64, 160, 1),
                    (2048, 1280, 5120): (128, 128, 160, 1), (512, 1280, 5120): (128, 64, 128, 3),
                    (128, 1280, 5120): (128, 64, 128, 4)}


@pytest.mark.parametrize("m,c,f", list(SD_FF_TF32_PLANS) + [(1, 320, 1280), (100, 640, 2560),
                                                            (300, 1280, 5120), (64, 32, 96)])
def test_geglu_tf32x3_plan(m, c, f):
    """The tf32x3 route's plan on a 132-SM card (one block an SM): launch
    1's tile rows (64 or 128) with the fewest rows loaded and split on the
    busiest SM; launch 2's tile with the least work on the busiest SM;
    launch 2's depth in at most 4 shares of at least 8 depth steps of 32,
    the fewest that give the busiest SM the least depth to run. Of the SD
    calls only the C = 1280 ones at M = 128 and 512 split."""
    sms = 132
    plan = gg.tf32x3_plan(m, c, f, sms)
    rows1, rows2, bn2, split = plan
    load = lambda rows: -(-(-(-m // rows) * (f // 64)) // sms) * (rows + 128)
    assert rows1 in (64, 128) and load(rows1) == min(load(r) for r in (64, 128))
    work = lambda rows, bn: -(-(-(-m // rows) * -(-c // bn)) // sms) * rows * bn
    assert rows2 in (64, 128) and bn2 in (128, 160)
    assert work(rows2, bn2) == min(work(r, b) for r in (64, 128) for b in (128, 160))
    tiles = -(-m // rows2) * -(-c // bn2)
    shares = [s for s in range(1, 5) if s == 1 or f // 32 // s >= 8]
    depth = lambda s: -(-tiles * s // sms) / s  # the busiest SM's units x a share's depth
    assert split in shares and depth(split) == min(depth(s) for s in shares)
    assert all(depth(s) > depth(split) for s in shares if s < split)
    if (m, c, f) in SD_FF_TF32_PLANS:
        assert plan == SD_FF_TF32_PLANS[m, c, f]


@pytest.fixture
def recorded_geglu(monkeypatch):
    """Bind a recorder in place of GEGLU's C entry (CPU tensors stand in for
    the card's, a 132-SM card): each launch's route code, plan and whether it
    was given the split's scratch."""
    calls = []

    def fn(*args):
        calls.append((args[11], tuple(args[14:18]), args[12] is not None))
        return 0

    monkeypatch.setattr(_launch, "bind", lambda *args: fn)
    monkeypatch.setattr(_launch, "check", lambda x, name: None)
    monkeypatch.setattr(_launch, "stream", lambda t: 0)
    monkeypatch.setattr(gg, "_sm_count", lambda index: 132)
    monkeypatch.setattr(gg, "LAUNCHES", gg.LAUNCHES)
    monkeypatch.setattr(gg, "ROUTE_LAUNCHES", dict.fromkeys(gg.ROUTES, 0))
    return calls


@pytest.mark.parametrize("m,c,route,want", [
    (128, 1280, None, ("tf32x3", (128, 64, 128, 4))),
    (2048, 640, None, ("tf32x3", (128, 64, 160, 1))),
    (300, 320, None, ("tf32x3", gg.tf32x3_plan(300, 320, 1280, 132))),
    (128, 1280, "fma", ("fma", (0, 0, 0, 1))), (4, 40, None, ("fma", (0, 0, 0, 1)))])
def test_geglu_fp32_launch_takes_route_3_with_its_plan(recorded_geglu, m, c, route, want):
    """fp32 at the SD widths reaches the C entry as route 3 with
    tf32x3_plan's plan (and the split's scratch where it splits); route="fma"
    and the test nets' C = 40 reach it as route 0, with no plan."""
    f = 4 * c
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    out = gg._geglu_ff_kernel(zeros(m, c), zeros(2 * f, c), zeros(2 * f), zeros(c, f), zeros(c),
                              forced=route)
    assert out.shape == (m, c)
    assert recorded_geglu == [(gg.ROUTE_CODES[want[0]], want[1], want[1][3] > 1)]
    assert gg.ROUTE_LAUNCHES == {**dict.fromkeys(gg.ROUTES, 0), want[0]: gg.LAUNCHES_PER_CALL}


@pytest.mark.parametrize("case", ["x", "w0", "b0", "b2", "bf16", "width"])
def test_geglu_refuses_what_the_tf32x3_route_cannot_take(no_launch, monkeypatch, case):
    """fp32 at an SD width with an operand or bias not 16-byte aligned (TMA
    reads 16-byte pieces) is refused before any launch, and so is "tf32x3"
    asked for in bf16 or at the test nets' C = 40. Nothing falls back to
    "fma"."""
    monkeypatch.setattr(_launch, "check", lambda x, name: None)  # CPU tensors stand in
    c = 40 if case == "width" else 320
    f = 4 * c
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    off = lambda shape, bad: (torch.zeros(torch.Size(shape).numel() + 1, dtype=dtype)[1:]
                              if bad else torch.zeros(torch.Size(shape).numel(), dtype=dtype)
                              ).view(shape)
    args = [off(shape, case == name) for name, shape in
            (("x", (4, c)), ("w0", (2 * f, c)), ("b0", (2 * f,)), ("w2", (c, f)), ("b2", (c,)))]
    forced = "tf32x3" if case in ("bf16", "width") else None
    match = "16-byte" if forced is None else "tf32x3 route takes float32"
    before = (gg.LAUNCHES, dict(gg.ROUTE_LAUNCHES))
    with pytest.raises(ValueError, match=match):
        gg._geglu_ff_kernel(*args, forced=forced)
    assert (gg.LAUNCHES, gg.ROUTE_LAUNCHES) == before


@pytest.mark.parametrize("case", ["width", "fp32", "pointer", "bias", "unknown"])
def test_geglu_refuses_what_the_wgmma_route_cannot_take(no_launch, monkeypatch, case):
    """A "wgmma" forced at a width it cannot take (C = 96, not a multiple of
    64) or in fp32, or an operand or bias not 16-byte aligned on the route
    the predicate gave it, or an unknown route: refused before any launch.
    Nothing falls back to the mma route."""
    monkeypatch.setattr(_launch, "check", lambda x, name: None)  # CPU tensors stand in
    c = 96 if case == "width" else 64
    f = 4 * c
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    x = torch.zeros(4 * c + 1, dtype=dtype)
    x = (x[1:] if case == "pointer" else x[:-1]).view(4, c)
    w0, w2 = torch.zeros((2 * f, c), dtype=dtype), torch.zeros((c, f), dtype=dtype)
    b0 = torch.zeros(2 * f + 1, dtype=dtype)
    b0 = b0[1:] if case == "bias" else b0[:-1]
    b2 = torch.zeros(c, dtype=dtype)
    forced = {"width": "wgmma", "fp32": "wgmma", "unknown": "tensor"}.get(case)
    match = {"pointer": "16-byte", "bias": "16-byte", "unknown": "route must be one of"}.get(
        case, "wgmma route takes bfloat16")
    before = (gg.LAUNCHES, dict(gg.ROUTE_LAUNCHES))
    with pytest.raises(ValueError, match=match):
        gg._geglu_ff_kernel(x, w0, b0, w2, b2, forced=forced)
    assert (gg.LAUNCHES, gg.ROUTE_LAUNCHES) == before


@pytest.fixture
def no_launch(monkeypatch):
    """Make any attempt to bind a kernel fail loudly: a refusal must come first."""
    def bind(*args):
        raise AssertionError(f"a kernel was bound: {args[:2]}")
    monkeypatch.setattr(_launch, "bind", bind)


@pytest.mark.parametrize("c,f", [(100, 400), (320, 1284)])
def test_geglu_refuses_widths_the_mma_route_cannot_take(no_launch, c, f):
    assert gg.route(torch.float32, c, f) == "fma"
    with pytest.raises(ValueError, match="multiples of 8"):
        gg.route(torch.bfloat16, c, f)
    x = torch.zeros((4, c), dtype=torch.bfloat16)
    w0, b0 = torch.zeros((2 * f, c), dtype=torch.bfloat16), torch.zeros(2 * f, dtype=torch.bfloat16)
    w2, b2 = torch.zeros((c, f), dtype=torch.bfloat16), torch.zeros(c, dtype=torch.bfloat16)
    before = dict(gg.ROUTE_LAUNCHES)
    with pytest.raises(ValueError, match="multiples of 8"):
        gg._geglu_ff_kernel(x, w0, b0, w2, b2)
    assert gg.ROUTE_LAUNCHES == before


def test_geglu_refuses_a_misaligned_operand_before_any_launch(no_launch, monkeypatch):
    monkeypatch.setattr(_launch, "check", lambda x, name: None)  # CPU tensors stand in
    c, f = 32, 64
    x = torch.zeros(4 * c + 1, dtype=torch.bfloat16)[1:].view(4, c)  # 2 bytes off
    w0, b0 = torch.zeros((2 * f, c), dtype=torch.bfloat16), torch.zeros(2 * f, dtype=torch.bfloat16)
    w2, b2 = torch.zeros((c, f), dtype=torch.bfloat16), torch.zeros(c, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        gg._geglu_ff_kernel(x, w0, b0, w2, b2)
    with pytest.raises(ValueError, match="mma route takes bfloat16"):
        gg._geglu_ff_kernel(x.float(), w0.float(), b0.float(), w2.float(), b2.float(),
                            forced="mma")


@pytest.mark.parametrize("case", ["pointer", "token_stride", "head_stride", "mma_pointer",
                                  "wgmma_fp32", "wgmma_at_32", "wgmma_at_512"])
def test_attention_refuses_what_the_wgmma_route_cannot_take(no_launch, case):
    """A wgmma width (40) with a misaligned pointer or stride, on its own
    route or forced onto "mma", is refused before any launch (TMA and the
    mma copies both read 16-byte pieces), and so is the VAE head's width
    (512, now a wgmma width) with a misaligned pointer on "wgmma"; so is
    "wgmma" asked for in fp32 or at a width that is not its own. Nothing
    falls back to another route."""
    d = {"wgmma_at_32": 32, "wgmma_at_512": 512}.get(case, 40)
    b, t, h = 1, 4, 2
    dtype = torch.float32 if case == "wgmma_fp32" else torch.bfloat16
    out = torch.empty((b, t, h, d), dtype=dtype)
    ptrs = [out.data_ptr()] * 3
    strides = [t * h * d, h * d, d]
    if case in ("pointer", "mma_pointer", "wgmma_at_512"):
        ptrs[2] += 2
    if case == "token_stride":
        strides[1] = h * d + 4
    if case == "head_stride":
        strides[2] = d + 4
    route = {"mma_pointer": "mma", "wgmma_fp32": "wgmma", "wgmma_at_32": "wgmma",
             "wgmma_at_512": "wgmma"}.get(case)
    before = (qk.LAUNCHES, dict(qk.ROUTE_LAUNCHES))
    match = ("wgmma route takes bfloat16" if case in ("wgmma_fp32", "wgmma_at_32")
             else "16-byte")
    with pytest.raises(ValueError, match=match):
        qk._launch_kernel(*ptrs, out, d, b, h, t, tuple(strides), (t * h * d, h * d, d),
                          route=route)
    assert (qk.LAUNCHES, qk.ROUTE_LAUNCHES) == before


@pytest.mark.parametrize("b,t,want", [
    (8, 256, 4), (8, 64, 1),      # the CIFAR-10 search: 32 q tiles, 4 key tiles; one key tile
    (16, 256, 2), (4, 256, 4),    # a rejection batch; a beam batch
    (32, 256, 1), (32, 64, 1),    # the DDPM++ training micro-batch: 128 tiles
    (128, 256, 1), (128, 64, 1),  # train_bench --arch cifar10 --batch 128: 512 tiles
    (1, 77, 2), (1, 1, 1), (1, 1000, 4), (33, 256, 1)])
def test_wgmma_split_at_the_ddpmpp_shapes(b, t, want):
    """d = 256's key split on a 132-SM card: 4 CTAs a q tile where that
    still fits the card (the serving path's [8, 256, 768]), 2 where only
    that does, 1 where the q tiles alone fill it or where a tile has fewer
    64-key tiles than the factor; the grid never exceeds the SMs."""
    got = qk.wgmma_split(b, 1, t, 132, {2: 66, 4: 33})
    assert got == want and got in qk.WGMMA_SPLITS
    tiles = b * -(-t // 64)
    assert got == 1 or (tiles * got <= 132 and got <= -(-t // 64))


@pytest.mark.parametrize("clusters,want", [({2: 66, 4: 33}, 4), ({2: 66, 4: 30}, 2),
                                           ({2: 31, 4: 30}, 1), ({2: 0, 4: 0}, 1)])
def test_wgmma_split_takes_only_clusters_the_card_holds_at_once(clusters, want):
    """At [8, 256, 768] (32 q tiles) a factor is taken only where the card
    holds all 32 of its clusters at once: a second wave of clusters would
    cost more than the split saves."""
    assert qk.wgmma_split(8, 1, 256, 132, clusters) == want


@pytest.fixture
def recorded_launch(monkeypatch):
    """Bind a recorder in place of the C entry (CPU tensors stand in for
    the card's, a 132-SM card): the launches' (route code, split,
    consumer warpgroups), and the counters restored afterwards."""
    calls = []

    def fn(*args):
        calls.append(tuple(args[-4:-1]))  # route, split, consumers
        return 0

    monkeypatch.setattr(_launch, "bind", lambda *args: fn)
    monkeypatch.setattr(_launch, "stream", lambda t: 0)
    monkeypatch.setattr(qk, "card_limits", lambda device: (132, {2: 66, 4: 33}))
    monkeypatch.setattr(qk, "LAUNCHES", qk.LAUNCHES)
    monkeypatch.setattr(qk, "ROUTE_LAUNCHES", dict.fromkeys(qk.ROUTES, 0))
    return calls


@pytest.mark.parametrize("b,t,route,want", [
    (8, 256, None, ("wgmma", 4, 1)), (8, 64, None, ("wgmma", 1, 1)),
    (32, 256, None, ("wgmma", 1, 1)), (128, 256, None, ("wgmma", 1, 2)),
    (8, 256, "mma", ("mma", 1, 1)), (32, 64, "mma", ("mma", 1, 1)),
    (8, 256, "fma", ("fma", 1, 1))])
def test_attention_at_256_takes_wgmma_and_still_serves_mma(recorded_launch, b, t, route, want):
    """bf16 at d = 256 (the DDPM++ net's head, [B, T, 768]) launches the
    wgmma route with wgmma_plan's split and consumer warpgroups; route="mma"
    still launches the mma.sync design there (and "fma" the first one),
    unsplit, one block layout."""
    d = 256
    assert qk.forward_route(torch.bfloat16, d) == "wgmma"
    assert qk.forward_route(torch.bfloat16, 512) == "wgmma"
    assert qk.forward_route(torch.float32, d) == "tf32x3"
    out = torch.empty((b, t, d), dtype=torch.bfloat16)
    ptr = out.data_ptr()
    qk._launch_kernel(ptr, ptr, ptr, out, d, b, 1, t, (t * 3 * d, 3 * d, d), (t * d, d, d),
                      route=route)
    assert recorded_launch == [(qk.ROUTE_CODES[want[0]], *want[1:])]
    assert qk.ROUTE_LAUNCHES[want[0]] == 1 and sum(qk.ROUTE_LAUNCHES.values()) == 1


@pytest.mark.parametrize("b,t,route,want", [
    (1, 4096, None, ("wgmma", 1, 2)),   # the VAE head's final decode: 64 q tiles
    (4, 4096, None, ("wgmma", 1, 2)),   # its candidates' decodes: 256 q tiles
    (2, 300, None, ("wgmma", 1, 2)), (1, 32, None, ("wgmma", 1, 2)),
    (1, 4096, "mma", ("mma", 1, 1)), (4, 4096, "fma", ("fma", 1, 1))])
def test_attention_at_512_takes_wgmma_with_its_plan(recorded_launch, b, t, route, want):
    """bf16 at d = 512 (the SD VAE mid-block's head, [B, T, 1, 512])
    launches the wgmma route (code 2) with its one plan at every batch:
    two column warpgroups, no key split; route="mma" still launches the
    mma.sync design there and "fma" the first one, unsplit, one block
    layout."""
    d = 512
    assert qk.forward_route(torch.bfloat16, d) == "wgmma"
    out = torch.empty((b, t, 1, d), dtype=torch.bfloat16)
    ptr, strides = out.data_ptr(), (t * d, d, d)
    qk._launch_kernel(ptr, ptr, ptr, out, d, b, 1, t, strides, strides, route=route)
    assert recorded_launch == [(qk.ROUTE_CODES[want[0]], *want[1:])]
    assert qk.ROUTE_LAUNCHES[want[0]] == 1 and sum(qk.ROUTE_LAUNCHES.values()) == 1


def test_attention_at_512_fp32_takes_fma(recorded_launch):
    """fp32 at d = 512 stays on the fp32 FMA kernel (the tf32x3 route takes
    d = 64 and 256); the wgmma route takes bf16 only."""
    b, t, d = 1, 300, 512
    assert qk.forward_route(torch.float32, d) == "fma"
    out = torch.empty((b, t, 1, d), dtype=torch.float32)
    ptr, strides = out.data_ptr(), (t * d, d, d)
    qk._launch_kernel(ptr, ptr, ptr, out, d, b, 1, t, strides, strides)
    with pytest.raises(ValueError, match="wgmma route takes bfloat16"):
        qk._launch_kernel(ptr, ptr, ptr, out, d, b, 1, t, strides, strides, route="wgmma")
    assert recorded_launch == [(qk.ROUTE_CODES["fma"], 1, 1)]


@pytest.mark.parametrize("d", [80, 160])
def test_attention_sd_widths_in_fp32_take_fma(recorded_launch, d):
    """The SD UNet's fp32 widths stay on the fp32 FMA kernel (the tf32x3
    kernel reads whole 128-byte boxes of 32 floats: d = 64 and 256);
    "tf32x3" forced there is refused before any launch."""
    b, t, h = 2, 100, 2
    assert qk.forward_route(torch.float32, d) == "fma"
    out = torch.empty((b, t, h, d), dtype=torch.float32)
    ptr, strides = out.data_ptr(), (t * h * d, h * d, d)
    qk._launch_kernel(ptr, ptr, ptr, out, d, b, h, t, strides, strides)
    with pytest.raises(ValueError, match="tf32x3 route takes float32"):
        qk._launch_kernel(ptr, ptr, ptr, out, d, b, h, t, strides, strides, route="tf32x3")
    assert recorded_launch == [(qk.ROUTE_CODES["fma"], 1, 1)]


# (d, B, T, heads, route, (route, split, consumers)) of fp32 launches on a
# 132-SM card: the ADM's sites at the search's batch 8 and the training
# micro-batch 16, the DDPM++ net's at the search's batch 8 ([8, 256, 768]:
# 32 q tiles, split 4; [8, 64, 768]: four 16-key tiles, split 4), a
# rejection batch, the training micro-batch 32 and reward_curve's batch 32
# and 16 at T = 64, a ragged T; forced "fma" takes the first design.
TF32X3_LAUNCHES = [
    (64, 8, 1024, 6, None, ("tf32x3", 1, 1)), (64, 8, 256, 9, None, ("tf32x3", 1, 1)),
    (64, 8, 64, 12, None, ("tf32x3", 1, 1)), (64, 16, 1024, 6, None, ("tf32x3", 1, 1)),
    (64, 2, 200, 3, None, ("tf32x3", 1, 1)), (64, 8, 1024, 6, "fma", ("fma", 1, 1)),
    (256, 8, 256, 1, None, ("tf32x3", 4, 1)), (256, 8, 64, 1, None, ("tf32x3", 4, 1)),
    (256, 16, 256, 1, None, ("tf32x3", 2, 1)), (256, 32, 256, 1, None, ("tf32x3", 1, 1)),
    (256, 32, 64, 1, None, ("tf32x3", 4, 1)), (256, 16, 64, 1, None, ("tf32x3", 4, 1)),
    (256, 2, 200, 1, None, ("tf32x3", 4, 1)), (256, 1, 1, 1, None, ("tf32x3", 1, 1)),
    (256, 8, 256, 1, "fma", ("fma", 1, 1))]


@pytest.mark.parametrize("d,b,t,h,route,want", TF32X3_LAUNCHES)
def test_attention_fp32_takes_tf32x3_with_its_plan(recorded_launch, d, b, t, h, route, want):
    """fp32 at the ADM's d = 64 and the DDPM++ net's d = 256 launches the
    tf32x3 route (code 3) with tf32x3_plan's key split (d = 256 only, over
    16-key tiles) and one consumer warpgroup; route="fma" still launches the
    first design there. Each launch counts once on its route."""
    assert qk.forward_route(torch.float32, d) == "tf32x3"
    out = torch.empty((b, t, h * d), dtype=torch.float32)
    ptr = out.data_ptr()
    qk._launch_kernel(ptr, ptr, ptr, out, d, b, h, t, (t * 3 * h * d, 3 * h * d, d),
                      (t * h * d, h * d, d), route=route)
    assert recorded_launch == [(qk.ROUTE_CODES[want[0]], *want[1:])]
    assert qk.ROUTE_LAUNCHES == {**dict.fromkeys(qk.ROUTES, 0), want[0]: 1}
    if route is None:
        assert want[1:] == qk.tf32x3_plan(d, b, h, t, 132, {2: 66, 4: 33})


@pytest.mark.parametrize("split", qk.WGMMA_SPLITS)
def test_tf32x3_forced_split_reaches_the_launch(recorded_launch, split):
    """split= forces d = 256's key split on the tf32x3 route as on wgmma
    (tests and probes), with one consumer warpgroup."""
    out = torch.empty((8, 256, 1, 256), dtype=torch.float32)
    ptr, s = out.data_ptr(), (256 * 256, 256, 256)
    qk._launch_kernel(ptr, ptr, ptr, out, 256, 8, 1, 256, s, s, split=split)
    assert recorded_launch == [(3, split, 1)]


@pytest.mark.parametrize("case", ["pointer", "token_stride", "head_stride", "out_pointer",
                                  "bf16_forced", "at_80", "mma_forced", "wgmma_forced",
                                  "split", "split_of_8"])
@pytest.mark.parametrize("d", qk.TF32X3_HEAD_DIMS)
def test_attention_refuses_what_the_tf32x3_route_cannot_take(no_launch, d, case):
    """fp32 at a tf32x3 width with a pointer (q|k|v or the output) or a
    token or head stride that TMA cannot take (not a multiple of 16 bytes)
    is refused before any kernel is bound; so is "tf32x3" forced in bf16 or
    at a width that is not its own, "mma" or "wgmma" forced in fp32, and a
    key split the route does not take (any at d = 64; 3 and 8 at 256).
    Nothing falls back to another route."""
    b, t, h = 1, 4, 2
    d = 80 if case == "at_80" else d
    dtype = torch.bfloat16 if case == "bf16_forced" else torch.float32
    flat = torch.empty(b * t * h * d + 1, dtype=dtype)
    out = (flat[1:] if case == "out_pointer" else flat[:-1]).view(b, t, h, d)
    ptrs = [flat.data_ptr()] * 3
    strides = [t * h * d, h * d, d]
    if case == "pointer":
        ptrs[1] += 4
    if case == "token_stride":
        strides[1] = h * d + 2
    if case == "head_stride":
        strides[2] = d + 1
    route = {"bf16_forced": "tf32x3", "at_80": "tf32x3", "mma_forced": "mma",
             "wgmma_forced": "wgmma"}.get(case)
    split = {"split": 2 if d == 64 else 3, "split_of_8": 8}.get(case)
    match = {"bf16_forced": "tf32x3 route takes float32", "at_80": "tf32x3 route takes float32",
             "mma_forced": "mma route takes bfloat16", "wgmma_forced": "wgmma route takes bfloat16",
             "split": "key split takes", "split_of_8": "key split takes"}.get(case, "16-byte")
    before = (qk.LAUNCHES, dict(qk.ROUTE_LAUNCHES))
    with pytest.raises(ValueError, match=match):
        qk._launch_kernel(*ptrs, out, d, b, h, t, tuple(strides), (t * h * d, h * d, d),
                          route=route, split=split)
    assert (qk.LAUNCHES, qk.ROUTE_LAUNCHES) == before


@pytest.mark.parametrize("d,bk", list(qk.TF32X3_KEY_ROWS.items()))
def test_tf32x3_key_rows_are_the_ones_the_source_takes(d, bk):
    """The K/V tile's keys (TF32X3_KEY_ROWS, over which tf32x3_plan counts
    a split's tiles) are the source's Tf32Tiles: 32 at d = 64, 16 at 256;
    the split takes 1 where the 16-key tiles are fewer than the factor."""
    src = (build.CSRC / "qkv_attention.cu").read_text()
    assert "static constexpr int kBK = D > 128 ? 16 : 32;   // keys per K/V tile" in src
    assert bk == (16 if d > 128 else 32)
    assert qk.tf32x3_plan(256, 8, 1, 32, 132, {2: 66, 4: 33}) == (2, 1)  # two 16-key tiles
    assert qk.tf32x3_plan(256, 8, 1, 16, 132, {2: 66, 4: 33}) == (1, 1)
    assert qk.tf32x3_plan(64, 1, 1, 64, 132, {2: 66, 4: 33}) == (1, 1)


@pytest.mark.parametrize("b,h,t", [
    (1, 1, 4096), (4, 1, 4096),   # the VAE head's decode batches 1 and 4
    (2, 1, 4096), (1, 1, 1024),   # a 256x256 decode
    (1, 1, 64), (1, 1, 32), (8, 1, 1024), (3, 1, 1000)])
def test_wgmma_plan_at_512(b, h, t):
    """d = 512's plan on a 132-SM card, whatever the clusters: two consumer
    warpgroups (they share the q rows and split O's columns) and no key
    split, which only d = 256 takes."""
    for clusters in ({2: 66, 4: 33}, {2: 0, 4: 0}):
        assert qk.wgmma_plan(512, b, h, t, 132, clusters) == (1, 2)
    assert qk.wgmma_consumers(b, h, t, 132, 512) == 2
    assert qk.wgmma_plan(512, b, h, t, 132, {2: 66, 4: 33}, split=1) == (1, 2)


@pytest.mark.parametrize("d,route,split", [(256, None, 3), (256, None, 8), (256, "mma", 2),
                                           (256, "fma", 4), (64, None, 2), (160, None, 4),
                                           (512, None, 2)])
def test_attention_refuses_a_split_it_cannot_take(no_launch, d, route, split):
    """A forced key split is d = 256's on the wgmma route, of WGMMA_SPLITS;
    anything else is refused before any launch (split=1 is the unsplit
    kernel everywhere)."""
    b, t, h = 2, 128, 1
    out = torch.empty((b, t, h, d), dtype=torch.bfloat16)
    ptr = out.data_ptr()
    strides = (t * h * d, h * d, d)
    before = (qk.LAUNCHES, dict(qk.ROUTE_LAUNCHES))
    with pytest.raises(ValueError, match="key split takes"):
        qk._launch_kernel(ptr, ptr, ptr, out, d, b, h, t, strides, strides, route=route,
                          split=split)
    assert (qk.LAUNCHES, qk.ROUTE_LAUNCHES) == before


def test_attention_forced_split_reaches_the_launch(recorded_launch):
    """split= of _launch_kernel (the tests' and probes' handle, through
    _qkv_forward and _bthd_forward) reaches the C entry at d = 256 on the
    wgmma route, with one consumer warpgroup; 1 is taken anywhere."""
    for split in qk.WGMMA_SPLITS:
        out = torch.empty((8, 256, 1, 256), dtype=torch.bfloat16)
        ptr, s = out.data_ptr(), (256 * 256, 256, 256)
        qk._launch_kernel(ptr, ptr, ptr, out, 256, 8, 1, 256, s, s, split=split)
    out = torch.empty((2, 64, 2, 64), dtype=torch.bfloat16)
    ptr, s = out.data_ptr(), (64 * 128, 128, 64)
    qk._launch_kernel(ptr, ptr, ptr, out, 64, 2, 2, 64, s, s, split=1)
    assert recorded_launch == [(2, 1, 1), (2, 2, 1), (2, 4, 1), (2, 1, 1)]


@pytest.mark.parametrize("d,b,h,t,want", [
    (256, 8, 1, 256, (4, 1)), (256, 8, 1, 64, (1, 1)),     # the CIFAR-10 search
    (256, 4, 1, 256, (4, 1)), (256, 16, 1, 256, (2, 1)),   # MCTS; rejection and beam
    (256, 32, 1, 256, (1, 1)),                             # the DDPM++ training micro-batch
    (256, 128, 1, 256, (1, 2)), (256, 128, 1, 300, (1, 2)),  # train_bench --batch 128
    (256, 128, 1, 64, (1, 1)), (256, 66, 1, 256, (1, 2)), (256, 65, 1, 256, (1, 1)),
    (64, 8, 6, 1024, (1, 2)), (160, 2, 8, 256, (1, 1)), (40, 2, 8, 4096, (1, 2))])
def test_wgmma_plan_at_the_ddpmpp_and_other_shapes(d, b, h, t, want):
    """(key split, consumer warpgroups) on a 132-SM card: a split only at
    d = 256, with one consumer warpgroup; unsplit, two where t > 64 and
    128-row tiles still give every SM one (b * h * ceil(t / 128) >= 132),
    else one. The C entry takes the pair as it is."""
    plan = qk.wgmma_plan(d, b, h, t, 132, {2: 66, 4: 33})
    assert plan == want
    split, consumers = plan
    assert consumers == qk.wgmma_consumers(b, h, t, 132) or split > 1
    assert (consumers == 2) == (split == 1 and t > 64 and b * h * -(-t // 128) >= 132)


@pytest.mark.parametrize("split", qk.WGMMA_SPLITS)
def test_wgmma_plan_takes_a_forced_split_with_one_consumer(split):
    """A forced factor at train_bench's shape, where 128-row tiles fill the
    card: a split takes one consumer warpgroup, split 1 the unsplit plan."""
    assert qk.wgmma_plan(256, 128, 1, 256, 132, {2: 66, 4: 33}, split=split) == (
        split, 2 if split == 1 else 1)


@pytest.mark.parametrize("case", ["pointer", "token_stride", "head_stride", "fp32_forced"])
def test_attention_refuses_what_the_mma_route_cannot_take(no_launch, case):
    b, t, h, d = 1, 4, 2, 40
    dtype = torch.float32 if case == "fp32_forced" else torch.bfloat16
    out = torch.empty((b, t, h, d), dtype=dtype)
    ptrs = [out.data_ptr()] * 3
    strides = [t * h * d, h * d, d]
    if case == "pointer":
        ptrs[1] += 2
    if case == "token_stride":
        strides[1] = h * d + 4  # 88 bytes in bf16
    if case == "head_stride":
        strides[2] = 44
    before = (qk.LAUNCHES, dict(qk.ROUTE_LAUNCHES))
    match = "mma route takes bfloat16" if case == "fp32_forced" else "16-byte"
    with pytest.raises(ValueError, match=match):
        qk._launch_kernel(*ptrs, out, d, b, h, t, tuple(strides), (t * h * d, h * d, d),
                          route="mma" if case == "fp32_forced" else None)
    assert (qk.LAUNCHES, qk.ROUTE_LAUNCHES) == before


@pytest.mark.parametrize("case", ["pointer", "token_stride", "head_stride", "fp32_forced"])
def test_attention_bwd_refuses_what_the_mma_route_cannot_take(no_launch, case):
    b, t, h, d = 1, 4, 2, 40
    dtype = torch.float32 if case == "fp32_forced" else torch.bfloat16
    o, g = (torch.zeros((b, t, h * d), dtype=dtype) for _ in range(2))
    lse = torch.zeros((b, h, t))
    ptrs = [o.data_ptr()] * 3
    strides = [t * h * d, h * d, d]
    if case == "pointer":
        ptrs[1] += 2
    if case == "token_stride":
        strides[1] = h * d + 4  # 168 bytes in bf16
    if case == "head_stride":
        strides[2] = 44
    before = (qk.BWD_LAUNCHES, dict(qk.BWD_ROUTE_LAUNCHES))
    match = "mma route takes bfloat16" if case == "fp32_forced" else "16-byte"
    with pytest.raises(ValueError, match=match):
        qk._launch_bwd(*ptrs, o, g, lse, *ptrs, d, b, h, t, tuple(strides), (t * h * d, h * d, d),
                       route="mma" if case == "fp32_forced" else None)
    assert (qk.BWD_LAUNCHES, qk.BWD_ROUTE_LAUNCHES) == before


@pytest.mark.parametrize("case", ["pointer", "token_stride", "head_stride", "g_pointer",
                                  "o_pointer", "out_pointer", "fp32_forced", "wgmma_at_40",
                                  "mma_at_8"])
@pytest.mark.parametrize("d", qk.BWD_WGMMA_HEAD_DIMS)
def test_attention_bwd_refuses_what_the_wgmma_route_cannot_take(no_launch, d, case):
    """A wgmma width of the backward (64, 256) with a pointer (q/k/v, g, o,
    the results) or a token or head stride that TMA cannot take is refused
    before any kernel is bound; so is "wgmma" forced in fp32 or at a width
    that is not its own, and "mma" forced where the predicate gives
    neither tensor-core route. Nothing falls back to another route."""
    b, t, h = 1, 4, 2
    d = {"wgmma_at_40": 40, "mma_at_8": 8}.get(case, d)
    dtype = torch.float32 if case == "fp32_forced" else torch.bfloat16
    flat = torch.zeros(b * t * h * d + 8, dtype=dtype)
    o, g = (flat[1 if case == f"{name}_pointer" else 0:][:b * t * h * d].view(b, t, h * d)
            for name in ("o", "g"))  # 2 bytes off where the case says so
    lse = torch.zeros((b, h, t))
    ptrs = [flat.data_ptr()] * 3
    if case == "pointer":
        ptrs[2] += 2
    out = list(ptrs)
    if case == "out_pointer":
        out[0] += 4
    strides = [t * h * d, h * d, d]
    if case == "token_stride":
        strides[1] = h * d + 4
    if case == "head_stride":
        strides[2] = d + 4
    route = {"fp32_forced": "wgmma", "wgmma_at_40": "wgmma", "mma_at_8": "mma"}.get(case)
    match = f"{route} route takes bfloat16" if route else "16-byte"
    before = (qk.BWD_LAUNCHES, dict(qk.BWD_ROUTE_LAUNCHES))
    with pytest.raises(ValueError, match=match):
        qk._launch_bwd(*ptrs, o, g, lse, *out, d, b, h, t, tuple(strides), (t * h * d, h * d, d),
                       route=route)
    assert (qk.BWD_LAUNCHES, qk.BWD_ROUTE_LAUNCHES) == before


@pytest.mark.parametrize("d,want", [(64, (1, 1)), (256, (1, 2))])
def test_bwd_wgmma_plan_is_the_one_the_source_takes(d, want):
    """The wgmma backward's (dQ, dK/dV) warpgroups a block: one and one at
    d = 64 (blocks of one warpgroup feeding their own rings, three to an
    SM), one and two at d = 256 (dQ's 64 x 256 fp32 in one warpgroup, dK's
    and dV's columns split over two); the C entry refuses any other, as its
    launcher states."""
    assert qk.bwd_wgmma_plan(d) == want
    src = (build.CSRC / "attention_bwd.cu").read_text()
    assert "kDkvWarpgroups = kWide ? 2 : 1;" in src
    assert "if (dq_nc != 1 || dkv_nc != WgBwd<D>::kDkvWarpgroups)" in src


@pytest.fixture
def recorded_bwd(monkeypatch):
    """Bind a recorder in place of the backward's C entry (CPU tensors stand
    in for the card's): each call's (route code, dQ warpgroups, dK/dV
    warpgroups), and the counters restored afterwards."""
    calls = []

    def fn(*args):
        calls.append(tuple(args[-4:-1]))
        return 0

    monkeypatch.setattr(_launch, "bind", lambda *args: fn)
    monkeypatch.setattr(_launch, "stream", lambda t: 0)
    monkeypatch.setattr(qk, "BWD_LAUNCHES", qk.BWD_LAUNCHES)
    monkeypatch.setattr(qk, "BWD_ROUTE_LAUNCHES", dict.fromkeys(qk.ROUTES, 0))
    return calls


@pytest.mark.parametrize("d,b,h,t", [(64, 16, 6, 1024), (64, 16, 12, 64), (64, 2, 3, 100),
                                     (256, 32, 1, 256), (256, 128, 1, 256), (256, 32, 1, 64)])
@pytest.mark.parametrize("route", [None, "mma", "fma"])
def test_attention_bwd_route_and_plan_reach_the_launch(recorded_bwd, d, b, h, t, route):
    """At the training widths the default backward reaches the C entry's
    route 2 with bwd_wgmma_plan's warpgroups and returns the fp32
    [B, H, T] buffer its dQ launch fills with delta; a forced "mma" reaches
    the mma kernels (route 1, plan (1, 1)) and "fma" the first design (route
    0), each with the wrapper's delta. Each call counts two launches on its
    route."""
    o = torch.zeros((b, t, h * d), dtype=torch.bfloat16)
    g = torch.randn((b, t, h * d)).bfloat16()
    lse = torch.zeros((b, h, t))
    ptr, s = o.data_ptr(), (t * h * d, h * d, d)
    delta = qk._launch_bwd(ptr, ptr, ptr, o, g, lse, ptr, ptr, ptr, d, b, h, t, s, s,
                           route=route)
    want = route or "wgmma"
    plan = qk.bwd_wgmma_plan(d) if want == "wgmma" else (1, 1)
    assert recorded_bwd == [(qk.ROUTE_CODES[want], *plan)]
    assert qk.BWD_ROUTE_LAUNCHES == {**dict.fromkeys(qk.ROUTES, 0),
                                     want: qk.BWD_LAUNCHES_PER_CALL}
    assert delta.shape == (b, h, t) and delta.dtype == torch.float32
    if want != "wgmma":  # the wrapper's row term, zero here (o is zero)
        assert torch.equal(delta, torch.zeros((b, h, t)))


def test_check_aligned():
    _launch.check_aligned("k", (0, 16, 4096), (8, 80), 2)  # 16- and 160-byte rows
    for ptrs, strides, item in (((8,), (), 2), ((0,), (4,), 2), ((0,), (6,), 4)):
        with pytest.raises(ValueError, match="16-byte"):
            _launch.check_aligned("k", ptrs, strides, item)


def test_the_wrappers_take_a_route_on_the_cpu_and_run_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 16, 2, 40), generator=g).bfloat16() for _ in range(3))
    want = qk.attention_plain(q, k, v)
    for route in (None, "fma", "mma", "wgmma", "tf32x3"):
        assert torch.equal(qk.attention(q, k, v, route=route), want)
    x, w0, b0 = torch.randn((8, 16), generator=g), torch.randn((64, 16), generator=g), \
        torch.randn(64, generator=g)
    w2, b2 = torch.randn((16, 32), generator=g), torch.randn(16, generator=g)
    assert torch.equal(gg.geglu_ff(x, w0, b0, w2, b2, route="fma"),
                       gg.geglu_ff_plain(x, w0, b0, w2, b2))


# ---------------------------------------------------------- the conv routes

# (C, K, W, Cres) of every routed conv of the SD-1.5 VAE decoder: the 3x3
# convs at 128-512 wide (two with their 1x1 shortcut) and the up-convs from
# 64-256 wide sources.
SD_DECODER_CONVS = [(512, 512, 128, 0), (512, 256, 256, 0), (256, 256, 256, 512),
                    (256, 256, 256, 0), (256, 128, 512, 0), (128, 128, 512, 256),
                    (128, 128, 512, 0), (512, 512, 64, 0), (256, 256, 256, 0)]
# The up-convs' sources alone (C, K, W, Cres: conv3x3_up2 takes wgmma), and the 3x3 convs
# a 512x512 encode adds: the two conv1s that change the width and the two
# shortcuts of Cres 128 and 256.
SD_DECODER_UP2 = [(512, 512, 64, 0), (512, 512, 128, 0), (256, 256, 256, 0)]
SD_ENCODER_CONVS = [(128, 256, 256, 0), (256, 512, 128, 0), (256, 256, 256, 128),
                    (512, 512, 128, 256)]
RAGGED_CONVS = [(40, 128, 64, 0), (128, 128, 35, 0), (128, 128, 64, 24), (48, 72, 40, 32)]
# (B, C, K, H, W, Cres) of every conv3x3_same call shape of one SD search
# (batch-4 and batch-1 decodes) and of a batch-4 512x512 encode
SD_SAME_CALLS = [(b, c, k, h, h, cres) for b in (1, 4) for c, k, h, cres in (
    (512, 512, 128, 0), (512, 256, 256, 0), (256, 256, 256, 512), (256, 256, 256, 0),
    (256, 128, 512, 0), (128, 128, 512, 256), (128, 128, 512, 0))] + [
    (4, c, k, h, h, cres) for c, k, h, cres in SD_ENCODER_CONVS]


def _ring_conditions_in_source():
    """The ring route's conditions as csrc/conv3x3.cu states them in its
    header and as its code defines them (kRingChannels, kRingWidth)."""
    src = (build.CSRC / "conv3x3.cu").read_text()
    stated = re.search(r"ring \(route 1\): bf16 with C and Cres multiples of (\d+) and W a "
                       r"multiple of (\d+),", src).groups()
    defined = re.search(r"kRingChannels = (\d+), kRingWidth = (\d+);", src).groups()
    return tuple(map(int, stated)), tuple(map(int, defined))


def _wgmma_conditions_in_source():
    """The wgmma route's conditions as csrc/conv3x3.cu states them on one
    line of its header and as its code defines them (kWgChannels,
    kWgScChannels, kWgWidth)."""
    src = (build.CSRC / "conv3x3.cu").read_text()
    stated = re.search(r"wgmma \(route 2\): bf16 with C a multiple of (\d+), Cres of (\d+) "
                       r"and W of (\d+),", src).groups()
    defined = re.search(r"kWgChannels = (\d+), kWgScChannels = (\d+), kWgWidth = (\d+);",
                        src).groups()
    return tuple(map(int, stated)), tuple(map(int, defined))


@pytest.mark.parametrize("c,k,w,cres", SD_DECODER_CONVS + SD_ENCODER_CONVS + RAGGED_CONVS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_route_at_the_sd_decoder_and_ragged_shapes(dtype, c, k, w, cres):
    """conv3x3_same in bf16 takes wgmma at every routed conv of the SD
    decoder and encoder and at C = 48, Cres = 32; v1 at C = 40, W = 35 or
    Cres = 24; fp32 always takes v1. The ring's predicate (``conv_route``,
    which a forced "ring" checks) still gives the ring in bf16 at the
    decoder's widths."""
    ragged = (c, k, w, cres) in RAGGED_CONVS[:3]
    wgmma = dtype == torch.bfloat16 and not ragged
    assert cv.same_route(dtype, c, k, w, cres) == ("wgmma" if wgmma else "v1")
    assert cv.conv_route(dtype, c, k, w, cres) == ("ring" if wgmma else "v1")


@pytest.mark.parametrize("c,k,w,cres", SD_DECODER_UP2)
def test_up2_route_stays_on_the_ring(c, k, w, cres):
    """conv3x3_up2's predicate at the SD decoder's up-convs: "wgmma" in bf16,
    "v1" in fp32; the ring stays forceable there (``conv_route`` gives it)."""
    assert cv.up2_route(torch.bfloat16, c, k, w) == "wgmma"
    assert cv.up2_route(torch.float32, c, k, w) == "v1"
    assert cv.conv_route(torch.bfloat16, c, k, w) == "ring"


@pytest.mark.parametrize("c,w,cres", [(c, w, cres) for c in (16, 40, 128) for w in (8, 35, 64)
                                      for cres in (0, 24, 256)])
def test_conv_route_is_the_one_the_source_states(c, w, cres):
    stated, defined = _ring_conditions_in_source()
    assert stated == defined == (cv.RING_CHANNEL_MULTIPLE, cv.RING_WIDTH_MULTIPLE)
    wg_stated, wg_defined = _wgmma_conditions_in_source()
    assert wg_stated == wg_defined == (cv.WGMMA_CHANNEL_MULTIPLE, cv.WGMMA_SHORTCUT_MULTIPLE,
                                       cv.WGMMA_WIDTH_MULTIPLE)
    chan, width = stated
    ring = c % chan == 0 and cres % chan == 0 and w % width == 0
    wg_chan, wg_sc, wg_width = wg_stated
    wgmma = c % wg_chan == 0 and cres % wg_sc == 0 and w % wg_width == 0
    assert cv.conv_route(torch.bfloat16, c, 128, w, cres) == ("ring" if ring else "v1")
    assert cv.same_route(torch.bfloat16, c, 128, w, cres) == (
        "wgmma" if wgmma else "ring" if ring else "v1")
    assert cv.conv_route(torch.float32, c, 128, w, cres) == "v1"
    assert cv.same_route(torch.float32, c, 128, w, cres) == "v1"


def test_conv_route_codes_follow_the_source():
    """The route codes are the C entry's: 0 v1, 1 ring, 2 wgmma (which both
    functions take: the up-conv's own kernel); both counters count all
    three."""
    assert cv.ROUTES == ("v1", "ring", "wgmma")
    assert set(cv.SAME_ROUTE_LAUNCHES) == set(cv.UP2_ROUTE_LAUNCHES) == set(cv.ROUTES)
    src = (build.CSRC / "conv3x3.cu").read_text()
    assert "if (route == 2) {" in src and "if (route == 1) {" in src
    assert "if (route != 0) return" in src
    # route 2 takes up2 to its own kernel, under its own conditions
    assert re.search(r"route == 2\) \{\n(.*\n){0,2}    if \(a\.up2\) \{\n.*kUpChannels.*kUpWidth"
                     r"\)\n.*\n      return launch_up2_wgmma\(a, s\);", src)


def _up2_wgmma_conditions_in_source():
    """The up-conv's wgmma route's conditions as csrc/conv3x3.cu states them
    on one line of its header and as its code defines them (kUpChannels,
    kUpWidth)."""
    src = (build.CSRC / "conv3x3.cu").read_text()
    stated = re.search(r"up2 wgmma \(route 2 of conv3x3_up2\): bf16 with C a multiple of (\d+) "
                       r"and W of (\d+),", src).groups()
    defined = re.search(r"kUpChannels = (\d+), kUpWidth = (\d+);", src).groups()
    return tuple(map(int, stated)), tuple(map(int, defined))


@pytest.mark.parametrize("c,w", [(c, w) for c in (16, 40, 48, 128, 512) for w in (8, 12, 24, 35, 64)])
def test_up2_route_is_the_one_the_source_states(c, w):
    """up2_route gives "wgmma" exactly where the header's stated conditions
    (equal to the constants the code defines and to the module's) hold in
    bf16, else conv_route's answer."""
    stated, defined = _up2_wgmma_conditions_in_source()
    assert stated == defined == (cv.UP2_WGMMA_CHANNEL_MULTIPLE, cv.UP2_WGMMA_WIDTH_MULTIPLE)
    chan, width = stated
    wgmma = c % chan == 0 and w % width == 0
    assert cv.up2_route(torch.bfloat16, c, 72, w) == (
        "wgmma" if wgmma else cv.conv_route(torch.bfloat16, c, 72, w))
    assert cv.up2_route(torch.float32, c, 72, w) == "v1"


def test_the_conv_kernels_include_the_shared_header():
    assert "mma_bf16.cuh" in [p.name for p in build.sources("conv3x3")]
    assert "hopper.cuh" in [p.name for p in build.sources("conv3x3")]
    assert re.search(r"conv3_ring_kernel", (build.CSRC / "conv3x3.cu").read_text())
    assert re.search(r"conv3_wgmma_kernel", (build.CSRC / "conv3x3.cu").read_text())


def _wgmma_constants_in_source():
    src = (build.CSRC / "conv3x3.cu").read_text()
    get = lambda name: int(re.search(rf"\b{name} = (\d+)", src).group(1))
    return ((get("kWgM"), get("kWgNC"), get("kWgCols")),
            (get("kWgSw"), get("kWgSx"), get("kWgP")))


@pytest.mark.parametrize("b,c,k,h,w,cres", SD_SAME_CALLS)
def test_wgmma_plan_at_the_sd_shapes(b, c, k, h, w, cres):
    """The wgmma route's tile and rings are the source's; at every
    conv3x3_same shape of an SD search and encode its plan fills the card's
    132 SMs with persistent blocks (tiles of 64 channels x 3 rows x 128
    columns, at least one each) within a block's 232,448 bytes of shared
    memory; the route takes every one of those shapes."""
    assert _wgmma_constants_in_source() == (cv.WGMMA_TILE, cv.WGMMA_RINGS)
    plan = cv.wgmma_plan(b, k, h, w, 132)
    assert plan["tiles"] == b * -(-h // 3) * -(-w // 128) * (k // 64)
    assert plan["blocks"] == 132 <= plan["tiles"]
    assert plan["smem_bytes"] <= cv.SMEM_PER_BLOCK == 232448
    assert cv.same_route(torch.bfloat16, c, k, w, cres) == "wgmma"


def test_wgmma_plan_of_a_small_call():
    """Fewer tiles than SMs: one block a tile."""
    plan = cv.wgmma_plan(1, 72, 7, 40, 132)
    assert plan["tiles"] == 1 * 3 * 1 * 2 == plan["blocks"]


# (B, C, K, H, W) of every conv3x3_up2 call shape of the searches: the SD
# decoder's three up-convs at decode batches 1, 2, 4 and 8
SD_UP2_CALLS = [(b, c, k, h, h) for b in (1, 2, 4, 8)
                for c, k, h, _ in SD_DECODER_UP2]


def _up2_constants_in_source():
    src = (build.CSRC / "conv3x3.cu").read_text()
    get = lambda name: int(re.search(rf"\b{name} = (\d+)", src).group(1))
    return (get("kUpNarrow"), get("kUpNC"), (get("kUpSw"), get("kUpSx"), get("kUpP")))


@pytest.mark.parametrize("b,c,k,h,w", SD_UP2_CALLS)
def test_up2_wgmma_plan_at_the_sd_shapes(b, c, k, h, w):
    """The up-conv's wgmma route at every conv3x3_up2 shape of the searches:
    its narrow-width switch, consumers and rings are the source's; tiles of
    64 channels x 2 rows x 64 columns at a 64-wide source, else 1 row x 128
    columns, which fill the card's 132 SMs with persistent blocks within a
    block's 232,448 bytes of shared memory; the route takes every one of
    those shapes."""
    assert _up2_constants_in_source() == (cv.UP2_NARROW_WIDTH, cv.UP2_WGMMA_CONSUMERS,
                                          cv.UP2_WGMMA_RINGS)
    plan = cv.up2_wgmma_plan(b, k, h, w, 132)
    rows = 2 if w <= 64 else 1
    assert (plan["rows"], plan["cols"]) == (rows, 128 // rows)
    assert plan["tiles"] == b * (h // rows) * -(-w // (128 // rows)) * (k // 64)
    assert plan["blocks"] == 132 <= plan["tiles"]
    assert plan["smem_bytes"] <= cv.SMEM_PER_BLOCK == 232448
    assert cv.up2_route(torch.bfloat16, c, k, w) == "wgmma"


def test_up2_wgmma_plan_of_a_small_call():
    """A ragged call: an odd H in 2-row tiles, K = 40 in one channel block,
    W = 24 in one tile; fewer tiles than SMs: one block a tile."""
    plan = cv.up2_wgmma_plan(1, 40, 7, 24, 132)
    assert plan["tiles"] == 1 * 4 * 1 * 1 == plan["blocks"]
    assert (plan["rows"], plan["cols"]) == (2, 64)


@pytest.mark.parametrize("k,c", [(512, 512), (72, 48), (40, 16)])
def test_up2_operand_blocks_follow_the_source(k, c):
    """The up-conv's wgmma route reads its weights as the source states:
    [ceil(K / 64)][C / 16][16 (phase, tap)][2 channel halves][64 rows][8
    channels], rows past K zero, so that block (kb, s) is the 32 KB the
    kernel copies at stage s of a tile at k0 = 64 kb."""
    src = (build.CSRC / "conv3x3.cu").read_text()
    assert "the operand layout [ceil(K / 64)][C / 16][16][2][64][8]" in src
    assert "wsrc + ((int64_t)(t.k0 / kWgM) * n + s) * (kUpWSlot / 2), kUpWSlot" in src
    g = torch.Generator().manual_seed(k + c)
    phased = torch.randn((4 * k, c, 2, 2), generator=g)  # phase_kernels' [4K, C, 2, 2]
    blocks = cv._up2_operand_blocks(phased, k, c)
    kb = -(-k // 64)
    assert blocks.shape == (kb, c // 16, 16, 2, 64, 8) and blocks.is_contiguous()
    assert blocks[0, 0].numel() * 2 == 32768  # bf16 bytes of one stage
    want = torch.zeros((16, kb * 64, c))  # [phase 2a + e, tap 2r + s, K, C], the ring's packing
    want[:, :k] = phased.view(4, k, c, 2, 2).permute(0, 3, 4, 1, 2).reshape(16, k, c)
    got = blocks.permute(2, 0, 4, 1, 3, 5).reshape(16, kb * 64, c)
    assert torch.equal(got, want)


def _conv_call(kernel, case):
    """The kernel function of ``conv3x3_same`` or ``conv3x3_up2`` called on
    CPU tensors for ``case``: "pointer" (x 2 bytes off), "fp32_forced"
    ("ring" forced on fp32), "c40_forced" ("ring" forced at C = 40)."""
    dtype = torch.float32 if case == "fp32_forced" else torch.bfloat16
    c = 40 if case == "c40_forced" else 128
    x = torch.zeros(c * 8 * 16 + 1, dtype=dtype)
    x = x[1:] if case == "pointer" else x[:-1]
    x = x.view(1, c, 8, 16)
    weight = torch.zeros((128, c, 3, 3), dtype=dtype)
    route = None if case == "pointer" else "ring"
    if kernel == "same":
        return lambda: cv._same_kernel(x, weight, None, None, None, None, None, None, route=route)
    return lambda: cv._up2_kernel(x, weight, None, route=route)


@pytest.mark.parametrize("case", ["pointer", "fp32_forced", "c40_forced"])
@pytest.mark.parametrize("kernel", ["same", "up2"])
def test_conv_refuses_what_the_ring_route_cannot_take(no_launch, kernel, case):
    before = (cv.SAME_LAUNCHES, cv.UP2_LAUNCHES, dict(cv.SAME_ROUTE_LAUNCHES),
              dict(cv.UP2_ROUTE_LAUNCHES))
    match = "16-byte" if case == "pointer" else "ring route takes bfloat16"
    with pytest.raises(ValueError, match=match):
        _conv_call(kernel, case)()
    assert (cv.SAME_LAUNCHES, cv.UP2_LAUNCHES, cv.SAME_ROUTE_LAUNCHES,
            cv.UP2_ROUTE_LAUNCHES) == before


def test_conv_refuses_an_unknown_route(no_launch):
    x, weight = torch.zeros((1, 16, 4, 8), dtype=torch.bfloat16), \
        torch.zeros((16, 16, 3, 3), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="route must be one of"):
        cv._up2_kernel(x, weight, None, route="mma")


def _wgmma_call(case):
    """conv3x3_same's kernel function (or conv3x3_up2's, "up2_...") on CPU
    tensors with "wgmma" forced for ``case``: "fp32", "c40" (C = 40),
    "cres48" (a shortcut of 48 channels), "w12" (W = 12), "pointer" (x 2
    bytes off) or "residual" (the residual 2 bytes off); the up-conv at
    "up2_fp32", "up2_c40", "up2_w12" or "up2_pointer"."""
    up2 = case.startswith("up2_")
    case = case[4:] if up2 else case
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    c = 40 if case == "c40" else 128
    w = 12 if case == "w12" else 16
    x = torch.zeros(c * 8 * w + 1, dtype=dtype)
    x = (x[1:] if case == "pointer" else x[:-1]).view(1, c, 8, w)
    weight = torch.zeros((128, c, 3, 3), dtype=dtype)
    residual, sc_x, sc_w = None, None, None
    if case == "residual":
        residual = torch.zeros(128 * 8 * w + 1, dtype=dtype)[1:].view(1, 128, 8, w)
    if case == "cres48":
        sc_x, sc_w = torch.zeros((1, 48, 8, w), dtype=dtype), torch.zeros((128, 48), dtype=dtype)
    if up2:
        return lambda: cv._up2_kernel(x, weight, None, route="wgmma")
    return lambda: cv._same_kernel(x, weight, None, residual, None, None, sc_x, sc_w,
                                   route="wgmma")


@pytest.mark.parametrize("case", ["fp32", "c40", "cres48", "w12", "pointer", "residual",
                                  "up2_fp32", "up2_c40", "up2_w12", "up2_pointer"])
def test_conv_refuses_what_the_wgmma_route_cannot_take(no_launch, case):
    """A forced "wgmma" where its conditions fail (conv3x3_same's, or the
    up-conv's: bf16, C a multiple of 16, W of 8), or on an operand that is
    not 16-byte aligned: refused before any launch, with nothing counted and
    no fall back to the ring."""
    before = (cv.SAME_LAUNCHES, cv.UP2_LAUNCHES, dict(cv.SAME_ROUTE_LAUNCHES),
              dict(cv.UP2_ROUTE_LAUNCHES))
    match = ("16-byte" if case.endswith(("pointer", "residual"))
             else "wgmma route takes bfloat16" if case.startswith("up2_")
             else "wgmma route takes conv3x3_same")
    with pytest.raises(ValueError, match=match):
        _wgmma_call(case)()
    assert (cv.SAME_LAUNCHES, cv.UP2_LAUNCHES, cv.SAME_ROUTE_LAUNCHES,
            cv.UP2_ROUTE_LAUNCHES) == before


@pytest.mark.parametrize("route", [None, "v1", "ring", "wgmma"])
def test_the_conv_wrappers_take_a_route_on_the_cpu_and_run_the_plain_version(route):
    g = torch.Generator().manual_seed(3)
    r = lambda *shape: torch.randn(shape, generator=g).bfloat16()
    x, weight, bias = r(2, 16, 6, 8), r(24, 16, 3, 3), r(24)
    kw = dict(gn_scale=1 + 0.1 * torch.randn((2, 16), generator=g),
              gn_shift=0.1 * torch.randn((2, 16), generator=g), shortcut=(r(2, 32, 6, 8), r(24, 32)))
    assert torch.equal(cv.conv3x3_same(x, weight, bias, route=route, **kw),
                       cv.conv3x3_same_plain(x, weight, bias, **kw))
    assert torch.equal(cv.conv3x3_up2(x, weight, bias, route=route),
                       cv.conv3x3_up2_plain(x, weight, bias))
