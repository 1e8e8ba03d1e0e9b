"""The CUDA kernels' build and routing, on the CPU: no card and no nvcc.

``ops/kernels/build.py`` names each library after a hash of its source and of
every ``csrc`` header the source includes, so an edited header is rebuilt and
a stale library is never loaded. The wrappers of the attention (forward and
backward) and GEGLU kernels pick a route in Python (``forward_route``,
``backward_route``, ``route``) and refuse, before any launch, what the
tensor-core route cannot take. The kernels themselves
are held against their plain versions on the card by
tests/test_torch_kernels_cuda.py.
"""
import re
import shutil

import pytest
import torch

from diffusion_tts_torch.ops.kernels import _launch, build
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
    for name in ("qkv_attention", "attention_bwd", "geglu_ff", "conv3x3"):
        assert [p.name for p in build.sources(name)] == [f"{name}.cu", "mma_bf16.cuh"]


def test_library_path_follows_a_header_included_by_a_header(csrc):
    (csrc / "extra.cuh").write_text("#pragma once\n")
    _append(csrc / "mma_bf16.cuh", '\n#include "extra.cuh"\n')
    before = build.library_path("geglu_ff")
    _append(csrc / "extra.cuh")
    assert build.library_path("geglu_ff") != before
    assert [p.name for p in build.sources("geglu_ff")] == ["geglu_ff.cu", "mma_bf16.cuh",
                                                           "extra.cuh"]


def test_library_path_ignores_headers_not_included(csrc):
    before = build.library_path("groupnorm")
    _append(csrc / "mma_bf16.cuh")
    assert build.library_path("groupnorm") == before


def _mma_widths_in_source(name="qkv_attention", macro="DTTS_ATTN_MMA"):
    """The mma route's widths as csrc/<name>.cu states them in its header
    and as its C entry dispatches them (the ``macro(d)`` cases)."""
    src = (build.CSRC / f"{name}.cu").read_text()
    stated = re.search(r"mma \(route 1\): bf16 at d = ([\d, ]+),", src).group(1)
    cases = re.findall(rf"{macro}\((\d+)\)", src)
    return tuple(int(d) for d in stated.split(", ")), tuple(int(d) for d in cases)


@pytest.mark.parametrize("d", qk.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_route_is_the_one_the_source_states(dtype, d):
    stated, dispatched = _mma_widths_in_source()
    assert stated == dispatched == qk.MMA_HEAD_DIMS
    want = "mma" if dtype == torch.bfloat16 and d in stated else "fma"
    assert qk.forward_route(dtype, d) == want


@pytest.mark.parametrize("d", qk.BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_route_is_the_one_the_source_states(dtype, d):
    """csrc/attention_bwd.cu's mma widths, as stated and as dispatched: the
    training path's d = 64 among them, d = 160 left on the CUDA cores."""
    stated, dispatched = _mma_widths_in_source("attention_bwd", "DTTS_ATTN_BWD_MMA")
    assert stated == dispatched == qk.BWD_MMA_HEAD_DIMS
    assert 64 in stated and 160 not in stated
    want = "mma" if dtype == torch.bfloat16 and d in stated else "fma"
    assert qk.backward_route(dtype, d) == want


@pytest.mark.parametrize("c", SD_FF_WIDTHS + (32, 64))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geglu_route_at_the_sd_and_test_widths(dtype, c):
    """The SD-1.5 UNet's (C, 4C) and the tiny test pipeline's widths: bf16 on
    the tensor cores, fp32 on the CUDA cores (csrc/geglu_ff.cu's header)."""
    assert gg.route(dtype, c, 4 * c) == ("mma" if dtype == torch.bfloat16 else "fma")


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


def test_check_aligned():
    _launch.check_aligned("k", (0, 16, 4096), (8, 80), 2)  # 16- and 160-byte rows
    for ptrs, strides, item in (((8,), (), 2), ((0,), (4,), 2), ((0,), (6,), 4)):
        with pytest.raises(ValueError, match="16-byte"):
            _launch.check_aligned("k", ptrs, strides, item)


def test_the_wrappers_take_a_route_on_the_cpu_and_run_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 16, 2, 40), generator=g).bfloat16() for _ in range(3))
    want = qk.attention_plain(q, k, v)
    for route in (None, "fma", "mma"):
        assert torch.equal(qk.attention(q, k, v, route=route), want)
    x, w0, b0 = torch.randn((8, 16), generator=g), torch.randn((64, 16), generator=g), \
        torch.randn(64, generator=g)
    w2, b2 = torch.randn((16, 32), generator=g), torch.randn(16, generator=g)
    assert torch.equal(gg.geglu_ff(x, w0, b0, w2, b2, route="fma"),
                       gg.geglu_ff_plain(x, w0, b0, w2, b2))
