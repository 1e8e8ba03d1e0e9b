"""The GroupNorm kernel's routes, on the CPU: no card and no nvcc.

``ops/kernels/groupnorm.py`` picks the kernel's design in Python before the
launch: "slab" (one launch, a thread-block cluster per (batch, group) that
holds the group in shared memory; fp32 and bf16 with each channel's row a
multiple of 16 bytes) or "v1" (two launches, any HW). ``gn_slab_cluster``
sizes the cluster. A forced route it cannot take, an unknown route or a
misaligned pointer is refused before any launch. The kernels themselves are
held against the plain version on the card by tests/test_torch_kernels_cuda.py.
"""
import re

import pytest
import torch

from diffusion_tts_torch.ops.kernels import _launch, build
from diffusion_tts_torch.ops.kernels import groupnorm as gn

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

GROUPS = 32
# (C, H) of every GroupNorm(+SiLU) call of the SD-1.5 search: the UNet's at
# 64, 32, 16 and 8 pixels a side (batch 2 and 8), the VAE decoder's mid and
# up-block-0 norms and its conv_norm_out (batch 4 and 1).
UNET = [(c, 64) for c in (320, 640, 960)] + [(c, 32) for c in (320, 640, 960, 1280, 1920)] + \
    [(c, 16) for c in (640, 1280, 1920, 2560)] + [(c, 8) for c in (1280, 2560)]
SD_SEARCH = [(b, c, h) for b in (2, 8) for c, h in UNET] + \
    [(b, c, h) for b in (4, 1) for c, h in ((512, 64), (128, 512))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h", SD_SEARCH)
def test_gn_route_takes_the_slab_at_every_sd_search_shape(b, c, h, dtype):
    assert gn.gn_route(dtype, c, h * h, GROUPS) == "slab"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [35, 6])
def test_gn_route_takes_v1_at_ragged_rows(hw, dtype):
    """35 and 6 pixels: a row of 70 / 12 bytes in bf16, 140 / 24 in fp32."""
    assert gn.gn_route(dtype, 64, hw, GROUPS) == "v1"
    assert gn.gn_route(torch.float16, 64, 64, GROUPS) == "v1"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h", SD_SEARCH)
def test_gn_slab_cluster_stays_within_its_limits(b, c, h, dtype):
    """cs is 1, 2, 4 or 8; a CTA's shared memory is its whole part within
    the two-per-SM budget, or the budget (cs = 8 only); cs is the least that
    fits unless the call had fewer than 132 CTAs; and at batch 2 (64 groups)
    every call has at least 132 CTAs."""
    cg, hw = c // GROUPS, h * h
    cs = gn.gn_slab_cluster(b, GROUPS, cg, hw, dtype)
    smem = gn.gn_slab_smem(cs, cg, hw, dtype)
    part = -(-cg * hw * dtype.itemsize // 16 // cs) * 16
    assert cs in (1, 2, 4, 8) and smem % 16 == 0
    if part <= gn.SLAB_BUDGET:
        assert smem == part
    else:
        assert cs == gn.SLAB_MAX_CLUSTER and smem == gn.SLAB_BUDGET
    half = cs // 2
    if half and b * GROUPS * half >= gn.SLAB_FILL_CTAS:  # not doubled to fill the card
        assert -(-cg * hw * dtype.itemsize // 16 // half) * 16 > gn.SLAB_BUDGET
    if b == 2:
        assert b * GROUPS * cs >= gn.SLAB_FILL_CTAS


@pytest.mark.parametrize("b,c,h,cs", [(8, 320, 64, 1), (8, 640, 64, 2), (2, 320, 64, 4),
                                      (1, 128, 512, 8), (8, 960, 64, 4), (4, 512, 64, 2)])
def test_gn_slab_cluster_at_the_card_tests_shapes(b, c, h, cs):
    """The bf16 shapes tests/test_torch_kernels_cuda.py drives through each
    cluster size."""
    assert gn.gn_slab_cluster(b, GROUPS, c // GROUPS, h * h, torch.bfloat16) == cs


def _slab_constants_in_source():
    """The slab route's conditions and budgets as csrc/groupnorm.cu states
    them in its header and as its code defines them."""
    src = (build.CSRC / "groupnorm.cu").read_text()
    stated = re.search(r"slab \(route 1\): fp32 and bf16 with each channel's row a multiple of "
                       r"(\d+)\s*//\s*bytes", src).group(1)
    in_header = re.search(r"// Route constants: kSlabRowBytes = (\d+), kSlabBudget = (\d+);",
                          src).groups()
    defined = re.search(r"constexpr int kSlabRowBytes = (\d+), kSlabBudget = (\d+);",
                        src).groups()
    return int(stated), tuple(map(int, in_header)), tuple(map(int, defined))


def test_slab_constants_are_the_ones_the_source_states():
    stated, in_header, defined = _slab_constants_in_source()
    assert stated == gn.SLAB_ROW_BYTES
    assert in_header == defined == (gn.SLAB_ROW_BYTES, gn.SLAB_BUDGET)
    assert gn.ROUTES == ("v1", "slab")  # route codes 0 and 1 of the source
    assert gn.LAUNCHES_PER_CALL == {"v1": 2, "slab": 1} and gn.STATS_LAUNCHES_PER_CALL == 2


def test_groupnorm_includes_no_shared_header():
    assert [p.name for p in build.sources("groupnorm")] == ["groupnorm.cu"]
    assert re.search(r"gn_slab_kernel", (build.CSRC / "groupnorm.cu").read_text())


@pytest.fixture
def no_launch(monkeypatch):
    """Make any attempt to bind a kernel fail loudly: a refusal must come
    first. CPU tensors stand in for CUDA ones."""
    def bind(*args):
        raise AssertionError(f"a kernel was bound: {args[:2]}")
    monkeypatch.setattr(_launch, "bind", bind)
    monkeypatch.setattr(_launch, "check", lambda x, name: None)


def _counters():
    return gn.LAUNCHES, dict(gn.ROUTE_LAUNCHES), gn.STATS_LAUNCHES


@pytest.mark.parametrize("case", ["ragged_forced", "unknown_route", "pointer"])
def test_group_norm_refuses_before_any_launch(no_launch, case):
    hw = 35 if case == "ragged_forced" else 64
    x = torch.zeros(2 * 64 * hw + 1, dtype=torch.bfloat16)
    x = (x[1:] if case == "pointer" else x[:-1]).view(2, 64, hw)  # "pointer": 2 bytes off
    route = {"ragged_forced": "slab", "unknown_route": "ring", "pointer": None}[case]
    match = {"ragged_forced": "slab route takes", "unknown_route": "route must be one of",
             "pointer": "16-byte"}[case]
    before = _counters()
    with pytest.raises(ValueError, match=match):
        gn._group_norm_kernel(x, torch.ones(64), torch.zeros(64), None, GROUPS, 1e-5, True,
                              route=route)
    assert _counters() == before


def test_group_norm_refuses_an_unknown_route_on_the_cpu():
    x = torch.zeros((1, 64, 8, 8))
    with pytest.raises(ValueError, match="route must be one of"):
        gn.group_norm_silu(x, torch.ones(64), torch.zeros(64), groups=GROUPS, route="mma")


@pytest.mark.parametrize("route", [None, "v1", "slab"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_route_runs_the_plain_twin_on_the_cpu(route, dtype):
    """Also at HW = 35, where "slab" could not launch: the CPU takes the twin."""
    g = torch.Generator().manual_seed(9)
    before = _counters()
    for shape in ((2, 64, 8, 8), (2, 64, 5, 7)):
        x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
        scale, bias = 1 + 0.1 * torch.randn(64, generator=g), 0.1 * torch.randn(64, generator=g)
        pre = torch.randn((2, 64), generator=g)
        assert torch.equal(gn.group_norm_silu(x, scale, bias, groups=GROUPS, route=route),
                           gn.group_norm_silu_plain(x, scale, bias, groups=GROUPS))
        assert torch.equal(
            gn.group_norm_silu_prebias(x, scale, bias, pre, groups=GROUPS, eps=1e-6,
                                       apply_silu=False, route=route),
            gn.group_norm_silu_plain(x, scale, bias, groups=GROUPS, eps=1e-6, apply_silu=False,
                                     pre=pre))
    assert _counters() == before
