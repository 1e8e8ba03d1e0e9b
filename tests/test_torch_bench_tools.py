"""The port's bench and tool entry points on the CPU: the bench twin
(diffusion_tts_torch/bench.py), entry(), the SD end-to-end bench and the
reward-bench twins (diffusion_tts_torch/tools/), held against the JAX
tools' row keys and the JAX package's NFE count; and that every entry
point, the reward curve, the SD lookahead bench and the all-scorers
example included, refuses to run without a card unless given the CPU."""
import ast
import json
import os

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from diffusion_tts_torch import bench
from diffusion_tts_torch import entry as t_entry
from diffusion_tts_torch.examples import sd_all_scorers
from diffusion_tts_torch.tools import (
    reward_bench,
    reward_curve,
    sd_bench,
    sd_e2e_bench,
    sd_reward_bench,
)
from diffusion_tts_tpu.search.nfe import nfe_per_sample as j_nfe_per_sample
from diffusion_tts_tpu.utils.config import SearchParams as JSearchParams

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _jax_row_keys(tool):
    """The keyword names of the ``rows.append(dict(...))`` call in the JAX
    tool tools/<tool>.py, read from its source."""
    with open(os.path.join(ROOT, "tools", f"{tool}.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append" and getattr(node.func.value, "id", "") == "rows"):
            return {kw.arg for kw in node.args[0].keywords}
    raise AssertionError(f"no rows.append(dict(...)) in tools/{tool}.py")


def test_bench_cpu_smoke_prints_one_json_line(capsys):
    out = bench.main(["--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    assert lines == [out]
    assert {"metric", "value", "unit", "vs_baseline"} <= set(out)
    assert out["unit"] == "NFE/s" and out["value"] > 0 and out["vs_baseline"] > 0
    assert out["flops_per_image"] == 152_971_776  # the tiny flagship's count
    assert out["nfe"] == 3 * 2 * 1 * 2
    assert "cpu smoke" in out["metric"]


def test_bench_sd_cpu_smoke_names_its_nfe_convention(capsys):
    out = bench.main(["--sd", "--device", "cpu", "--steps", "2", "--K", "1", "--N", "2",
                      "--repeat", "1"])
    assert _json_lines(capsys.readouterr().out) == [out]
    assert out["nfe"] == 2 * (1 + 1 * 2 * 2) * 1 and out["value"] > 0
    assert "raw UNet forwards" in out["nfe_convention"] and "sol" not in out


def test_sd_search_flops_follow_the_call_structure():
    """search_flops counts the base CFG UNet, K lookaheads and scoring
    decodes per step and the final decode, each net's count scaled by its
    batch."""
    from diffusion_tts_torch.utils.roofline import sd_unet_flops, sd_vae_decode_flops
    from _torch_port import SD_UNET_KW, SD_VAE_KW

    unet = sd_unet_flops(SD_UNET_KW, 1)["total_flops"]
    decode = sd_vae_decode_flops(SD_VAE_KW, 1)["total_flops"]
    assert sd_unet_flops(SD_UNET_KW, 6)["total_flops"] == 6 * unet
    got = sd_e2e_bench.search_flops(SD_UNET_KW, SD_VAE_KW, steps=3, K=2, N=4, b=1)
    want = unet * (2 * 3 + 2 * 4 * 3 * 2) + decode * (4 * 3 * 2 + 1)
    assert got["total_flops"] == want
    assert got["decode_flop_share"] == pytest.approx(decode * 25 / want)


def test_entry_builds_the_zero_weight_flagship_at_batch_4():
    fn, args = t_entry.entry(device="cpu")
    net, x, sigma, labels = args
    assert x.shape == (4, 64, 64, 3) and sigma.tolist() == [10.0] * 4
    assert labels.argmax(dim=1).tolist() == [0, 1, 2, 3] and labels.shape == (4, 1000)
    assert not any(p.any() for p in net.parameters())
    assert 290e6 < sum(p.numel() for p in net.parameters()) < 300e6
    with FakeTensorMode(allow_non_fake_inputs=True):  # the forward's shapes, no compute
        out = fn(*args)
    assert out.shape == (4, 64, 64, 3) and out.dtype == torch.float32  # the precond's


METHODS = ("naive", "rejection", "beam", "zero_order", "eps_greedy", "mcts")


def test_reward_bench_rows_match_the_jax_tool(tmp_path):
    path = str(tmp_path / "rows.json")
    rows = reward_bench.main(["--arch", "tiny", "--device", "cpu", "--steps", "3", "--N", "2",
                              "--K", "2", "--B", "1", "--S", "2", "--json", path])
    assert [r["method"] for r in rows] == list(METHODS)
    keys = _jax_row_keys("reward_bench")
    p = JSearchParams(N=2, K=2, B=1, S=2)
    for row in rows:
        assert set(row) == keys
        assert row["nfe_per_sample"] == j_nfe_per_sample(row["method"], 3, p, backend="edm")
        assert len(row["per_seed"]) == 2 and 0 <= row["reward"] <= 1
    assert rows[0]["reward_gain_vs_naive"] == 0.0
    with open(path) as f:
        assert json.load(f)["rows"] == rows


@pytest.mark.parametrize("curve", [False, True])
def test_sd_reward_bench_rows_match_the_jax_tool(curve):
    argv = ["--device", "cpu", "--steps", "3", "--seeds", "0"]
    out = sd_reward_bench.main(argv + (["--curve", "--curve-K", "1,2"] if curve else []))
    keys = _jax_row_keys("sd_reward_bench")
    want = (["eps_greedy_K1", "eps_greedy_K2"] if curve
            else ["naive", "rejection", "zero_order", "eps_greedy", "beam"])
    assert [r["method"] for r in out["rows"]] == want
    for row in out["rows"]:
        assert set(row) == keys
        method = "eps_greedy" if curve else row["method"]
        p = row["params"]
        jp = (JSearchParams(N=4, K=p["K"], eps=0.4, lambda_=0.15) if curve
              else dict(naive=JSearchParams(), rejection=JSearchParams(N=21),
                        zero_order=JSearchParams(N=4, K=5, lambda_=0.15),
                        eps_greedy=JSearchParams(N=4, K=5, eps=0.4, lambda_=0.15),
                        beam=JSearchParams(B=2, N=9))[method])
        assert row["nfe_per_sample"] == j_nfe_per_sample(method, 3, jp, backend="sd")
        assert len(row["per_seed"]) == 1


def test_sd_reward_bench_method_table_is_the_jax_tools():
    from tools import sd_reward_bench as j_tool  # the JAX tool, imported from the repo root

    assert sd_reward_bench.METHOD_PARAMS.keys() == j_tool.METHOD_PARAMS.keys()
    for name, p in sd_reward_bench.METHOD_PARAMS.items():
        jp = j_tool.METHOD_PARAMS[name]
        assert (p.N, p.K, p.B, p.S, p.eps, p.lambda_) == (jp.N, jp.K, jp.B, jp.S, jp.eps,
                                                          jp.lambda_)


ENTRY_POINTS = {
    "bench": lambda: bench.main([]),
    "bench --sd": lambda: bench.main(["--sd"]),
    "entry": lambda: t_entry.entry(),
    "reward_bench": lambda: reward_bench.main(["--arch", "tiny"]),
    "sd_reward_bench": lambda: sd_reward_bench.main(["--tiny"]),
    "sd_e2e_bench": lambda: sd_e2e_bench.main(["--tiny"]),
    "reward_curve": lambda: reward_curve.main(["--arch", "tiny", "--quick"]),
    "sd_bench": lambda: sd_bench.main(["--tiny"]),
    "sd_all_scorers": lambda: sd_all_scorers.main(["--tiny"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_a_card(name):
    """On the card by default: without one, each raises unless it is given
    the CPU (the tests above)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()
