"""The port's train-bench twin (diffusion_tts_torch/tools/train_bench.py) and
the training step's FLOP count (utils/roofline.py::train_step_flops) on the
CPU: the JAX tool's keys, a run at a tiny arch, and the count's forward and
backward halves."""
import ast
import json
import os

import pytest
import torch
from torch import nn

from diffusion_tts_torch.backends.edm_entry import NET_CONFIGS
from diffusion_tts_torch.tools import train_bench
from diffusion_tts_torch.utils import roofline

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool_keys():
    """The keyword names of ``out = dict(...)`` in tools/train_bench.py."""
    with open(os.path.join(ROOT, "tools", "train_bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "out"
                and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", "") == "dict"):
            return {kw.arg for kw in node.value.keywords}
    raise AssertionError("no out = dict(...) in tools/train_bench.py")


@pytest.mark.parametrize("arch,rounds,chain", [("tiny_adm", 2, 1), ("tiny", 1, 2)])
def test_cpu_run_prints_the_jax_tools_keys(arch, rounds, chain, capsys, tmp_path):
    path = str(tmp_path / "row.json")
    out = train_bench.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--rounds",
                            str(rounds), "--steps", "2", "--chain", str(chain), "--json", path])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert lines == [out] and json.load(open(path)) == out
    assert set(out) == _jax_tool_keys()
    assert out["batch"] == 2 * rounds and out["scan"] == 1 and out["chain"] == chain
    assert out["device"] == "cpu" and out["dtype"] == "bfloat16"
    assert out["img_per_s"] > 0 and out["step_ms"] > 0 and out["compile_s"] > 0
    assert out["sec_per_kimg"] == pytest.approx(1000.0 / out["img_per_s"])
    flops = roofline.train_step_flops(NET_CONFIGS[arch], 2, rounds)["total_flops"]
    assert out["step_gflops"] == flops / 1e9
    assert out["model_tflops_s"] == pytest.approx(flops / out["step_ms"] / 1e9)
    assert out["sol"] == pytest.approx(out["model_tflops_s"] * 1e12 / roofline.CPU_NOMINAL_PEAK)
    assert torch.isfinite(torch.tensor(out["loss"]))


def test_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_bench.main(["--arch", "tiny_adm"])


@pytest.mark.parametrize("arch", ["tiny_adm", "tiny"])
def test_step_forward_count_is_analyze_fns(arch):
    """The forward half of one step's count is the denoiser's forward at the
    micro-batch, rounds times."""
    cfg = NET_CONFIGS[arch]
    step = roofline.train_step_flops(cfg, 3, rounds=2)
    assert step["forward_flops"] == 2 * roofline.denoiser_flops(cfg, 3)["total_flops"]
    assert step["total_flops"] == step["forward_flops"] + step["backward_flops"]


def test_backward_counts_the_gradients_it_computes():
    """A linear and two convs whose input needs no gradient: the backward of
    the first layer computes its weight's gradient alone, the later layers
    their input's and weight's."""
    def loss():
        conv1, conv2 = nn.Conv2d(3, 8, 3, padding=1), nn.Conv2d(8, 4, 1)
        lin = nn.Linear(4 * 5 * 5, 6)
        x = torch.zeros((2, 3, 5, 5))
        return lin(conv2(conv1(x)).flatten(1)).sum()

    got = roofline.analyze_train_fn(loss)
    c1, c2, fc = 2 * 2 * 25 * 27 * 8, 2 * 2 * 25 * 8 * 4, 2 * 2 * 100 * 6
    assert got["forward_flops"] == c1 + c2 + fc
    assert got["backward_flops"] == c1 + 2 * c2 + 2 * fc


def test_full_width_backward_is_just_under_twice_the_forward():
    """The full-width ImageNet-64 ADM: every product but the few whose input
    needs no gradient (the first conv's, the embedding's linears) costs
    twice its forward in the backward (the attention's four products
    included: the count takes autograd's formulation, not the flash
    backward's recomputation). At test width those few weigh too much for
    this bound."""
    step = roofline.train_step_flops(NET_CONFIGS["imagenet64"], 1)
    assert step["forward_flops"] == 219_315_105_792
    assert 1.9 * step["forward_flops"] <= step["backward_flops"] <= 2.0 * step["forward_flops"]
