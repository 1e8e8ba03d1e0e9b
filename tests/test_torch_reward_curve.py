"""The port's reward-vs-NFE curve (diffusion_tts_torch/tools/reward_curve.py)
against the JAX tool (tools/reward_curve.py).

The sweep: both tools' main() with run_search and load_network stubbed in
their own packages (no denoiser runs) must make the same rows, in the same
order, with the same keys: (method, overrides, nfe_per_sample) equal, the
row keys those of the JAX tool's ``row = dict(...)``, read from its source.
Then one real run of the port on the CPU at the tiny SongUNet."""
import ast
import json
import os
import sys
import types

import jax.numpy as jnp
import pytest
import torch

from diffusion_tts_torch.tools import reward_curve

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_row_keys() -> set[str]:
    """The named keywords of ``row = dict(...)`` in tools/reward_curve.py
    (the ``**over`` overrides are each row's own)."""
    with open(os.path.join(ROOT, "tools", "reward_curve.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "row"
                and isinstance(node.value, ast.Call)):
            return {kw.arg for kw in node.value.keywords if kw.arg is not None}
    raise AssertionError("no row = dict(...) in tools/reward_curve.py")


def _json_rows(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _jax_rows(monkeypatch, capsys, argv) -> list[dict]:
    from diffusion_tts_tpu.backends import edm_entry
    from diffusion_tts_tpu.search import api
    from diffusion_tts_tpu.utils import cache

    b = len(argv[argv.index("--seeds") + 1].split(","))
    monkeypatch.setattr(edm_entry, "load_network", lambda arch: (None, None))
    monkeypatch.setattr(api, "run_search",
                        lambda *a, **k: types.SimpleNamespace(score=jnp.zeros(b)))
    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["reward_curve.py"] + argv)
    sys.path.insert(0, ROOT)
    try:
        from tools import reward_curve as j_reward_curve
    finally:
        sys.path.remove(ROOT)
    capsys.readouterr()
    j_reward_curve.main()
    return _json_rows(capsys.readouterr().out)


def _port_rows(monkeypatch, capsys, argv) -> list[dict]:
    from diffusion_tts_torch.backends import edm_entry
    from diffusion_tts_torch.search import api

    b = len(argv[argv.index("--seeds") + 1].split(","))
    monkeypatch.setattr(edm_entry, "load_network", lambda arch, device: None)
    monkeypatch.setattr(api, "run_search",
                        lambda *a, **k: types.SimpleNamespace(score=torch.zeros(b)))
    capsys.readouterr()
    rows = reward_curve.main(argv + ["--device", "cpu"])
    assert _json_rows(capsys.readouterr().out) == rows
    return rows


@pytest.mark.parametrize("quick", [True, False])
def test_sweep_and_nfe_match_the_jax_tool(monkeypatch, capsys, quick):
    argv = ["--steps", "18", "--seeds", "0,1,2"] + (["--quick"] if quick else [])
    want = _jax_rows(monkeypatch, capsys, argv)
    got = _port_rows(monkeypatch, capsys, argv)
    assert len(got) == (2 if quick else 14)
    keys = _jax_row_keys()
    drop = lambda row: {k: v for k, v in row.items() if k != "wallclock_s"}
    assert [drop(r) for r in got] == [drop(r) for r in want]
    for mine, ref in zip(got, want):
        overrides = set(ref) & {"N", "K", "B", "S"}
        assert set(mine) == set(ref) and set(ref) - overrides == keys
    if not quick:
        assert [(r["method"], r["nfe_per_sample"]) for r in got][:4] == [
            ("naive", 36), ("rejection", 72), ("rejection", 144), ("rejection", 288)]


def test_quick_run_on_the_cpu_writes_its_json(tmp_path):
    path = str(tmp_path / "curve.json")
    rows = reward_curve.main(["--arch", "tiny", "--quick", "--steps", "3", "--seeds", "0,1",
                              "--device", "cpu", "--json", path])
    with open(path) as f:
        data = json.load(f)
    assert set(data) == {"config", "weights", "device", "rows"}
    assert data["rows"] == rows and data["device"] == "cpu" and "RANDOM-INIT" in data["weights"]
    assert [(r["method"], r["nfe_per_sample"]) for r in rows] == [("eps_greedy", 48),
                                                                  ("rejection", 12)]
    assert all(0.0 <= r["reward"] <= 1.0 and r["reward_std"] >= 0.0 for r in rows)
