"""The port's seed-sharded generator (diffusion_tts_torch/tools/generate.py),
its per-seed generators (utils/rng.py), ``entry.dryrun_multichip`` on CPU
ranks and the training CLI under torchrun, on the CPU.

Every process started here has a time limit: torchrun's runs 180 s,
dryrun_multichip's ranks 120 s (their gloo collectives time out at the
same); each rank runs one torch thread (torchrun's default).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tts_torch.entry import dryrun_multichip
from diffusion_tts_torch.tools import generate
from diffusion_tts_torch.utils import rng
from diffusion_tts_tpu.samplers.edm import EDMHeunSampler as JEDMHeunSampler

from _torch_port import tiny_pair

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            "2"]
GEN = ["--arch", "tiny_adm", "--seeds", "0-7", "--steps", "3", "--churn", "20", "--device",
       "cpu"]


def torchrun(module: str, *args: str) -> subprocess.CompletedProcess:
    out = subprocess.run(TORCHRUN + ["-m", module, *args], cwd=REPO, capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    return out


@pytest.mark.parametrize("spec,want", [
    ("0-3", [0, 1, 2, 3]), ("1,2,5-7", [1, 2, 5, 6, 7]), ("9", [9]), ("2-2,0", [2, 0])])
def test_parse_seeds_matches_the_jax_tool(spec, want):
    from tools import generate as j_generate

    assert generate.parse_seeds(spec) == j_generate.parse_seeds(spec) == want


@pytest.mark.parametrize("world,max_batch", [(1, 8), (2, 2), (3, 2), (2, 64)])
def test_rank_batches_cover_every_seed_once(world, max_batch):
    """The reference's split (generate.py:254-257): batches of at most
    max_batch, strided over the ranks, every seed once."""
    seeds = list(range(11))
    per_rank = [generate.rank_batches(seeds, max_batch, r, world) for r in range(world)]
    flat = [s for batches in per_rank for b in batches for s in b]
    assert sorted(flat) == seeds
    assert all(len(b) <= max_batch for batches in per_rank for b in batches)
    assert len({len(batches) for batches in per_rank}) == 1  # every rank runs as many batches


def test_a_seeds_draws_do_not_depend_on_its_batch():
    shape = (4, 4, 3)
    batch = rng.stacked_normal(rng.per_seed_generators([3, 5, 7], "cpu", 2), shape)
    alone = rng.stacked_normal(rng.per_seed_generators([5], "cpu", 2), shape)
    assert batch.shape == (3, 4, 4, 3) and torch.equal(batch[1], alone[0])
    assert not torch.equal(batch[0], batch[1])
    other_path = rng.stacked_normal(rng.per_seed_generators([5], "cpu", 0), shape)
    assert not torch.equal(other_path, alone)


def test_sampler_matches_jax_with_its_uint8_clip():
    """generate's sampler on given z, churn noise and labels against the JAX
    tool's EDMHeunSampler and clip (tools/generate.py:84-89): within one
    uint8 level."""
    j_net, variables, t_net = tiny_pair(seed=3)
    g = np.random.default_rng(4)
    steps = 3
    z = g.standard_normal((2, 16, 16, 3)).astype(np.float32)
    eps = g.standard_normal((steps, 2, 16, 16, 3)).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[[1, 8]]
    sampler = JEDMHeunSampler(denoise=lambda x, s: j_net.apply(variables, x, s, labels),
                              num_steps=steps, S_churn=20.0)
    run = jax.jit(lambda zz, ee: jnp.clip(sampler.sample(zz, ee)[0] * 127.5 + 128, 0,
                                          255).astype(jnp.uint8))
    want = np.asarray(run(jnp.asarray(z), jnp.asarray(eps)), np.int16)
    got = generate.sample_images(t_net, torch.from_numpy(z), torch.from_numpy(eps),
                                 torch.from_numpy(labels), steps, 20.0).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want).max() <= 1
    assert len(np.unique(got)) > 10


def _pngs(folder):
    return {name: np.asarray(Image.open(os.path.join(folder, name)), np.int16)
            for name in sorted(os.listdir(folder))}


def test_images_do_not_depend_on_batch_or_rank(tmp_path):
    """Seeds 0-7 at --batch 8 in one process against --batch 2 on two gloo
    ranks under torchrun: the same PNGs within one uint8 level."""
    written = generate.main(["--outdir", str(tmp_path / "one"), "--batch", "8", *GEN])
    assert len(written) == 8
    out = torchrun("diffusion_tts_torch.tools.generate", "--outdir", str(tmp_path / "two"),
                   "--batch", "2", "--dist-backend", "gloo", *GEN)
    assert out.stdout.count("wrote 8 images") == 1  # rank 0 alone prints
    one, two = _pngs(tmp_path / "one"), _pngs(tmp_path / "two")
    assert list(one) == [f"{s:06d}.png" for s in range(8)] and one.keys() == two.keys()
    assert max(int(np.abs(one[k] - two[k]).max()) for k in one) <= 1
    assert not np.array_equal(one["000000.png"], one["000001.png"])


@pytest.mark.parametrize("n,mesh,sharded", [(2, "data:2xmodel:1", False),
                                            (4, "data:2xmodel:2", True)])
def test_dryrun_multichip_on_cpu_ranks(capsys, n, mesh, sharded):
    line = dryrun_multichip(n, device="cpu", timeout=120)
    assert line in capsys.readouterr().out
    assert line.startswith(f"dryrun_multichip({n}) ok: mesh={mesh} (cpu, gloo)")
    fields = dict(part.split("=", 1) for part in line.split() if "=" in part)
    assert np.isfinite(float(fields["loss"])) and int(fields["nimg"]) == 8  # 2 rounds of 4
    assert (int(line.split("model-sharded params=")[1].split()[0]) > 0) == sharded
    scores = [float(s.split("=")[1]) for s in line.split() if s.startswith("score=")]
    assert len(scores) == 3 and all(0 <= s <= 1 for s in scores)


def test_dryrun_multichip_refuses_nccl_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2)


@pytest.fixture
def png_folder(tmp_path):
    g = np.random.default_rng(0)
    root = tmp_path / "tiny-8x8"
    root.mkdir()
    labels = []
    for i in range(16):
        name = f"img{i:08d}.png"
        Image.fromarray(g.integers(0, 255, (8, 8, 3), dtype=np.uint8)).save(root / name)
        labels.append([name, int(g.integers(0, 4))])
    (root / "dataset.json").write_text(json.dumps({"labels": labels}))
    return str(root)


def test_train_cli_on_two_ranks(png_folder, tmp_path):
    """One step (a duration under 1 kimg ends the run after it) and its tick
    of the training CLI on two gloo ranks: rank 0 alone writes the run dir
    (one stats.jsonl holding both ranks' losses, the snapshots, the log),
    and the loop's consistency check before each snapshot held both ranks'
    nets bit for bit alike."""
    outdir = tmp_path / "runs"
    torchrun("diffusion_tts_torch.train", "--outdir", str(outdir), "--data", png_folder,
             "--device", "cpu", "--dist-backend", "gloo", "--arch", "adm", "--cbase", "64",
             "--cres", "1", "--augment", "0", "--cond", "1", "--batch", "64", "--batch-gpu",
             "16", "--duration", "0.0001", "--tick", "1", "--snap", "1", "--seed", "0")
    (run,) = os.listdir(outdir)
    run_dir = outdir / run
    assert {"training_options.json", "stats.jsonl", "log.txt", "network-snapshot-000000.pt",
            "network-snapshot-final.pt"} <= set(os.listdir(run_dir))
    (stats,) = [json.loads(line) for line in open(run_dir / "stats.jsonl")]
    assert stats["Loss/loss"]["num"] == 2 and stats["kimg"] == 0.064  # each rank's loss
    assert stats["Timing/sec_per_kimg"]["num"] == 1  # report0: rank 0's value only
    opts = json.loads((run_dir / "training_options.json").read_text())
    assert opts["net_config"]["model_kwargs"]["model_channels"] == 64
    assert open(run_dir / "log.txt").read().count("tick 0 ") == 1
