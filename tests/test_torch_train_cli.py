"""The port's training CLI (python -m diffusion_tts_torch.train) and loop on
the CPU: a dry run, a two-tick run on a tiny PNG folder, a resumed run, every
arch under every preconditioner, a DDPM++/VP run, and the augmentation pipe
at the recipe's --augment 0.12."""
import json
import os

import numpy as np
import pytest
import torch

from diffusion_tts_torch import train as cli
from diffusion_tts_torch.training import checkpoints
from diffusion_tts_torch.training import loop as cli_loop
from diffusion_tts_torch.training.dataset import ImageDataset, batch_iterator
from diffusion_tts_torch.training.loop import LoopConfig, training_loop
from diffusion_tts_torch.training.loss import EDMLoss
from diffusion_tts_torch.training.train_step import TrainConfig

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)

# the ADM preset at a width whose 8x8 blocks still hold one attention head
TINY = ["--arch", "adm", "--cbase", "64", "--cres", "1", "--augment", "0", "--cond", "1"]


@pytest.fixture
def png_folder(tmp_path):
    from PIL import Image

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


def test_dry_run(png_folder, tmp_path, capsys):
    cli.main(["--outdir", str(tmp_path / "runs"), "--data", png_folder, "--device", "cpu",
              "--dry-run", *TINY])
    out = capsys.readouterr().out
    assert "--dry-run: exiting" in out
    opts = json.loads(out[:out.index("--dry-run")])
    assert opts["run_dir"].endswith("00000-tiny-8x8-cond-adm-edm")
    assert opts["net_config"]["label_dim"] == 4 and opts["net_config"]["img_resolution"] == 8
    assert not (tmp_path / "runs").exists()


def test_two_tick_run_on_a_png_folder(png_folder, tmp_path, capsys):
    outdir = str(tmp_path / "runs")
    cli.main(["--outdir", outdir, "--data", png_folder, "--device", "cpu", *TINY,
              "--bf16", "1", "--batch", "64", "--batch-gpu", "32", "--duration", "0.002",
              "--tick", "1", "--snap", "1", "--dump", "2", "--seed", "0", "--max-ticks", "2"])
    (run,) = os.listdir(outdir)
    assert run == "00000-tiny-8x8-cond-adm-edm"
    run_dir = os.path.join(outdir, run)
    names = set(os.listdir(run_dir))
    assert {"training_options.json", "stats.jsonl", "log.txt", "network-snapshot-000001.pt",
            "network-snapshot-000002.pt", "network-snapshot-final.pt",
            "training-state-000002.pt"} <= names
    stats = [json.loads(line) for line in open(os.path.join(run_dir, "stats.jsonl"))]
    assert [s["tick"] for s in stats] == [0, 1]
    assert stats[0]["Loss/loss"]["num"] == 16 and np.isfinite(stats[1]["Loss/loss"]["mean"])
    assert "tick 1" in open(os.path.join(run_dir, "log.txt")).read()
    ema, config = checkpoints.load_snapshot(os.path.join(run_dir, "network-snapshot-final.pt"))
    assert config["model_type"] == "DhariwalUNet" and config["ckpt_format_version"] == 2
    assert all(v.dtype == torch.float32 for v in ema.values())  # fp32 parameters under bf16
    # a second run in the same outdir gets the next number
    capsys.readouterr()
    cli.main(["--outdir", outdir, "--data", png_folder, "--device", "cpu", "--dry-run", *TINY])
    assert '00001-tiny-8x8-cond-adm-edm"' in capsys.readouterr().out


def _loop(run_dir, net_seed, max_ticks, resume=None, transfer=None):
    from diffusion_tts_torch.models.preconds import EDMPrecond
    from diffusion_tts_torch.models.torch_import import load_into, random_state_dict

    g = np.random.default_rng(1)
    data = ImageDataset(g.integers(0, 255, (16, 8, 8, 3), dtype=np.uint8), g.integers(0, 4, 16))
    config = dict(img_resolution=8, img_channels=3, label_dim=4, model_type="DhariwalUNet",
                  model_kwargs=dict(model_channels=64, channel_mult=(1,), num_blocks=1,
                                    dropout=0.1))
    net = EDMPrecond(**config)
    load_into(net, random_state_dict(net, net_seed))
    return training_loop(
        net=net, net_config=config, data_iter=batch_iterator(data, 8, seed=0),
        loss_fn=EDMLoss(),
        train_cfg=TrainConfig(lr=1e-3, lr_rampup_kimg=0.0, grad_accum_rounds=2, total_batch=8),
        loop_cfg=LoopConfig(run_dir=run_dir, total_kimg=1, kimg_per_tick=0.016,
                            snapshot_ticks=1, state_dump_ticks=1, seed=3, batch_size=8),
        device="cpu", max_ticks=max_ticks, resume_state_path=resume,
        transfer_snapshot_path=transfer)


def test_loop_resumes_and_transfers(tmp_path):
    first = _loop(str(tmp_path / "a"), net_seed=0, max_ticks=2)
    assert first.nimg == 32
    dump = str(tmp_path / "a" / "training-state-000000.pt")
    resumed = _loop(str(tmp_path / "b"), net_seed=1, max_ticks=1, resume=dump)
    assert resumed.nimg == 48  # 32 from the dump, then one tick of two steps
    assert resumed.opt.state[next(resumed.net.parameters())]["step"] == 6
    donor = str(tmp_path / "a" / "network-snapshot-final.pt")
    moved = _loop(str(tmp_path / "c"), net_seed=2, max_ticks=1, transfer=donor)
    assert moved.nimg == 16
    # one tick from the donor's EMA stays near it; from another seed it would not
    ema, _ = checkpoints.load_snapshot(donor)
    name, p = next(iter(moved.net.named_parameters()))
    assert float((p.detach() - ema[name]).abs().max()) < 0.05


def test_loop_needs_a_card_unless_cpu_is_asked(monkeypatch, tmp_path, png_folder):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--outdir", str(tmp_path), "--data", png_folder, "--dry-run", *TINY])


@pytest.mark.parametrize("flags,trains", [
    (["--arch", "adm"], False),
    (["--arch", "ddpmpp", "--precond", "vp"], True),
    (["--arch", "ncsnpp"], False),
    (["--arch", "adm", "--precond", "vp"], False),
    (["--arch", "adm", "--precond", "ve"], False),
])
def test_augment_builds_the_pipe_and_map_augment(flags, trains, png_folder, tmp_path, capsys,
                                                  monkeypatch):
    """--augment 0.12 (the recipe's default) under each arch and precond: the
    dry run's net config has augment_dim 9, and the net the CLI builds a
    map_augment with 9 inputs; DDPM++/VP also trains one tick on the
    augmented images."""
    built = {}
    real_loop = cli_loop.training_loop

    def loop(**kw):
        built.update(kw)
        return real_loop(**kw)

    monkeypatch.setattr(cli_loop, "training_loop", loop)
    outdir = str(tmp_path / "runs")
    args = ["--outdir", outdir, "--data", png_folder, "--device", "cpu", "--augment", "0.12",
            "--cbase", "64" if "adm" in flags else "16", "--cres", "1", *flags]
    cli.main(args + ["--dry-run"])
    opts = json.loads(capsys.readouterr().out.split("--dry-run")[0])
    assert opts["augment"] == 0.12 and opts["net_config"]["model_kwargs"]["augment_dim"] == 9
    if not trains:
        return
    cli.main(args + ["--cond", "1", "--batch", "16", "--batch-gpu", "8", "--duration", "0.001",
                     "--tick", "1", "--snap", "1", "--seed", "0", "--max-ticks", "1"])
    pipe, net = built["augment_fn"], built["net"]
    assert pipe.label_dim == 9 and pipe.p == 0.12 and pipe.xflip == 1e8
    assert net.model.map_augment.weight.shape[1] == 9
    run_dir = os.path.join(outdir, "00000-tiny-8x8-cond-ddpmpp-vp")
    stats = [json.loads(line) for line in open(os.path.join(run_dir, "stats.jsonl"))]
    assert np.isfinite(stats[0]["Loss/loss"]["mean"])
    ema, _ = checkpoints.load_snapshot(os.path.join(run_dir, "network-snapshot-final.pt"))
    assert ema["model.map_augment.weight"].shape[1] == 9


@pytest.mark.parametrize("arch,model_type", [("ddpmpp", "SongUNet"), ("ncsnpp", "SongUNet"),
                                             ("adm", "DhariwalUNet")])
@pytest.mark.parametrize("precond", ["vp", "ve", "edm"])
def test_every_arch_and_precond_builds(arch, model_type, precond, png_folder, tmp_path, capsys):
    """Each preset under each preconditioner: the dry run names the pair in
    the run dir and the net config (the root train.py's presets)."""
    cli.main(["--outdir", str(tmp_path / "runs"), "--data", png_folder, "--device", "cpu",
              "--dry-run", "--arch", arch, "--precond", precond, "--augment", "0",
              "--cbase", "64", "--cres", "1"])
    out = capsys.readouterr().out
    opts = json.loads(out[:out.index("--dry-run")])
    assert opts["run_dir"].endswith(f"00000-tiny-8x8-uncond-{arch}-{precond}")
    cfg = opts["net_config"]
    assert cfg["precond"] == precond and cfg["model_type"] == model_type
    want = dict(cli.ARCH_PRESETS[arch]["model_kwargs"], model_channels=64, channel_mult=(1,),
                dropout=0.13)
    assert cfg["model_kwargs"] == json.loads(json.dumps(want))  # tuples are lists in JSON


def test_ddpmpp_vp_run_on_a_png_folder(png_folder, tmp_path):
    """--arch ddpmpp --precond vp trains: one tick, a VPPrecond snapshot with
    a SongUNet inside, a finite VP loss."""
    outdir = str(tmp_path / "runs")
    cli.main(["--outdir", outdir, "--data", png_folder, "--device", "cpu", "--arch", "ddpmpp",
              "--precond", "vp", "--cbase", "16", "--cres", "1", "--augment", "0", "--cond", "1",
              "--batch", "16", "--batch-gpu", "8", "--duration", "0.001", "--tick", "1",
              "--snap", "1", "--seed", "0", "--max-ticks", "1"])
    run_dir = os.path.join(outdir, "00000-tiny-8x8-cond-ddpmpp-vp")
    stats = [json.loads(line) for line in open(os.path.join(run_dir, "stats.jsonl"))]
    assert np.isfinite(stats[0]["Loss/loss"]["mean"])
    ema, config = checkpoints.load_snapshot(os.path.join(run_dir, "network-snapshot-final.pt"))
    assert config["precond"] == "vp" and config["model_type"] == "SongUNet"
    assert "model.enc.8x8_conv.weight" in ema and "model.dec.8x8_aux_conv.weight" in ema
