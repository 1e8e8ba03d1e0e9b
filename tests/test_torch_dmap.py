"""The port's dmap analysis (diffusion_tts_torch/analysis/dmap.py) against the
JAX package's numpy module on the same arrays, and on the noises a port
search records. Both are numpy underneath, so the results are equal."""
import os

import numpy as np
import pytest
import torch

from diffusion_tts_torch.analysis import dmap as t_dmap
from diffusion_tts_torch.backends.edm_entry import generate_image_grid
from diffusion_tts_torch.scorers import BrightnessScorer
from diffusion_tts_torch.utils.config import SearchParams
from diffusion_tts_tpu.analysis import dmap as j_dmap

torch.set_num_threads(1)  # one thread per xdist worker (tests/_torch_port.py)


def _noises(seed=0):
    return np.random.default_rng(seed).normal(size=(4, 3, 2, 8, 8, 3)).astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_norms_and_diffusion_map_equal_jax(as_tensor):
    noises = _noises()
    arg = torch.from_numpy(noises) if as_tensor else noises
    np.testing.assert_array_equal(t_dmap.noise_norms(arg), j_dmap.noise_norms(noises))
    flat = noises.reshape(24, -1)
    flat_arg = torch.from_numpy(flat) if as_tensor else flat
    for eps in (None, 50.0):
        np.testing.assert_array_equal(t_dmap.diffusion_map(flat_arg, 3, eps),
                                      j_dmap.diffusion_map(flat, 3, eps))


def test_save_load_round_trip_equals_jax(tmp_path):
    noises, t_steps = _noises(1), np.linspace(80, 0, 5)
    ours, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    t_dmap.save_noise_trajectories(ours, torch.from_numpy(noises), torch.from_numpy(t_steps))
    j_dmap.save_noise_trajectories(theirs, noises, t_steps)
    for path in (ours, theirs):
        for load in (t_dmap.load_noise_trajectories, j_dmap.load_noise_trajectories):
            got, steps = load(path)
            np.testing.assert_array_equal(got, noises)
            np.testing.assert_array_equal(steps, t_steps)
    t_dmap.save_noise_trajectories(str(tmp_path / "n.npz"), noises)
    assert t_dmap.load_noise_trajectories(str(tmp_path / "n.npz"))[1] is None


def test_bf16_tensor_reaches_the_host_as_fp32():
    x = torch.from_numpy(_noises(2)).bfloat16()
    norms = t_dmap.noise_norms(x)
    assert norms.dtype == np.float32 and norms.shape == (4, 6)
    np.testing.assert_array_equal(norms, j_dmap.noise_norms(x.float().numpy()))


def test_reads_an_eps_greedy_search_record(tmp_path):
    """eps-greedy at --arch tiny_adm with record_noises=True: best_noises
    [steps, K, B, 16, 16, 3] goes through the analysis as it comes (a
    tensor), and the figure-free part of create_visualizations writes the
    norms and the diffusion map."""
    params = SearchParams(N=2, K=2)
    result = generate_image_grid(arch="tiny_adm", scorer=BrightnessScorer(), method="eps_greedy",
                                 params=params, seed=0, gridw=2, num_steps=3, device="cpu",
                                 record_noises=True)
    noises = result.best_noises
    assert isinstance(noises, torch.Tensor) and noises.shape == (3, 2, 2, 16, 16, 3)
    norms = t_dmap.noise_norms(noises)
    np.testing.assert_array_equal(norms, j_dmap.noise_norms(noises.numpy()))
    assert norms.shape == (3, 4) and np.isfinite(norms).all()
    path = str(tmp_path / "noises.npz")
    t_dmap.save_noise_trajectories(path, noises)
    written = t_dmap.create_visualizations(path, str(tmp_path / "viz"), animate=False)
    for name in ("noise_norms.npy", "diffusion_map.npy"):
        assert os.path.join(str(tmp_path / "viz"), name) in written
    emb = np.load(os.path.join(str(tmp_path / "viz"), "diffusion_map.npy"))
    np.testing.assert_array_equal(emb, j_dmap.diffusion_map(noises.numpy().reshape(12, -1)))
