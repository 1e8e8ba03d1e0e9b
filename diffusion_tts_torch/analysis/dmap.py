"""Analysis of selected-noise trajectories, the dmap toolbox (the port's own
copy of diffusion_tts_tpu/analysis/dmap.py, which is numpy only; reference
edm/dmap.py:16-567).

It reads the best-noise stacks the port's search records:
``run_search(..., record_noises=True).best_noises`` is ``[steps, K, B,
...]`` for zero_order and eps_greedy (the reference collects the same data
at edm/main.py:741,854 into all_timestep_noises.pkl). Beam records the ids
of its kept candidates, ``[steps, B, M]``, not noises, so its record is no
input here. Every function takes numpy arrays or torch tensors on any
device (moved to the host first):

  * per-timestep norm statistics (the reference's Mahalanobis-norm violin
    plots, dmap.py:49-92 -- for i.i.d. standard-normal noise the covariance
    is identity, so Mahalanobis == L2),
  * diffusion-map spectral embedding (dmap.py:94-180) in numpy (Gaussian
    kernel, row-normalized Markov transition, eigendecomposition),
  * t-SNE embedding via sklearn when it is installed (dmap.py:182-553), and
  * matplotlib figures when matplotlib is installed.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A numpy array of ``x``: a torch tensor (any device, any dtype numpy
    holds) is detached and moved to the host first."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def save_noise_trajectories(path: str, best_noises, t_steps=None) -> None:
    """Persist the search's noise-selection record (the reference's
    all_timestep_noises.pkl + t_steps.pkl counterpart)."""
    arrays = {"noises": _host(best_noises)}
    if t_steps is not None:
        arrays["t_steps"] = _host(t_steps)
    np.savez_compressed(path, **arrays)


def load_noise_trajectories(path: str):
    with np.load(path) as f:
        return f["noises"], (f["t_steps"] if "t_steps" in f.files else None)


def noise_norms(noises: np.ndarray) -> np.ndarray:
    """[steps, K, B, ...] -> L2 (== Mahalanobis for N(0,I)) norms
    [steps, K*B]."""
    noises = _host(noises)
    steps = noises.shape[0]
    b = noises.shape[1] * noises.shape[2]
    flat = noises.reshape(steps, b, -1)
    return np.linalg.norm(flat, axis=-1)


def diffusion_map(
    points: np.ndarray, n_components: int = 2, epsilon: float | None = None
) -> np.ndarray:
    """Diffusion-map embedding of [N, D] points (dmap.py:94-180): Gaussian
    kernel K = exp(-|xi-xj|^2/eps), Markov-normalize, take the top
    non-trivial eigenvectors."""
    points = _host(points)
    d2 = np.square(points[:, None, :] - points[None, :, :]).sum(-1)
    if epsilon is None:
        epsilon = np.median(d2[d2 > 0]) + 1e-12
    k = np.exp(-d2 / epsilon)
    d = k.sum(1)
    p = k / d[:, None]
    vals, vecs = np.linalg.eig(p)
    order = np.argsort(-vals.real)
    # skip the trivial constant eigenvector (eigenvalue 1)
    sel = order[1 : n_components + 1]
    return (vecs[:, sel].real * vals[sel].real[None, :]).astype(np.float64)


def tsne_embedding(points: np.ndarray, n_components: int = 2, seed: int = 0):
    """t-SNE via sklearn when present (dmap.py:182-553); None otherwise."""
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        return None
    points = _host(points)
    perplexity = max(2, min(30, len(points) - 1))
    return TSNE(n_components=n_components, random_state=seed,
                perplexity=perplexity, init="pca").fit_transform(points)


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def create_tsne_visualization(noises: np.ndarray, t_steps, out_dir: str,
                              max_timesteps: int = 18, seed: int = 42) -> str | None:
    """Per-timestep t-SNE scatter with centroid-trajectory arrows
    (reference edm/dmap.py:182-250): first-batch noises from up to
    ``max_timesteps`` evenly-sampled timesteps, colored by timestep index,
    consecutive timestep centroids connected by arrows."""
    plt = _plt()
    if plt is None:
        return None
    noises = _host(noises)
    steps = noises.shape[0]
    sample = np.linspace(0, steps - 1, min(steps, max_timesteps), dtype=int)
    data, ts_idx = [], []
    for i, t in enumerate(sample):
        flat = noises[t, :, 0].reshape(noises.shape[1], -1)  # first batch sample
        data.append(flat)
        ts_idx.extend([i] * flat.shape[0])
    data = np.vstack(data)
    emb = tsne_embedding(data, seed=seed)
    if emb is None:
        return None
    ts_idx = np.asarray(ts_idx)

    fig, ax = plt.subplots(figsize=(12, 10))
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=ts_idx, cmap="viridis", alpha=0.8, s=50)
    fig.colorbar(sc, ax=ax, label="Timestep Index")
    centroids = [emb[ts_idx == i].mean(axis=0) for i in range(len(sample))
                 if np.any(ts_idx == i)]
    for a, b in zip(centroids[:-1], centroids[1:]):
        ax.annotate("", xy=tuple(b), xytext=tuple(a),
                    arrowprops=dict(arrowstyle="->", color="black", linewidth=1.5))
    ax.set_title("t-SNE Visualization of Noise Data with Timestep Progression")
    ax.set_xlabel("t-SNE Dimension 1")
    ax.set_ylabel("t-SNE Dimension 2")
    ax.grid(alpha=0.3)
    path = os.path.join(out_dir, "tsne_visualization.png")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def create_tsne_animation(noises: np.ndarray, t_steps, out_dir: str,
                          max_timesteps: int = 10, max_iterations: int = 20,
                          seed: int = 42, fps: int = 6) -> str | None:
    """Animated t-SNE of noise candidates across (timestep, iteration)
    (reference edm/dmap.py:252-553): one frame per sampled iteration,
    points colored by within-timestep iteration progress, the current
    timestep's iteration trajectory drawn as a line. Saved as GIF via the
    pillow writer (the reference prefers ffmpeg/mp4 and falls back the same
    way); if no writer is available, a 4x4 keyframe grid is written instead
    (reference's static fallback, dmap.py:518-553)."""
    plt = _plt()
    if plt is None:
        return None
    from matplotlib import animation

    noises = _host(noises)
    steps = noises.shape[0]
    k_iters = noises.shape[1]
    sample_ts = np.linspace(0, steps - 1, min(steps, max_timesteps), dtype=int)
    iters = np.linspace(0, k_iters - 1, min(k_iters, max_iterations), dtype=int)

    data, frame_ids, iter_prog, labels = [], [], [], []
    for ts_i, t in enumerate(sample_ts):
        for j, k in enumerate(iters):
            data.append(noises[t, k, 0].reshape(1, -1))
            frame_ids.append(ts_i * len(iters) + j)
            iter_prog.append(j / max(len(iters) - 1, 1))
            sigma = (f"σ={float(t_steps[t]):.4f}" if t_steps is not None
                     and t < len(t_steps) else f"step {t}")
            labels.append(f"{sigma}, Iteration {k + 1}/{k_iters}")
    data = np.vstack(data)
    emb = tsne_embedding(data, seed=seed)
    if emb is None:
        return None
    frame_ids = np.asarray(frame_ids)
    iter_prog = np.asarray(iter_prog)
    n_frames = len(set(frame_ids.tolist()))

    fig, ax = plt.subplots(figsize=(8, 7))
    pad = 0.1
    xr, yr = np.ptp(emb[:, 0]) or 1.0, np.ptp(emb[:, 1]) or 1.0
    ax.set_xlim(emb[:, 0].min() - pad * xr, emb[:, 0].max() + pad * xr)
    ax.set_ylim(emb[:, 1].min() - pad * yr, emb[:, 1].max() + pad * yr)
    ax.set_xlabel("t-SNE Dimension 1")
    ax.set_ylabel("t-SNE Dimension 2")
    ax.grid(alpha=0.3)
    title = ax.set_title("t-SNE of Noise Candidates Across Denoising Steps")
    text = ax.text(0.02, 0.98, "", transform=ax.transAxes, va="top",
                   bbox=dict(boxstyle="round", facecolor="white", alpha=0.7))
    (traj_line,) = ax.plot([], [], "-", color="tab:red", alpha=0.7, linewidth=2)
    scatter = ax.scatter([], [], s=60, c=[], cmap="viridis", vmin=0, vmax=1)

    transition = 8

    def update(frame):
        dist = np.abs(frame_ids - frame)
        keep = dist <= transition
        opacity = np.clip(1 - dist[keep] / transition, 0, 1)
        scatter.set_offsets(emb[keep])
        scatter.set_array(iter_prog[keep])
        scatter.set_sizes(100 * opacity)
        scatter.set_alpha(None)
        ts_cur = frame // len(iters)
        in_ts = frame_ids // len(iters) == ts_cur
        upto = in_ts & (frame_ids <= frame)
        pts = emb[upto]
        traj_line.set_data(pts[:, 0], pts[:, 1])
        nearest = int(np.argmin(np.abs(frame_ids - frame)))
        text.set_text(labels[nearest])
        return [scatter, traj_line, text, title]

    ani = animation.FuncAnimation(
        fig, update, frames=np.arange(n_frames), interval=1000 // fps, blit=True)
    try:
        if "pillow" in animation.writers.list():
            path = os.path.join(out_dir, "tsne_animation.gif")
            ani.save(path, writer="pillow", fps=fps, dpi=80)
            plt.close(fig)
            return path
        raise RuntimeError("no animation writer")
    except Exception:
        # static keyframe grid fallback (reference dmap.py:518-553)
        plt.close(fig)
        fig = plt.figure(figsize=(16, 13))
        for i, frame in enumerate(np.linspace(0, n_frames - 1, 16, dtype=int)):
            axi = fig.add_subplot(4, 4, i + 1)
            m = frame_ids == frame
            if np.any(m):
                axi.scatter(emb[m, 0], emb[m, 1], c=iter_prog[m], s=60,
                            cmap="viridis", vmin=0, vmax=1, alpha=0.8)
            nearest = int(np.argmin(np.abs(frame_ids - frame)))
            axi.set_title(labels[nearest], fontsize=8)
            axi.grid(alpha=0.3)
        fig.tight_layout()
        path = os.path.join(out_dir, "tsne_keyframes.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path


def create_visualizations(noises_path: str, out_dir: str,
                          animate: bool = True) -> list[str]:
    """Produce the reference's full figure set from a recorded trajectory
    file (edm/dmap.py:49-553): norm violins, diffusion-map scatter,
    per-timestep t-SNE with centroid arrows, and the t-SNE animation.
    Returns written file paths; skips plots whose deps are unavailable."""
    os.makedirs(out_dir, exist_ok=True)
    noises, t_steps = load_noise_trajectories(noises_path)
    written = []

    norms = noise_norms(noises)
    np.save(os.path.join(out_dir, "noise_norms.npy"), norms)
    written.append(os.path.join(out_dir, "noise_norms.npy"))

    steps = noises.shape[0]
    flat = noises.reshape(steps * noises.shape[1] * noises.shape[2], -1)
    emb = None
    if len(flat) >= 4:
        emb = diffusion_map(flat[: min(len(flat), 512)])
        np.save(os.path.join(out_dir, "diffusion_map.npy"), emb)
        written.append(os.path.join(out_dir, "diffusion_map.npy"))
        ts = tsne_embedding(flat[: min(len(flat), 512)])
        if ts is not None:
            np.save(os.path.join(out_dir, "tsne.npy"), ts)
            written.append(os.path.join(out_dir, "tsne.npy"))

    plt = _plt()
    if plt is not None:
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.violinplot([norms[i] for i in range(steps)], showmeans=True)
        ax.set_xlabel("timestep")
        ax.set_ylabel("noise L2 norm (Mahalanobis)")
        fig.savefig(os.path.join(out_dir, "norm_violins.png"), dpi=120)
        plt.close(fig)
        written.append(os.path.join(out_dir, "norm_violins.png"))

        if emb is not None:
            per_ts = noises.shape[1] * noises.shape[2]
            color = np.repeat(np.arange(steps), per_ts)[: len(emb)]
            fig, ax = plt.subplots(figsize=(8, 7))
            sc = ax.scatter(emb[:, 0], emb[:, 1], c=color, cmap="viridis", s=30)
            fig.colorbar(sc, ax=ax, label="timestep")
            ax.set_title("Diffusion-map embedding of selected noises")
            fig.savefig(os.path.join(out_dir, "diffusion_map.png"), dpi=120,
                        bbox_inches="tight")
            plt.close(fig)
            written.append(os.path.join(out_dir, "diffusion_map.png"))

    p = create_tsne_visualization(noises, t_steps, out_dir)
    if p:
        written.append(p)
    if animate:
        p = create_tsne_animation(noises, t_steps, out_dir)
        if p:
            written.append(p)
    return written


__all__ = [
    "save_noise_trajectories", "load_noise_trajectories", "noise_norms",
    "diffusion_map", "tsne_embedding", "create_tsne_visualization",
    "create_tsne_animation", "create_visualizations",
]
