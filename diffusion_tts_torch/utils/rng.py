"""RNG discipline for the port (counterpart of diffusion_tts_tpu/utils/rng.py).

The JAX package addresses every draw by a key path
(``fold_in_path(root, salt, step, k)``) so a candidate's noise does not
depend on how candidates are batched. The port keeps that property with
``torch.Generator``s: each draw gets a fresh generator seeded from the
integer path, mixed with splitmix64. Torch cannot reproduce threefry, so
these draws match the JAX package's in distribution only; tests that need
identical noise inject it (``search.noise.InjectedNoise``).
"""
from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in_path(seed: int, *path: int) -> int:
    """Fold a tuple of integers into a 63-bit seed, one at a time."""
    s = int(seed) & _MASK64
    for p in path:
        s = _splitmix64(s ^ _splitmix64(int(p) & _MASK64))
    return s >> 1


def generator(seed: int, *path: int, device: torch.device | str = "cpu") -> torch.Generator:
    """A generator on ``device`` seeded from ``fold_in_path(seed, *path)``."""
    g = torch.Generator(device=device)
    g.manual_seed(fold_in_path(seed, *path))
    return g


def normal(seed: int, path: tuple[int, ...], shape, device) -> torch.Tensor:
    """Standard-normal fp32 draw addressed by ``(seed, *path)``."""
    return torch.randn(shape, generator=generator(seed, *path, device=device),
                       device=device, dtype=torch.float32)


def uniform(seed: int, path: tuple[int, ...], shape, device) -> torch.Tensor:
    """U[0, 1) fp32 draw addressed by ``(seed, *path)``."""
    return torch.rand(shape, generator=generator(seed, *path, device=device),
                      device=device, dtype=torch.float32)


def per_seed_generators(seeds, device: torch.device | str = "cpu",
                        *path: int) -> list[torch.Generator]:
    """One generator per image seed, each seeded from ``(seed, *path)``:
    the reference's StackedRandomGenerator (edm/generate.py:182-196). The
    draws a seed sees do not depend on the batch or rank it lands in."""
    return [generator(int(s), *path, device=device) for s in seeds]


def stacked_normal(generators: list[torch.Generator], shape) -> torch.Tensor:
    """Per-seed standard-normal fp32 draws: [len(generators), *shape]."""
    return torch.stack([torch.randn(shape, generator=g, device=g.device, dtype=torch.float32)
                        for g in generators])


def unit_normalize(x: torch.Tensor, dims=None, eps: float = 0.0) -> torch.Tensor:
    """x / ||x||_2 over ``dims`` (default: all but the leading axis), the
    norm floored at ``eps`` or, when it is 0, the dtype's smallest normal."""
    if dims is None:
        dims = tuple(range(1, x.ndim))
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=True))
    return x / torch.clamp(norm, min=eps if eps > 0 else torch.finfo(x.dtype).tiny)


__all__ = ["fold_in_path", "generator", "normal", "uniform", "per_seed_generators",
           "stacked_normal", "unit_normalize"]
