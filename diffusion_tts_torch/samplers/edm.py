"""EDM Heun sampler with churn (counterpart of
diffusion_tts_tpu/samplers/edm.py::EDMHeunSampler).

Every data-independent scalar (sigma schedule, churn gammas, noise scales,
Heun coefficients) is computed on the host in float64, the precision of the
reference's sampler math (edm/generate.py:25-60), and kept as fp32 tables.
``step(x, i, eps)`` takes a scalar or per-sample [B] step index, so the
search drives it with candidate batches. The last step selects the Euler
result with ``torch.where`` (the second denoise still runs, with a safe
sigma), as the JAX package does, so every step costs two forwards. The
ablation sampler comes with the second slice of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

# denoise(x [B, H, W, C], sigma [B]) -> D_x  (a preconditioned model forward)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EDMHeunSampler:
    """Heun 2nd-order sampler with stochastic churn (Karras Algorithm 2).

    Tables (host fp64 -> fp32): t_steps[N+1], t_hat[N],
    noise_scale[N] = sqrt(t_hat^2 - t^2) * S_noise, h[N] = t_next - t_hat.
    """

    denoise: DenoiseFn
    num_steps: int = 18
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    S_churn: float = 0.0
    S_min: float = 0.0
    S_max: float = float("inf")
    S_noise: float = 1.0

    def __post_init__(self):
        si = np.arange(self.num_steps, dtype=np.float64)
        t = (
            self.sigma_max ** (1 / self.rho)
            + si / max(self.num_steps - 1, 1)
            * (self.sigma_min ** (1 / self.rho) - self.sigma_max ** (1 / self.rho))
        ) ** self.rho
        t_steps = np.concatenate([t, [0.0]])
        gamma = np.where(
            (t_steps[:-1] >= self.S_min) & (t_steps[:-1] <= self.S_max),
            min(self.S_churn / self.num_steps, math.sqrt(2.0) - 1.0),
            0.0,
        )
        t_hat = t_steps[:-1] + gamma * t_steps[:-1]
        noise_scale = np.sqrt(np.maximum(t_hat**2 - t_steps[:-1] ** 2, 0.0)) * self.S_noise
        h = t_steps[1:] - t_hat
        tables = {name: torch.from_numpy(v.astype(np.float32)) for name, v in
                  (("t_steps", t_steps), ("t_hat", t_hat), ("noise_scale", noise_scale),
                   ("h", h))}
        object.__setattr__(self, "_tables", {torch.device("cpu"): tables})

    def tables(self, device: torch.device) -> dict[str, torch.Tensor]:
        """The fp32 tables on ``device`` (copied there once)."""
        cache = self._tables
        if device not in cache:
            cache[device] = {k: v.to(device) for k, v in cache[torch.device("cpu")].items()}
        return cache[device]

    @property
    def t_steps(self) -> torch.Tensor:
        return self._tables[torch.device("cpu")]["t_steps"]

    def init_latents(self, z: torch.Tensor) -> torch.Tensor:
        """x_0 = z * sigma_max (reference edm/main.py:99)."""
        return z.float() * self.tables(z.device)["t_steps"][0]

    def step(self, x: torch.Tensor, i, eps: torch.Tensor, *,
             second_order: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """One churn + Euler (+ Heun) step (reference edm/main.py:82-96).

        ``i`` is an int, a 0-d tensor or a per-sample [B] tensor. Returns
        (x_next, denoised): denoised is the prediction the reference scores
        (D2 when the Heun correction ran, else D1).
        """
        tab = self.tables(x.device)
        i = torch.as_tensor(i, dtype=torch.long, device=x.device)
        bc = lambda v: v.reshape(v.shape + (1,) * (x.ndim - v.ndim))  # [B] -> [B,1,1,1]
        flat = lambda t: t.reshape(-1).expand(x.shape[0])  # sigma for the denoiser: [B]
        t_hat = bc(tab["t_hat"][i])
        t_next = bc(tab["t_steps"][i + 1])
        h = bc(tab["h"][i])
        x_hat = x + bc(tab["noise_scale"][i]) * eps

        d1 = self.denoise(x_hat, flat(t_hat))
        d_cur = (x_hat - d1) / t_hat
        x_eul = x_hat + h * d_cur
        if not second_order:
            return x_eul, d1
        is_last = bc(i >= self.num_steps - 1)
        t_next_safe = torch.where(is_last, torch.ones_like(t_next), t_next)
        d2 = self.denoise(x_eul, flat(t_next_safe))
        d_prime = (x_eul - d2) / t_next_safe
        x_heun = x_hat + h * (0.5 * d_cur + 0.5 * d_prime)
        return torch.where(is_last, x_eul, x_heun), torch.where(is_last, d1, d2)

    def sample(self, z: torch.Tensor, eps_all: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Full trajectory with injected noise eps_all [num_steps, *z.shape];
        returns (x_final, denoised_final). The last step is Euler only."""
        x = self.init_latents(z)
        n = self.num_steps
        for i in range(n - 1):
            x, _ = self.step(x, i, eps_all[i])
        return self.step(x, n - 1, eps_all[n - 1], second_order=False)


__all__ = ["EDMHeunSampler"]
