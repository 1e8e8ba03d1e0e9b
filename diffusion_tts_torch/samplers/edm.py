"""EDM samplers: Heun with churn and the generalized ablation sampler
(counterpart of diffusion_tts_tpu/samplers/edm.py::EDMHeunSampler and
::AblationSampler).

Every data-independent scalar (sigma schedule, churn gammas, noise scales,
Heun coefficients) is computed on the host in float64, the precision of the
reference's sampler math (edm/generate.py:25-60), and kept as fp32 tables.
``step(x, i, eps)`` takes a scalar or per-sample [B] step index, so the
search drives it with candidate batches. The last step selects the Euler
result with ``torch.where`` (the second denoise still runs, with a safe
sigma), as the JAX package does, so every step costs two forwards; so
does the ablation sampler's heun solver, and its euler solver costs one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from diffusion_tts_torch.ops import schedules

# denoise(x [B, H, W, C], sigma [B]) -> D_x  (a preconditioned model forward)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class _HostTables:
    """A sampler's fp32 tables, made on the host (``_tables``: {device:
    {name: tensor}}, the CPU's set at construction) and copied to each
    device once."""

    def tables(self, device: torch.device) -> dict[str, torch.Tensor]:
        cache = self._tables
        if device not in cache:
            cache[device] = {k: v.to(device) for k, v in cache[torch.device("cpu")].items()}
        return cache[device]


@dataclasses.dataclass(frozen=True)
class EDMHeunSampler(_HostTables):
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


def _vp_funcs(beta_d: float, beta_min: float):
    """sigma(t), sigma'(t) and sigma^-1(s) of the VP schedule, host fp64."""
    sigma = lambda t: np.sqrt(np.expm1(0.5 * beta_d * t ** 2 + beta_min * t))
    sigma_deriv = lambda t: 0.5 * (beta_min + beta_d * t) * (sigma(t) + 1.0 / sigma(t))
    sigma_inv = lambda s: (np.sqrt(beta_min ** 2 + 2.0 * beta_d
                                   * np.log1p(np.asarray(s, np.float64) ** 2)) - beta_min) / beta_d
    return sigma, sigma_deriv, sigma_inv


@dataclasses.dataclass(frozen=True)
class AblationSampler(_HostTables):
    """Generalized sampler: {vp, ve, iddpm, edm} discretization x {vp, ve,
    linear} schedule x {vp, none} scaling x {euler, heun} solver (reference
    edm/generate.py:66-176).

    Every per-step scalar is a closed-form function of the static schedule,
    tabulated on the host in fp64 and kept as fp32 tables:
    d_cur = c_x[i] x_hat - c_d[i] denoised, x_next = x_hat + h[i] (...), with
    c_x = sigma'/sigma + s'/s and c_d = sigma' s / sigma at t_hat, and the
    churn x_hat = (s(t_hat) / s(t_cur)) x + inj[i] eps. Each discretization
    goes through ``ops/schedules.py``'s float32 default before the fp64
    table math, where the JAX package rounds it (see that module).
    """

    denoise: DenoiseFn
    num_steps: int = 18
    sigma_min: float | None = None
    sigma_max: float | None = None
    rho: float = 7.0
    solver: str = "heun"
    discretization: str = "edm"
    schedule: str = "linear"
    scaling: str = "none"
    epsilon_s: float = 1e-3
    C_1: float = 0.001
    C_2: float = 0.008
    M: int = 1000
    alpha: float = 1.0
    S_churn: float = 0.0
    S_min: float = 0.0
    S_max: float = float("inf")
    S_noise: float = 1.0
    net_sigma_min: float = 0.0  # the range the net supports clamps the schedule's
    net_sigma_max: float = float("inf")

    def __post_init__(self):
        for name, allowed in (("solver", ("euler", "heun")),
                              ("discretization", ("vp", "ve", "iddpm", "edm")),
                              ("schedule", ("vp", "ve", "linear")), ("scaling", ("vp", "none"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {getattr(self, name)!r}")

        canon_sigma, _, _ = _vp_funcs(19.9, 0.1)
        defaults_min = {"vp": float(canon_sigma(self.epsilon_s)), "ve": 0.02, "iddpm": 0.002,
                        "edm": 0.002}
        defaults_max = {"vp": float(canon_sigma(1.0)), "ve": 100.0, "iddpm": 81.0, "edm": 80.0}
        sigma_min = defaults_min[self.discretization] if self.sigma_min is None else self.sigma_min
        sigma_max = defaults_max[self.discretization] if self.sigma_max is None else self.sigma_max
        sigma_min = max(sigma_min, self.net_sigma_min)
        sigma_max = min(sigma_max, self.net_sigma_max)
        vp_beta_d, vp_beta_min = schedules.vp_betas_for_range(sigma_min, sigma_max, self.epsilon_s)

        # the discretized sigma levels, through float32, then fp64
        n = self.num_steps
        if self.discretization == "vp":
            levels = schedules.vp_sigmas(n, beta_d=vp_beta_d, beta_min=vp_beta_min,
                                         epsilon_s=self.epsilon_s, append_zero=False)
        elif self.discretization == "ve":
            levels = schedules.ve_sigmas(n, sigma_min, sigma_max, append_zero=False)
        elif self.discretization == "iddpm":
            levels = schedules.iddpm_sigmas(n, sigma_min, sigma_max, M=self.M, C_1=self.C_1,
                                            C_2=self.C_2, append_zero=False)
        else:
            levels = schedules.karras_sigmas(n, sigma_min, sigma_max, self.rho,
                                             append_zero=False)
        sigma_steps = levels.astype(np.float64)

        # the schedule and scaling functions (host fp64)
        f64 = lambda t: np.asarray(t, np.float64)
        if self.schedule == "vp":
            sigma, sigma_deriv, sigma_inv = _vp_funcs(vp_beta_d, vp_beta_min)
        elif self.schedule == "ve":
            sigma = lambda t: np.sqrt(f64(t))
            sigma_deriv = lambda t: 0.5 / np.sqrt(f64(t))
            sigma_inv = lambda s: f64(s) ** 2
        else:
            sigma, sigma_deriv, sigma_inv = f64, lambda t: np.ones_like(f64(t)), f64
        if self.scaling == "vp":
            s_fn = lambda t: 1.0 / np.sqrt(1.0 + sigma(t) ** 2)
            s_deriv = lambda t: -sigma(t) * sigma_deriv(t) * s_fn(t) ** 3
        else:
            s_fn, s_deriv = (lambda t: np.ones_like(f64(t))), (lambda t: np.zeros_like(f64(t)))

        # the per-step tables (reference :139-160, in fp64)
        t_steps = np.concatenate([sigma_inv(sigma_steps), [0.0]])
        t_cur, t_next = t_steps[:-1], t_steps[1:]
        gamma = np.where((sigma(t_cur) >= self.S_min) & (sigma(t_cur) <= self.S_max),
                         min(self.S_churn / n, math.sqrt(2.0) - 1.0), 0.0)
        t_hat = sigma_inv(sigma(t_cur) + gamma * sigma(t_cur))
        inj = np.sqrt(np.maximum(sigma(t_hat) ** 2 - sigma(t_cur) ** 2, 0.0)) * s_fn(t_hat) \
            * self.S_noise
        h = t_next - t_hat
        t_prime = t_hat + self.alpha * h
        t_prime_safe = np.where(t_prime > 0, t_prime, 1.0)  # the last step's, never used
        coeffs = lambda t: (sigma_deriv(t) / sigma(t) + s_deriv(t) / s_fn(t),
                            sigma_deriv(t) * s_fn(t) / sigma(t))
        cx_hat, cd_hat = coeffs(t_hat)
        cx_prime, cd_prime = coeffs(t_prime_safe)
        tables = dict(x_scale=s_fn(t_hat) / s_fn(t_cur), inj=inj, h=h, sigma_hat=sigma(t_hat),
                      s_hat=s_fn(t_hat), cx_hat=cx_hat, cd_hat=cd_hat,
                      sigma_prime=sigma(t_prime_safe), s_prime=s_fn(t_prime_safe),
                      cx_prime=cx_prime, cd_prime=cd_prime)
        tables = {k: torch.from_numpy(np.asarray(v, np.float64).astype(np.float32))
                  for k, v in tables.items()}
        object.__setattr__(self, "_tables", {torch.device("cpu"): tables})
        object.__setattr__(self, "_x0_scale", float(sigma(t_steps[0]) * s_fn(t_steps[0])))

    def init_latents(self, z: torch.Tensor) -> torch.Tensor:
        """x_0 = z * sigma(t_0) * s(t_0)."""
        return z.float() * self._x0_scale

    def step(self, x: torch.Tensor, i, eps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One step (reference edm/generate.py:139-174). ``i`` is an int, a
        0-d tensor or a per-sample [B] tensor. Returns (x_next, denoised):
        the heun solver's D2 where its correction ran, else D1. The heun
        solver runs its second denoise on the last step too and selects the
        Euler result there, as the JAX package does: 2 NFE a step, euler 1."""
        tab = self.tables(x.device)
        i = torch.as_tensor(i, dtype=torch.long, device=x.device)
        at = lambda k: tab[k][i].reshape(i.shape + (1,) * (x.ndim - i.ndim))  # [B] -> [B,1,1,1]
        flat = lambda t: t.reshape(-1).expand(x.shape[0])  # sigma for the denoiser: [B]
        x_hat = at("x_scale") * x + at("inj") * eps
        d1 = self.denoise(x_hat / at("s_hat"), flat(at("sigma_hat")))
        d_cur = at("cx_hat") * x_hat - at("cd_hat") * d1
        h = at("h")
        x_eul = x_hat + h * d_cur
        if self.solver == "euler":
            return x_eul, d1
        x_prime = x_hat + self.alpha * h * d_cur
        d2 = self.denoise(x_prime / at("s_prime"), flat(at("sigma_prime")))
        d_prime = at("cx_prime") * x_prime - at("cd_prime") * d2
        x_heun = x_hat + h * ((1.0 - 1.0 / (2.0 * self.alpha)) * d_cur
                              + d_prime / (2.0 * self.alpha))
        is_last = (i >= self.num_steps - 1).reshape(i.shape + (1,) * (x.ndim - i.ndim))
        return torch.where(is_last, x_eul, x_heun), torch.where(is_last, d1, d2)

    def sample(self, z: torch.Tensor, eps_all: torch.Tensor) -> torch.Tensor:
        """Full trajectory with injected noise eps_all [num_steps, *z.shape];
        returns the final x."""
        x = self.init_latents(z)
        for i in range(self.num_steps):
            x, _ = self.step(x, i, eps_all[i])
        return x


__all__ = ["EDMHeunSampler", "AblationSampler"]
