"""Noise schedules of the EDM and SD samplers (counterpart of
diffusion_tts_tpu/ops/schedules.py).

Host numpy in float64, as the JAX package computes them:

  * the Karras rho schedule of the EDM sampler and the VP, VE and iDDPM
    discretizations of the ablation sampler (reference edm/main.py:78-80,
    edm/generate.py:85-115), each returned as a numpy array in ``dtype``,
    float32 by default, as the JAX functions return jnp.float32 by default;
  * SD's DDIM tables: the scaled-linear betas, the alpha-bar table and the
    'leading'-spaced timestep subsequence (reference sd/diffusers/.../
    schedulers/scheduling_ddim.py:180-240, 305-341);
  * the iDDPM u-table that iDDPMPrecond rounds sigma to.

The float32 default is part of the result, not a convenience:
``samplers/edm.py::AblationSampler`` takes each discretization through it
and only then goes back to float64 for its table math, as the JAX
package's sampler does with x64 off (its VP branch included), so that the
port's tables equal the JAX package's rather than merely coming close.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def _finish(sigmas: np.ndarray, dtype, append_zero: bool) -> np.ndarray:
    if append_zero:
        sigmas = np.concatenate([sigmas, [0.0]])
    return np.asarray(sigmas, dtype=dtype)


def karras_sigmas(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                  rho: float = 7.0, *, dtype=np.float32, append_zero: bool = True) -> np.ndarray:
    """Karras rho-spaced sigmas, optionally with a terminal 0:
    sigma_i = (smax^(1/rho) + i/(N-1) (smin^(1/rho) - smax^(1/rho)))^rho
    (reference edm/main.py:78-80)."""
    steps = np.arange(num_steps, dtype=np.float64)
    inv_rho = 1.0 / rho
    sigmas = (sigma_max ** inv_rho + steps / max(num_steps - 1, 1)
              * (sigma_min ** inv_rho - sigma_max ** inv_rho)) ** rho
    return _finish(sigmas, dtype, append_zero)


def vp_sigmas(num_steps: int, beta_d: float = 19.9, beta_min: float = 0.1,
              epsilon_s: float = 1e-3, *, dtype=np.float32,
              append_zero: bool = True) -> np.ndarray:
    """VP discretization (reference edm/generate.py:97-101):
    sigma(t) = sqrt(exp(beta_d/2 t^2 + beta_min t) - 1), t linear from 1 to
    epsilon_s."""
    steps = np.arange(num_steps, dtype=np.float64)
    t = 1.0 + steps / max(num_steps - 1, 1) * (epsilon_s - 1.0)
    sigmas = np.sqrt(np.exp(beta_d / 2.0 * t ** 2 + beta_min * t) - 1.0)
    return _finish(sigmas, dtype, append_zero)


def vp_betas_for_range(sigma_min: float, sigma_max: float,
                       epsilon_s: float = 1e-3) -> tuple[float, float]:
    """(beta_d, beta_min) whose VP sigma(t) is sigma_min at t = epsilon_s and
    sigma_max at t = 1 (reference edm/generate.py:100-102)."""
    beta_d = (2.0 * (math.log(sigma_min ** 2 + 1.0) / epsilon_s - math.log(sigma_max ** 2 + 1.0))
              / (epsilon_s - 1.0))
    beta_min = math.log(sigma_max ** 2 + 1.0) - 0.5 * beta_d
    return beta_d, beta_min


def vp_ablation_sigmas(num_steps: int, sigma_min: float | None = None,
                       sigma_max: float | None = None, epsilon_s: float = 1e-3, *,
                       dtype=np.float32, append_zero: bool = True) -> np.ndarray:
    """VP discretization as the ablation sampler builds it: the default
    range from the canonical beta_d = 19.9, beta_min = 0.1 schedule, the
    betas solved again for the range (reference edm/generate.py:88-104)."""
    canon = lambda t: math.sqrt(math.exp(0.5 * 19.9 * t ** 2 + 0.1 * t) - 1.0)
    sigma_min = canon(epsilon_s) if sigma_min is None else sigma_min
    sigma_max = canon(1.0) if sigma_max is None else sigma_max
    beta_d, beta_min = vp_betas_for_range(sigma_min, sigma_max, epsilon_s)
    return vp_sigmas(num_steps, beta_d=beta_d, beta_min=beta_min, epsilon_s=epsilon_s,
                     dtype=dtype, append_zero=append_zero)


def ve_sigmas(num_steps: int, sigma_min: float = 0.02, sigma_max: float = 100.0, *,
              dtype=np.float32, append_zero: bool = True) -> np.ndarray:
    """VE geometric sigmas (reference edm/generate.py:102-104)."""
    steps = np.arange(num_steps, dtype=np.float64)
    sigmas = np.sqrt(sigma_max ** 2 * (sigma_min ** 2 / sigma_max ** 2)
                     ** (steps / max(num_steps - 1, 1)))
    return _finish(sigmas, dtype, append_zero)


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """SD-1.5's scheduler configuration: 1000 training steps, scaled_linear
    betas in [0.00085, 0.012], leading spacing, steps_offset 1,
    set_alpha_to_one False."""

    alphas_cumprod: np.ndarray  # [num_train_timesteps] float64
    timesteps: np.ndarray  # [num_inference_steps] descending int64
    final_alpha_cumprod: float
    num_train_timesteps: int
    num_inference_steps: int


def ddim_schedule(num_inference_steps: int, num_train_timesteps: int = 1000,
                  beta_start: float = 0.00085, beta_end: float = 0.012,
                  beta_schedule: str = "scaled_linear", set_alpha_to_one: bool = False,
                  steps_offset: int = 1) -> DDIMSchedule:
    """The alpha-bar table and the leading timestep subsequence."""
    if beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
    else:
        raise ValueError(f"unsupported beta_schedule: {beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(num_inference_steps) * step_ratio).round()[::-1] + steps_offset
    return DDIMSchedule(alphas_cumprod=alphas_cumprod, timesteps=timesteps.astype(np.int64),
                        final_alpha_cumprod=final, num_train_timesteps=num_train_timesteps,
                        num_inference_steps=num_inference_steps)


def iddpm_sigma_table(M: int = 1000, C_1: float = 0.001, C_2: float = 0.008) -> np.ndarray:
    """The iDDPM u-table (reference edm/generate.py:106-112 and
    training/networks.py:584-590): u[M] = 0, then u[j-1] from u[j] by the
    reverse recursion. float64, length M + 1.

    The reference evaluates alpha_bar in float32 (torch promotes
    python_scalar * int64_tensor to the default dtype), so the sin() chain
    runs in fp32 before the fp64 recursion; so does this copy, bit for bit.
    """
    u = np.zeros(M + 1, dtype=np.float64)

    def alpha_bar(j: int) -> np.float32:
        t = np.float32(np.float32(np.float32(np.float32(0.5 * math.pi) * j) / M) / (C_2 + 1))
        s = np.float32(np.sin(t))
        return np.float32(s * s)  # x*x, not x**2: numpy's pow rounds differently

    for j in range(M, 0, -1):  # M, M-1, ..., 1
        ratio = np.float64(max(np.float32(alpha_bar(j - 1) / alpha_bar(j)), np.float32(C_1)))
        u[j - 1] = math.sqrt((u[j] ** 2 + 1.0) / ratio - 1.0)
    return u


def iddpm_sigmas(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 81.0,
                 M: int = 1000, C_1: float = 0.001, C_2: float = 0.008, *,
                 dtype=np.float32, append_zero: bool = True) -> np.ndarray:
    """iDDPM discretization: evenly strided entries of the u-table within
    [sigma_min, sigma_max] (reference edm/generate.py:106-112). The table
    descends with its index, so the strided entries do too."""
    u = iddpm_sigma_table(M=M, C_1=C_1, C_2=C_2)
    u_filtered = u[np.logical_and(u >= sigma_min, u <= sigma_max)]
    idx = (np.arange(num_steps, dtype=np.float64) * (len(u_filtered) - 1)
           / max(num_steps - 1, 1)).round().astype(np.int64)
    return _finish(u_filtered[idx], dtype, append_zero)


__all__ = ["karras_sigmas", "vp_sigmas", "vp_ablation_sigmas", "vp_betas_for_range",
           "ve_sigmas", "iddpm_sigmas", "iddpm_sigma_table", "DDIMSchedule", "ddim_schedule"]
