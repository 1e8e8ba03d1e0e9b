"""DDIM tables of Stable Diffusion's scheduler (counterpart of
diffusion_tts_tpu/ops/schedules.py::ddim_schedule and DDIMSchedule).

Host numpy in float64, as the JAX package computes them: the scaled-linear
beta schedule, the alpha-bar table and the 'leading'-spaced timestep
subsequence (reference sd/diffusers/.../schedulers/scheduling_ddim.py:
180-240, 305-341), and the iDDPM u-table that iDDPMPrecond rounds sigma to.
The Karras, VP, VE and iDDPM step schedules of the EDM samplers come with a
later slice of the port.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


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


__all__ = ["DDIMSchedule", "ddim_schedule", "iddpm_sigma_table"]
