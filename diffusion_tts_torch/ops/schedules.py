"""DDIM tables of Stable Diffusion's scheduler (counterpart of
diffusion_tts_tpu/ops/schedules.py::ddim_schedule and DDIMSchedule).

Host numpy in float64, as the JAX package computes them: the scaled-linear
beta schedule, the alpha-bar table and the 'leading'-spaced timestep
subsequence (reference sd/diffusers/.../schedulers/scheduling_ddim.py:
180-240, 305-341). The Karras, VP, VE and iDDPM tables of the EDM samplers
come with a later slice of the port.
"""
from __future__ import annotations

import dataclasses

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


__all__ = ["DDIMSchedule", "ddim_schedule"]
