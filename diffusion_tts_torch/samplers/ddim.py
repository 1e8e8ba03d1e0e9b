"""Stochastic DDIM sampler, the SD backend's scheduler (counterpart of
diffusion_tts_tpu/samplers/ddim.py::StochasticDDIMSampler).

The fork's DDIMScheduler.step with eta = 1.0 (reference
sd/diffusers/.../scheduling_ddim.py:342-487), so the per-step variance
noise is the searched degree of freedom. The alpha-bar gathers and
variance coefficients are tabulated per inference step on the host in
float64 and kept as fp32 tables; ``step_math`` is split from the model call
so the search reuses one UNet forward across many candidate noises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from diffusion_tts_torch.ops.schedules import ddim_schedule

# eps_model(x, t [B] int timesteps) -> predicted noise (already CFG-combined)
EpsModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StochasticDDIMSampler:
    """DDIM with eta-scaled stochastic variance injection.

    Per-step tables (host fp64 -> fp32): sqrt_a_t, sqrt_1m_a_t, sqrt_a_prev,
    dir_coef = sqrt(1 - a_prev - std^2), std = eta * sqrt((1 - a_prev) /
    (1 - a_t) * (1 - a_t / a_prev)); timesteps in int64.
    """

    eps_model: EpsModelFn
    num_steps: int = 50
    eta: float = 1.0
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    init_noise_sigma: float = 1.0

    def __post_init__(self):
        sched = ddim_schedule(self.num_steps, num_train_timesteps=self.num_train_timesteps,
                              beta_start=self.beta_start, beta_end=self.beta_end,
                              beta_schedule=self.beta_schedule,
                              set_alpha_to_one=self.set_alpha_to_one,
                              steps_offset=self.steps_offset)
        acp = sched.alphas_cumprod
        ts = sched.timesteps
        prev_ts = ts - self.num_train_timesteps // self.num_steps
        a_t = acp[ts]
        a_prev = np.where(prev_ts >= 0, acp[np.maximum(prev_ts, 0)], sched.final_alpha_cumprod)
        std = self.eta * np.sqrt((1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev))
        tables = {"timesteps": torch.from_numpy(ts)}
        for name, v in (("sqrt_a_t", np.sqrt(a_t)), ("sqrt_1m_a_t", np.sqrt(1.0 - a_t)),
                        ("sqrt_a_prev", np.sqrt(a_prev)),
                        ("dir_coef", np.sqrt(np.maximum(1.0 - a_prev - std ** 2, 0.0))),
                        ("std", std)):
            tables[name] = torch.from_numpy(v.astype(np.float32))
        object.__setattr__(self, "_tables", {torch.device("cpu"): tables})

    def tables(self, device: torch.device) -> dict[str, torch.Tensor]:
        """The tables on ``device`` (copied there once)."""
        cache = self._tables
        if device not in cache:
            cache[device] = {k: v.to(device) for k, v in cache[torch.device("cpu")].items()}
        return cache[device]

    @property
    def timesteps(self) -> torch.Tensor:
        return self._tables[torch.device("cpu")]["timesteps"]

    def timestep(self, i, n: int, device: torch.device) -> torch.Tensor:
        """The model timestep of step ``i`` (an int or a per-sample [n]
        index), broadcast to [n]."""
        i = torch.as_tensor(i, dtype=torch.long, device=device)
        return self.tables(device)["timesteps"][i].expand(n)

    def init_latents(self, z: torch.Tensor) -> torch.Tensor:
        return z.float() * self.init_noise_sigma

    def step_math(self, x: torch.Tensor, i, model_output: torch.Tensor,
                  eps: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
        """Scheduler step given the model output (reference
        scheduling_ddim.py:398-463, epsilon prediction, no clipping).
        ``eps`` is the injected variance noise; None means deterministic.
        Returns (x_prev, pred_x0) in fp32."""
        tab = self.tables(x.device)
        i = torch.as_tensor(i, dtype=torch.long, device=x.device)
        bc = lambda v: v.reshape(v.shape + (1,) * (x.ndim - v.ndim))
        mo, xf = model_output.float(), x.float()
        pred_x0 = (xf - bc(tab["sqrt_1m_a_t"][i]) * mo) / bc(tab["sqrt_a_t"][i])
        prev = bc(tab["sqrt_a_prev"][i]) * pred_x0 + bc(tab["dir_coef"][i]) * mo
        if eps is not None:
            prev = prev + bc(tab["std"][i]) * eps.float()
        return prev, pred_x0

    def step(self, x: torch.Tensor, i, eps: torch.Tensor | None):
        """Model forward + scheduler math: (x_next, pred_x0)."""
        return self.step_math(x, i, self.eps_model(x, self.timestep(i, x.shape[0], x.device)),
                              eps)

    def sample(self, z: torch.Tensor, eps_all: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Naive trajectory with injected noise eps_all [num_steps, *z.shape];
        returns (x_final, pred_x0 of the last step)."""
        x = self.init_latents(z)
        pred_x0 = None
        for i in range(self.num_steps):
            x, pred_x0 = self.step(x, i, eps_all[i])
        return x, pred_x0


__all__ = ["StochasticDDIMSampler"]
