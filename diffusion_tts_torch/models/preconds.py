"""Preconditioning wrappers: VP, VE, iDDPM, EDM (counterpart of
diffusion_tts_tpu/models/preconds.py).

Each wraps an inner UNet and computes ``D(x; sigma) = c_skip*x +
c_out*F(c_in*x, c_noise)`` with its formulation's scalings (reference
edm/training/networks.py:469-671). The precond math runs in fp32; the inner
net runs in its compute dtype. x is NHWC [B, H, W, C], like the JAX
package; the inner net runs NCHW. sigma is a scalar or [B].
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from diffusion_tts_torch.models.edm_nets import DhariwalUNet, SongUNet
from diffusion_tts_torch.ops.schedules import iddpm_sigma_table

_MODEL_TYPES = {"SongUNet": SongUNet, "DhariwalUNet": DhariwalUNet}


class _Precond(nn.Module):
    """The inner net (``model``, ``out_channels`` channels) and the steps
    every formulation shares: inputs to fp32, labels to [B or 1, label_dim]
    (zeros when none are given), the NHWC <-> NCHW moves around the net."""

    def __init__(self, img_resolution: int, img_channels: int, label_dim: int,
                 model_type: str, model_kwargs: dict | None, dtype: torch.dtype,
                 param_dtype: torch.dtype | None, out_channels: int | None = None):
        super().__init__()
        self.img_channels, self.label_dim = img_channels, label_dim
        self.model = _MODEL_TYPES[model_type](
            img_resolution=img_resolution, in_channels=img_channels,
            out_channels=out_channels or img_channels, label_dim=label_dim, dtype=dtype,
            param_dtype=param_dtype, **(model_kwargs or {}))

    def _prep(self, x: torch.Tensor, sigma, class_labels):
        x = x.float()
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(-1, 1, 1, 1)
        if self.label_dim == 0:
            class_labels = None
        elif class_labels is None:
            class_labels = torch.zeros((1, self.label_dim), device=x.device)
        else:
            class_labels = class_labels.float().reshape(-1, self.label_dim)
        return x, sigma, class_labels

    def _net(self, x_in: torch.Tensor, c_noise: torch.Tensor, class_labels, augment_labels,
             generator) -> torch.Tensor:
        """F(x_in, c_noise) in fp32 NHWC."""
        f = self.model(x_in.permute(0, 3, 1, 2), c_noise.reshape(-1), class_labels,
                       augment_labels, generator)
        return f.permute(0, 2, 3, 1).float()

    def round_sigma(self, sigma):
        return torch.as_tensor(sigma, dtype=torch.float32)


class VPPrecond(_Precond):
    """VP preconditioning (reference networks.py:469-520): c_skip=1,
    c_out=-sigma, c_in=1/sqrt(sigma^2+1), c_noise=(M-1)*sigma_inv(sigma)."""

    def __init__(self, img_resolution: int, img_channels: int, label_dim: int = 0,
                 beta_d: float = 19.9, beta_min: float = 0.1, M: int = 1000,
                 epsilon_t: float = 1e-5, model_type: str = "SongUNet",
                 model_kwargs: dict | None = None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None):
        super().__init__(img_resolution, img_channels, label_dim, model_type, model_kwargs,
                         dtype, param_dtype)
        self.beta_d, self.beta_min, self.M, self.epsilon_t = beta_d, beta_min, M, epsilon_t

    @property
    def sigma_min(self) -> float:
        return float(self.sigma(self.epsilon_t))

    @property
    def sigma_max(self) -> float:
        return float(self.sigma(1.0))

    def sigma(self, t):
        t = torch.as_tensor(t, dtype=torch.float32)
        return torch.sqrt(torch.exp(0.5 * self.beta_d * t**2 + self.beta_min * t) - 1.0)

    def sigma_inv(self, sigma):
        sigma = torch.as_tensor(sigma, dtype=torch.float32)
        return (torch.sqrt(self.beta_min**2 + 2.0 * self.beta_d * torch.log1p(sigma**2))
                - self.beta_min) / self.beta_d

    def forward(self, x: torch.Tensor, sigma, class_labels: torch.Tensor | None = None,
                augment_labels: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x, sigma, class_labels = self._prep(x, sigma, class_labels)
        c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
        c_noise = (self.M - 1) * self.sigma_inv(sigma)
        f = self._net(c_in * x, c_noise, class_labels, augment_labels, generator)
        return x - sigma * f


class VEPrecond(_Precond):
    """VE preconditioning (reference networks.py:528-565): c_skip=1,
    c_out=sigma, c_in=1, c_noise=ln(sigma/2)."""

    def __init__(self, img_resolution: int, img_channels: int, label_dim: int = 0,
                 sigma_min: float = 0.02, sigma_max: float = 100.0,
                 model_type: str = "SongUNet", model_kwargs: dict | None = None,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None):
        super().__init__(img_resolution, img_channels, label_dim, model_type, model_kwargs,
                         dtype, param_dtype)
        self.sigma_min, self.sigma_max = sigma_min, sigma_max

    def forward(self, x: torch.Tensor, sigma, class_labels: torch.Tensor | None = None,
                augment_labels: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x, sigma, class_labels = self._prep(x, sigma, class_labels)
        c_noise = torch.log(0.5 * sigma)
        return x + sigma * self._net(x, c_noise, class_labels, augment_labels, generator)


class iDDPMPrecond(_Precond):
    """iDDPM preconditioning (reference networks.py:572-625). The inner net
    emits twice the image channels (mean and learned variance); only the
    mean half feeds D. c_noise is M-1-j for the u-table entry j nearest to
    sigma. ``u`` (fp32 [M+1], ops/schedules.py::iddpm_sigma_table) is a
    buffer outside the state dict: it follows from M, C_1 and C_2."""

    def __init__(self, img_resolution: int, img_channels: int, label_dim: int = 0,
                 C_1: float = 0.001, C_2: float = 0.008, M: int = 1000,
                 model_type: str = "DhariwalUNet", model_kwargs: dict | None = None,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None):
        super().__init__(img_resolution, img_channels, label_dim, model_type, model_kwargs,
                         dtype, param_dtype, out_channels=2 * img_channels)
        self.M = M
        u = iddpm_sigma_table(M=M, C_1=C_1, C_2=C_2).astype(np.float32)
        self.register_buffer("u", torch.from_numpy(u), persistent=False)

    @property
    def sigma_min(self) -> float:
        return float(self.u[self.M - 1])

    @property
    def sigma_max(self) -> float:
        return float(self.u[0])

    def round_sigma(self, sigma, return_index: bool = False):
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=self.u.device)
        idx = torch.argmin((sigma.reshape(-1, 1) - self.u.reshape(1, -1)).abs(), dim=1)
        result = idx if return_index else self.u[idx]
        return result.reshape(sigma.shape)

    def forward(self, x: torch.Tensor, sigma, class_labels: torch.Tensor | None = None,
                augment_labels: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x, sigma, class_labels = self._prep(x, sigma, class_labels)
        c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
        c_noise = (self.M - 1 - self.round_sigma(sigma, return_index=True)).float()
        f = self._net(c_in * x, c_noise, class_labels, augment_labels, generator)
        return x - sigma * f[..., :self.img_channels]


class EDMPrecond(_Precond):
    """EDM preconditioning (reference networks.py:632-671):
    c_skip=sd^2/(s^2+sd^2), c_out=s*sd/sqrt(s^2+sd^2),
    c_in=1/sqrt(sd^2+s^2), c_noise=ln(s)/4."""

    def __init__(self, img_resolution: int, img_channels: int, label_dim: int = 0,
                 sigma_data: float = 0.5, model_type: str = "DhariwalUNet",
                 model_kwargs: dict | None = None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None):
        super().__init__(img_resolution, img_channels, label_dim, model_type, model_kwargs,
                         dtype, param_dtype)
        self.sigma_data = sigma_data

    def forward(self, x: torch.Tensor, sigma, class_labels: torch.Tensor | None = None,
                augment_labels: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x, sigma, class_labels = self._prep(x, sigma, class_labels)
        sd = self.sigma_data
        c_skip = sd**2 / (sigma**2 + sd**2)
        c_out = sigma * sd / torch.sqrt(sigma**2 + sd**2)
        c_in = 1.0 / torch.sqrt(sd**2 + sigma**2)
        c_noise = torch.log(sigma) / 4.0
        f = self._net(c_in * x, c_noise, class_labels, augment_labels, generator)
        return c_skip * x + c_out * f


__all__ = ["VPPrecond", "VEPrecond", "iDDPMPrecond", "EDMPrecond"]
