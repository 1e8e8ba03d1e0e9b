"""EDM preconditioning (counterpart of
diffusion_tts_tpu/models/preconds.py::EDMPrecond).

``D(x; sigma) = c_skip*x + c_out*F(c_in*x, c_noise)`` (reference
edm/training/networks.py:632-671). The precond math runs in fp32; the inner
net runs in its compute dtype. x is NHWC [B, H, W, C], like the JAX
package; the inner net runs NCHW. The VP, VE and iDDPM preconds come with
the second slice of the port.
"""
from __future__ import annotations

import torch
from torch import nn

from diffusion_tts_torch.models.edm_nets import DhariwalUNet

_MODEL_TYPES = {"DhariwalUNet": DhariwalUNet}


class EDMPrecond(nn.Module):
    """c_skip=sd^2/(s^2+sd^2), c_out=s*sd/sqrt(s^2+sd^2),
    c_in=1/sqrt(sd^2+s^2), c_noise=ln(s)/4."""

    def __init__(self, img_resolution: int, img_channels: int, label_dim: int = 0,
                 sigma_data: float = 0.5, model_type: str = "DhariwalUNet",
                 model_kwargs: dict | None = None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.label_dim, self.sigma_data = label_dim, sigma_data
        self.model = _MODEL_TYPES[model_type](
            img_resolution=img_resolution, in_channels=img_channels,
            out_channels=img_channels, label_dim=label_dim, dtype=dtype,
            param_dtype=param_dtype, **(model_kwargs or {}))

    def forward(self, x: torch.Tensor, sigma, class_labels: torch.Tensor | None = None,
                augment_labels: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.float()
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(-1, 1, 1, 1)
        if self.label_dim == 0:
            class_labels = None
        elif class_labels is None:
            class_labels = torch.zeros((1, self.label_dim), device=x.device)
        else:
            class_labels = class_labels.float().reshape(-1, self.label_dim)
        sd = self.sigma_data
        c_skip = sd**2 / (sigma**2 + sd**2)
        c_out = sigma * sd / torch.sqrt(sigma**2 + sd**2)
        c_in = 1.0 / torch.sqrt(sd**2 + sigma**2)
        c_noise = torch.log(sigma) / 4.0
        f = self.model((c_in * x).permute(0, 3, 1, 2), c_noise.reshape(-1), class_labels,
                       augment_labels, generator)
        return c_skip * x + c_out * f.permute(0, 2, 3, 1).float()


__all__ = ["EDMPrecond"]
