"""Matmul and conv FLOPs of one forward, counted from the op shapes
(counterpart of the FLOP half of diffusion_tts_tpu/utils/roofline.py:
``canonical_formulation``, ``analyze_fn``, ``sd_unet_flops``,
``sd_vae_decode_flops``).

The count is the numerator of the benches' speed-of-light fraction: the
useful matmul FLOPs of the reference formulation of a forward, a property
of the architecture and not of the kernels that run it. So the forward runs
under ``canonical_formulation()``, as the JAX package traces it: no kernel
route (every wrapper takes its plain twin), no 2x2-phase up-conv (nearest
2x, then the 3x3 conv at the upsampled size) and no GroupNorm folded into a
conv. It runs on fake CPU tensors (torch's FakeTensorMode): shapes only,
nothing allocated, so the full-width nets are counted in seconds on the
host. Each matrix product counts 2*M*K*N and each convolution
2*B*H_out*W_out*(C_in*kh*kw)*C_out; grouped convolutions (the SongUNet's
depthwise resampling filters) are skipped, as the JAX walker skips
``feature_group_count > 1``. Not ported: the JAX module's TPU tiling model
and the envelopes measured on a TPU (``MXU``, ``tile_eff``, ``practical_*``,
``roofline_seconds``).
"""
from __future__ import annotations

import collections
import contextlib

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten

# Dense bf16 peaks by card name (NVIDIA's data sheet, SXM part, no sparsity,
# at the full power limit). A card not listed raises: no default peak.
DENSE_BF16_PEAK = {"H100": 989e12}
# The CPU smoke runs' nominal peak (the JAX benches' "cpu" entry): it names
# no device, and a CPU run's fraction of it is no device metric.
CPU_NOMINAL_PEAK = 1e12


def peak_flops(device: torch.device | str) -> float:
    """The dense bf16 peak of ``device``'s card, or the CPU's nominal one."""
    device = torch.device(device)
    if device.type == "cpu":
        return CPU_NOMINAL_PEAK
    name = torch.cuda.get_device_name(device)
    for key, peak in DENSE_BF16_PEAK.items():
        if key in name:
            return peak
    raise ValueError(f"no dense bf16 peak is known for {name!r}; add it to DENSE_BF16_PEAK")


def nearest_upsample2x_conv3x3(x: torch.Tensor, w: torch.Tensor,
                               bias: torch.Tensor | None = None) -> torch.Tensor:
    """The reference formulation of ops/resample.py::nn_upsample2x_conv3x3:
    nearest 2x duplication, then a 3x3 conv with padding 1."""
    x = torch.repeat_interleave(torch.repeat_interleave(x, 2, dim=2), 2, dim=3)
    return F.conv2d(x, w, bias, padding=1)


@contextlib.contextmanager
def canonical_formulation():
    """The forward as the reference formulates it, for counting: the conv
    kernels' routes off (with them the GroupNorm fold into the conv
    prologue and the fused up-conv) and the phased up-conv replaced by
    ``nearest_upsample2x_conv3x3``. The attention, GroupNorm and GEGLU
    wrappers need no switch: on CPU tensors, fake ones included, they run
    their plain twins."""
    from diffusion_tts_torch.models import layers, sd_layers
    from diffusion_tts_torch.ops.kernels import conv3x3

    saved = (conv3x3._NO_CONV_KERNELS, layers.nn_upsample2x_conv3x3,
             sd_layers.nn_upsample2x_conv3x3)
    conv3x3._NO_CONV_KERNELS = True
    layers.nn_upsample2x_conv3x3 = sd_layers.nn_upsample2x_conv3x3 = nearest_upsample2x_conv3x3
    try:
        yield
    finally:
        (conv3x3._NO_CONV_KERNELS, layers.nn_upsample2x_conv3x3,
         sd_layers.nn_upsample2x_conv3x3) = saved


class _FlopCounter(TorchDispatchMode):
    """Adds up the FLOPs of every product and convolution that reaches
    dispatch, by op key (the JAX walker's keys)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = func._overloadpacket
        if op in (_aten.mm, _aten.addmm):
            a, b = args[-2:]
            (m, k), n = a.shape, b.shape[1]
            self.ops[("dot", m, k, n, 1)] += 2 * m * k * n
        elif op in (_aten.bmm, _aten.baddbmm):
            a, b = args[-2:]
            (batch, m, k), n = a.shape, b.shape[2]
            self.ops[("dot", m, k, n, batch)] += 2 * batch * m * k * n
        elif op is _aten.convolution:
            w, transposed, groups = args[1], args[6], args[8]
            if groups == 1:
                if transposed:
                    raise NotImplementedError("no formulation counts an ungrouped "
                                              "transposed convolution")
                b, cout, *spatial = out.shape
                ksp = tuple(w.shape[2:])
                taps = w.shape[1] * int(torch.Size(ksp).numel())
                self.ops[("conv", ksp, w.shape[1], cout, tuple(spatial), b)] += (
                    2 * b * int(torch.Size(spatial).numel()) * taps * cout)
        elif op in (_aten._scaled_dot_product_flash_attention,
                    _aten._scaled_dot_product_efficient_attention,
                    _aten._scaled_dot_product_cudnn_attention):
            raise NotImplementedError(f"{op} is not counted: the count follows the plain "
                                      "twins' products")
        return out


def analyze_fn(fn, *args) -> dict:
    """Run ``fn(*args)`` under ``canonical_formulation()`` on fake CPU
    tensors and count its products: ``{"total_flops": int, "ops": [(key,
    flops), ...]}``, largest first. Every tensor and module made inside
    ``fn`` is fake (no storage); real tensors among ``args`` and in modules
    built outside are read for their shapes only."""
    counter = _FlopCounter()
    with FakeTensorMode(allow_non_fake_inputs=True), canonical_formulation(), \
            torch.no_grad(), counter:
        fn(*args)
    ops = sorted(counter.ops.items(), key=lambda kv: -kv[1])
    return {"total_flops": sum(counter.ops.values()), "ops": ops}


def denoiser_flops(cfg: dict, batch: int = 1, precond: str = "edm") -> dict:
    """One forward of the EDM-family net ``cfg`` (a ``backends/edm_entry.py``
    config) under ``precond`` (a key of ``edm_entry.PRECONDS``) at
    ``batch`` images."""
    from diffusion_tts_torch.backends.edm_entry import PRECONDS

    def forward():
        net = PRECONDS[precond](**cfg).eval()
        res, ch, label_dim = cfg["img_resolution"], cfg["img_channels"], cfg["label_dim"]
        labels = torch.zeros((batch, label_dim)) if label_dim else None
        net(torch.zeros((batch, res, res, ch)), torch.ones((batch,)), labels)

    return analyze_fn(forward)


def sd_unet_flops(config: dict, batch: int, ctx_len: int = 77) -> dict:
    """One SD UNet forward of ``config`` (``pipelines/sd_pipeline.py``'s
    SD15_UNET) at ``batch`` images: a CFG forward for one sample is batch 2."""
    from diffusion_tts_torch.models.sd_unet import UNet2DConditionModel

    def forward():
        unet = UNet2DConditionModel(**config).eval()
        res = unet.sample_size
        unet(torch.zeros((batch, unet.in_channels, res, res)), torch.zeros((batch,)),
             torch.zeros((batch, ctx_len, unet.cross_attention_dim)))

    return analyze_fn(forward)


def sd_vae_decode_flops(config: dict, batch: int, latent_res: int = 64) -> dict:
    """One VAE decode of ``config`` (SD15_VAE) at ``batch`` latents of
    latent_res x latent_res."""
    from diffusion_tts_torch.models.sd_vae import AutoencoderKL

    def forward():
        vae = AutoencoderKL(**config).eval()
        vae.decode(torch.zeros((batch, config.get("latent_channels", 4), latent_res,
                                latent_res)))

    return analyze_fn(forward)


__all__ = ["DENSE_BF16_PEAK", "CPU_NOMINAL_PEAK", "peak_flops", "canonical_formulation",
           "analyze_fn", "denoiser_flops", "sd_unet_flops", "sd_vae_decode_flops",
           "nearest_upsample2x_conv3x3"]
