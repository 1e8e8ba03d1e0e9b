"""Matmul and conv FLOPs of one forward (and of one training step's
forward and backward), counted from the op shapes
(counterpart of the FLOP half of diffusion_tts_tpu/utils/roofline.py:
``canonical_formulation``, ``analyze_fn``, ``sd_unet_flops``,
``sd_vae_decode_flops``; the port adds ``sd_vae_encode_flops`` and the
training step's count, ``analyze_train_fn`` / ``train_step_flops``).

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
    prologue and the fused up-conv), the phased up-conv replaced by
    ``nearest_upsample2x_conv3x3`` and the attention wrappers by their
    plain twins, so that a backward is autograd's (four products per
    attention; the flash backward's wrapper recomputes the scores, a fifth).
    The GroupNorm and GEGLU wrappers need no switch: on CPU tensors, fake
    ones included, they run their plain twins."""
    from diffusion_tts_torch.models import layers, sd_layers
    from diffusion_tts_torch.ops.kernels import conv3x3, qkv_attention

    saved = (conv3x3._NO_CONV_KERNELS, layers.nn_upsample2x_conv3x3,
             sd_layers.nn_upsample2x_conv3x3, qkv_attention.qkv_self_attention,
             qkv_attention.attention)
    conv3x3._NO_CONV_KERNELS = True
    layers.nn_upsample2x_conv3x3 = sd_layers.nn_upsample2x_conv3x3 = nearest_upsample2x_conv3x3
    qkv_attention.qkv_self_attention = qkv_attention.qkv_self_attention_plain
    qkv_attention.attention = qkv_attention.attention_plain
    try:
        yield
    finally:
        (conv3x3._NO_CONV_KERNELS, layers.nn_upsample2x_conv3x3,
         sd_layers.nn_upsample2x_conv3x3, qkv_attention.qkv_self_attention,
         qkv_attention.attention) = saved


class _FlopCounter(TorchDispatchMode):
    """Adds up the FLOPs of every product and convolution that reaches
    dispatch, by op key (the JAX walker's keys), and by ``phase`` (the
    caller sets it: "forward" or "backward")."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.phases = collections.Counter()
        self.phase = "forward"

    def _add(self, key, flops: int) -> None:
        self.ops[key] += flops
        self.phases[self.phase] += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = func._overloadpacket
        if op in (_aten.mm, _aten.addmm):
            a, b = args[-2:]
            (m, k), n = a.shape, b.shape[1]
            self._add(("dot", m, k, n, 1), 2 * m * k * n)
        elif op in (_aten.bmm, _aten.baddbmm):
            a, b = args[-2:]
            (batch, m, k), n = a.shape, b.shape[2]
            self._add(("dot", m, k, n, batch), 2 * batch * m * k * n)
        elif op is _aten.convolution:
            w, transposed, groups = args[1], args[6], args[8]
            if groups == 1:
                if transposed:
                    raise NotImplementedError("no formulation counts an ungrouped "
                                              "transposed convolution")
                b, cout, *spatial = out.shape
                ksp = tuple(w.shape[2:])
                taps = w.shape[1] * int(torch.Size(ksp).numel())
                self._add(("conv", ksp, w.shape[1], cout, tuple(spatial), b),
                          2 * b * int(torch.Size(spatial).numel()) * taps * cout)
        elif op is _aten.convolution_backward:
            # (grad_output, input, weight, bias_sizes, stride, padding,
            # dilation, transposed, output_padding, groups, output_mask): the
            # input's and the weight's gradients each cost the forward's
            # products; the bias's is a sum
            grad_out, w, transposed, groups, mask = args[0], args[2], args[7], args[9], args[10]
            if groups == 1:
                if transposed:
                    raise NotImplementedError("no formulation counts an ungrouped "
                                              "transposed convolution")
                b, cout, *spatial = grad_out.shape
                ksp = tuple(w.shape[2:])
                flops = (2 * b * int(torch.Size(spatial).numel()) * w.shape[1]
                         * int(torch.Size(ksp).numel()) * cout)
                for wrt, wanted in zip(("input", "weight"), mask[:2]):
                    if wanted:
                        self._add(("conv_grad_" + wrt, ksp, w.shape[1], cout, tuple(spatial), b),
                                  flops)
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


def analyze_train_fn(fn, *args) -> dict:
    """Run ``loss = fn(*args)`` and ``loss.backward()`` as ``analyze_fn``
    runs its function (fake CPU tensors, ``canonical_formulation()``, one
    counting mode), with gradients on: ``{"total_flops", "forward_flops",
    "backward_flops", "ops"}``. The backward's products are the autograd
    formulas' (``mm`` for each linear's input and weight gradients,
    ``convolution_backward`` counted by the gradients it computes), so a
    product whose input needs no gradient (the first conv's, the
    embedding's) adds one product to the backward, not two."""
    counter = _FlopCounter()
    with FakeTensorMode(allow_non_fake_inputs=True), canonical_formulation(), \
            torch.enable_grad(), counter:
        loss = fn(*args)
        counter.phase = "backward"
        loss.backward()
    ops = sorted(counter.ops.items(), key=lambda kv: -kv[1])
    return {"total_flops": sum(counter.ops.values()),
            "forward_flops": counter.phases["forward"],
            "backward_flops": counter.phases["backward"], "ops": ops}


def train_step_flops(cfg: dict, micro: int, rounds: int = 1) -> dict:
    """The products of one training step of the EDM-family net ``cfg``
    (``backends/edm_entry.py``) under EDMPrecond and EDMLoss, as the train
    bench runs it: ``rounds`` forwards and backwards of the loss at
    ``micro`` images, in train mode (the optimizer and the EMA are
    elementwise and not counted)."""
    from diffusion_tts_torch.models.preconds import EDMPrecond
    from diffusion_tts_torch.training.loss import EDMLoss

    loss_fn = EDMLoss()

    def loss():
        net = EDMPrecond(**cfg).train()
        res, ch, label_dim = cfg["img_resolution"], cfg["img_channels"], cfg["label_dim"]
        labels = torch.zeros((micro, label_dim)) if label_dim else None
        return loss_fn(lambda x, s, lab, al: net(x, s, lab, al),
                       torch.zeros((micro, res, res, ch)), labels).mean()

    one = analyze_train_fn(loss)
    return {k: v * rounds if k != "ops" else v for k, v in one.items()}


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


def sd_vae_encode_flops(config: dict, batch: int, res: int = 512) -> dict:
    """One VAE encode of ``config`` (SD15_VAE) at ``batch`` images of res x
    res, quant_conv included."""
    from diffusion_tts_torch.models.sd_vae import AutoencoderKL

    def forward():
        vae = AutoencoderKL(**config).eval()
        vae.encode(torch.zeros((batch, 3, res, res)))

    return analyze_fn(forward)


__all__ = ["DENSE_BF16_PEAK", "CPU_NOMINAL_PEAK", "peak_flops", "canonical_formulation",
           "analyze_fn", "analyze_train_fn", "train_step_flops", "denoiser_flops",
           "sd_vae_encode_flops", "sd_unet_flops", "sd_vae_decode_flops",
           "nearest_upsample2x_conv3x3"]
