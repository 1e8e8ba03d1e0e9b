"""Stable Diffusion text-to-image pipeline with noise-trajectory search
(counterpart of diffusion_tts_tpu/pipelines/sd_pipeline.py).

The modified diffusers pipeline (reference pipeline_stable_diffusion.py
__call__, :812-814 with score_function/method/params; :1484 returns
(output, max_score)) rebuilt around the search engine: the pipeline owns
the UNet and the VAE, builds an SDSearchBackend bound to the prompt
embeddings, and runs ``search.api.run_search``. Reference defaults: 100
inference steps, eta = 1.0 stochastic DDIM, guidance 7.5 with the
unconditional half first, method 'eps_greedy'.

The models are NCHW; the search works on NHWC latents [B, h, w, 4] and
NHWC images [B, H, W, 3], the JAX package's layout, so both packages
search over the same arrays. Everything runs on the models' device. Text
encoding (CLIP) is not ported yet: prompts come in as ``prompt_embeds``.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

import torch

from diffusion_tts_torch.models.sd_import import load_diffusers, load_safetensors
from diffusion_tts_torch.models.sd_unet import UNet2DConditionModel
from diffusion_tts_torch.models.sd_vae import AutoencoderKL
from diffusion_tts_torch.models.torch_import import load_into, random_state_dict
from diffusion_tts_torch.samplers.ddim import StochasticDDIMSampler
from diffusion_tts_torch.search.api import run_search
from diffusion_tts_torch.search.sd_backend import SDSearchBackend
from diffusion_tts_torch.utils import rng
from diffusion_tts_torch.utils.config import SearchParams
from diffusion_tts_torch.utils.device import resolve_device

# SD-1.5 (runwayml/stable-diffusion-v1-5 unet/ and vae/ config.json)
SD15_UNET = dict(sample_size=64, in_channels=4, out_channels=4,
                 block_out_channels=(320, 640, 1280, 1280), layers_per_block=2,
                 attention_head_dim=8, cross_attention_dim=768)
SD15_VAE = dict(block_out_channels=(128, 256, 512, 512), layers_per_block=2,
                latent_channels=4)
# The JAX package's tiny_random geometry (the vendored suite's fast-test scale)
TINY_UNET = dict(sample_size=16, in_channels=4, out_channels=4,
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                 block_out_channels=(32, 64), layers_per_block=1, attention_head_dim=4,
                 cross_attention_dim=32)
TINY_VAE = dict(block_out_channels=(32, 64), layers_per_block=1)

_UNET_KEYS = ("sample_size", "in_channels", "out_channels", "down_block_types",
              "up_block_types", "block_out_channels", "layers_per_block",
              "attention_head_dim", "cross_attention_dim")
_VAE_KEYS = ("block_out_channels", "layers_per_block", "latent_channels", "scaling_factor")
# Salt of the initial latents' draw (the JAX package's fold_in constant)
SALT_LATENTS = 0xD1F


def _zero_scorer(images01, cond=None, timesteps=None):
    return torch.zeros(images01.shape[0], device=images01.device)


def _config(path: str, keys: tuple[str, ...]) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in keys}


def _find_weights(subdir: str) -> str:
    hits = sorted(glob.glob(os.path.join(subdir, "*.safetensors")))
    if not hits:
        raise FileNotFoundError(f"no safetensors weights under {subdir}")
    return hits[0]


@dataclasses.dataclass(eq=False)
class StableDiffusionSearchPipeline:
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    guidance_scale: float = 7.5

    @property
    def vae_scale_factor(self) -> int:
        return 2 ** (len(self.vae.block_out_channels) - 1)

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    # ------------------------------------------------------------------ load
    @classmethod
    def from_pretrained(cls, path: str, *, dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cuda",
                        **kwargs) -> "StableDiffusionSearchPipeline":
        """A local diffusers-layout SD checkpoint: ``unet/`` and ``vae/``,
        each a config.json and a .safetensors file."""
        dev = resolve_device(device)
        unet = UNet2DConditionModel(**_config(os.path.join(path, "unet"), _UNET_KEYS),
                                    dtype=dtype)
        load_diffusers(unet, load_safetensors(_find_weights(os.path.join(path, "unet"))))
        vae = AutoencoderKL(**_config(os.path.join(path, "vae"), _VAE_KEYS), dtype=dtype)
        load_diffusers(vae, load_safetensors(_find_weights(os.path.join(path, "vae"))))
        return cls(unet=unet.to(dev).eval(), vae=vae.to(dev).eval(), **kwargs)

    @classmethod
    def random(cls, unet_config: dict, vae_config: dict, *, seed: int = 0,
               dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda",
               **kwargs) -> "StableDiffusionSearchPipeline":
        """Random weights from a numpy seed (``random_state_dict``): the
        full SD-1.5 geometry (``SD15_UNET``, ``SD15_VAE``) where no
        checkpoint is at hand, or the tiny one for tests."""
        dev = resolve_device(device)
        unet = UNet2DConditionModel(**unet_config, dtype=dtype)
        load_into(unet, random_state_dict(unet, seed))
        vae = AutoencoderKL(**vae_config, dtype=dtype)
        load_into(vae, random_state_dict(vae, seed + 1))
        return cls(unet=unet.to(dev).eval(), vae=vae.to(dev).eval(), **kwargs)

    @classmethod
    def tiny_random(cls, seed: int = 0, *, dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda") -> "StableDiffusionSearchPipeline":
        return cls.random(TINY_UNET, TINY_VAE, seed=seed, dtype=dtype, device=device)

    # ------------------------------------------------------------- components
    def encode_prompt(self, prompt, negative_prompt=None):
        raise NotImplementedError("text encoding (CLIP) is not ported yet (ROADMAP.md Queue 1 "
                                  "item 10); pass prompt_embeds")

    def make_backend(self, cond: torch.Tensor, uncond: torch.Tensor, scorer, scorer_cond=None,
                     num_inference_steps: int = 100, eta: float = 1.0,
                     guidance_scale: float | None = None) -> SDSearchBackend:
        """A backend bound to cond/uncond embeddings [B, L, D]; with
        guidance > 1 every UNet call runs the unconditional and conditional
        halves as one batch (unconditional first)."""
        g = self.guidance_scale if guidance_scale is None else guidance_scale
        b = cond.shape[0]

        def eps_model(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            reps = x.shape[0] // b
            xin = x.permute(0, 3, 1, 2).contiguous()
            if g <= 1.0:
                out = self.unet(xin, t, cond.repeat(reps, 1, 1))
            else:
                ctx = torch.cat([uncond.repeat(reps, 1, 1), cond.repeat(reps, 1, 1)])
                un, tx = self.unet(torch.cat([xin, xin]), torch.cat([t, t]), ctx).chunk(2)
                out = un + g * (tx - un)
            return out.permute(0, 2, 3, 1)

        def vae_decode(lat: torch.Tensor) -> torch.Tensor:
            z = (lat / self.vae.scaling_factor).permute(0, 3, 1, 2).contiguous()
            return self.vae.decode(z).permute(0, 2, 3, 1)

        sampler = StochasticDDIMSampler(eps_model=eps_model, num_steps=num_inference_steps,
                                        eta=eta)
        return SDSearchBackend(sampler=sampler, vae_decode=vae_decode, scorer=scorer,
                               scorer_cond=scorer_cond)

    # ------------------------------------------------------------------ call
    @torch.no_grad()
    def __call__(self, prompt=None, *, prompt_embeds: torch.Tensor | None = None,
                 negative_prompt_embeds: torch.Tensor | None = None,
                 num_inference_steps: int = 100, guidance_scale: float = 7.5, eta: float = 1.0,
                 height: int | None = None, width: int | None = None, score_function=None,
                 scorer_cond=None, method: str = "eps_greedy",
                 params: SearchParams | dict | None = None, seed: int = 0,
                 record_noises: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (images01 [B, H, W, 3] in [0, 1], scores [B]) on the
        pipeline's device: the counterpart of the reference's
        (output, max_score)."""
        dev = self.device
        if prompt_embeds is None:
            uncond, cond = self.encode_prompt(prompt)
        else:
            cond = prompt_embeds.to(dev)
            uncond = (negative_prompt_embeds.to(dev) if negative_prompt_embeds is not None
                      else torch.zeros_like(cond))
        if isinstance(params, dict):
            remap = {"lambda": "lambda_"}
            params = SearchParams(**{remap.get(k, k): v for k, v in params.items()})
        backend = self.make_backend(cond, uncond, score_function or _zero_scorer,
                                    scorer_cond=scorer_cond,
                                    num_inference_steps=num_inference_steps, eta=eta,
                                    guidance_scale=guidance_scale)
        f = self.vae_scale_factor
        size = self.unet.sample_size * f
        shape = (cond.shape[0], (height or size) // f, (width or size) // f,
                 self.unet.in_channels)
        z = rng.normal(seed, (SALT_LATENTS,), shape, dev)
        result = run_search(method, backend, z, seed, params or SearchParams(),
                            record_noises=record_noises)
        return result.images, result.score


__all__ = ["StableDiffusionSearchPipeline", "SD15_UNET", "SD15_VAE", "TINY_UNET", "TINY_VAE"]
