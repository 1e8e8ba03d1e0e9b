"""Noisy-ImageNet classifier reward (counterpart of
diffusion_tts_tpu/scorers/imagenet.py; reference edm/scorers.py:56-174):
score = softmax(logits)[target class] of the 64x64 guided-diffusion
classifier (models/classifier.py), in fp32. Weights come from a local
``64x64_classifier.pt`` or are random, made with numpy from a seed."""
from __future__ import annotations

from typing import Mapping

import torch

from diffusion_tts_torch.models.classifier import EncoderUNetModel
from diffusion_tts_torch.models.torch_import import load_into, random_state_dict
from diffusion_tts_torch.utils.device import resolve_device


class ImageNetScorer:
    def __init__(self, state: Mapping[str, torch.Tensor] | None = None, *, seed: int = 0,
                 device: torch.device | str = "cuda", **model_overrides):
        """state: a guided-diffusion state dict (tensors); None draws random
        weights from ``seed``."""
        dev = resolve_device(device)
        model = EncoderUNetModel(**model_overrides)
        if state is None:
            state = random_state_dict(model, seed)
        self.model = load_into(model, state).to(dev).eval()

    @classmethod
    def from_torch_checkpoint(cls, path: str, **kwargs) -> "ImageNetScorer":
        """The OpenAI classifier .pt (a torch state dict) from a local path
        (the reference downloads it, edm/scorers.py:61-74)."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        return cls({k: v.float() for k, v in state.items()}, **kwargs)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def __call__(self, images01: torch.Tensor, cond=None, timesteps=None) -> torch.Tensor:
        """images01 [B, H, W, 3] in [0, 1]; cond: one-hot [B, classes]
        (the target is its argmax) or int labels [B]."""
        if cond is None:
            raise ValueError("ImageNetScorer needs class labels")
        dev = self.device
        b = images01.shape[0]
        if timesteps is None:
            timesteps = torch.zeros((b,), dtype=torch.float32, device=dev)
        logits = self.model(images01.float().to(dev).permute(0, 3, 1, 2), timesteps.to(dev))
        probs = torch.softmax(logits.float(), dim=-1)
        cond = torch.as_tensor(cond, device=dev)
        target = cond.argmax(dim=-1) if cond.ndim > 1 else cond.long()
        return probs.gather(1, target[:, None])[:, 0].to(images01.device)


__all__ = ["ImageNetScorer"]
