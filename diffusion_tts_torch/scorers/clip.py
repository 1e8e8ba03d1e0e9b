"""CLIP similarity reward (counterpart of diffusion_tts_tpu/scorers/clip.py;
reference sd/scorers.py:149-213): score = cosine(image features, text
features), with openai/clip-vit-large-patch14 from a local directory or a
tiny random model, on the port's own CLIP towers (models/clip.py).

Preprocessing runs on the device: a bicubic resize to the vision tower's
size with antialiasing (``jax.image.resize``'s bicubic antialiases when it
shrinks; without it the two differ by up to 0.7), a clip to [0, 1] and
CLIP's normalization. Text features are computed once per token-id batch
and cached.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from diffusion_tts_torch.models.clip import (
    CLIPConfig,
    CLIPModel,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from diffusion_tts_torch.models.torch_import import load_into, random_state_dict
from diffusion_tts_torch.utils.device import resolve_device

_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# The JAX package's tiny random CLIP (diffusion_tts_tpu/scorers/clip.py:64-73)
TINY_CLIP = CLIPConfig(
    text=CLIPTextConfig(hidden_size=32, intermediate_size=64, num_attention_heads=4,
                        num_hidden_layers=2, max_position_embeddings=77, vocab_size=1000),
    vision=CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_attention_heads=4,
                            num_hidden_layers=2, image_size=32, patch_size=8),
    projection_dim=16)


def preprocess_images(images01: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> CLIP pixel_values [B, 3, S, S]."""
    x = images01.float().permute(0, 3, 1, 2)
    if x.shape[2] != image_size or x.shape[3] != image_size:
        x = F.interpolate(x, size=(image_size, image_size), mode="bicubic", align_corners=False,
                          antialias=True).clamp(0.0, 1.0)
    mean = torch.tensor(_CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(_CLIP_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


class CLIPScorer:
    """Images are resized to the vision tower's ``image_size``, which its
    position embeddings fix."""

    def __init__(self, model: CLIPModel, device: torch.device | str = "cuda"):
        self.model = model.to(resolve_device(device)).eval()
        self.image_size = model.config.vision.image_size
        self._text_cache: dict[tuple, torch.Tensor] = {}

    @classmethod
    def from_pretrained(cls, path: str, *, device: torch.device | str = "cuda") -> "CLIPScorer":
        """A local HF CLIP directory (no download)."""
        return cls(CLIPModel.from_pretrained(path), device=device)

    @classmethod
    def random_init(cls, seed: int = 0, *, device: torch.device | str = "cuda") -> "CLIPScorer":
        """The tiny random CLIP (TINY_CLIP) for tests and runs without
        weights; weights from a numpy seed."""
        model = CLIPModel(TINY_CLIP)
        return cls(load_into(model, random_state_dict(model, seed)), device=device)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def text_features(self, input_ids) -> torch.Tensor:
        """Normalized text features [B, D] of token ids [B, L], cached by
        the ids' values."""
        ids = torch.as_tensor(input_ids).to("cpu", torch.long)
        key = (tuple(ids.shape), hash(ids.numpy().tobytes()))
        if key not in self._text_cache:
            emb = self.model.get_text_features(ids.to(self.device)).float()
            self._text_cache[key] = emb / emb.norm(dim=-1, keepdim=True)
        return self._text_cache[key]

    @torch.no_grad()
    def __call__(self, images01: torch.Tensor, cond=None, timesteps=None) -> torch.Tensor:
        """cond: None (scores 0), token ids [B or 1, L], or normalized text
        features [B or 1, D]; a batch of 1 broadcasts."""
        pix = preprocess_images(images01.to(self.device), self.image_size)
        img = self.model.get_image_features(pix).float()
        img = img / img.norm(dim=-1, keepdim=True)
        if cond is None:
            return torch.zeros(img.shape[0], dtype=torch.float32, device=img.device)
        cond = torch.as_tensor(cond)
        txt = cond.to(img.device, torch.float32) if cond.is_floating_point() else \
            self.text_features(cond)
        if txt.shape[0] == 1 and img.shape[0] > 1:
            txt = txt.expand(img.shape[0], -1)
        return (img * txt).sum(dim=-1)


__all__ = ["CLIPScorer", "TINY_CLIP", "preprocess_images"]
