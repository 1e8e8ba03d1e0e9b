"""CLIP's text and vision towers in PyTorch (the JAX package takes them from
transformers' Flax classes; the port writes its own, since importing
transformers' torch CLIP model pulls JAX and TensorFlow in wherever they are
installed).

A pre-LayerNorm transformer with quick_gelu MLPs, in fp32 as the JAX
package runs it. The text tower runs under
a causal mask and pools at the EOS token; the vision tower embeds 14x14 (or
``patch_size``) patches behind a class token, with ``pre_layrnorm`` before
the encoder and ``post_layernorm`` on the class token. Attention is a plain
einsum and softmax, as in the Flax model, which runs no Pallas kernel.

Module names are Hugging Face's (``text_model.*``, ``vision_model.*``,
``visual_projection.weight``, ``text_projection.weight``), so a local HF
CLIP directory (``config.json`` and ``model.safetensors`` or
``pytorch_model.bin``) loads without transformers: ``CLIPModel.
from_pretrained`` for the scorer, ``CLIPTextModel.from_pretrained`` for SD's
``text_encoder/``.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_tts_torch.models.sd_import import load_safetensors
from diffusion_tts_torch.models.torch_import import load_into


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """transformers' CLIPTextConfig fields the tower reads, with its defaults."""

    hidden_size: int = 512
    intermediate_size: int = 2048
    num_attention_heads: int = 8
    num_hidden_layers: int = 12
    max_position_embeddings: int = 77
    vocab_size: int = 49408
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    # 2 (older configs, openai's among them): pool at the argmax id; else at
    # the first occurrence of this id (transformers' rule)
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """transformers' CLIPVisionConfig fields the tower reads, with its defaults."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_attention_heads: int = 12
    num_hidden_layers: int = 12
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    text: CLIPTextConfig = CLIPTextConfig()
    vision: CLIPVisionConfig = CLIPVisionConfig()
    projection_dim: int = 512


# openai/clip-vit-large-patch14's config.json: the CLIP scorer's model
CLIP_VIT_L14 = CLIPConfig(
    text=CLIPTextConfig(hidden_size=768, intermediate_size=3072, num_attention_heads=12,
                        num_hidden_layers=12, eos_token_id=2),
    vision=CLIPVisionConfig(hidden_size=1024, intermediate_size=4096, num_attention_heads=16,
                            num_hidden_layers=24, image_size=224, patch_size=14),
    projection_dim=768)
# SD-1.5's text_encoder/config.json: ViT-L/14's text tower, no projection
SD15_TEXT = CLIPTextConfig(hidden_size=768, intermediate_size=3072, num_attention_heads=12,
                           num_hidden_layers=12, eos_token_id=2)

_ACTS = {"quick_gelu": lambda x: x * torch.sigmoid(1.702 * x), "gelu": F.gelu}
# Keys of HF checkpoints that no tower here holds: the contrastive
# temperature and the position-id buffers of older checkpoints
_IGNORED = ("logit_scale", "text_model.embeddings.position_ids",
            "vision_model.embeddings.position_ids")


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        b, t, d = x.shape
        split = lambda y: y.reshape(b, t, self.heads, d // self.heads)
        q = split(self.q_proj(x)) * (d // self.heads) ** -0.5
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if causal:
            mask = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
            w = w.masked_fill(mask, float("-inf"))
        w = torch.softmax(w, dim=-1)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, d))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str):
        super().__init__()
        self.act = _ACTS[act]
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = CLIPAttention(d, cfg.num_attention_heads)
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(d, cfg.intermediate_size, cfg.hidden_act)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, causal)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.token_embedding(input_ids) + self.position_embedding.weight[
            :input_ids.shape[1]]


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """input_ids [B, L] -> (last_hidden_state [B, L, D], pooled [B, D])."""
        h = self.final_layer_norm(self.encoder(self.embeddings(input_ids), causal=True))
        if self.config.eos_token_id == 2:
            eos = input_ids.argmax(dim=-1)
        else:
            eos = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        return h, h[torch.arange(h.shape[0], device=h.device), eos]


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // p) ** 2 + 1, d)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(d, eps=eps)  # HF's spelling
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(d, eps=eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, 3, S, S] -> the pooled class token [B, D]."""
        h = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)), causal=False)
        return self.post_layernorm(h[:, 0])


def _read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _fields(cls, raw: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in raw.items() if k in names})


def load_hf_state(path: str) -> dict[str, torch.Tensor]:
    """The weights of a local HF model directory, as float32 tensors:
    ``model.safetensors`` (read with numpy) or ``pytorch_model.bin``."""
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        return {k: torch.from_numpy(v) for k, v in load_safetensors(st).items()}
    bin_path = os.path.join(path, "pytorch_model.bin")
    if not os.path.exists(bin_path):
        raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under {path}")
    return {k: v.float() for k, v in
            torch.load(bin_path, map_location="cpu", weights_only=True).items()}


def _load_hf(module: nn.Module, state: dict[str, torch.Tensor]) -> nn.Module:
    """Load HF-named weights; the keys of ``_IGNORED`` are dropped, any other
    missing or extra key raises."""
    return load_into(module, {k: v for k, v in state.items() if k not in _IGNORED})


class CLIPTextModel(nn.Module):
    """The text tower alone (SD's ``text_encoder/``)."""

    def __init__(self, cfg: CLIPTextConfig = SD15_TEXT):
        super().__init__()
        self.config = cfg
        self.text_model = CLIPTextTransformer(cfg)

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTextModel":
        model = cls(_fields(CLIPTextConfig, _read_config(path)))
        return _load_hf(model, load_hf_state(path)).eval()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, L] -> last_hidden_state [B, L, D]."""
        return self.text_model(input_ids)[0]


class CLIPModel(nn.Module):
    """Both towers and their projections (the CLIP scorer's model)."""

    def __init__(self, cfg: CLIPConfig = CLIP_VIT_L14):
        super().__init__()
        self.config = cfg
        self.text_model = CLIPTextTransformer(cfg.text)
        self.vision_model = CLIPVisionTransformer(cfg.vision)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size, cfg.projection_dim,
                                           bias=False)
        self.text_projection = nn.Linear(cfg.text.hidden_size, cfg.projection_dim, bias=False)

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPModel":
        raw = _read_config(path)
        cfg = CLIPConfig(text=_fields(CLIPTextConfig, raw.get("text_config") or {}),
                         vision=_fields(CLIPVisionConfig, raw.get("vision_config") or {}),
                         projection_dim=raw.get("projection_dim", 512))
        return _load_hf(cls(cfg), load_hf_state(path)).eval()

    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixel_values))

    def get_text_features(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_projection(self.text_model(input_ids)[1])


__all__ = ["CLIPConfig", "CLIPTextConfig", "CLIPVisionConfig", "CLIPModel", "CLIPTextModel",
           "CLIP_VIT_L14", "SD15_TEXT", "load_hf_state"]
