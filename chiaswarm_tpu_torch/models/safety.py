"""The Stable Diffusion safety checker (torch.nn), the counterpart of
chiaswarm_tpu/models/safety.py: a CLIP ViT image tower (pre-LN,
quick-gelu MLPs), the visual projection, and cosine scores against fixed
concept and special-care embeddings with per-concept thresholds; a
special-care hit tightens every concept threshold by 0.01.

Key names are transformers' StableDiffusionSafetyChecker's
(`vision_model.vision_model.embeddings.*`, `...pre_layrnorm` as spelled
there, `...encoder.layers.N.*`, `visual_projection`, `concept_embeds`,
...), so the published checkpoint loads as it is. The LayerNorms use the
reference's epsilon, 1e-6 (flax's default; transformers' CLIP uses
1e-5). The tower's attention goes through ops.dot_product_attention: the
kernel on the card, the plain version on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import dot_product_attention
from .clip import _act

# the reference's LayerNorm epsilon (flax nn.LayerNorm's default)
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SafetyConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 768
    num_concepts: int = 17
    num_special: int = 3
    hidden_act: str = "quick_gelu"


TINY_SAFETY = SafetyConfig(
    image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=4,
    projection_dim=16, num_concepts=4, num_special=2,
)


class VisionAttention(nn.Module):
    def __init__(self, config: SafetyConfig):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, x):
        b, s, h = x.shape
        heads = (self.num_heads, h // self.num_heads)
        q = self.q_proj(x).view(b, s, *heads)
        k = self.k_proj(x).view(b, s, *heads)
        v = self.v_proj(x).view(b, s, *heads)
        return self.out_proj(dot_product_attention(q, k, v).reshape(b, s, h))


class VisionMLP(nn.Module):
    def __init__(self, config: SafetyConfig):
        super().__init__()
        self.act = config.hidden_act
        self.fc1 = nn.Linear(config.hidden_size, 4 * config.hidden_size)
        self.fc2 = nn.Linear(4 * config.hidden_size, config.hidden_size)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class VisionLayer(nn.Module):
    def __init__(self, config: SafetyConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=LN_EPS)
        self.self_attn = VisionAttention(config)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=LN_EPS)
        self.mlp = VisionMLP(config)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class VisionEmbeddings(nn.Module):
    def __init__(self, config: SafetyConfig):
        super().__init__()
        h, p = config.hidden_size, config.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(h))
        self.patch_embedding = nn.Conv2d(3, h, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding((config.image_size // p) ** 2 + 1, h)

    def forward(self, pixels):
        x = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class VisionEncoder(nn.Module):
    def __init__(self, config: SafetyConfig):
        super().__init__()
        self.layers = nn.ModuleList([VisionLayer(config) for _ in range(config.num_layers)])


class VisionTransformer(nn.Module):
    def __init__(self, config: SafetyConfig):
        super().__init__()
        self.embeddings = VisionEmbeddings(config)
        self.pre_layrnorm = nn.LayerNorm(config.hidden_size, eps=LN_EPS)
        self.encoder = VisionEncoder(config)
        self.post_layernorm = nn.LayerNorm(config.hidden_size, eps=LN_EPS)

    def forward(self, pixels):
        x = self.pre_layrnorm(self.embeddings(pixels))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x[:, 0])


class CLIPVisionModel(nn.Module):
    """transformers' CLIPVisionModel: its tower under `vision_model`."""

    def __init__(self, config: SafetyConfig):
        super().__init__()
        self.vision_model = VisionTransformer(config)


class CLIPVisionEncoder(nn.Module):
    """Normalised pixels [B, 3, S, S] -> projected image embeds [B, P]."""

    def __init__(self, config: SafetyConfig):
        super().__init__()
        self.vision_model = CLIPVisionModel(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim,
                                           bias=False)

    def forward(self, pixels):
        return self.visual_projection(self.vision_model.vision_model(pixels))


def _cos(a, b):
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
    return a @ b.T


class SafetyChecker(CLIPVisionEncoder):
    """The whole checker: pixels -> concept scores and per-image NSFW
    booleans."""

    def __init__(self, config: SafetyConfig):
        super().__init__(config)
        self.config = config
        self.concept_embeds = nn.Parameter(torch.zeros(config.num_concepts,
                                                       config.projection_dim))
        self.special_care_embeds = nn.Parameter(torch.zeros(config.num_special,
                                                            config.projection_dim))
        self.concept_embeds_weights = nn.Parameter(torch.zeros(config.num_concepts))
        self.special_care_embeds_weights = nn.Parameter(torch.zeros(config.num_special))

    def forward(self, pixels):
        """-> (concept scores [B, K] f32, flags [B] bool): a concept's
        cosine less its threshold, plus 0.01 where any special-care score
        is positive; an image is flagged where any concept score is
        positive. The arithmetic after the tower is f32, as in the
        reference."""
        e = super().forward(pixels).float()
        special = _cos(e, self.special_care_embeds.float()) - self.special_care_embeds_weights.float()
        adjustment = torch.where((special > 0).any(dim=-1, keepdim=True), 0.01, 0.0)
        concept = (_cos(e, self.concept_embeds.float()) - self.concept_embeds_weights.float()
                   + adjustment)
        return concept, (concept > 0).any(dim=-1)
