"""DPT monocular depth (ViT backbone + reassemble / fusion head), the
counterpart of chiaswarm_tpu/models/depth.py: the model behind the
`depth`, `normal bae` and `depth estimator` preprocessors, and `zoe
depth`'s stand-in.

Parameter names are transformers' `DPTForDepthEstimation` (`dpt.encoder.
layer.N.attention.attention.query`, `neck.fusion_stage.layers.J...`,
`head.head.K`), so Intel/dpt-large's file loads as published; the keys the
graph does not use (`dpt.layernorm`, the deepest fusion layer's
`residual_layer1`) are in `UNUSED_KEYS`. The graph is the JAX module's:
LayerNorm at eps 1e-6 and half-pixel 2x upsampling in the fusion (where
transformers aligns corners). Each of the 24 blocks' attention goes
through ops.dot_product_attention, the flash kernel on the card, at
[1, 577, 16, 64] for DPT-large.
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dot_product_attention
from .resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    taps: tuple[int, ...] = (5, 11, 17, 23)
    reassemble_channels: tuple[int, ...] = (256, 512, 1024, 1024)
    fusion_dim: int = 256
    head_dim: int = 32


TINY_DPT = DPTConfig(
    image_size=64, patch_size=16, hidden_size=32, num_layers=4, num_heads=4,
    taps=(0, 1, 2, 3), reassemble_channels=(16, 24, 32, 32), fusion_dim=16,
    head_dim=8,
)

LN_EPS = 1e-6  # flax's LayerNorm default, which the JAX module keeps

# published keys the graph does not read
UNUSED_KEYS = re.compile(r"^dpt\.layernorm\.|^neck\.fusion_stage\.layers\.0\.residual_layer1\.")


def group(**children) -> nn.Module:
    """A bare module holding `children` under their names (a key prefix)."""
    m = nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, 2 * x.shape[-2], 2 * x.shape[-1])


class ViTLayer(nn.Module):
    """Pre-LN ViT block; `attention.attention.{query,key,value}` and
    `attention.output.dense`, `intermediate.dense`, `output.dense`."""

    def __init__(self, hidden: int, heads: int, mlp: int | None = None,
                 eps: float = LN_EPS):
        super().__init__()
        self.heads = heads
        self.layernorm_before = nn.LayerNorm(hidden, eps=eps)
        self.attention = group(
            attention=group(query=nn.Linear(hidden, hidden), key=nn.Linear(hidden, hidden),
                            value=nn.Linear(hidden, hidden)),
            output=group(dense=nn.Linear(hidden, hidden)))
        self.layernorm_after = nn.LayerNorm(hidden, eps=eps)
        self.intermediate = group(dense=nn.Linear(hidden, mlp or 4 * hidden))
        self.output = group(dense=nn.Linear(mlp or 4 * hidden, hidden))

    def forward(self, x):
        b, s, d = x.shape
        att = self.attention.attention
        y = self.layernorm_before(x)
        q, k, v = (proj(y).view(b, s, self.heads, d // self.heads)
                   for proj in (att.query, att.key, att.value))
        x = x + self.attention.output.dense(dot_product_attention(q, k, v).reshape(b, s, d))
        y = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(y)


class FlippedConvTranspose(nn.ConvTranspose2d):
    """A k x k, stride-k transposed conv whose kernel is read flipped: the
    JAX module's flax `ConvTranspose` takes the published [in, out, k, k]
    weight as a plain (unflipped) kernel, so each output k x k block is
    transformers' block mirrored. The port keeps JAX's graph."""

    def __init__(self, channels: int, k: int):
        super().__init__(channels, channels, k, stride=k)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.flip(-2, -1), self.bias, self.stride)


class ResidualConvUnit(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.convolution2 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class FusionLayer(nn.Module):
    def __init__(self, channels: int, lateral: bool = True):
        super().__init__()
        if lateral:
            self.residual_layer1 = ResidualConvUnit(channels)
        self.residual_layer2 = ResidualConvUnit(channels)
        self.projection = nn.Conv2d(channels, channels, 1)

    def forward(self, fused, lateral):
        hidden = lateral if fused is None else fused + self.residual_layer1(lateral)
        return self.projection(upsample2x(self.residual_layer2(hidden)))


class DPTDepthModel(nn.Module):
    """pixels [B, 3, H, W] normalised -> inverse depth [B, H, W]."""

    def __init__(self, config: DPTConfig = DPTConfig()):
        super().__init__()
        cfg = self.config = config
        d = cfg.hidden_size
        tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.dpt = group(
            embeddings=group(patch_embeddings=group(projection=nn.Conv2d(
                3, d, cfg.patch_size, stride=cfg.patch_size))),
            encoder=group(layer=nn.ModuleList(
                [ViTLayer(d, cfg.num_heads) for _ in range(cfg.num_layers)])))
        self.dpt.embeddings.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.dpt.embeddings.position_embeddings = nn.Parameter(torch.zeros(1, tokens, d))
        layers = []
        for k, ch in enumerate(cfg.reassemble_channels):
            layer = group(projection=nn.Conv2d(d, ch, 1))
            if k < 2:  # /16 -> /4 and /8
                layer.resize = FlippedConvTranspose(ch, 4 if k == 0 else 2)
            elif k == 3:
                layer.resize = nn.Conv2d(ch, ch, 3, stride=2, padding=1)
            layers.append(layer)
        n = len(cfg.taps)
        self.neck = group(
            reassemble_stage=group(
                readout_projects=nn.ModuleList(
                    [nn.ModuleList([nn.Linear(2 * d, d)]) for _ in range(n)]),
                layers=nn.ModuleList(layers)),
            convs=nn.ModuleList([nn.Conv2d(ch, cfg.fusion_dim, 3, padding=1, bias=False)
                                 for ch in cfg.reassemble_channels]),
            # layer j fuses feature n-1-j, the deepest first
            fusion_stage=group(layers=nn.ModuleList(
                [FusionLayer(cfg.fusion_dim, lateral=j > 0) for j in range(n)])))
        f = cfg.fusion_dim
        self.head = group(head=nn.ModuleList([
            nn.Conv2d(f, f // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(f // 2, cfg.head_dim, 3, padding=1), nn.Identity(),
            nn.Conv2d(cfg.head_dim, 1, 1)]))

    def forward(self, pixels):
        cfg = self.config
        emb = self.dpt.embeddings
        x = emb.patch_embeddings.projection(pixels)
        b, d, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([emb.cls_token.expand(b, 1, d), x], dim=1) + emb.position_embeddings
        taps = {}
        for i, layer in enumerate(self.dpt.encoder.layer):
            x = layer(x)
            if i in cfg.taps:
                taps[i] = x
        stage = self.neck.reassemble_stage
        features = []
        for k, layer_idx in enumerate(cfg.taps):
            t = taps[layer_idx]
            tokens, cls = t[:, 1:], t[:, :1]
            readout = torch.cat([tokens, cls.expand_as(tokens)], dim=-1)
            tokens = F.gelu(stage.readout_projects[k][0](readout))
            fmap = tokens.transpose(1, 2).reshape(b, d, gh, gw)
            layer = stage.layers[k]
            fmap = layer.projection(fmap)
            if hasattr(layer, "resize"):
                fmap = layer.resize(fmap)
            features.append(self.neck.convs[k](fmap))
        fused = None
        for j, fusion in enumerate(self.neck.fusion_stage.layers):
            fused = fusion(fused, features[len(features) - 1 - j])
        head = self.head.head
        y = upsample2x(head[0](fused))
        y = F.relu(head[2](y))
        return F.relu(head[4](y))[:, 0]
