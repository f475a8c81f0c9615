"""UperNet semantic segmentation on a ConvNeXt backbone, the counterpart of
chiaswarm_tpu/models/segmentation.py: the model behind `segmentation`
(openmmlab/upernet-convnext-small over ADE20K's 150 labels).

ConvNeXt stages (depthwise 7x7, channel LayerNorm, pointwise MLP, layer
scale), PSP pyramid pooling over the top feature, FPN top-down fusion and
a pixel classifier; the resizes are the JAX module's (`jax.image.resize`
semantics, models/resize.py). Parameter names are transformers'
`UperNetForSemanticSegmentation`, each decode-head conv with a bias:
`fold_batchnorms` folds the published BatchNorms (eval-mode statistics)
into those convs, as the JAX converter does, leaves a folded state as it
is, and drops the auxiliary head (training-only supervision).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .depth import group
from .resize import resize_bilinear

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class UperNetConfig:
    depths: tuple[int, ...] = (3, 3, 27, 3)  # convnext-small
    hidden_sizes: tuple[int, ...] = (96, 192, 384, 768)
    hidden_size: int = 512
    num_labels: int = 150
    pool_scales: tuple[int, ...] = (1, 2, 3, 6)
    layer_norm_eps: float = 1e-6


TINY_UPERNET = UperNetConfig(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 24, 32), hidden_size=16,
                             num_labels=5)


def config_from_json(config_json: dict | None) -> UperNetConfig:
    """UperNetConfig from a transformers config.json, defaults where it is
    silent (the JAX package's `upernet_config_from_json`)."""
    cfg = UperNetConfig()
    cj = config_json or {}
    bb = cj.get("backbone_config", {})
    return UperNetConfig(
        depths=tuple(bb.get("depths", cfg.depths)),
        hidden_sizes=tuple(bb.get("hidden_sizes", cfg.hidden_sizes)),
        hidden_size=int(cj.get("hidden_size", cfg.hidden_size)),
        num_labels=int(cj.get("num_labels", cfg.num_labels)),
        pool_scales=tuple(cj.get("pool_scales", cfg.pool_scales)))


def config_json(cfg: UperNetConfig) -> dict:
    """The config.json fields `config_from_json` reads, for `cfg`."""
    return {"backbone_config": {"depths": list(cfg.depths),
                                "hidden_sizes": list(cfg.hidden_sizes)},
            "hidden_size": cfg.hidden_size, "num_labels": cfg.num_labels,
            "pool_scales": list(cfg.pool_scales)}


class ChannelsLN(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNextLayer(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.layernorm = nn.LayerNorm(dim, eps=eps)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.layer_scale_parameter = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        h = self.layernorm(self.dwconv(x).permute(0, 2, 3, 1))
        h = self.pwconv2(F.gelu(self.pwconv1(h))) * self.layer_scale_parameter
        return x + h.permute(0, 3, 1, 2)


class ConvRelu(nn.Module):
    """UperNetConvModule with its BatchNorm folded into the conv."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2)

    def forward(self, x):
        return F.relu(self.conv(x))


class UperNetSegmenter(nn.Module):
    """[B, 3, H, W] normalised -> logits [B, num_labels, H, W] (f32)."""

    def __init__(self, config: UperNetConfig = UperNetConfig()):
        super().__init__()
        cfg = self.config = config
        eps, hs, c = cfg.layer_norm_eps, cfg.hidden_sizes, cfg.hidden_size
        stages = []
        for s, (depth, dim) in enumerate(zip(cfg.depths, hs)):
            stage = group(layers=nn.ModuleList([ConvNextLayer(dim, eps) for _ in range(depth)]))
            if s > 0:
                stage.downsampling_layer = nn.ModuleList(
                    [ChannelsLN(hs[s - 1], eps=eps), nn.Conv2d(hs[s - 1], dim, 2, stride=2)])
            stages.append(stage)
        self.backbone = group(
            embeddings=group(patch_embeddings=nn.Conv2d(3, hs[0], 4, stride=4),
                             layernorm=ChannelsLN(hs[0], eps=eps)),
            encoder=group(stages=nn.ModuleList(stages)),
            hidden_states_norms=group(**{f"stage{s + 1}": ChannelsLN(dim, eps=eps)
                                         for s, dim in enumerate(hs)}))
        n = len(cfg.pool_scales)
        self.decode_head = group(
            psp_modules=nn.ModuleList([nn.ModuleList([nn.AdaptiveAvgPool2d(scale),
                                                      ConvRelu(hs[-1], c, 1)])
                                       for scale in cfg.pool_scales]),
            bottleneck=ConvRelu(hs[-1] + n * c, c, 3),
            lateral_convs=nn.ModuleList([ConvRelu(dim, c, 1) for dim in hs[:-1]]),
            fpn_convs=nn.ModuleList([ConvRelu(c, c, 3) for _ in hs[:-1]]),
            fpn_bottleneck=ConvRelu(len(hs) * c, c, 3),
            classifier=nn.Conv2d(c, cfg.num_labels, 1))

    def forward(self, pixels):
        bb = self.backbone
        x = bb.embeddings.layernorm(bb.embeddings.patch_embeddings(pixels))
        feats = []
        for s, stage in enumerate(bb.encoder.stages):
            if s > 0:
                x = stage.downsampling_layer[1](stage.downsampling_layer[0](x))
            for layer in stage.layers:
                x = layer(x)
            feats.append(getattr(bb.hidden_states_norms, f"stage{s + 1}")(x))
        head = self.decode_head
        top = feats[-1]
        hw = top.shape[-2:]
        psp = [top] + [resize_bilinear(conv(pool(top)), *hw) for pool, conv in head.psp_modules]
        laterals = [conv(f) for conv, f in zip(head.lateral_convs, feats)]
        laterals.append(head.bottleneck(torch.cat(psp, dim=1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], *laterals[i - 1].shape[-2:])
        outs = [conv(lat) for conv, lat in zip(head.fpn_convs, laterals)] + [laterals[-1]]
        size0 = outs[0].shape[-2:]
        outs = [outs[0]] + [resize_bilinear(o, *size0) for o in outs[1:]]
        logits = head.classifier(head.fpn_bottleneck(torch.cat(outs, dim=1)))
        return resize_bilinear(logits.float(), *pixels.shape[-2:])


def fold_batchnorms(state: dict) -> dict:
    """The published state -> this module's: each decode-head
    `X.batch_norm` folded into `X.conv` (weight scaled, bias added), the
    auxiliary head and `num_batches_tracked` dropped."""
    state = {k: torch.as_tensor(v).float() for k, v in state.items()
             if not k.startswith("auxiliary_head.") and not k.endswith("num_batches_tracked")}
    out = {}
    for key, value in state.items():
        if ".batch_norm." in key:
            continue
        if key.endswith(".conv.weight") and key.replace(".conv.weight",
                                                        ".batch_norm.running_var") in state:
            module = key[:-len(".conv.weight")]
            bn = {leaf: state[f"{module}.batch_norm.{leaf}"]
                  for leaf in ("weight", "bias", "running_mean", "running_var")}
            scale = bn["weight"] / torch.sqrt(bn["running_var"] + BN_EPS)
            bias = state.get(f"{module}.conv.bias", 0.0)
            out[key] = value * scale[:, None, None, None]
            out[f"{module}.conv.bias"] = bn["bias"] + (bias - bn["running_mean"]) * scale
        elif key not in out:
            out[key] = value
    return out
