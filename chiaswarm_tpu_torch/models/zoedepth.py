"""ZoeDepth metric depth (transformers `ZoeDepthForDepthEstimation`: a
BEiT-large backbone and the single-configuration metric-bins head), the
counterpart of chiaswarm_tpu/models/zoedepth.py: the model behind `zoe
depth`.

- BEiT: patch conv and a CLS token, pre-LN blocks with a per-layer 2D
  relative-position-bias table (a key projection without bias, layer-scale
  lambdas), taps after the blocks in `out_indices` keeping the CLS token;
- a DPT neck: readout-projected reassemble to four resolutions, 3x3
  projections, top-down fusion with corner-aligned 2x upsampling;
- the relative-depth head, whose last features condition the metric-bins
  head: a seed bin regressor, four attractor layers (inverse attractors
  at transformers' defaults alpha 300, gamma 2, averaged), projector MLPs
  and a conditional log-binomial softmax over the bin centres.

Attention adds the relative-position bias, so it is computed in plain
torch (einsum, f32 softmax), as the JAX module computes it outside any
Pallas kernel. The canvas is fixed to the trained window, where the bias
tables index directly. Parameter names are transformers', so
Intel/zoedepth-nyu's file loads as published; `config_from_json` reads
its config.json as the JAX converter does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .depth import group
from .resize import resize_align_corners, resize_bilinear


@dataclasses.dataclass(frozen=True)
class ZoeConfig:
    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-12
    out_indices: tuple[int, ...] = (6, 12, 18, 24)
    reassemble_factors: tuple[float, ...] = (4, 2, 1, 0.5)
    neck_hidden_sizes: tuple[int, ...] = (96, 192, 384, 768)
    fusion_hidden_size: int = 256
    bottleneck_features: int = 256
    num_relative_features: int = 32
    num_attractors: tuple[int, ...] = (16, 8, 4, 1)
    bin_embedding_dim: int = 128
    n_bins: int = 64
    min_depth: float = 1e-3
    max_depth: float = 10.0
    min_temp: float = 0.0212
    max_temp: float = 50.0
    seed_mlp_dim: int = 256
    projector_mlp_dim: int = 128

    @property
    def window(self) -> int:
        return self.image_size // self.patch_size


TINY_ZOE = ZoeConfig(
    image_size=64, patch_size=16, hidden_size=32, num_layers=4, num_heads=4,
    intermediate_size=64, out_indices=(1, 2, 3, 4), neck_hidden_sizes=(8, 16, 24, 32),
    fusion_hidden_size=16, bottleneck_features=16, num_relative_features=8,
    num_attractors=(4, 2, 2, 1), bin_embedding_dim=16, n_bins=8,
)


def config_from_json(cj: dict | None) -> ZoeConfig:
    """ZoeConfig from a transformers config.json (defaults where it is
    silent); ValueError for a multi-domain (NK) head."""
    cj = cj or {}
    bj = cj.get("backbone_config", {})
    bins_list = cj.get("bin_configurations") or [{}]
    if len(bins_list) > 1:
        raise ValueError("multi-domain (NK) ZoeDepth heads are not supported; use a "
                         "single-configuration checkpoint (ZoeD_N)")
    bins = bins_list[0]
    d = ZoeConfig()
    return ZoeConfig(
        image_size=int(bj.get("image_size", d.image_size)),
        patch_size=int(bj.get("patch_size", d.patch_size)),
        hidden_size=int(bj.get("hidden_size", d.hidden_size)),
        num_layers=int(bj.get("num_hidden_layers", d.num_layers)),
        num_heads=int(bj.get("num_attention_heads", d.num_heads)),
        intermediate_size=int(bj.get("intermediate_size", d.intermediate_size)),
        layer_norm_eps=float(bj.get("layer_norm_eps", d.layer_norm_eps)),
        out_indices=tuple(bj.get("out_indices", d.out_indices)),
        reassemble_factors=tuple(cj.get("reassemble_factors", d.reassemble_factors)),
        neck_hidden_sizes=tuple(cj.get("neck_hidden_sizes", d.neck_hidden_sizes)),
        fusion_hidden_size=int(cj.get("fusion_hidden_size", d.fusion_hidden_size)),
        bottleneck_features=int(cj.get("bottleneck_features", d.bottleneck_features)),
        num_relative_features=int(cj.get("num_relative_features", d.num_relative_features)),
        num_attractors=tuple(cj.get("num_attractors", d.num_attractors)),
        bin_embedding_dim=int(cj.get("bin_embedding_dim", d.bin_embedding_dim)),
        n_bins=int(bins.get("n_bins", d.n_bins)),
        min_depth=float(bins.get("min_depth", d.min_depth)),
        max_depth=float(bins.get("max_depth", d.max_depth)),
        min_temp=float(cj.get("min_temp", d.min_temp)),
        max_temp=float(cj.get("max_temp", d.max_temp)))


def config_json(cfg: ZoeConfig) -> dict:
    """The config.json fields `config_from_json` reads, for `cfg`."""
    return {
        "backbone_config": {"image_size": cfg.image_size, "patch_size": cfg.patch_size,
                            "hidden_size": cfg.hidden_size,
                            "num_hidden_layers": cfg.num_layers,
                            "num_attention_heads": cfg.num_heads,
                            "intermediate_size": cfg.intermediate_size,
                            "layer_norm_eps": cfg.layer_norm_eps,
                            "out_indices": list(cfg.out_indices)},
        "reassemble_factors": list(cfg.reassemble_factors),
        "neck_hidden_sizes": list(cfg.neck_hidden_sizes),
        "fusion_hidden_size": cfg.fusion_hidden_size,
        "bottleneck_features": cfg.bottleneck_features,
        "num_relative_features": cfg.num_relative_features,
        "num_attractors": list(cfg.num_attractors),
        "bin_embedding_dim": cfg.bin_embedding_dim,
        "bin_configurations": [{"n_bins": cfg.n_bins, "min_depth": cfg.min_depth,
                                "max_depth": cfg.max_depth}],
        "min_temp": cfg.min_temp, "max_temp": cfg.max_temp}


def relative_position_index(window: int) -> np.ndarray:
    """[(W^2+1)^2] index into the (2W-1)^2+3 bias table; the CLS rows use the
    three trailing entries (transformers' BeitRelativePositionBias)."""
    num_rel = (2 * window - 1) ** 2 + 3
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    area = window * window
    index = np.zeros((area + 1, area + 1), np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_rel - 3
    index[0:, 0] = num_rel - 2
    index[0, 0] = num_rel - 1
    return index.reshape(-1)


@functools.lru_cache(maxsize=8)
def _index(window: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(relative_position_index(window)).to(device)


class BeitSelfAttention(nn.Module):
    def __init__(self, cfg: ZoeConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d, bias=False)
        self.value = nn.Linear(d, d)
        self.relative_position_bias = group()
        self.relative_position_bias.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * cfg.window - 1) ** 2 + 3, cfg.num_heads))
        self.window = cfg.window

    def forward(self, x):
        b, s, d = x.shape
        hd = d // self.heads
        q, k, v = (proj(x).view(b, s, self.heads, hd)
                   for proj in (self.query, self.key, self.value))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
        table = self.relative_position_bias.relative_position_bias_table
        bias = table[_index(self.window, table.device)].view(s, s, self.heads).permute(2, 0, 1)
        weights = torch.softmax(logits + bias[None].float(), dim=-1).to(x.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, d)


class BeitLayer(nn.Module):
    def __init__(self, cfg: ZoeConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layernorm_before = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attention = group(attention=BeitSelfAttention(cfg),
                               output=group(dense=nn.Linear(d, d)))
        self.lambda_1 = nn.Parameter(torch.ones(d))
        self.layernorm_after = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.intermediate = group(dense=nn.Linear(d, cfg.intermediate_size))
        self.output = group(dense=nn.Linear(cfg.intermediate_size, d))
        self.lambda_2 = nn.Parameter(torch.ones(d))

    def forward(self, x):
        attn = self.attention.output.dense(self.attention.attention(self.layernorm_before(x)))
        x = x + attn * self.lambda_1
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h) * self.lambda_2


class PreActResidual(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(width, width, 3, padding=1)
        self.convolution2 = nn.Conv2d(width, width, 3, padding=1)

    def forward(self, x):
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class FusionLayer(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.residual_layer1 = PreActResidual(width)
        self.residual_layer2 = PreActResidual(width)
        self.projection = nn.Conv2d(width, width, 1)

    def forward(self, x, residual=None):
        if residual is not None:
            if residual.shape != x.shape:
                residual = resize_bilinear(residual, *x.shape[-2:])
            x = x + self.residual_layer1(residual)
        x = self.residual_layer2(x)
        x = resize_align_corners(x, 2 * x.shape[-2], 2 * x.shape[-1])
        return self.projection(x)


class Mlp1x1(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, softplus: bool = False):
        super().__init__()
        self.softplus = softplus
        self.conv1 = nn.Conv2d(cin, mid, 1)
        self.conv2 = nn.Conv2d(mid, out, 1)

    def forward(self, x):
        x = self.conv2(F.relu(self.conv1(x)))
        return F.softplus(x.float()).to(x.dtype) if self.softplus else x


class Attractor(nn.Module):
    def __init__(self, dim: int, n_attr: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 1)
        self.conv2 = nn.Conv2d(dim, n_attr, 1)

    def forward(self, emb, prev_bin, prev_emb):
        hh, ww = emb.shape[-2:]
        z = emb + resize_align_corners(prev_emb, hh, ww)
        attractors = F.softplus(self.conv2(F.relu(self.conv1(z))).float())
        centers = resize_align_corners(prev_bin.float(), hh, ww)
        dx = attractors[:, :, None] - centers[:, None]  # [B, A, N, h, w]
        return centers + (dx / (1.0 + 300.0 * dx * dx)).mean(dim=1)


def _log_binom(n, k, eps: float = 1e-7):
    n = n + eps
    k = k + eps
    return n * torch.log(n) - k * torch.log(k) - (n - k) * torch.log(n - k + eps)


class ConditionalLogBinomial(nn.Module):
    def __init__(self, cfg: ZoeConfig):
        super().__init__()
        self.cfg = cfg
        cin = cfg.num_relative_features + 1 + cfg.bin_embedding_dim
        self.mlp = nn.ModuleList([nn.Conv2d(cin, cin // 2, 1), nn.GELU(),
                                  nn.Conv2d(cin // 2, 4, 1)])

    def forward(self, main, condition):
        cfg = self.cfg
        x = torch.cat([main, condition], dim=1)
        x = F.softplus(self.mlp[2](F.gelu(self.mlp[0](x))).float())
        eps = 1e-4
        prob = x[:, :2] + eps
        prob = prob[:, 0] / (prob[:, 0] + prob[:, 1])
        temp = x[:, 2:] + eps
        temp = temp[:, 0] / (temp[:, 0] + temp[:, 1])
        temp = (cfg.max_temp - cfg.min_temp) * temp + cfg.min_temp
        prob = prob.clamp(eps, 1.0)[:, None]
        one_minus = (1.0 - prob).clamp(eps, 1.0)
        k = torch.arange(cfg.n_bins, dtype=torch.float32, device=x.device)[None, :, None, None]
        n = float(cfg.n_bins - 1)
        y = (_log_binom(torch.tensor(n, device=x.device), k) + k * torch.log(prob)
             + (n - k) * torch.log(one_minus))
        return torch.softmax(y / temp[:, None], dim=1)


class ZoeDepthModel(nn.Module):
    """[B, 3, S, S] normalised pixels (S = image_size) -> [B, S, S] depth in metres."""

    def __init__(self, config: ZoeConfig = ZoeConfig()):
        super().__init__()
        cfg = self.config = config
        d, p = cfg.hidden_size, cfg.patch_size
        self.backbone = group(
            embeddings=group(patch_embeddings=group(projection=nn.Conv2d(3, d, p, stride=p))),
            encoder=group(layer=nn.ModuleList([BeitLayer(cfg) for _ in range(cfg.num_layers)])))
        self.backbone.embeddings.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        layers = []
        for ch, factor in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors):
            layer = group(projection=nn.Conv2d(d, ch, 1))
            if factor > 1:
                layer.resize = nn.ConvTranspose2d(ch, ch, int(factor), stride=int(factor))
            elif factor < 1:
                layer.resize = nn.Conv2d(ch, ch, 3, stride=int(1 / factor), padding=1)
            layers.append(layer)
        f = cfg.fusion_hidden_size
        self.neck = group(
            reassemble_stage=group(
                readout_projects=nn.ModuleList([nn.ModuleList([nn.Linear(2 * d, d)])
                                                for _ in cfg.neck_hidden_sizes]),
                layers=nn.ModuleList(layers)),
            convs=nn.ModuleList([nn.Conv2d(ch, f, 3, padding=1, bias=False)
                                 for ch in cfg.neck_hidden_sizes]),
            fusion_stage=group(layers=nn.ModuleList([FusionLayer(f)
                                                     for _ in cfg.neck_hidden_sizes])))
        self.relative_head = group(
            conv1=nn.Conv2d(f, f // 2, 3, padding=1),
            conv2=nn.Conv2d(f // 2, cfg.num_relative_features, 3, padding=1),
            conv3=nn.Conv2d(cfg.num_relative_features, 1, 1))
        e = cfg.bin_embedding_dim
        self.metric_head = group(
            conv2=nn.Conv2d(f, cfg.bottleneck_features, 1),
            seed_bin_regressor=Mlp1x1(cfg.bottleneck_features, cfg.seed_mlp_dim, cfg.n_bins,
                                      softplus=True),
            seed_projector=Mlp1x1(cfg.bottleneck_features, cfg.projector_mlp_dim, e),
            projectors=nn.ModuleList([Mlp1x1(f, cfg.projector_mlp_dim, e)
                                      for _ in cfg.num_attractors]),
            attractors=nn.ModuleList([Attractor(e, n) for n in cfg.num_attractors]),
            conditional_log_binomial=ConditionalLogBinomial(cfg))

    def forward(self, pixels):
        cfg = self.config
        b = pixels.shape[0]
        win = cfg.window
        emb = self.backbone.embeddings
        x = emb.patch_embeddings.projection(pixels).flatten(2).transpose(1, 2)
        x = torch.cat([emb.cls_token.expand(b, 1, -1), x], dim=1)
        taps = []
        for i, layer in enumerate(self.backbone.encoder.layer):
            x = layer(x)
            if i + 1 in cfg.out_indices:
                taps.append(x)
        stage = self.neck.reassemble_stage
        feats = []
        for i, tap in enumerate(taps):
            tokens = tap[:, 1:]
            readout = tap[:, :1].expand_as(tokens)
            h = F.gelu(stage.readout_projects[i][0](torch.cat([tokens, readout], dim=-1)))
            h = h.transpose(1, 2).reshape(b, cfg.hidden_size, win, win)
            layer = stage.layers[i]
            h = layer.projection(h)
            if hasattr(layer, "resize"):
                h = layer.resize(h)
            feats.append(self.neck.convs[i](h))
        fused_states, fused = [], None
        for j, f in enumerate(feats[::-1]):
            layer = self.neck.fusion_stage.layers[j]
            fused = layer(f) if fused is None else layer(fused, f)
            fused_states.append(fused)
        bottleneck = feats[-1]

        head = self.relative_head
        h = head.conv1(fused_states[-1])
        h = resize_align_corners(h, 2 * h.shape[-2], 2 * h.shape[-1])
        rel_features = F.relu(head.conv2(h))
        relative_depth = F.relu(head.conv3(rel_features))

        mh = self.metric_head
        x = mh.conv2(bottleneck)
        prev_bin = bin_centers = mh.seed_bin_regressor(x)
        prev_embedding = mh.seed_projector(x)
        for i, feature in enumerate(fused_states):
            embedding = mh.projectors[i](feature)
            prev_bin = bin_centers = mh.attractors[i](embedding, prev_bin, prev_embedding)
            prev_embedding = embedding
        hh, ww = rel_features.shape[-2:]
        rel = resize_align_corners(relative_depth, hh, ww)
        last = torch.cat([rel_features, rel.to(rel_features.dtype)], dim=1)
        embedding = resize_align_corners(prev_embedding, hh, ww)
        probs = mh.conditional_log_binomial(last, embedding)
        centers = resize_align_corners(bin_centers.float(), hh, ww)
        return (probs * centers).sum(dim=1)

