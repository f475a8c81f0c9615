"""The Stable Cascade UNet (torch.nn), the counterpart of
chiaswarm_tpu/models/cascade_unet.py: diffusers' StableCascadeUNet, one
class for both stages.

- Stage C (the prior): patch size 1, two 2048-wide levels that keep the
  resolution (1x1-conv scalers), every layer a resnet, a timestep block
  and an attention block; conditioned on CLIP-bigG's states and pooled
  projection and an image embedding (zeros when a job has none).
- Stage B (the decoder): patch size 2, four levels (320, 640, 1280, 1280)
  with strided-conv downscalers and transposed-conv upscalers, attention
  in the two deep levels only; conditioned on stage C's latent through
  `effnet_mapper` and on the pooled text alone.

ConvNeXt-style blocks: a depthwise conv, the family's affine-free
LayerNorm over channels at eps 1e-6, a 4x GELU MLP with a global response
norm. The attention block's keys are the normed map's tokens followed by
the mapped conditioning tokens (a length that is no tile multiple); it
runs through ops.dot_product_attention, the JAX package's
`dot_product_attention` site: the attention kernel on the card (D = 2048 /
32 = 64 for stage C, 1280 / 20 = 64 for stage B).

NCHW in `torch.channels_last` (the LayerNorms and the MLPs read the
channel-last view); diffusers' key layout: the flattened per-level block
lists (`down_blocks.1.5.attention.to_q`), `down_downscalers.1.1` (stage
B's strided conv) or `down_downscalers.1.1.blocks.0` (stage C's mapping
conv), `up_upscalers.0.1` a ConvTranspose2d, `clf.1`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dot_product_attention
from .configs import CascadeUNetConfig

LN_EPS = 1e-6


def timestep_ratio_embedding(r, dim: int, max_positions: float = 10000.0):
    """Sinusoidal features of a [0, 1] timestep ratio [B] -> [B, dim] f32
    (sin first)."""
    r = r.float() * max_positions
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=r.device)
                     * -(math.log(max_positions) / (half - 1)))
    emb = r[:, None] * freq[None]
    emb = torch.cat([emb.sin(), emb.cos()], dim=1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def layer_norm_2d(x):
    """The family's LayerNorm over the channels of an NCHW map (no affine,
    eps 1e-6), through the channel-last view."""
    return F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), eps=LN_EPS).permute(0, 3, 1, 2)


class LayerNorm2d(nn.Module):
    def forward(self, x):
        return layer_norm_2d(x)


def resize_align_corners(x, size):
    """Bilinear resize with align_corners=True (the JAX package's
    `interpolate_bilinear_align_corners`); the identity at the same size."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class GlobalResponseNorm(nn.Module):
    """ConvNeXt-v2's GRN over NHWC: the spatial L2 norm of each channel
    over its mean across channels, statistics in f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):
        agg = x.float().square().sum(dim=(1, 2), keepdim=True).sqrt()
        stand = (agg / (agg.mean(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
        return self.gamma * (x * stand) + self.beta + x


class CascadeResBlock(nn.Module):
    """depthwise conv -> LN -> [skip concatenated] -> Linear(4c) GELU GRN
    Linear, residual."""

    def __init__(self, channels: int, c_skip: int = 0, kernel_size: int = 3):
        super().__init__()
        self.depthwise = nn.Conv2d(channels, channels, kernel_size, padding=kernel_size // 2,
                                   groups=channels)
        self.norm = LayerNorm2d()
        self.channelwise = nn.Sequential(
            nn.Linear(channels + c_skip, channels * 4), nn.GELU(),
            GlobalResponseNorm(channels * 4), nn.Dropout(0.0), nn.Linear(channels * 4, channels))

    def forward(self, x, x_skip=None):
        h = self.norm(self.depthwise(x))
        if x_skip is not None:
            h = torch.cat([h, x_skip.to(h.dtype)], dim=1)
        h = self.channelwise(h.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return h + x


class CascadeTimestepBlock(nn.Module):
    """x * (1 + a) + b, (a, b) summed over a Linear of each chunk of the
    timestep-ratio embedding."""

    def __init__(self, channels: int, t_dim: int, conds=()):
        super().__init__()
        self.conds = tuple(conds)
        self.mapper = nn.Linear(t_dim, channels * 2)
        for name in self.conds:
            setattr(self, f"mapper_{name}", nn.Linear(t_dim, channels * 2))

    def forward(self, x, t):
        t = t.chunk(len(self.conds) + 1, dim=1)
        a, b = self.mapper(t[0]).chunk(2, dim=1)
        for i, name in enumerate(self.conds):
            ac, bc = getattr(self, f"mapper_{name}")(t[i + 1]).chunk(2, dim=1)
            a, b = a + ac, b + bc
        return x * (1 + a[:, :, None, None]) + b[:, :, None, None]


class CascadeAttention(nn.Module):
    """diffusers' Attention with biased projections (to_q, to_k, to_v,
    to_out.0); the heads go to ops.dot_product_attention as [B, S, H, D]."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, hidden, context):
        b, sq, c = hidden.shape
        sk, d = context.shape[1], c // self.heads
        q = self.to_q(hidden).view(b, sq, self.heads, d)
        k = self.to_k(context).view(b, sk, self.heads, d)
        v = self.to_v(context).view(b, sk, self.heads, d)
        return self.to_out[0](dot_product_attention(q, k, v).reshape(b, sq, c))


class CascadeAttnBlock(nn.Module):
    """LN -> attention whose keys are the map's tokens (self_attn) followed
    by the conditioning mapped through SiLU + Linear, residual."""

    def __init__(self, channels: int, c_cond: int, heads: int, self_attn: bool = True):
        super().__init__()
        self.self_attn = self_attn
        self.norm = LayerNorm2d()
        self.attention = CascadeAttention(channels, heads)
        self.kv_mapper = nn.Sequential(nn.SiLU(), nn.Linear(c_cond, channels))

    def forward(self, x, kv):
        b, c, h, w = x.shape
        kv = self.kv_mapper(kv)
        tokens = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        if self.self_attn:
            kv = torch.cat([tokens, kv.to(tokens.dtype)], dim=1)
        out = self.attention(tokens, kv)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _Resize(nn.Module):
    """The parameterless interpolation slot of UpDownBlock2d."""

    def __init__(self, scale: float, enabled: bool):
        super().__init__()
        self.scale, self.enabled = scale, enabled

    def forward(self, x):
        if not self.enabled:
            return x
        h, w = x.shape[-2:]
        return resize_align_corners(x, (int(h * self.scale), int(w * self.scale)))


class UpDownBlock2d(nn.Module):
    """Stage C's scaler: a 1x1 mapping conv after (down) or before (up) a
    bilinear rescale where the level switches, identity otherwise."""

    def __init__(self, in_channels: int, out_channels: int, mode: str, enabled: bool):
        super().__init__()
        resize = _Resize(2.0 if mode == "up" else 0.5, enabled)
        mapping = nn.Conv2d(in_channels, out_channels, 1)
        self.blocks = nn.ModuleList([resize, mapping] if mode == "up" else [mapping, resize])

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class StableCascadeUNet(nn.Module):
    def __init__(self, config: CascadeUNetConfig):
        super().__init__()
        cfg = self.config = config
        c0, levels = cfg.block_out_channels[0], len(cfg.block_out_channels)
        self.clip_txt_pooled_mapper = nn.Linear(cfg.clip_text_pooled_in_channels,
                                                cfg.conditioning_dim * cfg.clip_seq)
        if cfg.clip_text_in_channels:
            self.clip_txt_mapper = nn.Linear(cfg.clip_text_in_channels, cfg.conditioning_dim)
        if cfg.clip_image_in_channels:
            self.clip_img_mapper = nn.Linear(cfg.clip_image_in_channels,
                                             cfg.conditioning_dim * cfg.clip_seq)
        self.embedding = nn.Sequential(
            nn.PixelUnshuffle(cfg.patch_size),
            nn.Conv2d(cfg.in_channels * cfg.patch_size ** 2, c0, 1), LayerNorm2d())

        def mapper(c_in):
            return nn.Sequential(nn.Conv2d(c_in, c0 * 4, 1), nn.GELU(), nn.Conv2d(c0 * 4, c0, 1),
                                 LayerNorm2d())

        if cfg.effnet_in_channels:
            self.effnet_mapper = mapper(cfg.effnet_in_channels)
        if cfg.pixel_mapper_in_channels:
            self.pixels_mapper = mapper(cfg.pixel_mapper_in_channels)

        def level(i: int, n_layers: int, c_skip: int) -> nn.ModuleList:
            ch, blocks = cfg.block_out_channels[i], nn.ModuleList()
            for layer in range(n_layers):
                blocks.append(CascadeResBlock(ch, c_skip if layer == 0 else 0, cfg.kernel_size))
                blocks.append(CascadeTimestepBlock(ch, cfg.timestep_ratio_embedding_dim,
                                                   cfg.timestep_conditioning_type))
                if cfg.attention[i]:
                    blocks.append(CascadeAttnBlock(ch, cfg.conditioning_dim,
                                                   cfg.num_attention_heads[i], cfg.self_attn))
            return blocks

        def repeat_mappers(i: int, n: int) -> nn.ModuleList:
            ch = cfg.block_out_channels[i]
            return nn.ModuleList([nn.Conv2d(ch, ch, 1) for _ in range(n - 1)])

        self.down_blocks, self.down_downscalers = nn.ModuleList(), nn.ModuleList()
        self.down_repeat_mappers = nn.ModuleList()
        for i in range(levels):
            if i:
                c_in, c_out = cfg.block_out_channels[i - 1], cfg.block_out_channels[i]
                scaler = (UpDownBlock2d(c_in, c_out, "down", cfg.switch_level[i - 1])
                          if cfg.switch_level is not None else nn.Conv2d(c_in, c_out, 2, stride=2))
                self.down_downscalers.append(nn.Sequential(LayerNorm2d(), scaler))
            else:
                self.down_downscalers.append(nn.Identity())
            self.down_blocks.append(level(i, cfg.down_num_layers_per_block[i], 0))
            self.down_repeat_mappers.append(repeat_mappers(i, cfg.down_blocks_repeat_mappers[i]))
        self.up_blocks, self.up_upscalers = nn.ModuleList(), nn.ModuleList()
        self.up_repeat_mappers = nn.ModuleList()
        for j in range(levels):
            i = levels - 1 - j
            self.up_blocks.append(level(i, cfg.up_num_layers_per_block[j],
                                        cfg.block_out_channels[i] if j else 0))
            if i:
                c_in, c_out = cfg.block_out_channels[i], cfg.block_out_channels[i - 1]
                scaler = (UpDownBlock2d(c_in, c_out, "up", cfg.switch_level[i - 1])
                          if cfg.switch_level is not None
                          else nn.ConvTranspose2d(c_in, c_out, 2, stride=2))
                self.up_upscalers.append(nn.Sequential(LayerNorm2d(), scaler))
            else:
                self.up_upscalers.append(nn.Identity())
            self.up_repeat_mappers.append(repeat_mappers(i, cfg.up_blocks_repeat_mappers[j]))
        self.clf = nn.Sequential(LayerNorm2d(), nn.Conv2d(c0, cfg.out_channels
                                                          * cfg.patch_size ** 2, 1),
                                 nn.PixelShuffle(cfg.patch_size))

    def _run(self, blocks, x, t_embed, clip, skip=None):
        first = True
        for block in blocks:
            if isinstance(block, CascadeResBlock):
                s = skip if first else None
                if s is not None:
                    x = resize_align_corners(x, s.shape[-2:])
                x = block(x, s)
                first = False
            elif isinstance(block, CascadeTimestepBlock):
                x = block(x, t_embed)
            else:
                x = block(x, clip)
        return x

    def forward(self, sample, timestep_ratio, clip_text_pooled, clip_text=None, clip_img=None,
                effnet=None, pixels=None):
        """sample [B, C, H, W], the ratios [B], the pooled text [B, S_p,
        pooled_in]; stage C: clip_text [B, S, text_in], clip_img [B, S_i,
        img_in] (zeros unset); stage B: effnet [B, 16, h, w], pixels [B, 3,
        8, 8] (zeros unset) -> [B, out_channels, H, W]."""
        cfg = self.config
        dtype = self.embedding[1].weight.dtype
        b = sample.shape[0]
        t_embed = timestep_ratio_embedding(timestep_ratio, cfg.timestep_ratio_embedding_dim)
        zero = timestep_ratio_embedding(torch.zeros_like(timestep_ratio),
                                        cfg.timestep_ratio_embedding_dim)
        t_embed = torch.cat([t_embed] + [zero] * len(cfg.timestep_conditioning_type),
                            dim=1).to(dtype)
        clip = self.clip_txt_pooled_mapper(clip_text_pooled.to(dtype)).reshape(
            b, -1, cfg.conditioning_dim)
        if cfg.clip_text_in_channels and clip_text is not None:
            pieces = [self.clip_txt_mapper(clip_text.to(dtype))]
            if cfg.clip_image_in_channels:
                if clip_img is None:
                    clip_img = torch.zeros((b, 1, cfg.clip_image_in_channels),
                                           device=sample.device, dtype=dtype)
                pieces.append(self.clip_img_mapper(clip_img.to(dtype)).reshape(
                    b, -1, cfg.conditioning_dim))
            clip = torch.cat(pieces + [clip], dim=1)
        clip = F.layer_norm(clip, (cfg.conditioning_dim,), eps=LN_EPS)

        x = self.embedding(sample.to(dtype).contiguous(memory_format=torch.channels_last))
        if cfg.effnet_in_channels and effnet is not None:
            x = x + self.effnet_mapper(resize_align_corners(effnet.to(dtype), x.shape[-2:]))
        if cfg.pixel_mapper_in_channels:
            if pixels is None:
                pixels = torch.zeros((b, cfg.pixel_mapper_in_channels, 8, 8),
                                     device=sample.device, dtype=dtype)
            x = x + resize_align_corners(self.pixels_mapper(pixels.to(dtype)), x.shape[-2:])

        level_outputs = []
        for blocks, scaler, repmap in zip(self.down_blocks, self.down_downscalers,
                                          self.down_repeat_mappers):
            x = scaler(x)
            for r in range(len(repmap) + 1):
                x = self._run(blocks, x, t_embed, clip)
                if r < len(repmap):
                    x = repmap[r](x)
            level_outputs.insert(0, x)
        x = level_outputs[0]
        for j, (blocks, scaler, repmap) in enumerate(zip(self.up_blocks, self.up_upscalers,
                                                         self.up_repeat_mappers)):
            skip = level_outputs[j] if j else None
            for r in range(len(repmap) + 1):
                x = self._run(blocks, x, t_embed, clip, skip)
                if r < len(repmap):
                    x = repmap[r](x)
            x = scaler(x)
        return self.clf(x)
