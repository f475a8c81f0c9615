"""Conditional UNet2D of the SD family (torch.nn), the counterpart of
chiaswarm_tpu/models/unet2d.py, including SDXL's `addition_embed` branch
(pooled text embeds + size/crop time ids) and the residuals of a
ControlNet (controlnet.py).

NCHW in and out, activations in `torch.channels_last` (see layers.py);
diffusers' UNet2DConditionModel key layout.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .layers import (
    Downsample2D,
    FusedGroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2DModel,
    Upsample2D,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    # per down block: number of transformer layers; 0 = plain ResNet block
    transformer_layers: tuple[int, ...] = (1, 1, 1, 0)
    mid_transformer_layers: int = 1
    layers_per_block: int = 2
    # per-block head COUNT (HF configs misname it `attention_head_dim`)
    num_attention_heads: int | tuple[int, ...] = 8
    # SDXL additional conditioning: pooled text embeds + time-id features
    addition_embed_dim: int = 0  # 0 = disabled
    addition_time_embed_dim: int = 256
    cross_attention_dim: int = 768
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    def heads_per_block(self) -> tuple[int, ...]:
        if isinstance(self.num_attention_heads, int):
            return (self.num_attention_heads,) * len(self.block_out_channels)
        return tuple(self.num_attention_heads)


class DownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, layers: int,
                 n_transformer: int, heads: int, cross_dim: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, temb_dim)
             for i in range(layers)])
        self.attentions = nn.ModuleList(
            [Transformer2DModel(out_ch, heads, out_ch // heads, n_transformer, cross_dim)
             for _ in range(layers)]) if n_transformer else None
        self.downsamplers = (nn.ModuleList([Downsample2D(out_ch)])
                             if add_downsample else None)

    def forward(self, x, temb, context):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UpBlock(nn.Module):
    def __init__(self, prev_ch: int, skip_chs: list[int], out_ch: int, temb_dim: int,
                 n_transformer: int, heads: int, cross_dim: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList()
        ch = prev_ch
        for skip in skip_chs:
            self.resnets.append(ResnetBlock2D(ch + skip, out_ch, temb_dim))
            ch = out_ch
        self.attentions = nn.ModuleList(
            [Transformer2DModel(out_ch, heads, out_ch // heads, n_transformer, cross_dim)
             for _ in skip_chs]) if n_transformer else None
        self.upsamplers = (nn.ModuleList([Upsample2D(out_ch)])
                           if add_upsample else None)

    def forward(self, x, skips, temb, context):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, ch: int, temb_dim: int, n_transformer: int, heads: int,
                 cross_dim: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, temb_dim), ResnetBlock2D(ch, ch, temb_dim)])
        self.attentions = nn.ModuleList(
            [Transformer2DModel(ch, heads, ch // heads, n_transformer, cross_dim)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNet2DConfig):
        super().__init__()
        self.config = cfg = config
        blocks = cfg.block_out_channels
        temb_dim = blocks[0] * 4
        heads = cfg.heads_per_block()
        cross = cfg.cross_attention_dim
        self.time_embedding = TimestepEmbedding(blocks[0], temb_dim)
        self.add_embedding = (TimestepEmbedding(cfg.addition_embed_dim, temb_dim)
                              if cfg.addition_embed_dim else None)
        self.conv_in = nn.Conv2d(cfg.in_channels, blocks[0], 3, padding=1)

        self.down_blocks = nn.ModuleList()
        skip_chs = [blocks[0]]
        ch = blocks[0]
        for b, out_ch in enumerate(blocks):
            last = b == len(blocks) - 1
            self.down_blocks.append(DownBlock(
                ch, out_ch, temb_dim, cfg.layers_per_block, cfg.transformer_layers[b],
                heads[b], cross, add_downsample=not last))
            skip_chs += [out_ch] * (cfg.layers_per_block + (0 if last else 1))
            ch = out_ch

        self.mid_block = MidBlock(blocks[-1], temb_dim, cfg.mid_transformer_layers,
                                  heads[-1], cross)

        self.up_blocks = nn.ModuleList()
        for b, out_ch in enumerate(reversed(blocks)):
            rev = len(blocks) - 1 - b
            last = b == len(blocks) - 1
            block_skips = [skip_chs.pop() for _ in range(cfg.layers_per_block + 1)]
            self.up_blocks.append(UpBlock(
                ch, block_skips, out_ch, temb_dim, cfg.transformer_layers[rev],
                heads[rev], cross, add_upsample=not last))
            ch = out_ch

        self.conv_norm_out = FusedGroupNorm(blocks[0], 32, 1e-5, act="silu")
        self.conv_out = nn.Conv2d(blocks[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states, added_cond=None,
                down_residuals=None, mid_residual=None):
        """sample [B, C_in, H, W]; timesteps [B] or scalar; context
        [B, S, cross_attention_dim]; SDXL added_cond {"text_embeds":
        [B, P], "time_ids": [B, 6]}; a ControlNet's `down_residuals` (one
        per skip, added to it) and `mid_residual` (added after the mid
        block). -> [B, C_out, H, W]."""
        cfg = self.config
        dtype = sample.dtype
        b = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(b)
        t_feat = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                    flip_sin_to_cos=cfg.flip_sin_to_cos,
                                    downscale_freq_shift=cfg.freq_shift)
        temb = self.time_embedding(t_feat.to(dtype))
        if self.add_embedding is not None:
            tid = timestep_embedding(added_cond["time_ids"].reshape(-1),
                                     cfg.addition_time_embed_dim,
                                     flip_sin_to_cos=cfg.flip_sin_to_cos,
                                     downscale_freq_shift=cfg.freq_shift)
            add_feat = torch.cat([added_cond["text_embeds"].to(dtype),
                                  tid.to(dtype).reshape(b, -1)], dim=-1)
            temb = temb + self.add_embedding(add_feat)

        x = self.conv_in(sample)
        skips = [x]
        for block in self.down_blocks:
            x, block_skips = block(x, temb, encoder_hidden_states)
            skips.extend(block_skips)
        if down_residuals is not None:
            skips = [s + r for s, r in zip(skips, down_residuals, strict=True)]
        x = self.mid_block(x, temb, encoder_hidden_states)
        if mid_residual is not None:
            x = x + mid_residual
        for block in self.up_blocks:
            x = block(x, skips, temb, encoder_hidden_states)
        return self.conv_out(self.conv_norm_out(x))
