"""ControlNet (Zhang et al.): the counterpart of
chiaswarm_tpu/models/controlnet.py.

A copy of the UNet's time embedding, input conv, down blocks and mid
block, built from the UNet's own config on the port's `DownBlock` and
`MidBlock` (unet2d.py), so its attention and GroupNorm run the same
kernels at the UNet's shapes. The control image is embedded by a small
conv stack and added after the input conv; each skip and the mid block's
output leave through a 1x1 "zero conv", scaled by `conditioning_scale`,
as residuals that the UNet adds to its skips and its mid block
(UNet2DConditionModel.forward's `down_residuals`, `mid_residual`).

Diffusers' ControlNetModel key layout, so a published checkpoint loads
without conversion: `controlnet_cond_embedding.{conv_in, blocks.N,
conv_out}`, `controlnet_down_blocks.N`, `controlnet_mid_block`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import TimestepEmbedding, timestep_embedding
from .unet2d import DownBlock, MidBlock, UNet2DConfig


def cond_channels(downscale: int) -> tuple[int, ...]:
    """The conditioning embedding's channel ramp: 16 -> 32 -> 96 -> 256 for
    the SD family's factor 8, truncated for the tiny VAEs' smaller factors
    (one stride-2 stage per factor of two, at least one)."""
    n_down = max((downscale - 1).bit_length(), 1)
    return ((16, 32, 96, 256) * 2)[: n_down + 1]


class ControlNetConditioningEmbedding(nn.Module):
    """Control image [B, 3, H, W] in [0, 1] -> features [B, C, H/f, W/f]."""

    def __init__(self, out_channels: int, downscale: int = 8):
        super().__init__()
        chs = cond_channels(downscale)
        self.conv_in = nn.Conv2d(3, chs[0], 3, padding=1)
        self.blocks = nn.ModuleList()
        for c_in, c_out in zip(chs[:-1], chs[1:]):
            self.blocks.append(nn.Conv2d(c_in, c_in, 3, padding=1))
            self.blocks.append(nn.Conv2d(c_in, c_out, 3, padding=1, stride=2))
        self.conv_out = nn.Conv2d(chs[-1], out_channels, 3, padding=1)

    def forward(self, cond):
        x = F.silu(self.conv_in(cond))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)


class ControlNetModel(nn.Module):
    def __init__(self, config: UNet2DConfig, cond_downscale: int = 8):
        """`cond_downscale`: the paired VAE's spatial factor."""
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
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(blocks[0],
                                                                         cond_downscale)
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
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in skip_chs])
        self.controlnet_mid_block = nn.Conv2d(blocks[-1], blocks[-1], 1)

    def zero_residual_convs_(self) -> None:
        """Zero the conditioning embedding's output conv and every residual
        conv: the branch then adds exact zeros (a no-op on the UNet), as
        a freshly initialised ControlNet does."""
        with torch.no_grad():
            for conv in (self.controlnet_cond_embedding.conv_out, *self.controlnet_down_blocks,
                         self.controlnet_mid_block):
                conv.weight.zero_()
                conv.bias.zero_()

    def forward(self, sample, timesteps, encoder_hidden_states, controlnet_cond,
                conditioning_scale: float = 1.0, added_cond=None):
        """sample [B, C_in, H, W] (the UNet's input rows); controlnet_cond
        [B, 3, H*f, W*f]; SDXL added_cond as the UNet's (the addition
        embedding runs only when it is given, as in the JAX module). ->
        (per-skip residuals, mid residual)."""
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
        if self.add_embedding is not None and added_cond is not None:
            tid = timestep_embedding(added_cond["time_ids"].reshape(-1),
                                     cfg.addition_time_embed_dim,
                                     flip_sin_to_cos=cfg.flip_sin_to_cos,
                                     downscale_freq_shift=cfg.freq_shift)
            add_feat = torch.cat([added_cond["text_embeds"].to(dtype),
                                  tid.to(dtype).reshape(b, -1)], dim=-1)
            temb = temb + self.add_embedding(add_feat)

        x = self.conv_in(sample) + self.controlnet_cond_embedding(controlnet_cond)
        skips = [x]
        for block in self.down_blocks:
            x, block_skips = block(x, temb, encoder_hidden_states)
            skips.extend(block_skips)
        x = self.mid_block(x, temb, encoder_hidden_states)
        down = [conv(s) for conv, s in zip(self.controlnet_down_blocks, skips)]
        mid = self.controlnet_mid_block(x)
        if conditioning_scale != 1.0:
            # a scale of 1 multiplies by one, which changes no bit
            down = [r * conditioning_scale for r in down]
            mid = mid * conditioning_scale
        return down, mid
