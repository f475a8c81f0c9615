"""The Paella VQ decoder (torch.nn), Stable Cascade's stage A: the
counterpart of chiaswarm_tpu/models/paella_vq.py.

Serving only decodes (diffusers' PaellaVQModel.decode without the
quantizer), so this is the up path alone: a 1x1 conv from the latent
channels, mixing residual blocks (bottleneck_blocks at the deep level,
one at each level above), a transposed conv (kernel 4, stride 2, padding
1) between levels, then a 1x1 conv and a pixel shuffle: 4x the latent's
side overall. The latents arrive already divided by the scale factor, as
diffusers' decode takes them.

LayerNorms and convs only: no kernel of the port runs here. diffusers'
key layout (`up_blocks.0.0`, `up_blocks.N.depthwise.1`, `.channelwise.0`,
`.gammas`, `out_block.0`); weights.py drops the encoder's and the
quantizer's keys of a published file.
"""

from __future__ import annotations

import torch
from torch import nn

from .cascade_unet import LayerNorm2d
from .configs import PaellaVQConfig


class MixingResidualBlock(nn.Module):
    """LN-modulated depthwise conv (edge-padded 3x3) and channel MLP, each
    branch gated by two of six learned gammas."""

    def __init__(self, channels: int, embed_dim: int):
        super().__init__()
        self.norm1 = LayerNorm2d()
        self.depthwise = nn.Sequential(nn.ReplicationPad2d(1),
                                       nn.Conv2d(channels, channels, 3, groups=channels))
        self.norm2 = LayerNorm2d()
        self.channelwise = nn.Sequential(nn.Linear(channels, embed_dim), nn.GELU(),
                                         nn.Linear(embed_dim, channels))
        self.gammas = nn.Parameter(torch.zeros(6))

    def forward(self, x):
        mods = self.gammas.to(x.dtype)
        h = self.norm1(x) * (1 + mods[0]) + mods[1]
        x = x + self.depthwise(h) * mods[2]
        h = self.norm2(x) * (1 + mods[3]) + mods[4]
        h = self.channelwise(h.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + h * mods[5]


class PaellaVQDecoder(nn.Module):
    def __init__(self, config: PaellaVQConfig):
        super().__init__()
        cfg = self.config = config
        c = cfg.c_levels()
        blocks = [nn.Sequential(nn.Conv2d(cfg.latent_channels, c[-1], 1))]
        for i in range(cfg.levels):
            ch = c[cfg.levels - 1 - i]
            blocks += [MixingResidualBlock(ch, ch * 4)
                       for _ in range(cfg.bottleneck_blocks if i == 0 else 1)]
            if i < cfg.levels - 1:
                blocks.append(nn.ConvTranspose2d(ch, c[cfg.levels - 2 - i], 4, stride=2,
                                                 padding=1))
        self.up_blocks = nn.Sequential(*blocks)
        self.out_block = nn.Sequential(
            nn.Conv2d(c[0], cfg.out_channels * cfg.up_down_scale_factor ** 2, 1),
            nn.PixelShuffle(cfg.up_down_scale_factor))

    def forward(self, latents):
        """[B, latent_channels, h, w] -> [B, 3, 4h, 4w] in about [0, 1]."""
        x = latents.to(self.out_block[0].weight.dtype)
        return self.out_block(self.up_blocks(x.contiguous(memory_format=torch.channels_last)))
