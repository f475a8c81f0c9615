"""AutoencoderKL decoder path (torch.nn), the counterpart of
chiaswarm_tpu/models/vae.py: post-quant conv, mid-block resnets and
single-head attention, up blocks, output norm and conv. NCHW in
`torch.channels_last` (see layers.py); diffusers' key layout. The encoder
(img2img, inpaint) is not ported yet.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from ..ops import dot_product_attention
from .layers import FusedGroupNorm, ResnetBlock2D, Upsample2D


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215  # 0.13025 for SDXL
    shift_factor: float = 0.0
    use_quant_conv: bool = True


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block; head dim is
    the channel count (512 for SD/SDXL)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = FusedGroupNorm(channels, 32, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        hidden = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = self.to_q(hidden)[:, :, None, :]
        k = self.to_k(hidden)[:, :, None, :]
        v = self.to_v(hidden)[:, :, None, :]
        out = self.to_out[0](dot_product_attention(q, k, v)[:, :, 0, :])
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, eps=1e-6), ResnetBlock2D(ch, ch, eps=1e-6)])
        self.attentions = nn.ModuleList([VAEAttention(ch)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, eps=1e-6)
             for i in range(layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_ch)])
                           if add_upsample else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        blocks = config.block_out_channels
        mid_ch = blocks[-1]
        self.conv_in = nn.Conv2d(config.latent_channels, mid_ch, 3, padding=1)
        self.mid_block = MidBlock(mid_ch)
        self.up_blocks = nn.ModuleList()
        ch = mid_ch
        for b, out_ch in enumerate(reversed(blocks)):
            self.up_blocks.append(UpBlock(ch, out_ch, config.layers_per_block + 1,
                                          add_upsample=b != len(blocks) - 1))
            ch = out_ch
        self.conv_norm_out = FusedGroupNorm(blocks[0], 32, 1e-6, act="silu")
        self.conv_out = nn.Conv2d(blocks[0], config.in_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """The decoding half: scaled latents [B, C, h, w] -> pixels
    [B, 3, 8h, 8w] in [-1, 1]."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = (nn.Conv2d(config.latent_channels, config.latent_channels, 1)
                                if config.use_quant_conv else nn.Identity())

    def decode(self, latents):
        latents = latents / self.config.scaling_factor + self.config.shift_factor
        return self.decoder(self.post_quant_conv(latents))

    def forward(self, latents):
        return self.decode(latents)
