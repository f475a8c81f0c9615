"""MoVQ image codec (torch.nn), the counterpart of
chiaswarm_tpu/models/movq.py: diffusers' `VQModel` with
`norm_type="spatial"`, Kandinsky 2.x's pixel stage (and Kandinsky 3's).

Serving never runs the vector quantizer: diffusion latents are continuous,
so `decode` maps latents -> `post_quant_conv` -> a decoder whose every norm
is a SpatialNorm conditioned on the latents themselves (GroupNorm modulated
by 1x1 convs of the latent map, nearest-upsampled to the feature's size),
and `encode` (img2img) is the encoder and `quant_conv`, no sampling. The
codebook (`quantize.embedding`) is not part of the module; the loader
drops it.

NCHW in `torch.channels_last`; every GroupNorm (eps 1e-6) goes through
ops.group_norm, the mid attention (one head of the block's width, D = 512
at the published geometry) through ops.dot_product_attention. diffusers'
key layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dot_product_attention
from .configs import MoVQConfig
from .layers import FusedGroupNorm


class SpatialNorm(nn.Module):
    """GroupNorm whose scale and shift are 1x1 convs of the latent map
    `zq`, upsampled by nearest to the feature's size (integer factors)."""

    def __init__(self, channels: int, zq_channels: int, groups: int = 32):
        super().__init__()
        self.norm_layer = FusedGroupNorm(channels, groups, 1e-6)
        self.conv_y = nn.Conv2d(zq_channels, channels, 1)
        self.conv_b = nn.Conv2d(zq_channels, channels, 1)

    def forward(self, f, zq):
        if zq.shape[-2:] != f.shape[-2:]:
            zq = F.interpolate(zq, size=f.shape[-2:], mode="nearest")
        zq = zq.contiguous(memory_format=torch.channels_last)
        return self.norm_layer(f) * self.conv_y(zq) + self.conv_b(zq)


class VQResnet(nn.Module):
    """norm -> SiLU -> conv, twice, plus the shortcut (no temb); `zq_channels`
    swaps both norms for SpatialNorm (the decoder side)."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 zq_channels: int | None = None):
        super().__init__()
        self.spatial = zq_channels is not None
        if self.spatial:
            self.norm1 = SpatialNorm(in_channels, zq_channels, groups)
            self.norm2 = SpatialNorm(out_channels, zq_channels, groups)
        else:
            self.norm1 = FusedGroupNorm(in_channels, groups, 1e-6, act="silu")
            self.norm2 = FusedGroupNorm(out_channels, groups, 1e-6, act="silu")
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def _norm(self, norm, x, zq):
        return F.silu(norm(x, zq)) if self.spatial else norm(x)

    def forward(self, x, zq=None):
        h = self.conv1(self._norm(self.norm1, x, zq))
        h = self.conv2(self._norm(self.norm2, h, zq))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VQAttention(nn.Module):
    """Single-head mid attention over the block's channels; SpatialNorm on
    the decoder side, GroupNorm on the encoder's."""

    def __init__(self, channels: int, groups: int = 32, zq_channels: int | None = None):
        super().__init__()
        if zq_channels is not None:
            self.spatial_norm = SpatialNorm(channels, zq_channels, groups)
        else:
            self.group_norm = FusedGroupNorm(channels, groups, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x, zq=None):
        b, c, h, w = x.shape
        norm = self.spatial_norm(x, zq) if zq is not None else self.group_norm(x)
        tokens = norm.contiguous(memory_format=torch.channels_last).permute(
            0, 2, 3, 1).reshape(b, h * w, c)
        q = self.to_q(tokens)[:, :, None, :]
        k = self.to_k(tokens)[:, :, None, :]
        v = self.to_v(tokens)[:, :, None, :]
        out = self.to_out[0](dot_product_attention(q, k, v)[:, :, 0, :])
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class _Sampler(nn.Module):
    """A down- or upsampler's one conv (diffusers' `downsamplers.0.conv`)."""

    def __init__(self, channels: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(channels, channels, 3, stride=2 if down else 1,
                              padding=0 if down else 1)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))  # diffusers' (0, 1, 0, 1)
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    def __init__(self, resnets: list, sampler: _Sampler | None, down: bool):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.sampler_name = None
        if sampler is not None:
            self.sampler_name = "downsamplers" if down else "upsamplers"
            setattr(self, self.sampler_name, nn.ModuleList([sampler]))

    def forward(self, x, zq=None):
        for resnet in self.resnets:
            x = resnet(x, zq)
        if self.sampler_name is not None:
            x = getattr(self, self.sampler_name)[0](x)
        return x


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int, zq_channels: int | None):
        super().__init__()
        self.resnets = nn.ModuleList([VQResnet(ch, ch, groups, zq_channels),
                                      VQResnet(ch, ch, groups, zq_channels)])
        self.attentions = nn.ModuleList([VQAttention(ch, groups, zq_channels)])

    def forward(self, x, zq=None):
        x = self.resnets[0](x, zq)
        x = self.attentions[0](x, zq)
        return self.resnets[1](x, zq)


class MoVQEncoder(nn.Module):
    def __init__(self, cfg: MoVQConfig):
        super().__init__()
        g = cfg.norm_num_groups
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        blocks, prev = [], chans[0]
        for b, ch in enumerate(chans):
            resnets = [VQResnet(prev if i == 0 else ch, ch, g) for i in range(cfg.layers_per_block)]
            last = b == len(chans) - 1
            blocks.append(_Block(resnets, None if last else _Sampler(ch, True), True))
            prev = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(chans[-1], g, None)
        self.conv_norm_out = FusedGroupNorm(chans[-1], g, 1e-6, act="silu")
        self.conv_out = nn.Conv2d(chans[-1], cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class MoVQDecoder(nn.Module):
    def __init__(self, cfg: MoVQConfig):
        super().__init__()
        g = cfg.norm_num_groups
        zc = cfg.latent_channels
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], g, zc)
        blocks, prev = [], rev[0]
        for b, ch in enumerate(rev):
            resnets = [VQResnet(prev if i == 0 else ch, ch, g, zc)
                       for i in range(cfg.layers_per_block + 1)]
            last = b == len(rev) - 1
            blocks.append(_Block(resnets, None if last else _Sampler(ch, False), False))
            prev = ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = SpatialNorm(rev[-1], zc, g)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, x, zq):
        """x: the post_quant_conv latents; zq: the latents before it (the
        SpatialNorm conditioning, as diffusers' VQModel.decode)."""
        x = self.conv_in(x)
        x = self.mid_block(x, zq)
        for block in self.up_blocks:
            x = block(x, zq)
        return self.conv_out(F.silu(self.conv_norm_out(x, zq)))


class MoVQ(nn.Module):
    def __init__(self, cfg: MoVQConfig):
        super().__init__()
        self.config = cfg
        self.encoder = MoVQEncoder(cfg)
        self.quant_conv = nn.Conv2d(cfg.latent_channels, cfg.vq_embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.vq_embed_dim, cfg.latent_channels, 1)
        self.decoder = MoVQDecoder(cfg)

    def encode(self, pixels):
        """[B, 3, H, W] in [-1, 1] -> continuous latents [B, C, H/f, W/f]."""
        return self.quant_conv(self.encoder(pixels))

    def decode(self, latents):
        latents = latents.contiguous(memory_format=torch.channels_last)
        return self.decoder(self.post_quant_conv(latents), latents)
