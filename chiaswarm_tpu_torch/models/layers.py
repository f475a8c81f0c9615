"""Shared diffusion building blocks (torch.nn), the counterparts of
chiaswarm_tpu/models/layers.py.

Layout: image activations are NCHW tensors kept in `torch.channels_last`
memory, which is NHWC in memory. The GroupNorm kernel reads channel-last
rows, so `x.permute(0, 2, 3, 1)` hands it a free contiguous view and no
copy sits around the ~100 GroupNorm calls of an SDXL UNet step; the
transformer's [B, H*W, C] tokens are a view of the same memory. cuDNN's
convolutions keep channels_last in and out.

Parameter names are diffusers' (`to_out.0`, `ff.net.0.proj`, ...), so a
diffusers state dict loads as it is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dot_product_attention, group_norm


class FusedGroupNorm(nn.Module):
    """nn.GroupNorm over an NCHW (channels_last) tensor, with an optionally
    fused SiLU, through ops.group_norm (the kernel on the card, the plain
    version on the CPU). Parameters `weight`/`bias` as nn.GroupNorm."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 act: str | None = None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        # a no-op for channels_last activations, which every producer in
        # the UNet and the VAE already returns
        x = x.contiguous(memory_format=torch.channels_last)
        y = group_norm(x.permute(0, 2, 3, 1), self.weight, self.bias,
                       groups=self.num_groups, eps=self.eps, act=self.act)
        return y.permute(0, 3, 1, 2)


def timestep_embedding(timesteps, dim: int, *, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0):
    """Sinusoidal timestep features [B] -> [B, dim] f32 (cos first)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    args = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class TimestepEmbedding(nn.Module):
    """2-layer MLP lifting sinusoidal features to the UNet's temb width."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    """GN+SiLU -> conv -> (+ temb) -> GN+SiLU -> conv, plus the shortcut.
    diffusers: UNet resnets norm at eps 1e-5, VAE resnets at 1e-6."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_dim: int | None = None, eps: float = 1e-5):
        super().__init__()
        self.norm1 = FusedGroupNorm(in_channels, 32, eps, act="silu")
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels) if temb_dim else None
        self.norm2 = FusedGroupNorm(out_channels, 32, eps, act="silu")
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return h + x


class Attention(nn.Module):
    """Multi-head attention over [B, S, C] with optional cross context;
    the heads go to ops.dot_product_attention as [B, S, H, D] views."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 cross_dim: int | None = None, out_dim: int | None = None):
        super().__init__()
        inner = num_heads * head_dim
        cross_dim = cross_dim or query_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(cross_dim, inner, bias=False)
        self.to_v = nn.Linear(cross_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, out_dim or query_dim)])

    def forward(self, hidden, context=None):
        context = hidden if context is None else context
        b, sq, _ = hidden.shape
        sk = context.shape[1]
        heads = (self.num_heads, self.head_dim)
        q = self.to_q(hidden).view(b, sq, *heads)
        k = self.to_k(context).view(b, sk, *heads)
        v = self.to_v(context).view(b, sk, *heads)
        out = dot_product_attention(q, k, v).reshape(b, sq, -1)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # erf gelu, diffusers parity


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # index 1 is diffusers' dropout slot, kept so the keys line up
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU MLP, pre-LN residual wiring."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, cross_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, head_dim, cross_dim=cross_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, hidden, context):
        hidden = hidden + self.attn1(self.norm1(hidden))
        hidden = hidden + self.attn2(self.norm2(hidden), context)
        return hidden + self.ff(self.norm3(hidden))


class Transformer2DModel(nn.Module):
    """Spatial transformer with linear projections (SDXL layout):
    NCHW -> [B, H*W, C] tokens -> N blocks -> NCHW residual."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 num_layers: int, cross_dim: int):
        super().__init__()
        self.norm = FusedGroupNorm(channels, 32, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, num_heads, head_dim, cross_dim)
             for _ in range(num_layers)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context):
        b, c, h, w = x.shape
        hidden = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        hidden = self.proj_in(hidden)
        for block in self.transformer_blocks:
            hidden = block(hidden, context)
        hidden = self.proj_out(hidden)
        return hidden.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
