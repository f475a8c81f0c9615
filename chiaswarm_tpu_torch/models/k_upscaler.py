"""The SD-x2 latent upscaler's UNet (torch.nn), the counterpart of
chiaswarm_tpu/models/k_upscaler.py: the K-diffusion upscaler graph that
diffusers serves as `UNet2DConditionModel` with K blocks.

Gaussian-Fourier time features with the 896-d conditioning projection
folded into the timestep embedding; AdaGroupNorm everywhere (an
affine-free GroupNorm of C / 32 groups whose scale and shift are a Linear
of the time embedding, per batch row); erf-gelu resnets with bias-free
shortcuts; fixed blur kernels for the down and up sampling (depthwise,
reflect-padded; the up path a stride-2 transposed convolution, which is
the reference's input-dilated convolution of the symmetric kernel);
K-attention blocks with layer-normed cross states; a 1x1 conv-in over 8
channels (noise and conditioning latents); no mid block and no output
norm; a 5-channel 1x1 conv-out, whose last channel the pipeline drops.

Skip wiring: each down level hands on its pre-downsample output; each up
level concatenates the mirrored one (the deepest concatenates the bottom
state with itself).

Attention goes through ops.dot_product_attention (the kernel on the card,
the plain version on the CPU), as every attention of a UNet in the port;
the reference computes the same softmax(QKᵀ·d^-½)·V with f32 logits
outside a kernel. AdaGroupNorm stays `F.group_norm` with the per-row
affine, as the reference computes it outside its GroupNorm kernel.
NCHW in `torch.channels_last`; diffusers' key names.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dot_product_attention


@dataclasses.dataclass(frozen=True)
class KUpscalerConfig:
    in_channels: int = 8
    out_channels: int = 5
    block_out_channels: tuple[int, ...] = (384, 768, 1280, 1280)
    layers_per_block: int = 4
    cross_attention_dim: int = 768
    attention_head_dim: int = 64
    resnet_group_size: int = 32
    time_cond_proj_dim: int = 896
    cross_attention: tuple[bool, ...] = (False, True, True, True)
    # self-attention at the bottom of the U (deepest down, deepest up)
    down_self_attention: tuple[bool, ...] = (False, False, False, True)
    up_self_attention: tuple[bool, ...] = (True, False, False, False)
    attention_bias: bool = True


TINY_K_UPSCALER = KUpscalerConfig(
    block_out_channels=(32, 64),
    layers_per_block=2,
    cross_attention_dim=32,
    attention_head_dim=8,
    resnet_group_size=16,
    # tiny CLIP pools 32 wide, plus a 16-wide fixed noise embedding
    time_cond_proj_dim=48,
    cross_attention=(False, True),
    down_self_attention=(False, True),
    up_self_attention=(True, False),
)


def _blur_kernel(scale: float, x) -> torch.Tensor:
    """The fixed 4x4 blur, one per channel of x: [C, 1, 4, 4]."""
    k1 = torch.tensor([1.0, 3.0, 3.0, 1.0], device=x.device) / 8.0 * scale
    return torch.outer(k1, k1).to(x.dtype).expand(x.shape[1], 1, 4, 4)


class KDownsample2D(nn.Module):
    """Depthwise 4x4 blur, stride 2, after a reflect pad of 1."""

    def forward(self, x):
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), _blur_kernel(1.0, x),
                        stride=2, groups=x.shape[1])


class KUpsample2D(nn.Module):
    """Depthwise transposed 4x4 blur (scale 2), stride 2, padding 3, after a
    reflect pad of 1: output twice the input."""

    def forward(self, x):
        return F.conv_transpose2d(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                                  _blur_kernel(2.0, x), stride=2, padding=3,
                                  groups=x.shape[1])


class AdaGroupNorm(nn.Module):
    """Affine-free GroupNorm, then x * (1 + scale) + shift per batch row,
    scale and shift a Linear of the time embedding."""

    def __init__(self, temb_dim: int, channels: int, groups: int):
        super().__init__()
        self.groups = groups
        self.linear = nn.Linear(temb_dim, 2 * channels)

    def forward(self, x, temb):
        scale, shift = self.linear(temb)[:, :, None, None].chunk(2, dim=1)
        return F.group_norm(x, self.groups, eps=1e-5) * (1.0 + scale) + shift


class KResnetBlock(nn.Module):
    """AdaGN -> gelu -> conv, twice; a bias-free 1x1 shortcut where the
    width changes."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, group_size: int):
        super().__init__()
        self.norm1 = AdaGroupNorm(temb_dim, in_ch, max(1, in_ch // group_size))
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = AdaGroupNorm(temb_dim, out_ch, max(1, out_ch // group_size))
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1, bias=False) if in_ch != out_ch else None

    def forward(self, x, temb):
        h = self.conv1(F.gelu(self.norm1(x, temb)))
        h = self.conv2(F.gelu(self.norm2(h, temb)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class KAttention(nn.Module):
    """diffusers' Attention as the K blocks build it: q/k/v bias (when the
    config has it), to_out.0 with bias, layer-normed cross states."""

    def __init__(self, channels: int, head_dim: int, cross_dim: int | None = None,
                 bias: bool = True):
        super().__init__()
        self.heads = max(1, channels // head_dim)
        kv_dim = cross_dim or channels
        self.norm_cross = nn.LayerNorm(kv_dim, eps=1e-5) if cross_dim else None
        self.to_q = nn.Linear(channels, channels, bias=bias)
        self.to_k = nn.Linear(kv_dim, channels, bias=bias)
        self.to_v = nn.Linear(kv_dim, channels, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, hidden, context):
        if self.norm_cross is not None:
            context = self.norm_cross(context)
        b, n, c = hidden.shape
        s = context.shape[1]
        heads = (self.heads, c // self.heads)
        q = self.to_q(hidden).view(b, n, *heads)
        k = self.to_k(context).view(b, s, *heads)
        v = self.to_v(context).view(b, s, *heads)
        return self.to_out[0](dot_product_attention(q, k, v).reshape(b, n, c))


class KAttentionBlock(nn.Module):
    """AdaGN-normed token attention: self (attn1, where configured), then
    cross (attn2) over the layer-normed encoder states, both residual."""

    def __init__(self, channels: int, temb_dim: int, head_dim: int, cross_dim: int,
                 group_size: int, self_attention: bool, bias: bool):
        super().__init__()
        groups = max(1, channels // group_size)
        if self_attention:
            self.norm1 = AdaGroupNorm(temb_dim, channels, groups)
            self.attn1 = KAttention(channels, head_dim, None, bias)
        else:
            self.norm1 = self.attn1 = None
        self.norm2 = AdaGroupNorm(temb_dim, channels, groups)
        self.attn2 = KAttention(channels, head_dim, cross_dim, bias)

    @staticmethod
    def _tokens(x):
        b, c, h, w = x.shape
        return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1).reshape(
            b, h * w, c)

    @staticmethod
    def _image(tokens, like):
        b, c, h, w = like.shape
        return tokens.reshape(b, h, w, c).permute(0, 3, 1, 2)

    def forward(self, x, temb, context):
        if self.attn1 is not None:
            tokens = self._tokens(self.norm1(x, temb))
            x = x + self._image(self.attn1(tokens, tokens), x)
        return x + self._image(self.attn2(self._tokens(self.norm2(x, temb)), context), x)


class GaussianFourierProjection(nn.Module):
    """cat(cos, sin) of 2π·t·w with a frozen weight vector (diffusers'
    `time_proj`, flip_sin_to_cos)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim), requires_grad=False)

    def forward(self, timesteps):
        args = timesteps.float()[:, None] * self.weight.float()[None, :] * (2.0 * math.pi)
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class KTimestepEmbedding(nn.Module):
    """t_emb + cond_proj(timestep_cond) -> linear_1 -> gelu -> linear_2 ->
    gelu."""

    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.cond_proj = nn.Linear(cond_dim, dim, bias=False)
        self.linear_1 = nn.Linear(dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb, cond):
        t_emb = t_emb + self.cond_proj(cond)
        return F.gelu(self.linear_2(F.gelu(self.linear_1(t_emb))))


class KBlock(nn.Module):
    """One level of the U: resnets, each followed by its attention block
    where the level has cross-attention, and the fixed resampler."""

    def __init__(self, resnets: list, attentions: list, resampler: str | None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        if resampler == "down":
            self.downsamplers = nn.ModuleList([KDownsample2D()])
        elif resampler == "up":
            self.upsamplers = nn.ModuleList([KUpsample2D()])
        self.resampler = resampler

    def forward(self, x, temb, context):
        for j, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[j](x, temb, context)
        return x

    def resample(self, x):
        if self.resampler == "down":
            return self.downsamplers[0](x)
        if self.resampler == "up":
            return self.upsamplers[0](x)
        return x


class KUpscalerUNet(nn.Module):
    """[B, 8, H, W] (noise latents, conditioning latents) + [B] continuous
    timesteps (log(σ)/4) + [B, S, cross] CLIP states + [B, cond]
    timestep condition -> [B, out_channels, H, W]."""

    def __init__(self, config: KUpscalerConfig):
        super().__init__()
        self.config = cfg = config
        widths = cfg.block_out_channels
        n, c0 = len(widths), widths[0]
        temb = 2 * c0
        self.time_proj = GaussianFourierProjection(c0)
        self.time_embedding = KTimestepEmbedding(temb, cfg.time_cond_proj_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 1)

        def attention(ch, self_attention):
            return KAttentionBlock(ch, temb, cfg.attention_head_dim, cfg.cross_attention_dim,
                                   cfg.resnet_group_size, self_attention, cfg.attention_bias)

        self.down_blocks = nn.ModuleList()
        for i, out_ch in enumerate(widths):
            in_ch = widths[i - 1] if i else c0
            resnets = [KResnetBlock(in_ch if j == 0 else out_ch, out_ch, temb,
                                    cfg.resnet_group_size) for j in range(cfg.layers_per_block)]
            attns = ([attention(out_ch, cfg.down_self_attention[i])
                      for _ in range(cfg.layers_per_block)] if cfg.cross_attention[i] else [])
            self.down_blocks.append(KBlock(resnets, attns, "down" if i != n - 1 else None))
        rev = tuple(reversed(widths))
        self.up_blocks = nn.ModuleList()
        for lvl in range(n):
            i, out_ch, k_out = n - 1 - lvl, rev[lvl], rev[min(lvl + 1, n - 1)]
            last = cfg.layers_per_block - 1
            outs = [k_out if j == last else out_ch for j in range(cfg.layers_per_block)]
            resnets = [KResnetBlock(2 * out_ch if j == 0 else out_ch, outs[j], temb,
                                    cfg.resnet_group_size) for j in range(cfg.layers_per_block)]
            attns = ([attention(outs[j], cfg.up_self_attention[lvl])
                      for j in range(cfg.layers_per_block)] if cfg.cross_attention[i] else [])
            self.up_blocks.append(KBlock(resnets, attns, "up" if lvl != n - 1 else None))
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 1)

    def forward(self, sample, timesteps, encoder_hidden_states, timestep_cond):
        dtype = self.conv_in.weight.dtype
        t_emb = self.time_proj(timesteps).to(dtype)
        temb = self.time_embedding(t_emb, timestep_cond.to(dtype))
        context = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype))
        skips = []
        for block in self.down_blocks:
            x = block(x, temb, context)
            skips.append(x)
            x = block.resample(x)
        for block in self.up_blocks:
            x = torch.cat([x, skips.pop()], dim=1)
            x = block.resample(block(x, temb, context))
        return self.conv_out(x)
