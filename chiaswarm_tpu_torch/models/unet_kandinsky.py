"""The Kandinsky 2.x decoder UNet (torch.nn), the counterpart of
chiaswarm_tpu/models/unet_kandinsky.py: diffusers' UNet2DConditionModel as
kandinsky-community/kandinsky-2-2-decoder (and -2-1) ship it.

ResnetDownsample / SimpleCrossAttn down blocks, SimpleCrossAttn mid and up
blocks, scale-shift AdaGN resnets whose down- and upsampling is inside the
resnet (average pool / nearest 2x on both branches before conv1), and
added-KV attention: the image-projection tokens' K/V come BEFORE the
spatial self K/V, so a query attends S + tokens keys. Conditioning:

- "image" (2.2): the CLIP image embedding feeds the additive time branch
  (`add_embedding.image_proj` + LayerNorm) and the cross-attention tokens
  (`encoder_hid_proj.image_embeds` + LayerNorm);
- "text_image" (2.1): `cond` is {"text_states", "text_embeds",
  "image_embeds"}; LN(text_proj(pooled text)) + image_proj(image) join the
  time branch, and the image tokens are prepended to the projected text
  states (no LayerNorm).

DeepFloyd IF's "text" mode and its `class_embed_timestep` come with the IF
slice of the port.

NCHW in `torch.channels_last`; every GroupNorm (the resnets', the
attention's on its [B, S, C] tokens, the output's with SiLU fused) goes
through ops.group_norm and the attention through ops.dot_product_attention
(D = 64 at the published geometry). diffusers' key layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dot_product_attention, group_norm
from .configs import K22UNetConfig
from .layers import FusedGroupNorm, TimestepEmbedding, timestep_embedding


class KResnetBlock(nn.Module):
    """diffusers ResnetBlock2D, time_embedding_norm="scale_shift", with the
    optional resnet-internal down (2x2 average pool) or up (nearest 2x)
    sampling of both branches before conv1."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, groups: int = 32,
                 down: bool = False, up: bool = False):
        super().__init__()
        self.down, self.up = down, up
        self.norm1 = FusedGroupNorm(in_channels, groups, 1e-5, act="silu")
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, 2 * out_channels)
        self.norm2 = FusedGroupNorm(out_channels, groups, 1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def _resample(self, x):
        if self.down:
            return F.avg_pool2d(x, 2)
        if self.up:
            return F.interpolate(x, scale_factor=2.0, mode="nearest")
        return x

    def forward(self, x, temb):
        h = self._resample(self.norm1(x))
        x = self._resample(x)
        h = self.conv1(h)
        scale, shift = self.time_emb_proj(F.silu(temb))[:, :, None, None].chunk(2, dim=1)
        h = F.silu(self.norm2(h) * (1.0 + scale) + shift)
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class KAttention(nn.Module):
    """diffusers Attention with AttnAddedKVProcessor: GroupNorm over the
    [B, S, C] tokens, the added (context) K/V concatenated before the self
    K/V, residual over the map."""

    def __init__(self, channels: int, heads: int, head_dim: int, cross_dim: int,
                 groups: int = 32):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        # its parameters; the norm runs on the [B, S, C] tokens
        self.group_norm = FusedGroupNorm(channels, groups, 1e-5)
        self.to_q = nn.Linear(channels, inner)
        self.to_k = nn.Linear(channels, inner)
        self.to_v = nn.Linear(channels, inner)
        self.add_k_proj = nn.Linear(cross_dim, inner)
        self.add_v_proj = nn.Linear(cross_dim, inner)
        self.to_out = nn.ModuleList([nn.Linear(inner, channels)])

    def forward(self, x, context):
        """x [B, C, H, W] (channels_last); context [B, N, cross_dim]."""
        b, c, h, w = x.shape
        tokens = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1).reshape(
            b, h * w, c)
        gn = self.group_norm
        norm = group_norm(tokens, gn.weight, gn.bias, groups=gn.num_groups, eps=gn.eps)
        heads = (self.heads, self.head_dim)
        q = self.to_q(norm).view(b, h * w, *heads)
        k = torch.cat([self.add_k_proj(context), self.to_k(norm)], dim=1)
        v = torch.cat([self.add_v_proj(context), self.to_v(norm)], dim=1)
        out = dot_product_attention(q, k.view(b, -1, *heads), v.view(b, -1, *heads))
        out = self.to_out[0](out.reshape(b, h * w, -1))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class _DownBlock(nn.Module):
    """`layers` resnets (each followed by attention where the level
    attends), then the resnet downsampler; a skip after each."""

    def __init__(self, cfg: K22UNetConfig, in_ch: int, out_ch: int, temb_dim: int,
                 attend: bool, add_downsample: bool):
        super().__init__()
        g = cfg.norm_num_groups
        self.resnets = nn.ModuleList([KResnetBlock(in_ch if i == 0 else out_ch, out_ch,
                                                   temb_dim, g)
                                      for i in range(cfg.layers_per_block)])
        self.attentions = nn.ModuleList(
            [KAttention(out_ch, out_ch // cfg.attention_head_dim, cfg.attention_head_dim,
                        cfg.cross_attention_dim, g) for _ in range(cfg.layers_per_block)]
            if attend else [])
        self.downsamplers = nn.ModuleList(
            [KResnetBlock(out_ch, out_ch, temb_dim, g, down=True)] if add_downsample else [])

    def forward(self, x, temb, ctx):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if len(self.attentions):
                x = self.attentions[i](x, ctx)
            skips.append(x)
        for down in self.downsamplers:
            x = down(x, temb)
            skips.append(x)
        return x, skips


class _UpBlock(nn.Module):
    def __init__(self, cfg: K22UNetConfig, in_chs: list[int], out_ch: int, temb_dim: int,
                 attend: bool, add_upsample: bool):
        super().__init__()
        g = cfg.norm_num_groups
        self.resnets = nn.ModuleList([KResnetBlock(c, out_ch, temb_dim, g) for c in in_chs])
        self.attentions = nn.ModuleList(
            [KAttention(out_ch, out_ch // cfg.attention_head_dim, cfg.attention_head_dim,
                        cfg.cross_attention_dim, g) for _ in in_chs] if attend else [])
        self.upsamplers = nn.ModuleList(
            [KResnetBlock(out_ch, out_ch, temb_dim, g, up=True)] if add_upsample else [])

    def forward(self, x, skips, temb, ctx):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
            if len(self.attentions):
                x = self.attentions[i](x, ctx)
        for up in self.upsamplers:
            x = up(x, temb)
        return x


class _AddEmbedding(nn.Module):
    """ImageTimeEmbedding (2.2) or TextImageTimeEmbedding (2.1)."""

    def __init__(self, cfg: K22UNetConfig, temb_dim: int):
        super().__init__()
        if cfg.conditioning == "image":
            self.image_proj = nn.Linear(cfg.encoder_hid_dim, temb_dim)
            self.image_norm = nn.LayerNorm(temb_dim)
        else:
            self.text_proj = nn.Linear(cfg.cross_attention_dim, temb_dim)
            self.text_norm = nn.LayerNorm(temb_dim)
            self.image_proj = nn.Linear(cfg.image_embed_dim, temb_dim)


class _HidProjection(nn.Module):
    """ImageProjection (2.2) or TextImageProjection (2.1)."""

    def __init__(self, cfg: K22UNetConfig):
        super().__init__()
        tokens = cfg.image_proj_tokens * cfg.cross_attention_dim
        if cfg.conditioning == "image":
            self.image_embeds = nn.Linear(cfg.encoder_hid_dim, tokens)
            self.norm = nn.LayerNorm(cfg.cross_attention_dim)
        else:
            self.image_embeds = nn.Linear(cfg.image_embed_dim, tokens)
            self.text_proj = nn.Linear(cfg.encoder_hid_dim, cfg.cross_attention_dim)


class K22UNet(nn.Module):
    def __init__(self, cfg: K22UNetConfig):
        super().__init__()
        if cfg.conditioning not in ("image", "text_image"):
            raise ValueError(f"conditioning {cfg.conditioning!r} is not ported to "
                             "chiaswarm_tpu_torch yet (DeepFloyd IF's slice)")
        self.config = cfg
        chans = cfg.block_out_channels
        temb_dim = chans[0] * 4
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim)
        self.add_embedding = _AddEmbedding(cfg, temb_dim)
        self.encoder_hid_proj = _HidProjection(cfg)
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)

        downs, skip_chs, prev = [], [chans[0]], chans[0]
        for b, ch in enumerate(chans):
            last = b == len(chans) - 1
            downs.append(_DownBlock(cfg, prev, ch, temb_dim, cfg.down_attention[b], not last))
            skip_chs += [ch] * (cfg.layers_per_block + (0 if last else 1))
            prev = ch
        self.down_blocks = nn.ModuleList(downs)

        mid = chans[-1]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([KResnetBlock(mid, mid, temb_dim,
                                                             cfg.norm_num_groups)
                                                for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([KAttention(
            mid, mid // cfg.attention_head_dim, cfg.attention_head_dim,
            cfg.cross_attention_dim, cfg.norm_num_groups)])

        ups = []
        for b, ch in enumerate(reversed(chans)):
            rev = len(chans) - 1 - b
            in_chs = []
            for _ in range(cfg.layers_per_block + 1):
                in_chs.append(prev + skip_chs.pop())
                prev = ch
            ups.append(_UpBlock(cfg, in_chs, ch, temb_dim, cfg.down_attention[rev],
                                b != len(chans) - 1))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = FusedGroupNorm(chans[0], cfg.norm_num_groups, 1e-5, act="silu")
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    def conditioning(self, cond, dtype):
        """-> (the additive time-branch term [B, temb], the cross-attention
        tokens [B, N, cross_dim]). `cond`: the image embedding [B, E]
        ("image") or the text_image dict."""
        cfg = self.config
        add, hid = self.add_embedding, self.encoder_hid_proj
        if cfg.conditioning == "image":
            cond = cond.to(dtype)
            aug = add.image_norm(add.image_proj(cond))
            ctx = hid.image_embeds(cond).view(-1, cfg.image_proj_tokens,
                                              cfg.cross_attention_dim)
            return aug, hid.norm(ctx)
        text_states = cond["text_states"].to(dtype)
        text_embeds = cond["text_embeds"].to(dtype)
        image_embeds = cond["image_embeds"].to(dtype)
        aug = add.text_norm(add.text_proj(text_embeds)) + add.image_proj(image_embeds)
        img_tokens = hid.image_embeds(image_embeds).view(-1, cfg.image_proj_tokens,
                                                         cfg.cross_attention_dim)
        return aug, torch.cat([img_tokens, hid.text_proj(text_states)], dim=1)

    def forward(self, sample, timesteps, cond):
        """sample [B, C_in, H, W], timesteps [B] (or a scalar), cond as
        `conditioning` takes it -> [B, C_out, H, W]."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        b = sample.shape[0]
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(b)
        t_feat = timestep_embedding(timesteps, cfg.block_out_channels[0])
        aug, ctx = self.conditioning(cond, dtype)
        temb = self.time_embedding(t_feat.to(dtype)) + aug
        x = self.conv_in(sample.to(dtype).contiguous(memory_format=torch.channels_last))
        skips = [x]
        for block in self.down_blocks:
            x, block_skips = block(x, temb, ctx)
            skips.extend(block_skips)
        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        x = mid.attentions[0](x, ctx)
        x = mid.resnets[1](x, temb)
        for block in self.up_blocks:
            x = block(x, skips, temb, ctx)
        return self.conv_out(self.conv_norm_out(x))
