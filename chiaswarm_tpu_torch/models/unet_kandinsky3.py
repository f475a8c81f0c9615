"""The Kandinsky 3 UNet (torch.nn), the counterpart of
chiaswarm_tpu/models/unet_kandinsky3.py: diffusers' Kandinsky3UNet graph.

Every norm inside the blocks is a conditional group norm (an affine-free
GroupNorm whose scale and shift come from a Linear of the SiLU'd time
embedding); the resnets are four-sub-block bottlenecks (kernels 1-3-3-1 at
max(in, out) // compression_ratio wide) with the up- and downsampling in
given sub-block positions and a shortcut that mirrors them; the attention
blocks work on the flattened map's tokens (self where no context is given,
cross over the projected T5 states otherwise) with a 1x1-conv feed-forward.
The T5 states enter through a bias-free Linear and a LayerNorm
(`encoder_hid_proj`), and through an attention pooling of their mean that
adds onto the time embedding (`add_time_condition`).

As in the JAX package, the conditional group norms are `F.group_norm`
(statistics in f32) with the modulation after it, and the attention is a
plain softmax with f32 logits and a -1e9 key mask: neither is a Pallas
call there, so neither is a kernel here. The output norm
(`conv_norm_out`, affine, SiLU fused) goes through ops.group_norm: the
GroupNorm kernel on the card.

NCHW in `torch.channels_last`; diffusers' key layout
(`down_blocks.0.resnets_in.0.resnet_blocks.1.group_norm.context_mlp.1`,
`attentions.N.attention.to_out.0`, ...), with an `nn.Identity` where a
level has no attention, so the indices line up with the published files.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .configs import K3UNetConfig
from .layers import FusedGroupNorm, TimestepEmbedding, timestep_embedding


class ConditionalGroupNorm(nn.Module):
    """x_norm * (scale(temb) + 1) + shift(temb), the norm affine-free at eps
    1e-5 with its statistics in f32."""

    def __init__(self, groups: int, channels: int, temb_dim: int):
        super().__init__()
        self.groups = groups
        self.context_mlp = nn.Sequential(nn.SiLU(), nn.Linear(temb_dim, 2 * channels))

    def forward(self, x, temb):
        scale, shift = self.context_mlp(temb)[:, :, None, None].chunk(2, dim=1)
        x = F.group_norm(x.float(), self.groups, eps=1e-5).to(x.dtype)
        return x * (scale + 1.0) + shift


class K3Attention(nn.Module):
    """Bias-free attention whose query and output width is `inner`; K and V
    project from the context's width. Logits in f32, masked keys at -1e9."""

    def __init__(self, query_dim: int, context_dim: int, head_dim: int, inner: int):
        super().__init__()
        self.heads = max(1, inner // head_dim)
        self.head_dim = inner // self.heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, inner, bias=False)])

    def forward(self, q_in, kv_in, mask=None):
        b, n, _ = q_in.shape
        s = kv_in.shape[1]
        q = self.to_q(q_in).view(b, n, self.heads, self.head_dim)
        k = self.to_k(kv_in).view(b, s, self.heads, self.head_dim)
        v = self.to_v(kv_in).view(b, s, self.heads, self.head_dim)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * self.head_dim ** -0.5
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :].bool(), -1e9)
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, n, -1)
        return self.to_out[0](out)


class K3EncoderProj(nn.Module):
    """The T5 states through a bias-free Linear and a LayerNorm."""

    def __init__(self, encoder_hid_dim: int, cross_attention_dim: int):
        super().__init__()
        self.projection_linear = nn.Linear(encoder_hid_dim, cross_attention_dim, bias=False)
        self.projection_norm = nn.LayerNorm(cross_attention_dim, eps=1e-5)

    def forward(self, x):
        return self.projection_norm(self.projection_linear(x))


class K3AttentionPooling(nn.Module):
    """The context's mean attends over the context; the pooled vector adds
    onto the time embedding."""

    def __init__(self, num_channels: int, context_dim: int, head_dim: int):
        super().__init__()
        self.attention = K3Attention(context_dim, context_dim, head_dim, num_channels)

    def forward(self, temb, context, mask=None):
        pooled = self.attention(context.mean(dim=1, keepdim=True), context, mask)
        return temb + pooled[:, 0]


class K3Block(nn.Module):
    """norm -> SiLU -> (transposed 2x up) -> conv -> (strided 2x down).
    `up_resolution` None keeps the resolution, True doubles it before the
    conv, False halves it after."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, kernel_size: int,
                 groups: int, up_resolution: bool | None = None):
        super().__init__()
        self.group_norm = ConditionalGroupNorm(groups, in_channels, temb_dim)
        self.up_sample = (nn.ConvTranspose2d(in_channels, in_channels, 2, stride=2)
                          if up_resolution is True else nn.Identity())
        self.projection = nn.Conv2d(in_channels, out_channels, kernel_size,
                                    padding=kernel_size // 2)
        self.down_sample = (nn.Conv2d(out_channels, out_channels, 2, stride=2)
                            if up_resolution is False else nn.Identity())

    def forward(self, x, temb):
        x = F.silu(self.group_norm(x, temb))
        return self.down_sample(self.projection(self.up_sample(x)))


class K3ResNetBlock(nn.Module):
    """Four sub-blocks (kernels 1-3-3-1) and a shortcut that mirrors any
    resolution change."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, groups: int,
                 compression_ratio: int, up_resolutions=(None, None, None, None)):
        super().__init__()
        hidden = max(in_channels, out_channels) // compression_ratio
        pairs = ((in_channels, hidden), (hidden, hidden), (hidden, hidden),
                 (hidden, out_channels))
        self.resnet_blocks = nn.ModuleList(
            [K3Block(i, o, temb_dim, k, groups, up)
             for (i, o), k, up in zip(pairs, (1, 3, 3, 1), up_resolutions)])
        self.shortcut_up_sample = (nn.ConvTranspose2d(in_channels, in_channels, 2, stride=2)
                                   if True in up_resolutions else nn.Identity())
        self.shortcut_projection = (nn.Conv2d(in_channels, out_channels, 1)
                                    if in_channels != out_channels else nn.Identity())
        self.shortcut_down_sample = (nn.Conv2d(out_channels, out_channels, 2, stride=2)
                                     if False in up_resolutions else nn.Identity())

    def forward(self, x, temb):
        out = x
        for block in self.resnet_blocks:
            out = block(out, temb)
        x = self.shortcut_down_sample(self.shortcut_projection(self.shortcut_up_sample(x)))
        return x + out


class K3AttentionBlock(nn.Module):
    """Attention over the map's tokens (self, or cross over the context)
    and a 1x1-conv feed-forward, both residual, each entered through a
    conditional group norm."""

    def __init__(self, channels: int, temb_dim: int, context_dim: int | None, groups: int,
                 head_dim: int, expansion_ratio: int):
        super().__init__()
        self.in_norm = ConditionalGroupNorm(groups, channels, temb_dim)
        self.attention = K3Attention(channels, context_dim or channels, head_dim, channels)
        self.out_norm = ConditionalGroupNorm(groups, channels, temb_dim)
        self.feed_forward = nn.Sequential(
            nn.Conv2d(channels, expansion_ratio * channels, 1, bias=False), nn.SiLU(),
            nn.Conv2d(expansion_ratio * channels, channels, 1, bias=False))

    def forward(self, x, temb, context=None, mask=None):
        b, c, h, w = x.shape
        tokens = self.in_norm(x, temb).permute(0, 2, 3, 1).reshape(b, h * w, c)
        if context is None:
            attn = self.attention(tokens, tokens)
        else:
            attn = self.attention(tokens, context, mask)
        x = x + attn.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.feed_forward(self.out_norm(x, temb))


def _attention_block(cfg: K3UNetConfig, channels: int, cross: bool):
    return K3AttentionBlock(channels, cfg.time_embedding_dim,
                            cfg.cross_attention_dim if cross else None, cfg.groups,
                            cfg.attention_head_dim, cfg.expansion_ratio)


class K3DownBlock(nn.Module):
    """[self-attention] then layers_per_block x (resnet_in -> [cross-attention]
    -> resnet_out); the last resnet_out's third sub-block halves the
    resolution where the level downsamples."""

    def __init__(self, cfg: K3UNetConfig, in_channels: int, out_channels: int, cross: bool,
                 self_attention: bool, down_sample: bool):
        super().__init__()
        temb, nb = cfg.time_embedding_dim, cfg.layers_per_block
        self.cross, self.self_attention = cross, self_attention
        attentions = [_attention_block(cfg, in_channels, False) if self_attention
                      else nn.Identity()]
        resnets_in, resnets_out = [], []
        for j in range(nb):
            resnets_in.append(K3ResNetBlock(in_channels if j == 0 else out_channels,
                                            out_channels, temb, cfg.groups,
                                            cfg.compression_ratio))
            attentions.append(_attention_block(cfg, out_channels, True) if cross
                              else nn.Identity())
            up_res = ((None, None, False, None) if j == nb - 1 and down_sample
                      else (None, None, None, None))
            resnets_out.append(K3ResNetBlock(out_channels, out_channels, temb, cfg.groups,
                                             cfg.compression_ratio, up_res))
        self.attentions = nn.ModuleList(attentions)
        self.resnets_in = nn.ModuleList(resnets_in)
        self.resnets_out = nn.ModuleList(resnets_out)

    def forward(self, x, temb, context, mask):
        if self.self_attention:
            x = self.attentions[0](x, temb)
        for attn, rin, rout in zip(self.attentions[1:], self.resnets_in, self.resnets_out):
            x = rin(x, temb)
            if self.cross:
                x = attn(x, temb, context, mask)
            x = rout(x, temb)
        return x


class K3UpBlock(nn.Module):
    """layers_per_block x (resnet_in -> [cross-attention] -> resnet_out)
    then [self-attention]; the first resnet_in's second sub-block doubles
    the resolution where the level upsamples. Channels: resnet_in keeps its
    input's width, resnet_out moves through [(in + skip, in)] + [(in,
    in)] * (n - 2) + [(in, out)]."""

    def __init__(self, cfg: K3UNetConfig, in_channels: int, cat_channels: int,
                 out_channels: int, cross: bool, self_attention: bool, up_sample: bool):
        super().__init__()
        temb, nb = cfg.time_embedding_dim, cfg.layers_per_block
        self.cross, self.self_attention = cross, self_attention
        pairs = ([(in_channels + cat_channels, in_channels)]
                 + [(in_channels, in_channels)] * (nb - 2) + [(in_channels, out_channels)])
        attentions = [_attention_block(cfg, out_channels, False) if self_attention
                      else nn.Identity()]
        resnets_in, resnets_out = [], []
        for j, (ic, oc) in enumerate(pairs):
            up_res = ((None, True, None, None) if j == 0 and up_sample
                      else (None, None, None, None))
            resnets_in.append(K3ResNetBlock(ic, ic, temb, cfg.groups, cfg.compression_ratio,
                                            up_res))
            attentions.append(_attention_block(cfg, ic, True) if cross else nn.Identity())
            resnets_out.append(K3ResNetBlock(ic, oc, temb, cfg.groups, cfg.compression_ratio))
        self.attentions = nn.ModuleList(attentions)
        self.resnets_in = nn.ModuleList(resnets_in)
        self.resnets_out = nn.ModuleList(resnets_out)

    def forward(self, x, temb, context, mask):
        for attn, rin, rout in zip(self.attentions[1:], self.resnets_in, self.resnets_out):
            x = rin(x, temb)
            if self.cross:
                x = attn(x, temb, context, mask)
            x = rout(x, temb)
        if self.self_attention:
            x = self.attentions[0](x, temb)
        return x


class Kandinsky3UNet(nn.Module):
    """[B, 4, H, W] latents + [B] timesteps + [B, S, encoder_hid_dim] T5
    states (+ a [B, S] 1-keep mask) -> [B, 4, H, W] noise prediction."""

    def __init__(self, config: K3UNetConfig):
        super().__init__()
        cfg = self.config = config
        init_ch, n = cfg.init_channels, len(cfg.block_out_channels)
        self.time_embedding = TimestepEmbedding(init_ch, cfg.time_embedding_dim)
        self.add_time_condition = K3AttentionPooling(
            cfg.time_embedding_dim, cfg.cross_attention_dim, cfg.attention_head_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, init_ch, 3, padding=1)
        self.encoder_hid_proj = K3EncoderProj(cfg.encoder_hid_dim, cfg.cross_attention_dim)
        hidden = (init_ch, *cfg.block_out_channels)
        self.down_blocks = nn.ModuleList(
            [K3DownBlock(cfg, hidden[i], cfg.block_out_channels[i], cfg.add_cross_attention[i],
                         cfg.add_self_attention[i], down_sample=i != n - 1)
             for i in range(n)])
        ups = []
        for lvl in range(n):
            i = n - 1 - lvl  # the level this up block mirrors
            ups.append(K3UpBlock(cfg, cfg.block_out_channels[i],
                                 cfg.block_out_channels[i] if lvl else 0, hidden[i],
                                 cfg.add_cross_attention[i], cfg.add_self_attention[i],
                                 up_sample=lvl != 0))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = FusedGroupNorm(init_ch, cfg.groups, 1e-5, act="silu")
        self.conv_out = nn.Conv2d(init_ch, cfg.in_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states, encoder_attention_mask=None):
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        n = len(cfg.block_out_channels)
        temb = timestep_embedding(timesteps, cfg.init_channels, flip_sin_to_cos=False,
                                  downscale_freq_shift=1.0)
        temb = self.time_embedding(temb.to(dtype))
        context = self.encoder_hid_proj(encoder_hidden_states.to(dtype))
        mask = encoder_attention_mask
        temb = self.add_time_condition(temb, context, mask)
        x = self.conv_in(sample.to(dtype).contiguous(memory_format=torch.channels_last))
        skips = []
        for i, down in enumerate(self.down_blocks):
            x = down(x, temb, context, mask)
            if i != n - 1:
                skips.append(x)
        for lvl, up in enumerate(self.up_blocks):
            if lvl:
                x = torch.cat([x, skips.pop()], dim=1)
            x = up(x, temb, context, mask)
        return self.conv_out(self.conv_norm_out(x))
