"""Flux's MMDiT transformer (torch.nn), the counterpart of
chiaswarm_tpu/models/flux.py.

- 2x2-patchified 16-channel latents -> `x_embedder`; T5 context ->
  `context_embedder`; the sinusoidal flow time (and, for dev, the
  distilled guidance) and CLIP's pooled vector through MLPs, summed into
  the modulation vector `vec`.
- `depth_double` double-stream blocks: the image and text streams each
  with their own adaLN modulation from `vec`, one joint attention over
  [text | image] tokens with per-head RMS qk-norm and 3-D RoPE (text
  positions zero, image positions (0, y, x)).
- `depth_single` single-stream blocks over the joined sequence: q, k, v
  and the MLP input from one modulated input, attention and gelu MLP
  joined into one output projection.
- a final adaLN and a linear back to patch channels.

Every joint attention, [B, S_txt + S_img, 24, 128] at full width, goes
through `ops.dot_product_attention`: the hand-written kernel on the card
(`wgmma-d128` in bf16), the plain version on the CPU.

diffusers' FluxTransformer2DModel key layout, so a diffusers
`transformer/` folder loads without a rename: separate `to_q` / `to_k` /
`to_v` (the text stream's `add_*_proj`) where the JAX module fuses them
into `*_attn_qkv`, the single block's `to_q` / `to_k` / `to_v` and
`proj_mlp` where it fuses them into `linear1`, and `norm_out.linear`'s
output in (scale, shift) order where its `final_layer_mod` has (shift,
scale); weights.py's `flux_state_dict` undoes those three steps of
`convert_flux`. RoPE runs in the serving dtype, as in the JAX module.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dot_product_attention
from .configs import FluxConfig
from .layers import TimestepEmbedding
from .t5 import RMSNorm


def timestep_embedding(t, dim: int, max_period: float = 10_000.0,
                       time_factor: float = 1000.0):
    """Sinusoidal features [B, dim] f32 (cos first) of the flow time t in
    [0, 1], scaled by `time_factor`."""
    t = t.float() * time_factor
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_frequencies(ids, axes_dims: tuple[int, ...], theta: int):
    """[B, S, n_axes] integer positions -> (cos, sin) [B, S, head_dim / 2],
    axis by axis (Flux's 3-D RoPE)."""
    angles = []
    for axis, dim in enumerate(axes_dims):
        pos = ids[..., axis].float()
        scale = torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device) / dim
        angles.append(pos[..., None] * (1.0 / theta ** scale))
    angles = torch.cat(angles, dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x [B, S, H, D] rotated in (even, odd) pairs of its last dim."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def _layer_norm(x):
    """LayerNorm without scale or bias, eps 1e-6."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def _attention(q, k, v, cos, sin):
    """Joint attention with RoPE; [B, S, H, D] -> [B, S, H * D]."""
    out = dot_product_attention(apply_rope(q, cos, sin).contiguous(),
                                apply_rope(k, cos, sin).contiguous(), v.contiguous())
    b, s, h, d = out.shape
    return out.reshape(b, s, h * d)


class AdaNorm(nn.Module):
    """vec -> `n` modulation chunks [B, 1, hidden] (diffusers' AdaLayerNorm*
    `linear`, whose input is silu(vec))."""

    def __init__(self, hidden: int, n: int):
        super().__init__()
        self.n = n
        self.linear = nn.Linear(hidden, n * hidden)

    def forward(self, vec):
        return self.linear(F.silu(vec))[:, None, :].chunk(self.n, dim=-1)


class GeluProj(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.proj = nn.Linear(dim, out)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """diffusers' FeedForward with the tanh gelu: `net.0.proj`, `net.2`."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.net = nn.ModuleList([GeluProj(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class FluxAttention(nn.Module):
    """q, k, v projections and their qk-norms (the text stream's `add_*`
    beside them in a double block) and the output projections."""

    def __init__(self, config: FluxConfig, joint: bool):
        super().__init__()
        hidden, hd = config.hidden_size, config.head_dim
        self.heads = config.num_heads
        self.to_q, self.to_k, self.to_v = (nn.Linear(hidden, hidden) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(hd), RMSNorm(hd)
        if joint:
            self.add_q_proj, self.add_k_proj, self.add_v_proj = (
                nn.Linear(hidden, hidden) for _ in range(3))
            self.norm_added_q, self.norm_added_k = RMSNorm(hd), RMSNorm(hd)
            self.to_out = nn.ModuleList([nn.Linear(hidden, hidden)])
            self.to_add_out = nn.Linear(hidden, hidden)

    def qkv(self, x, text: bool = False):
        """x [B, S, hidden] -> normalised q, k and v [B, S, H, D]."""
        b, s, _ = x.shape
        projs = ((self.add_q_proj, self.add_k_proj, self.add_v_proj) if text
                 else (self.to_q, self.to_k, self.to_v))
        q, k, v = (p(x).view(b, s, self.heads, -1) for p in projs)
        norms = (self.norm_added_q, self.norm_added_k) if text else (self.norm_q, self.norm_k)
        return norms[0](q), norms[1](k), v


class DoubleStreamBlock(nn.Module):
    def __init__(self, config: FluxConfig):
        super().__init__()
        hidden = config.hidden_size
        mlp = int(hidden * config.mlp_ratio)
        self.norm1 = AdaNorm(hidden, 6)
        self.norm1_context = AdaNorm(hidden, 6)
        self.attn = FluxAttention(config, joint=True)
        self.ff = FeedForward(hidden, mlp)
        self.ff_context = FeedForward(hidden, mlp)

    def forward(self, img, txt, vec, cos, sin):
        img_mod = self.norm1(vec)
        txt_mod = self.norm1_context(vec)
        iq, ik, iv = self.attn.qkv(_layer_norm(img) * (1 + img_mod[1]) + img_mod[0])
        tq, tk, tv = self.attn.qkv(_layer_norm(txt) * (1 + txt_mod[1]) + txt_mod[0], text=True)
        # joint attention, text tokens first (as the ids are laid out)
        attn = _attention(torch.cat([tq, iq], dim=1), torch.cat([tk, ik], dim=1),
                          torch.cat([tv, iv], dim=1), cos, sin)
        txt_len = txt.shape[1]
        img = img + img_mod[2] * self.attn.to_out[0](attn[:, txt_len:])
        txt = txt + txt_mod[2] * self.attn.to_add_out(attn[:, :txt_len])
        img = img + img_mod[5] * self.ff(_layer_norm(img) * (1 + img_mod[4]) + img_mod[3])
        txt = txt + txt_mod[5] * self.ff_context(_layer_norm(txt) * (1 + txt_mod[4])
                                                 + txt_mod[3])
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, config: FluxConfig):
        super().__init__()
        hidden = config.hidden_size
        mlp = int(hidden * config.mlp_ratio)
        self.norm = AdaNorm(hidden, 3)
        self.proj_mlp = nn.Linear(hidden, mlp)
        self.attn = FluxAttention(config, joint=False)
        self.proj_out = nn.Linear(hidden + mlp, hidden)

    def forward(self, x, vec, cos, sin):
        shift, scale, gate = self.norm(vec)
        y = _layer_norm(x) * (1 + scale) + shift
        q, k, v = self.attn.qkv(y)
        mlp = F.gelu(self.proj_mlp(y), approximate="tanh")
        return x + gate * self.proj_out(torch.cat([_attention(q, k, v, cos, sin), mlp], dim=-1))


class TimeTextEmbed(nn.Module):
    def __init__(self, config: FluxConfig):
        super().__init__()
        hidden = config.hidden_size
        self.timestep_embedder = TimestepEmbedding(256, hidden)
        self.guidance_embedder = (TimestepEmbedding(256, hidden) if config.guidance_embed
                                  else None)
        self.text_embedder = TimestepEmbedding(config.pooled_dim, hidden)


class FinalNorm(nn.Module):
    """diffusers' AdaLayerNormContinuous: `linear` gives (scale, shift)."""

    def __init__(self, hidden: int):
        super().__init__()
        self.linear = nn.Linear(hidden, 2 * hidden)

    def forward(self, x, vec):
        scale, shift = self.linear(F.silu(vec))[:, None, :].chunk(2, dim=-1)
        return _layer_norm(x) * (1 + scale) + shift


class FluxTransformer(nn.Module):
    def __init__(self, config: FluxConfig):
        super().__init__()
        self.config = config
        hidden = config.hidden_size
        self.x_embedder = nn.Linear(config.in_channels, hidden)
        self.context_embedder = nn.Linear(config.context_dim, hidden)
        self.time_text_embed = TimeTextEmbed(config)
        self.transformer_blocks = nn.ModuleList(
            [DoubleStreamBlock(config) for _ in range(config.depth_double)])
        self.single_transformer_blocks = nn.ModuleList(
            [SingleStreamBlock(config) for _ in range(config.depth_single)])
        self.norm_out = FinalNorm(hidden)
        self.proj_out = nn.Linear(hidden, config.in_channels)

    def embed(self, timesteps, pooled, guidance=None):
        """The modulation vector [B, hidden] of flow times `timesteps` [B],
        CLIP's pooled [B, P] and (dev) the guidance [B], 1 unset."""
        emb = self.time_text_embed
        dtype = self.x_embedder.weight.dtype
        vec = emb.timestep_embedder(timestep_embedding(timesteps, 256).to(dtype))
        if emb.guidance_embedder is not None:
            g = guidance if guidance is not None else torch.ones_like(timesteps)
            vec = vec + emb.guidance_embedder(timestep_embedding(g, 256).to(dtype))
        return vec + emb.text_embedder(pooled.to(dtype))

    def forward(self, img, img_ids, txt, txt_ids, timesteps, pooled, guidance=None):
        """img [B, S_img, in_channels] patchified latents, txt [B, S_txt,
        context_dim], ids [B, S, 3] -> velocity [B, S_img, in_channels]."""
        cfg = self.config
        dtype = self.x_embedder.weight.dtype
        img = self.x_embedder(img.to(dtype))
        txt = self.context_embedder(txt.to(dtype))
        vec = self.embed(timesteps, pooled, guidance)
        cos, sin = rope_frequencies(torch.cat([txt_ids, img_ids], dim=1), cfg.axes_dims_rope,
                                    cfg.theta)
        cos, sin = cos.to(dtype), sin.to(dtype)
        for block in self.transformer_blocks:
            img, txt = block(img, txt, vec, cos, sin)
        x = torch.cat([txt, img], dim=1)
        for block in self.single_transformer_blocks:
            x = block(x, vec, cos, sin)
        x = self.norm_out(x[:, txt.shape[1]:], vec)
        return self.proj_out(x)


def patchify(latents):
    """[B, H, W, C] -> ([B, H/2 * W/2, 4C], ids [B, S, 3] int32: (0, y, x))."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
    ys, xs = torch.meshgrid(torch.arange(h // 2, device=latents.device),
                            torch.arange(w // 2, device=latents.device), indexing="ij")
    ids = torch.stack([torch.zeros_like(ys), ys, xs], dim=-1).reshape(1, -1, 3)
    return x, ids.expand(b, -1, -1).to(torch.int32)


def unpatchify(x, h: int, w: int):
    """[B, H/2 * W/2, 4C] -> [B, H, W, C]."""
    b, _, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h // 2, w // 2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)
