"""The Kandinsky 2.x diffusion prior (torch.nn), the counterpart of
chiaswarm_tpu/models/prior.py: diffusers' `PriorTransformer`, text ->
CLIP image embedding.

A transformer over [text tokens | text embed | timestep | noisy image
embed | learned prd token] with learned positions: sinusoidal time
features at the inner width through a 2-layer MLP, pre-LN blocks with
biased q/k/v and an exact-GELU feed-forward, the final LayerNorm and
projection read from the last (prd) token. Given the text keep-mask the
blocks run causal attention with the padded text masked (-1e4), as
PriorTransformer does when the pipeline passes the mask. Its attention is
a plain matmul + softmax, as in the JAX package (no kernel there either).

The whitening stats `clip_mean` / `clip_std` of a checkpoint are not
parameters here: the pipeline reads them beside the module
(pipelines/kandinsky.py). diffusers' key layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .configs import PriorConfig
from .layers import TimestepEmbedding, timestep_embedding


class PriorAttention(nn.Module):
    def __init__(self, cfg: PriorConfig):
        super().__init__()
        inner = cfg.hidden_size
        self.heads, self.head_dim = cfg.num_heads, cfg.head_dim
        self.to_q = nn.Linear(inner, inner)
        self.to_k = nn.Linear(inner, inner)
        self.to_v = nn.Linear(inner, inner)
        self.to_out = nn.ModuleList([nn.Linear(inner, inner)])

    def forward(self, x, mask):
        b, s, inner = x.shape

        def heads(proj):
            return proj(x).view(b, s, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.to_q), heads(self.to_k), heads(self.to_v)
        logits = torch.matmul(q, k.transpose(-1, -2)) * self.head_dim ** -0.5
        if mask is not None:
            logits = logits + mask
        weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, inner)
        return self.to_out[0](out)


class PriorFeedForward(nn.Module):
    def __init__(self, inner: int):
        super().__init__()
        proj = nn.Module()
        proj.proj = nn.Linear(inner, 4 * inner)
        # index 1 is diffusers' dropout slot, kept so the keys line up
        self.net = nn.ModuleList([proj, nn.Identity(), nn.Linear(4 * inner, inner)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x)))


class PriorBlock(nn.Module):
    """norm1 -> biased self-attention -> norm3 -> exact-GELU FF, pre-LN."""

    def __init__(self, cfg: PriorConfig):
        super().__init__()
        inner = cfg.hidden_size
        self.norm1 = nn.LayerNorm(inner, eps=1e-5)
        self.attn1 = PriorAttention(cfg)
        self.norm3 = nn.LayerNorm(inner, eps=1e-5)
        self.ff = PriorFeedForward(inner)

    def forward(self, x, mask):
        x = x + self.attn1(self.norm1(x), mask)
        return x + self.ff(self.norm3(x))


class DiffusionPrior(nn.Module):
    def __init__(self, cfg: PriorConfig):
        super().__init__()
        self.config = cfg
        inner = cfg.hidden_size
        seq = cfg.text_seq + cfg.additional_tokens
        self.time_embedding = TimestepEmbedding(inner, inner)
        self.proj_in = nn.Linear(cfg.embed_dim, inner)
        self.embedding_proj = nn.Linear(cfg.text_dim, inner)
        self.encoder_hidden_states_proj = nn.Linear(cfg.text_dim, inner)
        self.positional_embedding = nn.Parameter(torch.zeros(1, seq, inner))
        self.prd_embedding = nn.Parameter(torch.zeros(1, 1, inner))
        self.transformer_blocks = nn.ModuleList([PriorBlock(cfg) for _ in range(cfg.num_layers)])
        self.norm_out = nn.LayerNorm(inner, eps=1e-5)
        self.proj_to_clip_embeddings = nn.Linear(inner, cfg.embed_dim)

    def attention_bias(self, keep_mask, dtype):
        """The additive [B, 1, S, S] bias of a text keep-mask [B, text_seq]:
        padded text masked, the additional tokens always kept, plus the
        causal triangle."""
        cfg = self.config
        seq = cfg.text_seq + cfg.additional_tokens
        pad = F.pad((1.0 - keep_mask.float()) * -1e4, (0, cfg.additional_tokens))
        causal = torch.full((seq, seq), -1e4, device=keep_mask.device).triu(1)
        return (pad[:, None, :] + causal[None]).to(dtype)[:, None]

    def forward(self, noisy_embed, timesteps, text_hiddens, text_embed, attention_mask=None):
        """noisy_embed [B, E], timesteps [B], text_hiddens [B, S, Dt],
        text_embed [B, Dt], attention_mask [B, S] keep-mask or None ->
        the predicted clean image embedding [B, E]."""
        dtype = self.proj_in.weight.dtype
        b = noisy_embed.shape[0]
        inner = self.config.hidden_size
        time_tok = self.time_embedding(timestep_embedding(timesteps, inner).to(dtype))
        x = torch.cat([
            self.encoder_hidden_states_proj(text_hiddens.to(dtype)),
            self.embedding_proj(text_embed.to(dtype))[:, None],
            time_tok[:, None],
            self.proj_in(noisy_embed.to(dtype))[:, None],
            self.prd_embedding.to(dtype).expand(b, 1, inner),
        ], dim=1)
        x = x + self.positional_embedding.to(dtype)
        mask = None if attention_mask is None else self.attention_bias(attention_mask, dtype)
        for block in self.transformer_blocks:
            x = block(x, mask)
        return self.proj_to_clip_embeddings(self.norm_out(x)[:, -1])
