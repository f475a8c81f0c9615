"""T5 text encoder (encoder only, torch.nn), Flux's context encoder: the
counterpart of chiaswarm_tpu/models/t5.py.

Pre-RMSNorm blocks; bidirectional self-attention with no 1/sqrt(d)
scaling (T5 folds it into its weights) and one relative-position bias,
log-bucketed, that the first block's table computes once and every block
adds; the gated-GELU feed-forward of T5 v1.1 / XXL (gelu(wi_0 x) * wi_1 x,
then wo). transformers' T5EncoderModel key layout
(`encoder.block.N.layer.0.SelfAttention.q`, ...), so its safetensors load
as they are; `shared` is the token table (transformers ties
`encoder.embed_tokens` to it).

The biased attention is plain matmul + softmax in f32, as the JAX package
leaves it to XLA: no kernel replaces it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .configs import T5Config


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * weight, the statistics in f32 (T5's
    layer norm, and Flux's per-head qk-norm)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """T5's log-bucketed relative positions, bidirectional (the encoder's
    form): half the buckets for keys after the query; within each half,
    exact distances below a quarter of the buckets, then log-spaced up to
    `max_distance`."""
    rel = np.arange(klen)[None, :] - np.arange(qlen)[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * half
    rel = np.abs(rel)
    max_exact = half // 2
    large = max_exact + (np.log(np.maximum(rel, 1) / max_exact)
                         / np.log(max_distance / max_exact)
                         * (half - max_exact)).astype(np.int64)
    large = np.minimum(large, half - 1)
    return buckets + np.where(rel < max_exact, rel, large)


class T5Attention(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.config = config
        inner = config.num_heads * config.d_kv
        self.q = nn.Linear(config.d_model, inner, bias=False)
        self.k = nn.Linear(config.d_model, inner, bias=False)
        self.v = nn.Linear(config.d_model, inner, bias=False)
        self.o = nn.Linear(inner, config.d_model, bias=False)
        self.relative_attention_bias = (
            nn.Embedding(config.relative_attention_num_buckets, config.num_heads)
            if has_relative_bias else None)

    def position_bias(self, length: int, device) -> torch.Tensor:
        """[1, H, S, S] f32 from this block's bucket table."""
        cfg = self.config
        buckets = relative_position_buckets(length, length, cfg.relative_attention_num_buckets,
                                            cfg.relative_attention_max_distance)
        table = self.relative_attention_bias.weight.float()
        return table[torch.from_numpy(buckets).to(device)].permute(2, 0, 1)[None]

    def forward(self, x, position_bias, attention_mask=None):
        cfg = self.config
        b, s, _ = x.shape

        def heads(proj):
            return proj(x).view(b, s, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        q, k, v = heads(self.q), heads(self.k), heads(self.v)
        logits = torch.matmul(q, k.transpose(-1, -2)).float() + position_bias
        if attention_mask is not None:
            # a 1-keep mask over the keys
            logits = logits.masked_fill(~attention_mask[:, None, None, :].bool(), -1e9)
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, -1)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(config, has_relative_bias)
        self.layer_norm = RMSNorm(config.d_model, config.layer_norm_epsilon)

    def forward(self, x, position_bias, attention_mask=None):
        return x + self.SelfAttention(self.layer_norm(x), position_bias, attention_mask)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(config.d_model, config.d_ff, bias=False)
        self.wi_1 = nn.Linear(config.d_model, config.d_ff, bias=False)
        self.wo = nn.Linear(config.d_ff, config.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(config)
        self.layer_norm = RMSNorm(config.d_model, config.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(config, has_relative_bias),
                                    T5LayerFF(config)])

    def forward(self, x, position_bias, attention_mask=None):
        return self.layer[1](self.layer[0](x, position_bias, attention_mask))


class T5Stack(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(config, has_relative_bias=(i == 0))
                                    for i in range(config.num_layers)])
        self.final_layer_norm = RMSNorm(config.d_model, config.layer_norm_epsilon)


class T5Encoder(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config)

    def forward(self, input_ids, attention_mask=None):
        """[B, S] ids (and a [B, S] 1-keep mask) -> [B, S, d_model]."""
        x = self.shared(input_ids)
        blocks = self.encoder.block
        bias = blocks[0].layer[0].SelfAttention.position_bias(input_ids.shape[1], x.device)
        for block in blocks:
            x = block(x, bias, attention_mask)
        return self.encoder.final_layer_norm(x)
