"""Kandinsky 2.1's multilingual CLIP text tower (torch.nn), the counterpart
of chiaswarm_tpu/models/mclip.py with its own copy of the XLM-R layer of
chiaswarm_tpu/models/clap.py.

MultilingualCLIP = an XLM-RoBERTa trunk (post-LN layers, learned positions
offset past the padding id, token-type embeddings, exact GELU) + mean
pooling over the attention mask + one Linear (`LinearTransformation`) into
the 768-d CLIP space. The decoder UNet cross-attends to the trunk's hidden
states and adds the pooled projection to its time branch. Attention is a
plain matmul + softmax with the padding masked (-1e9), as in the JAX
package. The published checkpoint's key layout (`transformer.*`,
`LinearTransformation.*`); its CLS pooler is not used and is dropped at
load.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .configs import MCLIPConfig


class XLMRSelfAttention(nn.Module):
    def __init__(self, cfg: MCLIPConfig):
        super().__init__()
        h = cfg.hidden_size
        self.heads = cfg.num_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, x, bias):
        b, s, h = x.shape
        d = h // self.heads

        def heads(proj):
            return proj(x).view(b, s, self.heads, d).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        logits = torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5 + bias
        weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        return torch.matmul(weights, v).transpose(1, 2).reshape(b, s, h)


class _Dense(nn.Module):
    """A Linear, optionally followed by a residual LayerNorm (transformers'
    `*.output` modules: `dense` + `LayerNorm`)."""

    def __init__(self, d_in: int, d_out: int, eps: float | None = None):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        if eps is not None:
            self.LayerNorm = nn.LayerNorm(d_out, eps=eps)


class XLMRLayer(nn.Module):
    """Post-LN transformer layer (BERT / RoBERTa convention)."""

    def __init__(self, cfg: MCLIPConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = nn.Module()
        self.attention.self = XLMRSelfAttention(cfg)
        self.attention.output = _Dense(h, h, eps)
        self.intermediate = _Dense(h, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, h, eps)

    def forward(self, x, bias):
        att = self.attention.output.dense(self.attention.self(x, bias))
        x = self.attention.output.LayerNorm(x + att)
        y = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + y)


class MCLIPTextEncoder(nn.Module):
    def __init__(self, cfg: MCLIPConfig):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.transformer = nn.Module()
        emb = nn.Module()
        emb.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        emb.position_embeddings = nn.Embedding(cfg.max_positions, h)
        emb.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        emb.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.transformer.embeddings = emb
        self.transformer.encoder = nn.Module()
        self.transformer.encoder.layer = nn.ModuleList(
            [XLMRLayer(cfg) for _ in range(cfg.num_layers)])
        self.LinearTransformation = nn.Linear(h, cfg.projection_dim)

    def forward(self, input_ids, attention_mask=None):
        """[B, S] ids (and the [B, S] keep-mask; from the padding id
        unset) -> {"hidden_states" [B, S, D], "pooled_proj" [B, P]}."""
        cfg = self.config
        if attention_mask is None:
            attention_mask = (input_ids != cfg.pad_token_id).float()
        keep = attention_mask.to(torch.int64)
        positions = torch.cumsum(keep, dim=1) * keep + cfg.pad_token_id
        emb = self.transformer.embeddings
        x = (emb.word_embeddings(input_ids) + emb.position_embeddings(positions)
             + emb.token_type_embeddings(torch.zeros_like(input_ids)))
        x = emb.LayerNorm(x)
        bias = ((1.0 - attention_mask.float()) * -1e9)[:, None, None, :].to(x.dtype)
        for layer in self.transformer.encoder.layer:
            x = layer(x, bias)
        mask = attention_mask.to(x.dtype)[..., None]
        pooled = (x * mask).sum(dim=1) / attention_mask.sum(dim=1, keepdim=True).clamp(
            min=1.0).to(x.dtype)
        return {"hidden_states": x, "pooled_proj": self.LinearTransformation(pooled)}
