"""CLIP text encoders (torch.nn), the counterpart of
chiaswarm_tpu/models/clip.py: causal transformer, penultimate hidden
state for SDXL (`hidden_state_index=-2`), the last layer's state before
the final LayerNorm for the SD-x2 upscaler (`apply_final_norm=False`),
and the pooled projection of SDXL's second encoder. transformers'
CLIPTextModel(WithProjection) key layout. Causal attention is a plain
matmul + softmax, as in the JAX package (no kernel there either).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    max_positions: int = 77
    intermediate_mult: int = 4
    hidden_act: str = "gelu"  # gelu (SD2/XL) | quick_gelu (SD1.x ViT-L)
    # -1 = final layer norm output; -2 = input of the last layer
    hidden_state_index: int = -1
    # False with index -1: the last layer's output before the final
    # LayerNorm (the SD-x2 upscaler's conditioning); pooled keeps the norm
    apply_final_norm: bool = True
    projection_dim: int = 0  # >0: pooled projection (SDXL encoder 2)


def _act(name: str, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)  # exact erf gelu


class CLIPAttention(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, hidden, mask):
        b, s, h = hidden.shape
        head_dim = h // self.num_heads

        def heads(proj):
            return proj(hidden).view(b, s, self.num_heads, head_dim).transpose(1, 2)

        q, k, v = heads(self.q_proj), heads(self.k_proj), heads(self.v_proj)
        logits = torch.matmul(q, k.transpose(-1, -2)) * head_dim ** -0.5 + mask
        weights = torch.softmax(logits.float(), dim=-1).to(hidden.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, h)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        h = config.hidden_size
        self.act = config.hidden_act
        self.fc1 = nn.Linear(h, h * config.intermediate_mult)
        self.fc2 = nn.Linear(h * config.intermediate_mult, h)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(config)
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(config)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=1e-5)

    def forward(self, hidden, mask):
        hidden = hidden + self.self_attn(self.layer_norm1(hidden), mask)
        return hidden + self.mlp(self.layer_norm2(hidden))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position_embedding = nn.Embedding(config.max_positions, config.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(config) for _ in range(config.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(config)
        self.encoder = CLIPEncoder(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=1e-5)


class CLIPTextEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)
        self.text_projection = (
            nn.Linear(config.hidden_size, config.projection_dim, bias=False)
            if config.projection_dim else None)

    def forward(self, input_ids, extra_embeddings=None, attention_mask=None):
        """input_ids [B, S] -> {"hidden_states": [B, S, D] (per the
        config's index), "pooled": [B, D or projection_dim]} (the final
        norm's state at each row's first EOS).

        `extra_embeddings` [K, D] holds a job's textual-inversion vectors:
        an id at or past `vocab_size` takes row `id - vocab_size` of it. The
        token table only ever sees ids clamped into the vocabulary, and the
        EOS that pools stays the vocabulary's last id, which no placeholder
        id equals. `attention_mask` [B, S] (1 keep) masks the padded keys
        on top of the causal mask (Stable Cascade's masked encode)."""
        cfg = self.config
        tm = self.text_model
        b, s = input_ids.shape
        tok = tm.embeddings.token_embedding(input_ids.clamp(max=cfg.vocab_size - 1))
        if extra_embeddings is not None:
            extra_idx = (input_ids - cfg.vocab_size).clamp(0, extra_embeddings.shape[0] - 1)
            tok = torch.where((input_ids >= cfg.vocab_size)[..., None],
                              extra_embeddings.to(tok.dtype)[extra_idx], tok)
        hidden = tok + tm.embeddings.position_embedding.weight[None, :s]
        causal = torch.full((s, s), -1e9, dtype=hidden.dtype,
                            device=hidden.device).triu(1)[None, None]
        if attention_mask is not None:
            causal = causal + torch.where(attention_mask[:, None, None, :].bool(), 0.0,
                                          -1e9).to(hidden.dtype)
        collected = []
        for layer in tm.encoder.layers:
            collected.append(hidden)
            hidden = layer(hidden, causal)
        final = tm.final_layer_norm(hidden)
        collected.append(final)
        if cfg.hidden_state_index == -1:
            out_hidden = final if cfg.apply_final_norm else hidden
        else:
            out_hidden = collected[cfg.hidden_state_index]

        eos_idx = (input_ids == cfg.vocab_size - 1).int().argmax(dim=-1)
        pooled = final[torch.arange(b, device=final.device), eos_idx]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return {"hidden_states": out_hidden, "pooled": pooled}
