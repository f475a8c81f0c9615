"""Attention dispatch, [B, S, H, D] throughout.

The counterpart of chiaswarm_tpu/ops/attention.py. There the Pallas
kernel took only long sequences (Sq >= 1024, D <= 128) on a TPU, a launch
heuristic of that chip. Here every attention of the UNet and the VAE on
the card goes through the hand-written kernel, whatever its length or
head width; a CPU tensor takes the plain version. There is no fallback
between the two.
"""

from __future__ import annotations

from .flash_attention import flash_attention, reference_attention


def dot_product_attention(q, k, v, scale: float | None = None):
    """[B, S_q, H, D] x [B, S_kv, H, D] -> [B, S_q, H, D]."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, scale=scale)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, scale=scale)
    raise ValueError(f"dot_product_attention: no kernel for device {q.device}")
