"""Attention and GroupNorm: Hopper kernels with their plain versions."""

from .attention import dot_product_attention
from .group_norm import group_norm

__all__ = ["dot_product_attention", "group_norm"]
