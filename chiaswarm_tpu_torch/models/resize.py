"""Bilinear resizes of NCHW maps with the JAX package's semantics.

- `resize_bilinear` is `jax.image.resize(x, shape, "bilinear")`: half-pixel
  centres, a triangle kernel that widens by the scale when it shrinks
  (antialiasing), weights renormalised where taps fall outside the input.
  Growing on both axes, that is exactly `F.interpolate(align_corners=False)`
  (two taps, the outside tap's weight folded into the edge), which it
  then calls; otherwise it applies JAX's weight matrices, one per axis.
- `resize_align_corners` is the JAX package's
  `interpolate_bilinear_align_corners` (torch's `align_corners=True`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] f32, as jax's `compute_weight_mat` with the triangle
    kernel, no translation and antialiasing on."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = ((np.arange(n_out, dtype=np.float32) + 0.5) * np.float32(inv_scale)
              - np.float32(0.5))
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / np.float32(
        kernel_scale)
    w = np.maximum(0.0, 1.0 - dist).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T.astype(np.float32).copy()


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, C, h, w] -> [B, C, height, width]."""
    h, w = x.shape[-2:]
    if (h, w) == (height, width):
        return x
    if height >= h and width >= w:
        return F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False)
    wh = torch.from_numpy(_weights(h, height)).to(x.device, x.dtype)
    ww = torch.from_numpy(_weights(w, width)).to(x.device, x.dtype)
    return torch.einsum("oh,bchw,pw->bcop", wh, x, ww)


def resize_align_corners(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, C, h, w] -> [B, C, height, width], corners aligned."""
    if tuple(x.shape[-2:]) == (height, width):
        return x
    return F.interpolate(x, size=(height, width), mode="bilinear", align_corners=True)
