"""Flash attention: the Hopper kernel (csrc/flash_attention.cu), its
wrapper and its plain PyTorch version.

Replaces the Pallas kernel of chiaswarm_tpu/ops/flash_attention.py
(`_flash_kernel`, launched by `_flash_impl`). Layout as there:
q [B, Sq, H, D], k/v [B, Skv, H, D] -> [B, Sq, H, D], heads never moved.
On the H100 it is bound by operations (bf16 tensor cores, 989 TFLOP/s);
the source says what its design does about that.

`flash_attention` takes CUDA tensors only and launches the kernel or
raises; `reference_attention` is the plain version the CPU path and the
on-card comparison use. The kernel reports which of its routes took each
call (`COUNTER.routes`): a tensor-core kernel for bf16 at the head widths in
`TENSOR_CORE_WIDTHS`, the f32 FMA kernel for everything else.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import (
    DTYPE_CODES,
    FLOAT,
    INT,
    PTR,
    LaunchCounter,
    bind,
    check_launch,
    current_stream,
    require_cuda_tensor,
)

# launches on the card (chip_smoke.py reads them around the main path);
# COUNTER.routes counts them by (route, dtype, head width): route
# "wgmma-d<D>" is the tensor-core kernel for head width D, "fma" the f32
# FMA kernel
COUNTER = LaunchCounter()

MAX_HEAD_DIM = 512
# bf16 head widths that run on the tensor cores (wgmma fed by TMA)
TENSOR_CORE_WIDTHS = (40, 64, 80, 160, 512)
FA_FORWARD_ARGS = [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, FLOAT, INT, PTR, PTR]
# fa_forward, bound when the library first loads
_forward = None


def _bind_forward():
    global _forward
    _forward = bind(_build.load("flash_attention"), "fa_forward", FA_FORWARD_ARGS)
    return _forward


def reference_attention(q, k, v, scale: float | None = None):
    """Plain attention, as chiaswarm_tpu.ops.attention.reference_attention:
    logits in the input type, softmax in f32, weights cast back to the
    input type before the product with v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def flash_attention(q, k, v, scale: float | None = None):
    """[B, Sq, H, D] x [B, Skv, H, D] -> [B, Sq, H, D] on the card.

    bf16 at a head width in TENSOR_CORE_WIDTHS runs on the tensor cores
    (wgmma fed by TMA); f32, and other head widths up to 512, run the f32
    FMA kernel. Raises on anything else."""
    require_cuda_tensor("q", q)
    require_cuda_tensor("k", k, q.dtype)
    require_cuda_tensor("v", v, q.dtype)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Sq,H,D], k/v [B,Skv,H,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    bk, skv, hk, dk = k.shape
    if (bk, hk, dk) != (b, h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d} not supported (multiple of 8, <= {MAX_HEAD_DIM})")
    if sq < 1 or skv < 1:
        raise ValueError("empty sequence")
    if scale is None:
        scale = d ** -0.5
    forward = _forward or _bind_forward()
    out = torch.empty_like(q)
    route = ctypes.c_int()
    err = forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, sq, skv, h, d, float(scale), DTYPE_CODES[q.dtype],
                  current_stream(q.get_device()), ctypes.byref(route))
    if err:
        check_launch(_build.load("flash_attention"), "fa_error_string", err, "flash_attention")
    # the route code is the tensor-core kernel's head width, 0 for the FMA kernel
    name = f"wgmma-d{route.value}" if route.value else "fma"
    COUNTER.note((q.shape, k.shape, q.dtype), (name, q.dtype, d))
    return out
