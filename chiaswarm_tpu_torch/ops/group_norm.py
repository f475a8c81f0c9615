"""GroupNorm (+ fused SiLU): the Hopper kernel (csrc/group_norm.cu), its
wrapper and its plain PyTorch version.

Replaces the Pallas kernel of chiaswarm_tpu/ops/group_norm.py
(`_gn_kernel`, launched by `_fused_group_norm`). Layout as there: x is
channel-last [B, ..., C], scale/bias [C]. On the H100 it is bound by
bytes (3.35 TB/s); the source says what its design does about that.

`group_norm` routes by where x lies: a CUDA tensor goes to the kernel
(`fused_group_norm`, which launches or raises), a CPU tensor to the plain
version `reference_group_norm`.
"""

from __future__ import annotations

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

COUNTER = LaunchCounter()

MAX_CHANNELS = 4096
# CTAs per batch row the stats and apply passes aim for: about four waves
# over the H100's 132 SMs
_TARGET_CTAS = 4 * 132


def reference_group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                         silu: bool = False):
    """Plain GroupNorm over the last axis with f32 statistics and the fast
    variance E[x^2] - mean^2, as chiaswarm_tpu's `_reference_group_norm`."""
    shape = x.shape
    c = shape[-1]
    xf = x.float().reshape(*shape[:-1], groups, c // groups)
    red = tuple(range(1, xf.ndim - 2)) + (xf.ndim - 1,)
    mean = xf.mean(dim=red, keepdim=True)
    var = (xf * xf).mean(dim=red, keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(shape)
    y = y * scale.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def fused_group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                     silu: bool = False):
    """The kernel: x contiguous channel-last [B, ..., C] on the card."""
    require_cuda_tensor("x", x)
    require_cuda_tensor("scale", scale, x.dtype)
    require_cuda_tensor("bias", bias, x.dtype)
    if x.ndim < 3:
        raise ValueError(f"expected x [B, ..., C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must be [{c}]")
    if c % 8 or c > MAX_CHANNELS or c % groups:
        raise ValueError(f"channels {c} not supported (multiple of 8 and of "
                         f"groups={groups}, <= {MAX_CHANNELS})")
    b = x.shape[0]
    n = x.numel() // (b * c)
    lib = _build.load("group_norm")
    bind(lib, "gn_forward", [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                             INT, FLOAT, INT, INT, PTR])
    bind(lib, "gn_threads", [INT])
    rows_par = lib.gn_threads(c) // (c // 8)
    chunks = max(1, min(-(-_TARGET_CTAS // b), -(-n // (4 * rows_par))))
    out = torch.empty_like(x)
    scratch = torch.empty(b * groups * 2 * (chunks + 1), device=x.device,
                          dtype=torch.float32)
    stats = scratch[b * groups * 2 * chunks:]
    err = lib.gn_forward(x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                         scratch.data_ptr(), stats.data_ptr(), b, n, c, groups, chunks,
                         float(eps), int(silu), DTYPE_CODES[x.dtype],
                         current_stream(x.device))
    check_launch(lib, "gn_error_string", err, "group_norm")
    COUNTER.note((tuple(x.shape), str(x.dtype).replace("torch.", ""), bool(silu), float(eps)))
    return out


def group_norm(x, scale, bias, *, groups: int = 32, eps: float = 1e-5,
               act: str | None = None):
    """GroupNorm over the channel-last axis with optional fused SiLU.

    x: [B, ..., C]; scale/bias: [C]. The kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    silu = act == "silu"
    if x.device.type == "cuda":
        return fused_group_norm(x, scale, bias, groups, eps, silu)
    if x.device.type == "cpu":
        return reference_group_norm(x, scale, bias, groups, eps, silu)
    raise ValueError(f"group_norm: no kernel for device {x.device}")
