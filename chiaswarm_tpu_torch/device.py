"""Where the port runs: the card by default, the CPU only when asked.

Entry points resolve their `device` here. With no argument that is
`cuda`, and without a CUDA device this raises instead of continuing on
the CPU; the tests pass `device="cpu"`. The serving dtype follows the
JAX package (bf16 on the accelerator, f32 on the CPU).

TF32 is off for both matrix products and cuDNN convolutions, so f32 work
on the card stays full f32 (the bounds of the reference tests assume it).
The main path runs in bf16, which these flags do not touch.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; chiaswarm_tpu_torch runs on the card "
            "unless the caller passes device='cpu'")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    set_precision()
    return device


def set_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def serving_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def memory_gb(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory >> 30
    return 0
