"""The runtime LoRA delta, the counterpart of
chiaswarm_tpu/pipelines/lora_runtime.py.

One base model stays resident and bit-identical. For one pass (a text
encode, a denoise loop) every Linear that an adapter matched returns

    y = W·x + b + gain · (x·Aᵀ)·Bᵀ

with `alpha / rank` folded into A when the stacks are built (so one
device copy serves the adapter at every scale) and `gain = lora_scale`.
The delta rides on forward hooks that `applied` installs and always
removes: no weight is ever edited, not even for the pass, since a bf16
add-then-subtract does not round-trip.

Each hooked call costs two launches: the product x·Aᵀ, then one GEMM that
adds gain·(x·Aᵀ)·Bᵀ into the Linear's own output in place. Neither is a
kernel of this repo: the JAX package computes the same two products
outside Pallas. Under torch.profiler the work is a `lora_delta` range.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch
from torch import nn


def build_stacks(matched: dict[str, tuple], dtype, device) -> tuple[dict, int]:
    """Matched factors {key: (A [r, in], B [out, r], alpha)} -> ({key: (Aᵀ
    scaled by alpha / r [in, r], Bᵀ [r, out])} on `device` in `dtype`, their
    device bytes). Stored transposed, so a call multiplies them as they
    are."""
    stacks, nbytes = {}, 0
    for key, (a, b, alpha) in matched.items():
        a = np.asarray(a, np.float32)
        if alpha is not None:
            a = a * (alpha / a.shape[0])
        pair = tuple(torch.from_numpy(np.ascontiguousarray(t.T)).to(device, dtype)
                     for t in (a, np.asarray(b, np.float32)))
        stacks[key] = pair
        nbytes += sum(t.numel() * t.element_size() for t in pair)
    return stacks, nbytes


def _hook(at: torch.Tensor, bt: torch.Tensor, gain: float, rows: int):
    def hook(module, args, y):
        x = args[0]
        # JAX's interceptor passes a Dense call through when its leading
        # dimension is not the batch. Every matched Linear of the port's
        # UNet and CLIP encoders takes the batch first (tokens [B, S, C],
        # embeddings [B, C], the time embedding broadcast to [B] as in
        # JAX), so that case cannot arise here: it is refused, never
        # silently skipped.
        if x.shape[0] != rows:
            raise RuntimeError(f"LoRA delta on {tuple(x.shape)}: the leading dimension is "
                               f"not the batch of {rows} rows")
        if torch.autograd._profiler_enabled():
            # a range costs microseconds of host time a call: only under
            # the profiler
            with torch.profiler.record_function("lora_delta"):
                _add_delta(x, y, at, bt, gain)
        else:
            _add_delta(x, y, at, bt, gain)
    return hook


def _add_delta(x, y, at, bt, gain: float) -> None:
    # 2-D products on flat rows: the cheapest dispatch on the host, which
    # the served steps are bound by
    low = torch.mm(x.reshape(-1, x.shape[-1]), at)
    y.view(-1, y.shape[-1]).addmm_(low, bt, alpha=gain)


@contextmanager
def applied(index: dict[str, nn.Linear], stacks: dict[str, tuple] | None, gain: float,
            rows: int):
    """For the duration, every module of `index` (the UNet's keys, or one
    text encoder's "te{i}:" keys) that has stacks adds its delta to each
    call's output; every call must have `rows` rows. None `stacks`
    installs nothing. -> the number of hooked modules."""
    handles = []
    try:
        for key, (at, bt) in (stacks or {}).items():
            module = index.get(key)
            if module is not None:
                handles.append(module.register_forward_hook(_hook(at, bt, gain, rows)))
        yield len(handles)
    finally:
        for handle in handles:
            handle.remove()
