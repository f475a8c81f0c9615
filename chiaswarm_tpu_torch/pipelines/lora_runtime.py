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

A coalesced pass (`applied_rows`) gives each row its own adapter slot and
gain, as the JAX package's per-row operands do: slot s adds
`gain_row · (x·A_sᵀ)·B_sᵀ` to the rows whose slot is s, and nothing to the
others. Slot 0 (rows without an adapter, and padding rows) is no slot at
all: per slot the hook computes x·A_sᵀ over every row, zeroes the rows of
other slots by a per-row gain of 0, and adds the product with B_sᵀ, three
launches a slot. A row's gain of 0 adds an exact zero, so an adapter-free
row gets, bit for bit, what a pass without hooks gives it.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch
from torch import nn

from .. import telemetry

LORA_ROWS = telemetry.counter(
    "swarm_lora_rows_total",
    "Image rows through denoise passes by adapter mode "
    "(delta | merged | none)",
    ("mode",),
)


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


def _rows_hook(slots: list, rows: int):
    """`slots` [(Aᵀ, Bᵀ, per-row gain [rows, 1, 1])], one per adapter slot
    that has this module."""
    def hook(module, args, y):
        x = args[0]
        if x.shape[0] != rows:
            raise RuntimeError(f"LoRA delta on {tuple(x.shape)}: the leading dimension is "
                               f"not the batch of {rows} rows")
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function("lora_delta"):
                _add_row_deltas(x, y, slots, rows)
        else:
            _add_row_deltas(x, y, slots, rows)
    return hook


def _add_row_deltas(x, y, slots: list, rows: int) -> None:
    flat_x, flat_y = x.reshape(-1, x.shape[-1]), y.view(-1, y.shape[-1])
    for at, bt, gain in slots:
        low = torch.mm(flat_x, at)
        low.view(rows, -1, low.shape[-1]).mul_(gain)
        flat_y.addmm_(low, bt)


@contextmanager
def applied_rows(index: dict[str, nn.Linear], slot_stacks: list[dict], gains: torch.Tensor):
    """Per-row adapters for the duration: `slot_stacks[s - 1]` holds the
    stacks of slot s (1..S), `gains` [S, rows] each row's gain under each
    slot (the row's gain in its own slot's line, 0 elsewhere). Every call
    of a hooked module must have `rows` rows; `gains` is in the stacks'
    dtype. -> the number of hooked modules."""
    rows = gains.shape[1]
    per_key: dict[str, list] = {}
    for s, stacks in enumerate(slot_stacks):
        g = gains[s].view(rows, 1, 1)
        for key, (at, bt) in stacks.items():
            if key in index:
                per_key.setdefault(key, []).append((at, bt, g))
    handles = []
    try:
        for key, slots in per_key.items():
            handles.append(index[key].register_forward_hook(_rows_hook(slots, rows)))
        yield len(handles)
    finally:
        for handle in handles:
            handle.remove()


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
