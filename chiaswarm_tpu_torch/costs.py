"""Serving-path cost plane: per-pass FLOPs, achieved TFLOP/s, MFU.

The counterpart of chiaswarm_tpu/costs.py, with the port's own peak table:

- ``PEAK_TFLOPS`` / ``peak_tflops(device)``: the card's peak dense bf16
  TFLOP/s, keyed by the prefix of ``torch.cuda.get_device_name()``, with
  the JAX package's ``BENCH_PEAK_TFLOPS`` override. A card with no entry,
  or the CPU, yields None: MFU then reports ``null`` while FLOPs are still
  counted.
- ``pass_cost`` / ``job_cost``: the ``pipeline_config.cost`` stamp that
  ``SDPipeline.run`` and ``run_batched`` put on every envelope. ``flops``
  is the JOB's own integer FLOP count (the hive's per-tenant sums equal
  the sum of the envelope stamps exactly); the pass figures (achieved
  TFLOP/s over the denoise and decode, MFU) are shared by every envelope
  of a coalesced pass.
- ``note_divergence``: the analytic-vs-counted cross-check that the pass
  ledger (programs.py) feeds: the first UNet call of each pass key is
  counted by ``torch.utils.flop_counter`` (plus the attention kernel's
  launches, which it cannot see) and held against models/flops.py.
"""

from __future__ import annotations

import os

import torch

from . import telemetry

# peak dense bf16 TFLOP/s per card, by the prefix of its CUDA device name
# (the MFU denominator). NVIDIA's H100 SXM5 datasheet: 1,979 TFLOP/s bf16
# with 2:4 sparsity, 989.4 dense. An unknown card reports MFU null.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4,
}

_PASS_FLOPS = telemetry.counter(
    "swarm_pass_flops_total",
    "Analytic UNet FLOPs served by completed denoise passes, per model "
    "(models/flops.py; the serving-path twin of the bench's MFU "
    "denominator)",
    ("model",),
)
_PASS_MFU = telemetry.gauge(
    "swarm_pass_mfu",
    "Model FLOPs utilisation of the most recent denoise pass, per model "
    "and mesh geometry (analytic UNet FLOPs over the denoise+decode "
    "span against the slice's aggregate peak; absent on platforms with "
    "no peak-TFLOPs entry)",
    ("model", "geometry"),
)
_DIVERGENCE = telemetry.gauge(
    "swarm_flops_divergence_ratio",
    "Counted FLOPs (torch.utils.flop_counter plus the attention kernel's "
    "launches) of the first UNet call of a pass key over the analytic "
    "models/flops.py count, per model (~1.0 = the MFU denominator is "
    "corroborated; the count includes the time and added-condition "
    "embeddings the analytic count omits)",
    ("model",),
)


def device_kind(device) -> str:
    """The name a peak-table prefix matches: a CUDA device's name, a string
    as given, "" for anything else (the CPU)."""
    if isinstance(device, str):
        return device
    if getattr(device, "type", None) == "cuda":
        return torch.cuda.get_device_name(device)
    return ""


def peak_tflops(device) -> float | None:
    """Peak dense bf16 TFLOP/s of `device` (a torch device, or a CUDA
    device name), or None when the card has no table entry.
    ``BENCH_PEAK_TFLOPS`` overrides."""
    override = os.environ.get("BENCH_PEAK_TFLOPS")
    if override:
        return float(override)
    kind = device_kind(device)
    for prefix, tf in PEAK_TFLOPS.items():
        if kind.startswith(prefix):
            return tf
    return None


def pass_cost(*, model: str, pass_flops: float, denoise_s: float | None,
              chips: int, device=None, geometry: str = "replicated") -> dict:
    """One denoise pass's cost figures, counted into the pass metrics.
    Called once per PASS (a coalesced pass calls it once for the whole
    group); per-envelope stamps derive from it via ``job_cost``.

    ``denoise_s`` is the pass's ``denoise_s + decode_s`` (the JAX
    package's ``denoise_decode_s`` span); a span too short to measure
    reports achieved TFLOP/s and MFU as None rather than dividing by
    zero."""
    flops = int(round(max(float(pass_flops), 0.0)))
    chips = max(int(chips or 1), 1)
    peak = peak_tflops(device) if device is not None else None
    achieved = None
    if denoise_s and denoise_s > 0:
        achieved = flops / float(denoise_s) / 1e12
    mfu = None
    if achieved is not None and peak:
        mfu = round(achieved / (peak * chips), 4)
    if flops > 0:
        _PASS_FLOPS.inc(flops, model=model)
    if mfu is not None:
        _PASS_MFU.set(mfu, model=model, geometry=geometry)
    return {
        "pass_flops": flops,
        "denoise_s": denoise_s,
        "tflops_per_s": None if achieved is None else round(achieved, 4),
        "chips": chips,
        "peak_tflops_per_chip": peak,
        "mfu": mfu,
    }


def job_cost(pass_figures: dict, job_flops: float) -> dict:
    """The per-envelope ``pipeline_config.cost`` stamp: the job's OWN
    integer FLOPs first (what the tenant ledger sums), then the shared
    pass figures."""
    return {"flops": int(round(max(float(job_flops), 0.0))), **pass_figures}


def note_divergence(model: str, analytic_flops: float,
                    counted_flops: float) -> float | None:
    """Publish the counted/analytic FLOP ratio of one pass key's UNet call.
    Returns the ratio (None when either side is unusable: a missing count
    reads as "uncorroborated", not as divergence 0)."""
    try:
        analytic = float(analytic_flops)
        counted = float(counted_flops)
    except (TypeError, ValueError):
        return None
    if analytic <= 0 or counted <= 0:
        return None
    ratio = counted / analytic
    _DIVERGENCE.set(round(ratio, 4), model=model)
    return ratio
