"""Pass ledger: every pass key the pipelines run, and every kernel library.

The counterpart of chiaswarm_tpu/programs.py. The port compiles no XLA
programs, so what the JAX ledger records per jit site this one records
per (model, kind, key) of a denoise pass (`SDPipeline.run` and
`run_batched` key their passes as the JAX pipeline keys its programs):

- the first pass's seconds (denoise and decode), and the passes run;
- the analytic FLOPs of one UNet call (models/flops.py) and of the pass;
- the counted FLOPs of the key's FIRST UNet call: `torch.utils.flop_counter`
  counts its aten ops, and 4*B*H*Sq*Skv*D is added for each launch of the
  attention kernel over the call (a ctypes launch that the counter cannot
  see, read from `flash_attention.COUNTER.shapes`; on the CPU the plain
  attention's einsums are counted already). The ratio feeds
  `swarm_flops_divergence_ratio{model}` through costs.note_divergence.

Beside the passes, the kernel libraries that ops/_build.py built or loaded
in this process: build seconds and `.so` bytes (`_build.BUILT`).

Served at the worker's ``GET /debug/programs`` via ``snapshot()``; the
libraries' bytes are the memory census's ``program_ledger`` store.
"""

from __future__ import annotations

import threading
from collections import Counter, OrderedDict

from . import costs, telemetry

# entries kept (LRU by registration): every pass key a long-running worker
# meets, bounded
MAX_ENTRIES = 512

_LIVE = telemetry.gauge(
    "swarm_programs_live",
    "Pass keys registered in the pass ledger (programs.py, the port's "
    "counterpart of compiled programs), per model",
    ("model",),
)


class PassEntry:
    """One pass key's ledger row (mutable; snapshot() serialises it)."""

    __slots__ = ("model", "kind", "key", "calls", "first_s", "analytic_call_flops",
                 "analytic_pass_flops", "counted_call_flops", "attention_flops",
                 "divergence", "error")

    def __init__(self, model: str, kind: str, key):
        self.model = model
        self.kind = kind
        self.key = repr(key)
        self.calls = 0
        self.first_s = None
        self.analytic_call_flops = None
        self.analytic_pass_flops = None
        self.counted_call_flops = None
        self.attention_flops = None
        self.divergence = None
        self.error = None

    @property
    def counting(self) -> bool:
        """The key's first UNet call is still to be counted."""
        return self.counted_call_flops is None and self.error is None

    def count_call(self, unet, *args, **kwargs):
        """Run one UNet call under the FLOP counter (plus the attention
        kernel's launches), record the count and the divergence, and
        return the call's output. A counter failure costs the count,
        never the call."""
        from torch.utils.flop_counter import FlopCounterMode

        from .ops.flash_attention import COUNTER

        before = Counter(COUNTER.shapes)
        try:
            with FlopCounterMode(display=False) as mode:
                out = unet(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — only the counter can fail here
            self.error = f"{type(e).__name__}: {e}"
            return unet(*args, **kwargs)
        attention = 0
        for (q_shape, k_shape, _dtype), n in (Counter(COUNTER.shapes) - before).items():
            b, sq, h, d = q_shape
            attention += n * 4 * b * h * sq * k_shape[1] * d
        self.attention_flops = int(attention)
        self.counted_call_flops = int(mode.get_total_flops()) + int(attention)
        if self.analytic_call_flops:
            self.divergence = costs.note_divergence(
                self.model, self.analytic_call_flops, self.counted_call_flops)
        return out

    def finish(self, seconds: float) -> None:
        """One pass of this key ended after `seconds` (denoise and decode)."""
        with _LOCK:
            self.calls += 1
            if self.first_s is None:
                self.first_s = float(seconds)

    def as_dict(self) -> dict:
        return {
            "model": self.model,
            "kind": self.kind,
            "key": self.key,
            "calls": self.calls,
            "first_s": None if self.first_s is None else round(self.first_s, 4),
            "analytic_call_flops": self.analytic_call_flops,
            "analytic_pass_flops": self.analytic_pass_flops,
            "counted_call_flops": self.counted_call_flops,
            "attention_flops": self.attention_flops,
            "divergence": None if self.divergence is None else round(self.divergence, 4),
            "error": self.error,
        }


_LOCK = threading.Lock()
_LEDGER: OrderedDict[tuple, PassEntry] = OrderedDict()


def _refresh_live() -> None:
    counts: dict[str, int] = {}
    with _LOCK:
        for entry in _LEDGER.values():
            counts[entry.model] = counts.get(entry.model, 0) + 1
    for model, n in counts.items():
        _LIVE.set(n, model=model)


def note_pass(model: str, kind: str, key, *, call_flops: float,
              pass_flops: float) -> PassEntry:
    """The ledger entry of one pass key, registered on its first pass with
    the analytic FLOPs of one UNet call and of the whole pass."""
    ident = (model, kind, repr(key))
    with _LOCK:
        entry = _LEDGER.get(ident)
        if entry is not None:
            _LEDGER.move_to_end(ident)
            return entry
        entry = PassEntry(model, kind, key)
        entry.analytic_call_flops = float(call_flops) if call_flops > 0 else None
        entry.analytic_pass_flops = float(pass_flops)
        _LEDGER[ident] = entry
        while len(_LEDGER) > MAX_ENTRIES:
            _LEDGER.popitem(last=False)
    _refresh_live()
    return entry


def kernel_libraries() -> list[dict]:
    """The kernel libraries built or loaded in this process."""
    from .ops import _build

    return [{"name": name, **info} for name, info in sorted(_build.BUILT.items())]


def snapshot() -> dict:
    """The GET /debug/programs payload: every pass entry, the kernel
    libraries, and the per-model worst divergence."""
    with _LOCK:
        entries = [e.as_dict() for e in _LEDGER.values()]
    divergence: dict[str, float] = {}
    for e in entries:
        d = e.get("divergence")
        if d is None:
            continue
        prior = divergence.get(e["model"])
        if prior is None or abs(d - 1.0) > abs(prior - 1.0):
            divergence[e["model"]] = d
    return {"programs": entries, "divergence": divergence, "kernels": kernel_libraries()}


def resident_code_bytes() -> dict:
    """Memory-census provider: the kernel libraries' `.so` bytes and the
    ledger's entry count."""
    libs = kernel_libraries()
    with _LOCK:
        n = len(_LEDGER)
    return {"bytes": int(sum(lib.get("bytes") or 0 for lib in libs)), "entries": n,
            "libraries": len(libs)}


def reset() -> None:
    """Drop every ledger entry (tests)."""
    with _LOCK:
        _LEDGER.clear()
