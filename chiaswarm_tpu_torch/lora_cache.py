"""Adapter caches, the counterparts of chiaswarm_tpu/lora_cache.py (raw
factors on the host) and chiaswarm_tpu/lora_operands.py (their stacks on
the device).

A `LoraCache` is an object that the `Registry` owns, as the registry is
the worker's, not process-global state. It holds two byte-capped LRUs:

- `factors`: an adapter's raw factors {module key: (A, B, alpha)} as read
  from its file, keyed by `adapter_key` (ref, weight_name, subfolder). The
  factors are scale-independent: one entry serves every `lora_scale`.
- `operands`: the device stacks that pipelines/lora_runtime.py builds from
  the factors an adapter matched on one model, keyed by (model name,
  adapter key). A pipeline's entries go when the registry evicts it.

`resident_adapter_refs` names the adapters whose stacks are resident, for
the worker's poll (`resident_adapters`). A cap of 0 caches nothing: adapters still load, once per job. A factor
load from the file drops the operand entries of that adapter, so a
reloaded file never serves stale stacks. Lookups, bytes and entries are
exported under the JAX caches' names (`swarm_lora_cache_*` for the
factors, `swarm_lora_operand_cache_*` for the stacks).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from . import telemetry
from .models.lora import factors_nbytes, load_factors

_FACTOR_EVENTS = telemetry.counter(
    "swarm_lora_cache_total",
    "Adapter factor-cache lookups by outcome (miss = the adapter's "
    "safetensors were read and parsed from disk)",
    ("event",),
)
_FACTOR_BYTES = telemetry.gauge(
    "swarm_lora_cache_bytes",
    "Bytes of raw adapter factors currently resident in the factor "
    "cache (bounded by Settings.lora_cache_mb)")
_FACTOR_ENTRIES = telemetry.gauge(
    "swarm_lora_cache_entries",
    "Distinct adapters resident in the factor cache")
_OPERAND_EVENTS = telemetry.counter(
    "swarm_lora_operand_cache_total",
    "Device-resident operand-stack cache lookups by outcome (miss = the "
    "stacks were re-assembled host-side and re-uploaded)",
    ("event",),
)
_OPERAND_BYTES = telemetry.gauge(
    "swarm_lora_operand_cache_bytes",
    "Bytes of stacked adapter operands currently resident on device "
    "(bounded by Settings.lora_operand_cache_mb)")
_OPERAND_ENTRIES = telemetry.gauge(
    "swarm_lora_operand_cache_entries",
    "Distinct operand-stack recipes resident in the operand cache")


def wire_adapter_ref(ref, weight_name=None, subfolder=None) -> str:
    """An adapter key's parts -> the wire spelling the submitting client
    used, as chiaswarm_tpu/coalesce.py's `wire_adapter_ref`: a file under a
    worker-local root dir is its bare file name; a hub repo is
    "pub/repo[/sub...][/file]". A worker's root dir is configuration, not
    the adapter's identity."""
    ref, name, sub = str(ref or ""), str(weight_name or ""), str(subfolder or "")
    if name and os.path.isabs(os.path.expanduser(ref)):
        return "/".join(p for p in (sub, name) if p)
    return "/".join(p for p in (ref, sub, name) if p)


def adapter_key(lora: dict) -> tuple:
    """The cache identity of a resolved adapter reference (its scale is
    not part of it)."""
    return (str(lora.get("lora")), lora.get("weight_name"), lora.get("subfolder"))


class ByteLRU:
    """A least-recently-used map whose entries' bytes stay under a cap."""

    def __init__(self, max_bytes: int, gauges: tuple | None = None):
        """`gauges`: the (bytes, entries) gauges this cache's size sets."""
        self.max_bytes = int(max_bytes)
        self.gauges = gauges
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def _export(self) -> None:
        if self.gauges is not None:
            self.gauges[0].set(self._bytes)
            self.gauges[1].set(len(self._entries))

    def get(self, key):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._entries.move_to_end(key)
            return entry[0]

    def put(self, key, value, nbytes: int) -> None:
        """Insert (replacing `key`'s entry), then evict from the least
        recent end to the cap. An entry larger than the cap is not kept."""
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            if nbytes <= self.max_bytes:
                self._entries[key] = (value, int(nbytes))
                self._bytes += int(nbytes)
                while self._bytes > self.max_bytes:
                    self._bytes -= self._entries.popitem(last=False)[1][1]
            self._export()

    def drop(self, predicate) -> int:
        """Remove every entry whose key satisfies `predicate` -> bytes freed."""
        with self._lock:
            keys = [k for k in self._entries if predicate(k)]
            freed = sum(self._entries.pop(k)[1] for k in keys)
            self._bytes -= freed
            self._export()
            return freed

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)


class LoraCache:
    def __init__(self, factor_bytes: int = 256 << 20, operand_bytes: int = 512 << 20):
        self.factors = ByteLRU(factor_bytes, (_FACTOR_BYTES, _FACTOR_ENTRIES))
        self.operands = ByteLRU(operand_bytes, (_OPERAND_BYTES, _OPERAND_ENTRIES))

    def resolve(self, lora: dict, model_name: str, model_root_dir: str | None
                ) -> tuple[dict, bool]:
        """-> (the adapter's raw factors, whether they came from the cache).
        Load failures raise ValueError (a fatal job error)."""
        key = adapter_key(lora)
        factors = self.factors.get(key)
        if factors is not None:
            _FACTOR_EVENTS.inc(event="hit")
            return factors, True
        _FACTOR_EVENTS.inc(event="miss")
        factors = load_factors(lora, model_name, model_root_dir)
        self.factors.put(key, factors, factors_nbytes(factors))
        self.operands.drop(lambda k: k[1] == key)
        return factors, False

    def stacks(self, model_name: str, lora: dict):
        """The device stacks kept for (model, adapter), or None."""
        stacks = self.operands.get((model_name, adapter_key(lora)))
        _OPERAND_EVENTS.inc(event="miss" if stacks is None else "hit")
        return stacks

    def keep_stacks(self, model_name: str, lora: dict, value, nbytes: int) -> None:
        self.operands.put((model_name, adapter_key(lora)), value, nbytes)

    def resident_adapter_refs(self) -> list[str]:
        """The wire refs of every adapter whose stacks the operand cache
        holds, least recently used first, each once: the poll's
        `resident_adapters`, in JAX's format and order."""
        with self.operands._lock:
            keys = list(self.operands._entries)
        return list(dict.fromkeys(wire_adapter_ref(*key[1]) for key in keys))

    def drop_model(self, model_name: str) -> int:
        """Forget one model's device stacks -> bytes freed."""
        return self.operands.drop(lambda k: k[0] == model_name)
