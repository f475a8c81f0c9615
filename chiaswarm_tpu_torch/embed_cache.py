"""Encoded-prompt cache: repeat prompts skip the text encoders. The
counterpart of chiaswarm_tpu/embed_cache.py.

A byte-capped LRU of encoded text rows keyed by (model name, text): the
context row [77, D] and, for SDXL, the pooled row [P]. The prompt and the
negative are cached apart, so the shared "" negative of a coalesced group
is encoded once and then hits. The worker's `Registry` owns one cache
(`Settings.embed_cache_mb`, `CHIASWARM_EMBED_CACHE_MB`; 0 turns it off)
and its pipelines share it; the pipeline consults it only when nothing of
the job changes the encoders (no textual inversion, no adapter over the
text encoders: `SDPipeline.encode_prompts`), so a cached row is the row
the encoders give.

Rows stay where the encoders wrote them (on the card when serving there),
each a copy of its own so that a view does not keep the whole encode
batch alive; their bytes count wherever they live. `hits` and `misses`
count rows over the cache's life; `swarm_embed_cache_total{event}`,
`swarm_embed_cache_bytes` and `swarm_embed_cache_entries` export them, as
the JAX cache does.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from . import telemetry

_EVENTS = telemetry.counter(
    "swarm_embed_cache_total",
    "Text-embedding cache lookups by row, by outcome (hit = the row "
    "skipped its text-encoder forward entirely)",
    ("event",),
)
_BYTES = telemetry.gauge(
    "swarm_embed_cache_bytes",
    "Bytes of encoded prompt rows currently resident in the embedding "
    "cache (bounded by Settings.embed_cache_mb)")
_ENTRIES = telemetry.gauge(
    "swarm_embed_cache_entries",
    "Distinct (model, text) rows resident in the embedding cache")


def _nbytes(value: tuple) -> int:
    return sum(t.numel() * t.element_size() for t in value if t is not None)


class EmbedCache:
    """Byte-capped LRU of encoded text rows."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self.hits = 0
        self.misses = 0
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def lookup(self, key: tuple):
        """The cached (context row, pooled row or None) for `key`, or None.
        The caller counts per row (`note_rows`)."""
        with self._lock:
            value = self._entries.get(key)
            if value is not None:
                self._entries.move_to_end(key)
            return value

    def put(self, key: tuple, value: tuple) -> None:
        """Insert, then evict from the least recent end to the cap. A row
        larger than the cap is not kept (it would empty the cache)."""
        nbytes = _nbytes(value)
        if nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= _nbytes(old)
            self._entries[key] = value
            self._bytes += nbytes
            while self._bytes > self.max_bytes:
                self._bytes -= _nbytes(self._entries.popitem(last=False)[1])
            self._gauges()

    def _gauges(self) -> None:
        _BYTES.set(self._bytes)
        _ENTRIES.set(len(self._entries))

    def note_rows(self, hits: int, misses: int) -> None:
        with self._lock:
            self.hits += hits
            self.misses += misses
        if hits:
            _EVENTS.inc(hits, event="hit")
        if misses:
            _EVENTS.inc(misses, event="miss")

    def drop_model(self, model_name: str) -> int:
        """Forget one model's rows (its pipeline was evicted) -> bytes freed."""
        with self._lock:
            keys = [k for k in self._entries if k[0] == model_name]
            freed = sum(_nbytes(self._entries.pop(k)) for k in keys)
            self._bytes -= freed
            self._gauges()
            return freed

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)


def from_settings(mb: int) -> EmbedCache | None:
    """The cache of `embed_cache_mb` MiB, None when 0 (off)."""
    return EmbedCache(int(mb) << 20) if int(mb) > 0 else None
