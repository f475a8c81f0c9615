"""Memory census: every byte-capped store, one ledger.

The counterpart of chiaswarm_tpu/memory_census.py:

- a registry of named byte providers (``register``). The port's stores
  are the worker's, not process-global: the worker registers its
  registry's embedding cache (``embed_cache``), its adapter caches
  (``lora_factor_cache`` and ``lora_operand_cache``, lora_cache.py) and
  its outbox; the pass ledger (``program_ledger``, programs.py: the
  kernel libraries' bytes) is built in. Each provider returns at least
  ``{"bytes": int}`` plus whatever detail it wants surfaced;
- ``census()``: the ``GET /debug/memory`` payload: every store's bytes
  (exported as ``swarm_memory_store_bytes{store}``), the total, the card's
  occupancy (``torch.cuda.mem_get_info`` and ``memory_stats``; exported as
  ``swarm_device_hbm_used_bytes`` / ``_limit_bytes``) and its headroom;
- ``device_headroom()``: the headroom probe the worker's ``/healthz``
  consults against ``Settings.memory_headroom_degraded``.

The device census reads the card the worker serves on (``set_device``);
a worker on the CPU reports no device, so the headroom probe never fires
there, as in the JAX package. Providers that fail record an error detail
and never break the endpoint.
"""

from __future__ import annotations

import threading

from . import telemetry

_STORE_BYTES = telemetry.gauge(
    "swarm_memory_store_bytes",
    "Resident bytes per byte-capped store (embed cache, LoRA factor / "
    "operand caches, program ledger, outbox, artifact spool, WAL), "
    "refreshed on each /debug/memory census",
    ("store",),
)
_HBM_USED = telemetry.gauge(
    "swarm_device_hbm_used_bytes",
    "Bytes in use on each local device (device.memory_stats), refreshed "
    "on each /debug/memory census",
    ("device",),
)
_HBM_LIMIT = telemetry.gauge(
    "swarm_device_hbm_limit_bytes",
    "Per-device memory limit (device.memory_stats bytes_limit, falling "
    "back to the chips/device HBM table)",
    ("device",),
)
_HEADROOM = telemetry.gauge(
    "swarm_memory_headroom_ratio",
    "Worst-device free-HBM fraction (1 - used/limit); drives the "
    "low-headroom /healthz degradation (memory_headroom_degraded)",
)

_LOCK = threading.Lock()
_PROVIDERS: dict[str, object] = {}
# the card the device census reads (None: no device, as on the CPU)
_DEVICE = None


def register(store: str, provider) -> None:
    """Register (or replace) the byte provider for `store`: a callable
    returning ``{"bytes": int, ...detail}``. The last registration wins,
    which is the live worker's."""
    with _LOCK:
        _PROVIDERS[str(store)] = provider


def set_device(device) -> None:
    """The torch device whose memory the census reads (a CUDA device;
    anything else turns the device census off)."""
    global _DEVICE
    _DEVICE = device if getattr(device, "type", None) == "cuda" else None


def cache_provider(cache):
    """Provider over a byte-capped cache (resident bytes + entry count; 0
    when the cache is off, i.e. None)."""
    def provider() -> dict:
        if cache is None:
            return {"bytes": 0, "entries": 0, "enabled": False}
        return {"bytes": int(cache.resident_bytes), "entries": len(cache),
                "cap_bytes": int(getattr(cache, "max_bytes", 0))}
    return provider


def _builtin_providers() -> dict:
    from . import programs

    return {"program_ledger": programs.resident_code_bytes}


def census() -> dict:
    """The GET /debug/memory payload: per-store bytes (gauges refreshed as
    a side effect), the total, the card's occupancy and headroom."""
    with _LOCK:
        providers = dict(_PROVIDERS)
    for name, provider in _builtin_providers().items():
        providers.setdefault(name, provider)
    stores: dict[str, dict] = {}
    total = 0
    for name in sorted(providers):
        try:
            detail = providers[name]() or {}
        except Exception as e:  # noqa: BLE001 — a torn-down store must not 500 the census
            detail = {"bytes": 0, "error": f"{type(e).__name__}: {e}"}
        nbytes = detail.get("bytes")
        nbytes = int(nbytes) if isinstance(nbytes, (int, float)) else 0
        detail["bytes"] = nbytes
        _STORE_BYTES.set(nbytes, store=name)
        total += nbytes
        stores[name] = detail
    payload = {"stores": stores, "total_bytes": total}
    devices = _device_census()
    if devices is not None:
        payload["devices"] = devices
        headrooms = [d["headroom_ratio"] for d in devices
                     if d.get("headroom_ratio") is not None]
        if headrooms:
            payload["headroom_ratio"] = min(headrooms)
            _HEADROOM.set(payload["headroom_ratio"])
    return payload


def _device_census() -> list[dict] | None:
    """The card's memory: what the whole device has in use (total less
    free, every process and the caching allocator's reserve) against its
    total, and this process's allocated and reserved bytes. None without
    a card."""
    device = _DEVICE
    if device is None:
        return None
    import torch

    free, limit = torch.cuda.mem_get_info(device)
    stats = torch.cuda.memory_stats(device)
    used = int(limit - free)
    label = f"cuda:{device.index if device.index is not None else torch.cuda.current_device()}"
    _HBM_USED.set(used, device=label)
    _HBM_LIMIT.set(int(limit), device=label)
    return [{
        "device": label,
        "kind": torch.cuda.get_device_name(device),
        "bytes_in_use": used,
        "bytes_limit": int(limit),
        "bytes_allocated": int(stats.get("allocated_bytes.all.current", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "headroom_ratio": round(max(free / limit, 0.0), 4) if limit else None,
    }]


def device_headroom() -> float | None:
    """The card's free fraction, or None without a card. Exports the
    headroom gauge as a side effect."""
    devices = _device_census()
    if not devices:
        return None
    headrooms = [d["headroom_ratio"] for d in devices if d.get("headroom_ratio") is not None]
    if not headrooms:
        return None
    worst = min(headrooms)
    _HEADROOM.set(worst)
    return worst
