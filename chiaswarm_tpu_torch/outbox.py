"""Durable result outbox: a finished job's envelope survives anything.

The counterpart of chiaswarm_tpu/outbox.py, in its on-disk format, so
either package (and tools/outbox_inspect.py) reads the other's spool:

- every result envelope is SPOOLED to disk before the first upload
  attempt: ``<time_ns>-<seq>-<job id>.json`` under ``$SDAAS_ROOT/outbox/``,
  written tmp+rename as ``{"spooled_at", "result"}``;
- the uploader retries transient failures with capped exponential backoff
  and jitter (``backoff_delay``); a permanent hive refusal (4xx), or an
  ACK that says the hive will never store the result, PARKS the entry:
  rewritten with its delivery history and renamed ``.json.parked``, out
  of the retry loop, still on disk;
- the spool file is unlinked ONLY on the hive's ACK;
- when a worker starts, ``recover()`` hands back every entry a previous
  process spooled (parked ones too: the hive may accept now), so delivery
  is at-least-once across restarts and the hive dedupes by job id
  (``tools/outbox_inspect.py --requeue`` moves parked entries back).

One difference: ``claim()`` takes an advisory lock on the directory for
the life of a worker's run, exclusive while it recovers and shared after.
A worker that finds the spool shared with a live one (another process, or
another worker of this one) spools beside it but recovers nothing: what
it would recover is still in flight.

Depth / oldest-age / retry counters feed /metrics and /healthz
(``saturated`` turns the worker's health degraded).
"""

from __future__ import annotations

import dataclasses
import fcntl
import itertools
import json
import logging
import os
import random
import re
import time
from pathlib import Path

from . import telemetry

logger = logging.getLogger(__name__)

# capped exponential backoff between delivery attempts for one entry;
# module-level so tests (and the chaos harness) can shrink them
BACKOFF_BASE_S = 0.5
BACKOFF_CAP_S = 30.0

_DEPTH = telemetry.gauge(
    "swarm_outbox_depth", "Result envelopes spooled on disk awaiting hive ACK")
_OLDEST = telemetry.gauge(
    "swarm_outbox_oldest_age_seconds",
    "Age of the oldest spooled result envelope (0 when empty)")
_SPOOLED = telemetry.counter(
    "swarm_outbox_spooled_total", "Result envelopes written to the outbox")
_DELIVERED = telemetry.counter(
    "swarm_outbox_delivered_total",
    "Result envelopes unlinked after a hive ACK")
_RETRIES = telemetry.counter(
    "swarm_outbox_retries_total",
    "Delivery attempts retried after a transient failure")
_PARKED = telemetry.counter(
    "swarm_outbox_parked_total",
    "Envelopes parked after a permanent hive refusal (kept on disk)")
_RECOVERED = telemetry.counter(
    "swarm_outbox_recovered_total",
    "Envelopes re-enqueued from a previous process's spool")

_SAFE_ID = re.compile(r"[^A-Za-z0-9._-]+")


def backoff_delay(retries: int, base: float | None = None,
                  cap: float | None = None) -> float:
    """Delay before attempt `retries`+1: exponential, capped, with jitter
    in [ceiling/2, ceiling] so a fleet retrying the same hive outage does
    not re-POST in lockstep."""
    base = BACKOFF_BASE_S if base is None else base
    cap = BACKOFF_CAP_S if cap is None else cap
    ceiling = min(cap, base * (2 ** max(int(retries) - 1, 0)))
    return random.uniform(ceiling / 2, ceiling)


@dataclasses.dataclass
class OutboxEntry:
    result: dict
    job_id: str
    path: Path | None  # None = spool write failed; in-memory only
    spooled_at: float
    retries: int = 0
    parked: bool = False


class Outbox:
    def __init__(self, directory: str | Path, max_entries: int = 512):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_entries = int(max_entries)
        self._seq = itertools.count()
        # the advisory lock of claim(), held from a worker's start to its end
        self._lock_file = None
        # the byte census: the spool directory's bytes beside the
        # in-memory stores; the last-constructed outbox wins
        from . import memory_census

        memory_census.register("outbox", self.resident_bytes)

    def claim(self) -> bool:
        """Lock the spool for one worker's run: True when no other live
        worker shares it (the caller may then `recover()`), False when one
        does (recover nothing). Blocks while another worker recovers."""
        self.release()
        handle = open(self.directory / ".lock", "a+")
        try:
            fcntl.flock(handle, fcntl.LOCK_EX | fcntl.LOCK_NB)
            exclusive = True
        except OSError:
            fcntl.flock(handle, fcntl.LOCK_SH)
            exclusive = False
        self._lock_file = handle
        return exclusive

    def share(self) -> None:
        """After recovery: let other workers use the spool beside this one."""
        if self._lock_file is not None:
            fcntl.flock(self._lock_file, fcntl.LOCK_SH)

    def release(self) -> None:
        if self._lock_file is not None:
            self._lock_file.close()
            self._lock_file = None

    def resident_bytes(self) -> dict:
        """Census provider: spooled envelope bytes on disk (delivery
        spool + parked), plus the file count."""
        files = self._files()
        total = 0
        for path in files:
            try:
                total += path.stat().st_size
            except OSError:
                continue
        return {"bytes": total, "entries": len(files)}

    # --- spool lifecycle ---

    def spool(self, result: dict) -> OutboxEntry:
        """Persist one envelope before its first upload attempt. A failed
        write (full disk, bad mount) degrades to an in-memory entry — the
        job is still delivered this process, just not restart-durable —
        and is logged loudly rather than failing the job."""
        job_id = str(result.get("id", "unknown"))
        now = time.time()
        name = (f"{time.time_ns():020d}-{next(self._seq):04d}-"
                f"{_SAFE_ID.sub('_', job_id)[:80]}.json")
        path: Path | None = self.directory / name
        try:
            payload = json.dumps({"spooled_at": now, "result": result})
            tmp = path.with_name(path.name + ".tmp")
            tmp.write_text(payload)
            os.replace(tmp, path)
        except OSError:
            logger.exception(
                "outbox spool failed for %s; delivery is NOT restart-durable "
                "for this envelope", job_id)
            path = None
        _SPOOLED.inc()
        entry = OutboxEntry(result, job_id, path, now)
        self.refresh_gauges()
        return entry

    def delivered(self, entry: OutboxEntry) -> None:
        """Hive ACKed: the spool file may finally go away."""
        if entry.path is not None:
            try:
                entry.path.unlink(missing_ok=True)
            except OSError:
                logger.warning("could not unlink delivered entry %s",
                               entry.path)
        _DELIVERED.inc()
        self.refresh_gauges()

    def park(self, entry: OutboxEntry, reason: str | None = None) -> None:
        """Permanent hive refusal: take the entry out of the in-process
        retry loop but KEEP it on disk (renamed aside). recover() picks
        parked entries up on the next start — never a silent drop. The
        payload is rewritten with the delivery history (retries, when and
        why it parked) so `tools/outbox_inspect.py` can show an operator
        what happened without the process that knew."""
        entry.parked = True
        if entry.path is not None and not entry.path.name.endswith(".parked"):
            try:
                payload = json.dumps({
                    "spooled_at": entry.spooled_at,
                    "parked_at": time.time(),
                    "retries": entry.retries,
                    "park_reason": reason,
                    "result": entry.result,
                })
                tmp = entry.path.with_name(entry.path.name + ".tmp")
                tmp.write_text(payload)
                os.replace(tmp, entry.path)
                parked = entry.path.with_name(entry.path.name + ".parked")
                os.replace(entry.path, parked)
                entry.path = parked
            except OSError:
                logger.warning("could not park entry %s", entry.path)
        _PARKED.inc()
        self.refresh_gauges()

    def recover(self) -> list[OutboxEntry]:
        """Entries spooled by a previous process, oldest first. Unreadable
        files are left in place and logged — an operator can still recover
        the artifacts by hand."""
        entries = []
        for path in self._files():
            try:
                payload = json.loads(path.read_text())
                result = payload["result"]
            except (OSError, ValueError, KeyError, TypeError):
                logger.exception(
                    "unreadable outbox entry %s; leaving it on disk", path)
                continue
            entries.append(OutboxEntry(
                result,
                str(result.get("id", "unknown")),
                path,
                float(payload.get("spooled_at", time.time())),
                retries=int(payload.get("retries", 0) or 0),
                parked=path.name.endswith(".parked"),
            ))
            _RECOVERED.inc()
        entries.sort(key=lambda e: (e.spooled_at, str(e.path)))
        self.refresh_gauges()
        return entries

    def note_retry(self) -> None:
        _RETRIES.inc()

    # --- state for healthz / metrics ---

    def _files(self) -> list[Path]:
        try:
            return sorted(self.directory.glob("*.json")) + sorted(
                self.directory.glob("*.json.parked"))
        except OSError:
            return []

    @property
    def depth(self) -> int:
        return len(self._files())

    def oldest_age_s(self) -> float | None:
        ages = []
        for path in self._files():
            try:
                ages.append(time.time() - path.stat().st_mtime)
            except OSError:
                continue
        return max(ages) if ages else None

    @property
    def saturated(self) -> bool:
        return self.max_entries > 0 and self.depth >= self.max_entries

    def refresh_gauges(self) -> None:
        files = self._files()
        _DEPTH.set(len(files))
        oldest = 0.0
        for path in files:
            try:
                oldest = max(oldest, time.time() - path.stat().st_mtime)
            except OSError:
                continue
        _OLDEST.set(round(oldest, 1))
