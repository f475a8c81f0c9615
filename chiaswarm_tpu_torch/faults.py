"""Deterministic fault injection for the worker: the counterpart of
chiaswarm_tpu/faults.py (the switchboard copied; the port imports nothing
of the JAX package).

Named injection points compiled into the runtime, free when disarmed (one
dict lookup) and deterministic when armed: a test or a smoke phase arms
exactly the failure it wants, N times.

Spec grammar (``Settings.fault_injection`` / ``CHIASWARM_FAULTS``):

    "drop_submit=3,hang_denoise=1"

arms each named point for its first N hits. Special key ``hang_timeout``
(seconds, float) bounds how long a hang blocks when nobody calls
``release_hangs()``.

Injection points of the port's worker (site -> effect):

- ``drop_submit``    hive.HiveClient.submit_result raises the transport
                     error of a dropped connection before the POST leaves
                     the worker
- ``kill_before_ack`` the worker's uploader raises FaultInjected AFTER the
                     hive's ACK, BEFORE the outbox unlink (a simulated
                     crash: the worker stops, the envelope stays spooled
                     for the next start)
- ``hang_denoise``   the device task blocks, holding the device, until
                     ``release_hangs()`` / hang_timeout (a hung pass; the
                     watchdog's case)
- ``oom_batched``    a coalesced pass raises an out-of-memory error before
                     it runs (each member is then served alone)
- ``hang_after_checkpoint`` the checkpoint shipper blocks right after it
                     hands a checkpoint upload to the event loop (the
                     worker dies mid-denoise past a durable checkpoint)

Sites call ``faults.fire(point)`` / ``faults.hang(point)`` by name;
unknown names never fire, so a new point costs one line at its site.
"""

from __future__ import annotations

import logging
import os
import threading

logger = logging.getLogger(__name__)

DEFAULT_HANG_TIMEOUT_S = 600.0


class FaultInjected(Exception):
    """An armed injection point fired (the default exception when the
    site didn't supply a more realistic one)."""


class FaultPlan:
    """One parsed fault spec: armed counts per point, fired counts for
    assertions, and the shared hang latch. Thread-safe — sites fire from
    the device thread while the asyncio loop reads counters."""

    def __init__(self, spec: str = "",
                 hang_timeout_s: float = DEFAULT_HANG_TIMEOUT_S):
        self.hang_timeout_s = float(hang_timeout_s)
        self._lock = threading.Lock()
        self._armed: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        self._release = threading.Event()
        self._hanging = 0
        for part in (spec or "").replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            point, _, count = part.partition("=")
            point = point.strip()
            try:
                value = float(count) if count else 1.0
            except ValueError:
                logger.warning("unparseable fault spec entry %r ignored", part)
                continue
            if point == "hang_timeout":
                self.hang_timeout_s = value
            else:
                self._armed[point] = int(value)

    # --- introspection (tests, smoke phases) ---

    def active(self, point: str) -> bool:
        with self._lock:
            return self._armed.get(point, 0) > 0

    def fired(self, point: str) -> int:
        with self._lock:
            return self._fired.get(point, 0)

    @property
    def hanging(self) -> int:
        """Threads currently blocked inside a hang point."""
        with self._lock:
            return self._hanging

    # --- injection sites ---

    def _consume(self, point: str) -> bool:
        with self._lock:
            if self._armed.get(point, 0) <= 0:
                return False
            self._armed[point] -= 1
            self._fired[point] = self._fired.get(point, 0) + 1
            return True

    def fire(self, point: str, exc: Exception | None = None) -> None:
        """Raise at an armed point (consuming one charge); no-op otherwise.

        `exc` lets the site raise the exception class its real failure
        would produce (e.g. an aiohttp connection error) so downstream
        classification paths run unmodified.
        """
        if not self._consume(point):
            return
        logger.warning("fault injected: %s", point)
        raise exc if exc is not None else FaultInjected(point)

    def hang(self, point: str) -> None:
        """Block the calling thread at an armed point until
        ``release_hangs()`` or hang_timeout; no-op otherwise."""
        if not self._consume(point):
            return
        logger.warning("fault injected: %s (hanging, timeout %.0fs)",
                       point, self.hang_timeout_s)
        with self._lock:
            self._hanging += 1
        try:
            self._release.wait(self.hang_timeout_s)
        finally:
            with self._lock:
                self._hanging -= 1

    def release_hangs(self) -> None:
        """Unblock every current and future hang point (the 'hang clears'
        half of a watchdog-recovery scenario)."""
        self._release.set()


_plan = FaultPlan(os.environ.get("CHIASWARM_FAULTS", ""))


def configure(spec: str = "",
              hang_timeout_s: float = DEFAULT_HANG_TIMEOUT_S) -> FaultPlan:
    """Install (and return) a fresh process-wide plan. ``configure("")``
    disarms everything — call it in test teardown."""
    global _plan
    # a replaced plan must not strand threads blocked in its hang points
    _plan.release_hangs()
    _plan = FaultPlan(spec, hang_timeout_s)
    return _plan


def get_plan() -> FaultPlan:
    return _plan


def active(point: str) -> bool:
    return _plan.active(point)


def fire(point: str, exc: Exception | None = None) -> None:
    _plan.fire(point, exc)


def hang(point: str) -> None:
    _plan.hang(point)
