"""Cross-job batching: hold compatible hive jobs for a short linger window
and release them as one work item. The counterpart of
chiaswarm_tpu/batching.py `BatchScheduler`, trimmed to the port's one
device.

`put()` admits raw hive jobs. A job whose `coalesce_key` is None leaves at
once as a work item of its own ("solo"). Others join the open group of
their key, which leaves as one item when its linger window ends
("linger"), when it holds `max_coalesce` jobs ("size"), when its images
reach the device's rows limit ("rows", checked before a job would push it
past the limit too), when a new distinct adapter would pass `lora_slots`
("slots"), when an interactive job joins it ("priority"), when an
interactive job of another key dispatches ("preempt": the one device is
contended, so linger luck must not decide who goes first), or at
`flush_all()` / `close()` ("shutdown"). The device takes items in FIFO
order with `get()`; `task_done(job)` and `full()` gate the poll loop as an
asyncio.Queue would. `cancel(job_id)` drops a job the hive cancelled while
it is still held here, lingering or released and not yet taken.

`put_gang(jobs)` admits a gang, the jobs a gang-scheduling hive handed in
one reply under one `trace.gang` id: it leaves at once ("gang", no
linger: the hive did the waiting), as the JAX scheduler releases it. Only
rows and `max_coalesce` chunk it (and the distinct adapters past
`lora_slots`): a gang larger than one pass leaves as several items, a
member whose key is None, or differs, goes through `put()`, and a closed
scheduler, or one with `max_coalesce` 1, admits every member through
`put()`. A zero linger does not stop a gang, as in JAX. `outstanding_rows` (the
images lingering, released and executing) is what the worker advertises
as its `queue_depth`. Each flushed job's `trace` (when the hive sent one)
gets `lingered_s` and `coalesced_with`, which the hive's accounting reads
back from the envelope.

Each release is counted as the JAX scheduler counts it:
`swarm_batch_flush_total{reason}`, `swarm_batch_group_jobs`, and for a
coalescing group or a gang `swarm_batch_group_rows` and
`swarm_batch_linger_wait_seconds`. Left out, as the port has one device:
the dispatch board's placement matching (`claim`,
`swarm_placement_total`).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable

from . import telemetry
from .coalesce import adapter_ref, coalesce_key, is_interactive, job_rows

logger = logging.getLogger(__name__)

_FLUSHES = telemetry.counter(
    "swarm_batch_flush_total",
    "Work items released by the batch scheduler, by flush reason",
    ("reason",),
)
_GROUP_JOBS = telemetry.histogram(
    "swarm_batch_group_jobs",
    "Jobs per released work item (coalesce factor; 1 = solo dispatch)",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16),
)
_GROUP_ROWS = telemetry.histogram(
    "swarm_batch_group_rows",
    "Images per released coalesced group",
    buckets=(1, 2, 4, 8, 16, 32),
)
_LINGER_WAIT = telemetry.histogram(
    "swarm_batch_linger_wait_seconds",
    "Open time of a coalescing group from first job to flush",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
)


def _stamp_trace(jobs: list[dict], lingered: float) -> None:
    """The linger split of each job's hive trace context, which the envelope
    echoes back."""
    for job in jobs:
        if isinstance(job.get("trace"), dict):
            job["trace"]["lingered_s"] = round(lingered, 3)
            job["trace"]["coalesced_with"] = len(jobs) - 1


class BatchScheduler:
    def __init__(self, linger_s: float = 0.05, max_coalesce: int = 8, maxsize: int = 0,
                 ready_maxsize: int = 0, rows_limit: Callable[[dict], int | None] | None = None,
                 lora_slots: int = 8):
        self.linger_s = max(float(linger_s), 0.0)
        self.max_coalesce = int(max_coalesce)
        self.lora_slots = max(int(lora_slots), 1)
        self.maxsize = int(maxsize)
        self.ready_maxsize = int(ready_maxsize)
        self.rows_limit = rows_limit
        # released work items, oldest first: {"jobs", "reason"}
        self._board: list[dict] = []
        self._change = asyncio.Event()
        # key -> {"jobs", "rows", "cap", "adapters", "opened", "timer"}
        self._pending: dict[tuple, dict] = {}
        self._outstanding = 0
        self._ready_jobs = 0
        # images released and not taken, and taken and not done
        self._ready_rows = 0
        self._executing_rows = 0
        self._closed = False

    # --- the queue surface of the worker's loops ---

    def full(self) -> bool:
        """Poll gating: released jobs not yet taken, or all jobs in flight,
        at their bounds (0 = unbounded)."""
        if self.ready_maxsize > 0 and self._ready_jobs >= self.ready_maxsize:
            return True
        return self.maxsize > 0 and self._outstanding >= self.maxsize

    def task_done(self, job: dict | None = None) -> None:
        """One job finished executing (`job` gives its image count; one
        image without it)."""
        self._outstanding -= 1
        self._executing_rows = max(
            self._executing_rows - (job_rows(job) if job is not None else 1), 0)

    @property
    def outstanding_jobs(self) -> int:
        """Lingering, released and executing jobs."""
        return self._outstanding

    @property
    def ready_jobs(self) -> int:
        """Released jobs not yet taken by the device."""
        return self._ready_jobs

    @property
    def pending_jobs(self) -> int:
        """Jobs lingering in open groups."""
        return sum(len(g["jobs"]) for g in self._pending.values())

    @property
    def outstanding_rows(self) -> int:
        """Images lingering, released and executing: the hive's gang budget
        counts rows, not jobs."""
        return (sum(g["rows"] for g in self._pending.values()) + self._ready_rows
                + self._executing_rows)

    async def get_item(self) -> dict:
        """The oldest released work item {"jobs", "reason"}."""
        while not self._board:
            await self._change.wait()
        entry = self._board.pop(0)
        self._ready_jobs -= len(entry["jobs"])
        rows = sum(job_rows(job) for job in entry["jobs"])
        self._ready_rows -= rows
        self._executing_rows += rows
        return entry

    async def get(self) -> list[dict]:
        """The jobs of the oldest released work item."""
        return (await self.get_item())["jobs"]

    def _release(self, jobs: list[dict], reason: str) -> None:
        _FLUSHES.inc(reason=reason)
        _GROUP_JOBS.observe(len(jobs))
        self._ready_jobs += len(jobs)
        self._ready_rows += sum(job_rows(job) for job in jobs)
        self._board.append({"jobs": jobs, "reason": reason})
        event, self._change = self._change, asyncio.Event()
        event.set()

    # --- admission ---

    async def put(self, job: dict) -> None:
        self._outstanding += 1
        if self._closed or self.max_coalesce <= 1 or self.linger_s <= 0:
            self._release([job], "solo")
            return
        key = coalesce_key(job)
        if key is None:
            if is_interactive(job):
                self._preempt_lingerers()
            self._release([job], "solo")
            return

        rows = job_rows(job)
        adapter = adapter_ref(job)
        group = self._pending.get(key)
        if group is not None and group["cap"] is not None and group["rows"] + rows > group["cap"]:
            # this job would push the group past one pass: release it now
            self._flush(key, "rows")
            group = None
        if (group is not None and adapter is not None and adapter not in group["adapters"]
                and len(group["adapters"]) >= self.lora_slots):
            self._flush(key, "slots")
            group = None
        if group is None:
            cap = None
            if self.rows_limit is not None:
                try:
                    cap = self.rows_limit(job)
                except Exception:  # noqa: BLE001 — the capacity probe is advisory
                    logger.exception("rows_limit probe failed")
            group = {"jobs": [], "rows": 0, "cap": cap, "adapters": set(),
                     "opened": time.monotonic()}
            group["timer"] = asyncio.get_running_loop().call_later(
                self.linger_s, self._flush, key)
            self._pending[key] = group
        group["jobs"].append(job)
        group["rows"] += rows
        if adapter is not None:
            group["adapters"].add(adapter)
        if is_interactive(job):
            # the interactive job takes its group with it now
            self._flush(key, "priority")
            self._preempt_lingerers()
        elif len(group["jobs"]) >= self.max_coalesce:
            self._flush(key, "size")
        elif group["cap"] is not None and group["rows"] >= group["cap"]:
            self._flush(key, "rows")

    async def put_gang(self, jobs: list[dict]) -> None:
        """Admit a gang: each key's members leave at once ("gang"), in
        chunks of at most `max_coalesce` jobs, the rows limit and
        `lora_slots` distinct adapters; members whose key is None go through
        `put()`, as does every member of a lone job's gang or on a closed
        scheduler."""
        if len(jobs) <= 1 or self._closed or self.max_coalesce <= 1:
            for job in jobs:
                await self.put(job)
            return
        solos: list[dict] = []
        by_key: dict[tuple, list[dict]] = {}
        for job in jobs:
            key = coalesce_key(job)
            if key is None:
                solos.append(job)
            else:
                by_key.setdefault(key, []).append(job)
        for members in by_key.values():
            cap = None
            if self.rows_limit is not None:
                try:
                    cap = self.rows_limit(members[0])
                except Exception:  # noqa: BLE001 — the capacity probe is advisory
                    logger.exception("rows_limit probe failed")
            chunk: list[dict] = []
            rows = 0
            adapters: set[str] = set()
            for job in members:
                r, a = job_rows(job), adapter_ref(job)
                if chunk and (len(chunk) >= self.max_coalesce
                              or (cap is not None and rows + r > cap)
                              or (a is not None and a not in adapters
                                  and len(adapters) >= self.lora_slots)):
                    self._release_gang(chunk, rows)
                    chunk, rows, adapters = [], 0, set()
                chunk.append(job)
                rows += r
                if a is not None:
                    adapters.add(a)
            if chunk:
                self._release_gang(chunk, rows)
        for job in solos:
            await self.put(job)
        if any(is_interactive(job) for job in jobs):
            self._preempt_lingerers()

    def _release_gang(self, jobs: list[dict], rows: int) -> None:
        self._outstanding += len(jobs)
        _GROUP_ROWS.observe(rows)
        _LINGER_WAIT.observe(0.0)
        _stamp_trace(jobs, 0.0)
        if len(jobs) > 1:
            logger.info("hive gang of %d jobs (%d images) for %s", len(jobs), rows,
                        jobs[0].get("model_name"))
        self._release(jobs, "gang")

    def _preempt_lingerers(self) -> None:
        """An interactive job dispatches: every other lingering group
        leaves now (the one device is contended), behind it in FIFO
        order."""
        for other in list(self._pending):
            self._flush(other, "preempt")

    def _flush(self, key: tuple, reason: str = "linger") -> None:
        group = self._pending.pop(key, None)
        if group is None:  # the timer fired after an earlier flush
            return
        group["timer"].cancel()
        lingered = time.monotonic() - group["opened"]
        _GROUP_ROWS.observe(group["rows"])
        _LINGER_WAIT.observe(lingered)
        _stamp_trace(group["jobs"], lingered)
        if len(group["jobs"]) > 1:
            logger.info("coalesced %d jobs (%d images) for %s [%s] after %.3fs",
                        len(group["jobs"]), group["rows"], key[0], reason, lingered)
        self._release(group["jobs"], reason)

    def cancel(self, job_id) -> bool:
        """Drop a job the hive cancelled while it is held here: a member of
        an open group (a group left empty goes, with its timer) or of a
        released item not yet taken (an item left empty goes). True when
        found; the job leaves the outstanding count, and no envelope is
        ever built for it. A job already taken by the device is not here:
        the cancel registry (cancel.py) reaches it."""
        job_id = str(job_id)
        for key, group in list(self._pending.items()):
            for job in group["jobs"]:
                if str(job.get("id")) != job_id:
                    continue
                group["jobs"].remove(job)
                group["rows"] -= job_rows(job)
                # an adapter may be shared by a surviving member
                group["adapters"] = {a for a in map(adapter_ref, group["jobs"])
                                     if a is not None}
                self._outstanding -= 1
                if not group["jobs"]:
                    group["timer"].cancel()
                    del self._pending[key]
                logger.info("cancelled lingering job %s before it ran", job_id)
                return True
        for entry in list(self._board):
            for job in entry["jobs"]:
                if str(job.get("id")) != job_id:
                    continue
                entry["jobs"].remove(job)
                self._ready_jobs -= 1
                self._ready_rows -= job_rows(job)
                self._outstanding -= 1
                if not entry["jobs"]:
                    self._board.remove(entry)
                logger.info("cancelled released job %s before it ran", job_id)
                return True
        return False

    def flush_all(self) -> None:
        """Release every lingering group now."""
        for key in list(self._pending):
            self._flush(key, "shutdown")

    def close(self) -> None:
        """Drain: release every lingering group, and admit later jobs solo."""
        self._closed = True
        self.flush_all()
