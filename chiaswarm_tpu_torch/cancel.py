"""Worker-side cancel tokens, the counterpart of chiaswarm_tpu/cancel.py.

The hive owns the durable half of a cancellation; this module is the
volatile worker half: a process-wide set of job ids whose cancel the hive
piggybacked on a `/work` reply (`cancels: [...]`) while the job was already
running on the device. The worker's poll loop marks an id here, and the
chunked denoise (pipelines/stable_diffusion.py, `denoise_chunk_steps`)
probes it before the first step, at every chunk boundary and after the
last step:

- a solo pass whose job is cancelled raises `JobCancelled` and frees the
  device within one chunk instead of one whole pass;
- a coalesced pass with a cancelled member keeps running (the padded
  shapes are fixed and the batchmates must finish unharmed), and the
  cancelled row comes back flagged, so that no envelope is built for it;
- a coalesced pass whose every member is cancelled raises like a solo.

A job the worker still holds (lingering in the batch scheduler, or
released and not yet started) never reaches this registry:
`BatchScheduler.cancel` drops it. The worker discards a pass's ids when
the pass ends, so a later job with the same id is never poisoned by a
stale token.

`swarm_cancel_tokens_pending` counts the marked ids, as in the JAX
package. The worker hands each pass its job id(s) explicitly (`job_id` on the
solo run, one per request of a coalesced one). Thread-safe: the event
loop marks ids while the device thread probes them.
"""

from __future__ import annotations

import threading

from . import telemetry

_PENDING = telemetry.gauge(
    "swarm_cancel_tokens_pending",
    "Job ids marked cancelled while executing, not yet reaped by their "
    "slice (the chunked denoise probes these at chunk boundaries)")


class JobCancelled(Exception):
    """A pass aborted because every job it served was cancelled. The
    worker builds no envelope for it: the hive already tombstoned the
    jobs."""

    def __init__(self, job_ids):
        self.job_ids = [str(j) for j in (job_ids or [])]
        super().__init__("job cancelled mid-denoise: " + (",".join(self.job_ids) or "?"))


class CancelRegistry:
    """The ids of jobs cancelled while executing (marked by the poll loop,
    probed by the device thread, discarded when the pass ends)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ids: set[str] = set()

    def cancel(self, job_id) -> None:
        with self._lock:
            self._ids.add(str(job_id))
            _PENDING.set(len(self._ids))

    def cancelled(self, job_id) -> bool:
        with self._lock:
            return str(job_id) in self._ids

    def discard(self, job_id) -> None:
        with self._lock:
            self._ids.discard(str(job_id))
            _PENDING.set(len(self._ids))

    def clear(self) -> None:
        with self._lock:
            self._ids.clear()
            _PENDING.set(0)


_REGISTRY = CancelRegistry()


def get_registry() -> CancelRegistry:
    return _REGISTRY


def cancel(job_id) -> None:
    _REGISTRY.cancel(job_id)


def cancelled(job_id) -> bool:
    return _REGISTRY.cancelled(job_id)


def discard(job_id) -> None:
    _REGISTRY.discard(job_id)
