"""The port's worker: poll the hive -> batch -> format -> run -> POST the
envelopes.

The core loop of chiaswarm_tpu/worker.py with the same wire shapes:
bearer auth, `worker_version`, a capability advertisement with the GPU in
the legacy `gpu`/`memory` keys as well as `chips`/`hbm_gb` (and
`unconverted_families`, the model-name keywords of the families the port
does not serve yet, which the repo's hive matches against a job's model
name before it hands the job out; and `flux_runnable`, whether
FLUX.1-dev's bundle and one 1024^2 image fit the device resident, by
capacity.py's tables), and result
envelopes {id, artifacts (b64 + sha256), nsfw, worker_version,
pipeline_config (with timings), fatal_error on unrecoverable jobs}.

Cross-job batching, as the JAX worker's poll loop, slice worker and
`ChipSet.run_batched` do it on one device: the poll loop puts each job
into a `BatchScheduler` (batching.py), and one device task takes its
work items in order. A single job runs through `execute`. A group formats
every member; when every member formats to the diffusion callback the
group runs as one `diffusion_batched_callback` pass (each member's seed
drawn where the job has none and stamped into its envelope, `job_s` the
pass's wall time), otherwise each member runs alone. Any exception in the
pass serves every member alone, which gives each job the fatal or
transient envelope it would have had; a member that does not format gets
its own fatal envelope. Every job gets exactly one envelope, unless the
hive cancelled it. The poll loop asks for work only while the device is
idle and nothing released waits for it; while the device is busy it goes
on polling with `cancel_only=1` (the cancel-only heartbeat), so that the
hive's revocations (`cancels` on the reply) reach it.

Cancels, chunked denoise, checkpoints, resume and previews, as the JAX
worker does them: a revoked job still held by the scheduler is dropped; a
running one is marked in the cancel registry (cancel.py), which the
pipeline probes at every `denoise_chunk_steps` boundary, so the device is
free within one chunk; a cancelled solo, or a pass whose every member was
cancelled, delivers nothing, and a cancelled member of a coalesced pass
no envelope. A solo diffusion pass with chunking on ships a checkpoint
(checkpoint.py) every `checkpoint_every_chunks` boundaries and a JPEG
preview every `preview_every_chunks` to the hive, both fire and forget
from the event loop; a checkpoint larger than `checkpoint_max_bytes` is
skipped. The poll advertises `resume_capable` when chunking and
checkpoints are both on, and a redelivered solo job's `resume` offer is
fetched and unpacked before its pass, which then restarts at the
checkpoint's step; any failure runs the full pass. A coalesced pass never
checkpoints or resumes.

The worker plane, as the JAX worker has it:

- Durable delivery (outbox.py): the device task spools each envelope to
  `$SDAAS_ROOT/outbox/` and goes on to its next pass; an uploader task
  delivers the spool with capped backoff and jitter, unlinks an entry
  only on the hive's ACK, and parks it on a permanent refusal (4xx) or
  on an ACK that says the hive will not store it (`cancelled`,
  `expired`, `unknown_job`). A starting worker redelivers what a
  previous process left spooled. `run(max_jobs)` returns only once every
  envelope is delivered or parked.
- The watchdog: a pass past `job_deadline_s` (scaled by
  `job_deadline_compile_scale` when its model is not resident, capped by
  the jobs' own `deadline_s`) gives each of its jobs the transient-error
  envelope, and the device is quarantined: no work is taken and
  `/healthz` reads degraded until a probe, a tiny matmul on the device
  once the hung pass has released it (within `quarantine_probe_grace_s`),
  returns it to service. The hung pass cannot be stopped; it runs on.
- The drain: `stop(drain=True)`, which SIGTERM calls, stops taking work,
  finishes the passes in flight and flushes the outbox, for at most
  `drain_deadline_s`.
- Telemetry (telemetry.py): the JAX worker's poll, job, queue, watchdog,
  cancel, checkpoint, preview and resume metrics, the stage histogram
  fed from each pass's timings (`denoise` is `denoise_s + decode_s`),
  and on `metrics_host:metrics_port` `GET /metrics`, `GET /healthz`,
  `GET /debug/programs` (programs.py), `GET /debug/memory`
  (memory_census.py) and `POST /debug/profile?seconds=N`, a
  torch.profiler capture (gated by `profiler_capture`, behind the bearer
  token when one is set, one at a time).
- Fault points (faults.py): `drop_submit` (hive.py), `kill_before_ack`
  (the uploader: a simulated crash that leaves the envelope spooled),
  `hang_denoise` (the device task), `oom_batched` (a coalesced pass) and
  `hang_after_checkpoint` (the checkpoint shipper).

Several hives, gangs and stage graphs, as the JAX worker serves them:

- The hive client (hive.py) pins one of `sdaas_uris` and fails over; the
  poll loop backs off a failed poll with decorrelated jitter
  (`_next_backoff`: U(cadence, 3 x the last pause), capped at
  ERROR_BACKOFF_SECONDS), so failing over takes a few cadences, not the
  cap. `/healthz` has a `hive` block (endpoints, the active one,
  failovers, epoch).
- A gang-scheduling hive hands same-key jobs in one reply under one
  `trace.gang` id: they enter the scheduler together (`put_gang`, flushed
  at once). The poll advertises `gang_rows` (`max_coalesce`) and
  `queue_depth` (the scheduler's outstanding images), and, once samples
  exist, `stats`: the per-stage EWMAs of this worker's
  own timings (`hive_stats_ewma_alpha`), folded once per physical pass
  (the pass's `denoise_s + decode_s` as `denoise`, its wall clock as
  `pass`; waits left out). The hive's `trace` context comes off each job
  (stamped with the receipt instant, and with the linger split when the
  scheduler releases it) and rides the envelope back as
  `pipeline_config.trace`.
- Stage graphs: the poll advertises `stages` (`stage_roles`; the host
  stages only while the lane has consumers). A stage-job's predecessor
  artifacts are fetched through the authed client before it is queued.
  Chip stages (denoise, upscale) go through the scheduler to the device;
  the host stages (encode, decode, postprocess) go to the stage lane,
  `stage_workers` consumers that run their callbacks off the device
  thread (device "cpu" for their own work; the decode's NSFW check is the
  process's checker on the card) and ship through the same finish and
  outbox path. A cancel drops a queued stage-job; `swarm_queue_depth
  {queue="stage"}` and `/healthz`'s `stage_lane` count the lane, and the
  drain waits for it. The poll after a stage-job's envelope waits (at most
  HANDOFF_WAIT_SECONDS) until the envelope is delivered, since the hive
  admits the next stage on delivery: so the decode of one workflow rides
  the reply that hands the denoise of the next, and runs beside it.
  `Worker.timeline` keeps the last work items' spans on the device and the
  lane.

Run it with `python -m chiaswarm_tpu_torch.worker` (on the card; settings
from $SDAAS_ROOT/settings.json and the SDAAS_* and CHIASWARM_* variables).
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import collections
import json
import logging
import random
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from . import __version__, faults, memory_census, programs, telemetry
from . import cancel as cancel_registry
from . import checkpoint
from . import outbox as outbox_mod
from .batching import BatchScheduler
from .cancel import JobCancelled
from .capacity import coalesce_rows_limit, default_canvas, fit_batch
from .coalesce import CHIP_STAGES, CPU_STAGES, stage_of
from .device import device_label, memory_gb, resolve_device, synchronize
from .embed_cache import from_settings
from .faults import FaultInjected
from .hive import HiveClient, HiveError
from .job_arguments import format_args
from .log_setup import setup_stream
from .lora_cache import LoraCache
from .outbox import Outbox, OutboxEntry
from .post_processors.output_processor import (
    exception_image,
    fatal_exception_response,
    image_to_buffer,
    to_pil,
)
from .registry import Registry, unconverted_family_keywords
from .settings import load_settings, resolve_path
from .telemetry import observe_stage, trace_job
from .workflows.diffusion import diffusion_batched_callback, diffusion_callback

logger = logging.getLogger(__name__)

# the model whose resident fit `flux_runnable` advertises
FLUX_DEV = "black-forest-labs/FLUX.1-dev"
POLL_SECONDS = 11.0
ERROR_BACKOFF_SECONDS = 121.0
# the longest an idle poll waits for a stage-job's envelope to land
HANDOFF_WAIT_SECONDS = 5.0
# the revocations `Worker.cancels` keeps, newest last
MAX_CANCEL_RECORDS = 256
# the pipeline timings the stage histogram reads, under the JAX worker's
# stage names (its `denoise` span, denoise_decode_s, is the port's
# denoise_s + decode_s)
STAGE_KEYS = {"text_encode_s": "text_encode", "upscale_s": "upscale"}

_JOBS_POLLED = telemetry.counter(
    "swarm_jobs_polled_total", "Jobs received from hive /work polls")
_POLL_ERRORS = telemetry.counter(
    "swarm_poll_errors_total", "ask_for_work calls that raised")
_JOBS_COMPLETED = telemetry.counter(
    "swarm_jobs_completed_total",
    "Result envelopes produced, by outcome (ok | error | fatal)",
    ("outcome",),
)
_LAST_POLL = telemetry.gauge(
    "swarm_last_poll_unixtime",
    "Wall-clock time of the last successful hive poll")
_SLICES_TOTAL = telemetry.gauge(
    "swarm_slices_total", "Chip slices this worker serves jobs on")
_SLICES_BUSY = telemetry.gauge(
    "swarm_slices_busy", "Chip slices currently executing a job")
_JOBS_IN_FLIGHT = telemetry.gauge(
    "swarm_jobs_in_flight",
    "Jobs accepted from the hive and not yet uploaded")
_QUEUE_DEPTH = telemetry.gauge(
    "swarm_queue_depth",
    "Jobs per internal queue (lingering = open coalescing groups, "
    "ready = released to slice workers, results = awaiting upload)",
    ("queue",),
)
_WATCHDOG_EXPIRED = telemetry.counter(
    "swarm_watchdog_expired_total",
    "Jobs whose execution exceeded the slice watchdog deadline",
    ("kind",),
)
_WATCHDOG_PROBES = telemetry.counter(
    "swarm_watchdog_probe_total",
    "Quarantined-slice smoke probes, by outcome (ok | failed | wedged)",
    ("outcome",),
)
_SLICE_STATE = telemetry.gauge(
    "swarm_slice_state",
    "Chip slices by lifecycle state (active | quarantined)",
    ("state",),
)
_CHECKPOINTS = telemetry.counter(
    "swarm_checkpoints_total",
    "Mid-pass checkpoints cut at denoise chunk boundaries, by outcome "
    "(shipped = the hive stored it; oversize = bigger than "
    "checkpoint_max_bytes, skipped; error = pack or upload failed)",
    ("outcome",),
)
_PREVIEWS = telemetry.counter(
    "swarm_previews_total",
    "Progressive preview frames decoded at denoise chunk boundaries, "
    "by outcome (shipped | error)",
    ("outcome",),
)
_RESUMES = telemetry.counter(
    "swarm_resume_total",
    "Redelivered jobs that arrived with a resume offer, by outcome "
    "(resumed = checkpoint fetched+unpacked and handed to the pipeline; "
    "fetch_failed | unpack_failed degrade to a full pass)",
    ("outcome",),
)
_JOBS_CANCELLED = telemetry.counter(
    "swarm_jobs_cancelled_total",
    "Hive-revoked jobs this worker dropped, by where the cancel caught "
    "them (held = still lingering/on the dispatch board, no envelope "
    "ever produced; executing = aborted or row-dropped mid-denoise at a "
    "chunk boundary; unknown = already delivered or never held)",
    ("stage",),
)


def _next_backoff(prev: float, base: float = POLL_SECONDS,
                  cap: float = ERROR_BACKOFF_SECONDS) -> float:
    """The pause after a failed poll, with decorrelated jitter: U(base,
    3 x prev), capped, so repeated failures walk up to the cap and a fleet
    that lost its hive together does not poll again in lockstep."""
    prev = max(float(prev), base)
    return min(float(cap), random.uniform(base, prev * 3))


def fold_stage_stats(stats: dict, alpha: float, timings: dict) -> None:
    """Fold one pass's timings into `stats` {stage: [ewma_s, samples]}, as
    the JAX worker folds them: every `<stage>_s` span, waits
    (`queue_wait_s`) left out, and the pass's `denoise_s` and `decode_s`
    read as one span, `denoise` (the port's denoise span)."""
    spans = dict(timings)
    if isinstance(spans.get("denoise_s"), (int, float)) and not isinstance(
            spans.get("denoise_s"), bool):
        decode = spans.pop("decode_s", 0.0)
        spans["denoise_s"] += decode if isinstance(decode, (int, float)) else 0.0
    for key, value in spans.items():
        if not (isinstance(key, str) and key.endswith("_s")) or key == "queue_wait_s":
            continue
        try:
            v = float(value)
        except (TypeError, ValueError):
            continue
        if v < 0:
            continue
        entry = stats.get(key[:-2])
        if entry is None:
            stats[key[:-2]] = [v, 1]
        else:
            entry[0] += alpha * (v - entry[0])
            entry[1] += 1


def _deadline_cap_of(job: dict) -> float:
    """The job's own watchdog cap from its `deadline_s` field; 0 = none
    (garbage too: the field is the submitter's, forwarded unchecked)."""
    try:
        cap = float(job.get("deadline_s") or 0.0)
    except (TypeError, ValueError):
        return 0.0
    return cap if cap > 0 else 0.0


def profiler_running() -> bool:
    """A torch.profiler is active in this process (on any thread)."""
    from torch.autograd import profiler

    return bool(profiler._is_profiler_enabled or torch.autograd._profiler_enabled())


class Worker:
    def __init__(self, settings=None, device=None, registry: Registry | None = None,
                 poll_seconds: float = POLL_SECONDS, heartbeat_seconds: float | None = None,
                 backoff_cap_seconds: float = ERROR_BACKOFF_SECONDS):
        """`poll_seconds` between polls of an idle worker (and the first
        pause after a failed one, which grows up to `backoff_cap_seconds`);
        `heartbeat_seconds` between the cancel-only polls of a busy one
        (`poll_seconds` unset)."""
        self.settings = settings or load_settings()
        self.device = resolve_device(device)
        self.registry = registry or Registry(
            self.device, self.settings.model_root_dir, self.settings.lora_root_dir,
            LoraCache(int(self.settings.lora_cache_mb) << 20,
                      int(self.settings.lora_operand_cache_mb) << 20),
            from_settings(self.settings.embed_cache_mb), self.settings.safety_checker_model)
        self.hive = HiveClient(self.settings)
        self.poll_seconds = poll_seconds
        self.heartbeat_seconds = (poll_seconds if heartbeat_seconds is None
                                  else heartbeat_seconds)
        self.backoff_cap_seconds = backoff_cap_seconds
        # durable result spool: envelopes land here before their first
        # upload and leave only on the hive's ACK
        self.outbox = Outbox(resolve_path(self.settings.outbox_dir or "outbox"),
                             max_entries=int(self.settings.outbox_max_entries))
        if self.settings.fault_injection:
            faults.configure(self.settings.fault_injection)
        # the byte census reads this worker's stores and device
        memory_census.set_device(self.device)
        memory_census.register("embed_cache", memory_census.cache_provider(
            self.registry.embed_cache))
        memory_census.register("lora_factor_cache", memory_census.cache_provider(
            self.registry.lora_cache.factors))
        memory_census.register("lora_operand_cache", memory_census.cache_provider(
            self.registry.lora_cache.operands))
        self.jobs_done = 0
        self._busy = False
        # the ids of the work item on the device (the cancel router's view)
        self._executing: set[str] = set()
        # job id -> {"stage", "marked_at", "freed_at"} of the latest
        # revocations (time.monotonic(); "freed_at" where a pass aborted)
        self.cancels: dict[str, dict] = {}
        # the loop partial uploads run on, and the uploads not yet done
        self._loop: asyncio.AbstractEventLoop | None = None
        self._uploads: set = set()
        # held by the thread that runs a pass (and by the probe): the
        # watchdog's view of whether the device is free
        self._device_lock = threading.Lock()
        self._quarantined = False
        # what the last quarantine probe did: {"outcome", "device",
        # "waited_s", "at"} (time.monotonic())
        self.last_probe: dict | None = None
        # True once the uploader stopped at `kill_before_ack` (a simulated
        # crash: the envelope stays spooled for the next start)
        self.crashed = False
        self._scheduler: BatchScheduler | None = None
        self._results: asyncio.Queue | None = None
        self._delivering = 0
        self._changed: asyncio.Event | None = None
        self._stopping: asyncio.Event | None = None
        self._draining: asyncio.Event | None = None
        self._in_service: asyncio.Event | None = None
        self._probe_tasks: set = set()
        self._metrics_runner = None
        self._profiling = False
        self._last_poll_monotonic: float | None = None
        # the per-stage EWMAs of this worker's own passes, {stage: [ewma_s,
        # samples]}, advertised as `stats`
        self._stage_stats: dict[str, list] = {}
        self._stats_alpha = min(max(float(self.settings.hive_stats_ewma_alpha or 0.2), 0.01),
                                1.0)
        # the host stage lane: its queue (made by run), the jobs it runs,
        # the ids queued and those cancelled while queued
        self._stage_queue: asyncio.Queue | None = None
        self._stage_running: set[str] = set()
        self._stage_queued_ids: set[str] = set()
        self._stage_cancelled: set[str] = set()
        # stage-jobs whose envelopes are spooled and not yet delivered
        self._handoff_ids: set[str] = set()
        # the last work items on the device and the lane: {"ids", "lane"
        # ("device" | "stage"), "start", "end"} (time.monotonic())
        self.timeline: collections.deque = collections.deque(maxlen=256)

    def scheduler(self) -> BatchScheduler:
        """The linger window between the poll loop and the device, from the
        settings: released work may hold one item, in flight at most one
        group's worth of jobs."""
        coalesce = max(int(self.settings.max_coalesce), 1)
        return BatchScheduler(linger_s=float(self.settings.batch_linger_ms) / 1000.0,
                              max_coalesce=coalesce, maxsize=coalesce, ready_maxsize=1,
                              rows_limit=self.rows_limit,
                              lora_slots=int(self.settings.lora_slots_max))

    def rows_limit(self, job: dict) -> int:
        """The most images of one coalesced group of this job's model and
        canvas on this device (capacity.py)."""
        model = job.get("model_name", "")
        params = job.get("parameters") or {}
        height = int(job.get("height", params.get("default_height")) or default_canvas(model))
        width = int(job.get("width", params.get("default_width")) or height)
        return coalesce_rows_limit(self.device, model, height, width)

    def identifier(self) -> str:
        return str(self.device)

    def capabilities(self) -> dict:
        gb = memory_gb(self.device)
        caps = {
            # legacy keys a reference hive understands
            "memory": gb << 30,
            "gpu": device_label(self.device),
            "chips": 1,
            "hbm_gb": gb,
            "topology": f"{self.device.type}x1",
            "backend": "torch",
            "resident_models": ",".join(self.registry.resident_models()),
            # adapters whose device stacks are warm here, for a hive that
            # routes a repeat adapter job back to them
            "resident_adapters": ",".join(self.registry.lora_cache.resident_adapter_refs()),
            "jobs_completed": self.jobs_done,
            # model-name keywords of the families this worker cannot serve,
            # which a capability-aware hive does not hand it
            "unconverted_families": ",".join(unconverted_family_keywords()),
            "flux_runnable": int(fit_batch(self.device, FLUX_DEV, 1, 1024) >= 1),
            # a redelivered job may come with a checkpoint to resume from
            "resume_capable": int(int(self.settings.denoise_chunk_steps) > 0
                                  and int(self.settings.checkpoint_every_chunks) > 0),
            # the gang budget of a gang-scheduling hive: images one pass
            # merges (max_coalesce, a job cap, so an underestimate for
            # multi-image jobs) against the images in flight here
            "gang_rows": max(int(self.settings.max_coalesce), 1),
            "queue_depth": (self._scheduler.outstanding_rows
                            if self._scheduler is not None else 0),
        }
        stages = self._stage_roles()
        if stages is not None:
            caps["stages"] = ",".join(sorted(stages))
        if self._stage_stats:
            caps["stats"] = json.dumps(
                {"a": self._stats_alpha,
                 "s": {stage: [round(ewma, 4), n]
                       for stage, (ewma, n) in self._stage_stats.items()}},
                separators=(",", ":"))
        return caps

    def _stage_roles(self) -> frozenset[str] | None:
        """The stage names the poll advertises, or None for no `stages`
        parameter ("none": the worker never sees a stage-job). "auto" is
        every stage, the host stages only while the lane has consumers; an
        explicit list passes through, less the host stages when the lane is
        off (a stage nothing pops would strand its jobs until their lease
        lapses)."""
        raw = str(self.settings.stage_roles or "auto").strip()
        if raw.lower() == "none":
            return None
        host_ok = int(self.settings.stage_workers or 0) > 0
        if raw.lower() == "auto":
            return frozenset(CHIP_STAGES | (CPU_STAGES if host_ok else frozenset()))
        roles = {r.strip() for r in raw.split(",") if r.strip()}
        if not host_ok:
            roles -= CPU_STAGES
        return frozenset(roles)

    def execute(self, job: dict, host: bool = False) -> dict | None:
        """Run one job to its result envelope (never raises for a job's
        own failure: ValueError/TypeError give a fatal envelope, anything
        else an error-image artifact the hive may retry; None when the hive
        cancelled the job during its pass). A diffusion job's pass is
        chunked, checkpointed and previewed as the settings say, and
        resumed from the job's `resume` offer. `host`: a host stage-job on
        the stage lane, with device "cpu" for the callback's own work and no
        seed drawn."""
        job = dict(job)
        offer = job.pop("resume", None)
        try:
            callback, args = format_args(job, self.settings, self.device)
        except Exception as e:  # noqa: BLE001 — malformed job: never resubmit
            logger.exception("format_args failed for job %s", job.get("id"))
            return fatal_exception_response(e, job.get("id"), job)
        if callback is diffusion_callback and int(self.settings.denoise_chunk_steps) > 0:
            self._arm(str(job.get("id")), args, offer)
        return self._run_one(job, callback, args, host)

    def _arm(self, job_id: str, args: dict, offer: dict | None) -> None:
        """A solo diffusion pass's checkpoint and preview shippers, and the
        state of its resume offer where one is given and usable."""
        s = self.settings
        if isinstance(offer, dict) and offer.get("href"):
            args["resume"] = self._resume_state(job_id, offer)
        if int(s.checkpoint_every_chunks) > 0:
            args["checkpoint_every_chunks"] = int(s.checkpoint_every_chunks)
            args["checkpoint_cb"] = self._checkpoint_shipper(job_id)
        if int(s.preview_every_chunks) > 0:
            args["preview_every_chunks"] = int(s.preview_every_chunks)
            args["preview_cb"] = self._preview_shipper(job_id)

    def _resume_state(self, job_id: str, offer: dict) -> dict | None:
        """The unpacked checkpoint of a resume offer, or None (logged) when
        it cannot be fetched or read: the full pass runs then. Resume is an
        optimisation, so no failure here reaches the job."""
        try:
            blob = self.hive.fetch_artifact(str(offer["href"]))
        except Exception as e:  # noqa: BLE001 — never a job error
            logger.warning("resume offer for %s: checkpoint fetch raised (%r); running the "
                           "full pass", job_id, e)
            blob = None
        if blob is None:
            _RESUMES.inc(outcome="fetch_failed")
            logger.warning("resume offer for %s: checkpoint fetch failed; running the full "
                           "pass", job_id)
            return None
        try:
            state = checkpoint.unpack(blob)
        except Exception as e:  # noqa: BLE001 — never a job error
            _RESUMES.inc(outcome="unpack_failed")
            logger.warning("resume offer for %s: checkpoint unpack failed (%r); running the "
                           "full pass", job_id, e)
            return None
        _RESUMES.inc(outcome="resumed")
        logger.info("job %s resumes from its checkpoint at step %s", job_id, state["step"])
        return state

    def _checkpoint_shipper(self, job_id: str):
        """The checkpoint callback of one pass: packs on the device thread,
        skips a blob over `checkpoint_max_bytes`, uploads fire and forget.
        A failed pack costs the checkpoint, never the pass."""
        max_bytes = int(self.settings.checkpoint_max_bytes)

        def ship(step, latents, leaves, signature, rng):
            try:
                blob = checkpoint.pack(step, latents, leaves, signature, rng)
            except Exception:  # noqa: BLE001 — the pass goes on without it
                _CHECKPOINTS.inc(outcome="error")
                logger.exception("checkpoint pack failed for %s", job_id)
                return
            if max_bytes > 0 and len(blob) > max_bytes:
                _CHECKPOINTS.inc(outcome="oversize")
                logger.warning("checkpoint for %s at step %d is %d bytes "
                               "(checkpoint_max_bytes %d); skipped", job_id, step, len(blob),
                               max_bytes)
                return
            self._ship("checkpoint", job_id, {
                "step": int(step), "signature": signature,
                "worker_name": self.settings.worker_name,
                "blob": base64.b64encode(blob).decode("ascii")})
            # the worker dies here, mid-denoise past a shipped checkpoint,
            # when the fault is armed
            faults.hang("hang_after_checkpoint")

        return ship

    def _preview_shipper(self, job_id: str):
        """The preview callback of one pass: the decoded boundary pixels as a
        JPEG, uploaded fire and forget. A failed encode costs the preview,
        never the pass."""

        def ship(step, pixels):
            try:
                buffer = image_to_buffer(to_pil(pixels[0]), "image/jpeg")
            except Exception:  # noqa: BLE001 — the pass goes on without it
                _PREVIEWS.inc(outcome="error")
                logger.exception("preview encode failed for %s", job_id)
                return
            self._ship("preview", job_id, {
                "step": int(step), "content_type": "image/jpeg",
                "worker_name": self.settings.worker_name,
                "blob": base64.b64encode(buffer.getvalue()).decode("ascii")})

        return ship

    def _post_partial(self, kind: str, job_id: str, payload: dict) -> None:
        counter = _CHECKPOINTS if kind == "checkpoint" else _PREVIEWS
        try:
            ack = self.hive.post_partial(kind, job_id, payload)
        except Exception:  # noqa: BLE001 — the pass goes on without it
            logger.exception("%s upload failed for %s", kind, job_id)
            ack = None
        counter.inc(outcome="shipped" if ack else "error")

    def _ship(self, kind: str, job_id: str, payload: dict) -> None:
        """Upload one partial from the device thread: on the event loop
        when the worker runs one (the pass never waits for it), else at
        once. A failed upload costs the partial, never the pass."""
        loop = self._loop
        if loop is None or loop.is_closed():
            self._post_partial(kind, job_id, payload)
            return
        upload = asyncio.to_thread(self._post_partial, kind, job_id, payload)
        try:
            future = asyncio.run_coroutine_threadsafe(upload, loop)
        except RuntimeError:  # the loop closed after the check
            upload.close()
            (_CHECKPOINTS if kind == "checkpoint" else _PREVIEWS).inc(outcome="error")
            logger.warning("%s for %s dropped: the event loop is gone", kind, job_id)
            return
        self._uploads.add(future)
        future.add_done_callback(self._uploads.discard)

    def _run_one(self, job: dict, callback, args: dict, host: bool = False) -> dict | None:
        job_id = job.get("id")
        args.pop("id", None)
        model_name = args.pop("model_name", "")
        seed = args.pop("seed", None)
        if seed is None and not host:
            seed = random.getrandbits(63)
        if callback is diffusion_callback:
            args.update(job_id=job_id, denoise_chunk_steps=int(self.settings.denoise_chunk_steps))
        started = time.perf_counter()
        try:
            # every record logged during the job carries its id
            with trace_job(job_id):
                artifacts, pipeline_config = callback(
                    "cpu" if host else self.identifier(), model_name, registry=self.registry,
                    seed=seed, **args)
        except JobCancelled as e:
            self._note_aborted(e)
            return None
        except (ValueError, TypeError) as e:
            logger.exception("job %s failed (fatal)", job_id)
            return fatal_exception_response(e, job_id, job)
        except Exception as e:  # noqa: BLE001 — transient: report as an artifact
            logger.exception("job %s failed", job_id)
            artifacts, pipeline_config = exception_image(e, job.get("content_type", "image/jpeg"))
        if not host:
            pipeline_config["seed"] = seed
        pipeline_config.setdefault("timings", {})["job_s"] = round(
            time.perf_counter() - started, 4)
        return {
            "id": job_id,
            "artifacts": artifacts,
            "nsfw": pipeline_config.get("nsfw", False),
            "worker_version": __version__,
            "pipeline_config": pipeline_config,
        }

    def _note_aborted(self, e: JobCancelled) -> None:
        logger.warning("pass of %s aborted: cancelled by the hive", e.job_ids)
        now = time.monotonic()
        for job_id in e.job_ids:
            self.cancels.setdefault(job_id, {})["freed_at"] = now

    def execute_group(self, jobs: list[dict]) -> list[dict | None]:
        """A work item of the scheduler -> one envelope per job, in order
        (None for a job the hive cancelled during its pass)."""
        if len(jobs) == 1:
            return [self.execute(jobs[0])]
        # a coalesced pass never resumes
        jobs = [{k: v for k, v in job.items() if k != "resume"} for job in jobs]
        envelopes: dict[int, dict | None] = {}
        prepared: dict[int, tuple] = {}
        for k, job in enumerate(jobs):
            try:
                prepared[k] = format_args(job, self.settings, self.device)
            except Exception as e:  # noqa: BLE001 — a malformed member: its own fatal envelope
                logger.exception("format_args failed for job %s", job.get("id"))
                envelopes[k] = fatal_exception_response(e, job.get("id"), job)
        if len(prepared) > 1 and all(cb is diffusion_callback for cb, _ in prepared.values()):
            try:
                envelopes.update(zip(prepared, self._run_pass(
                    [args for _, args in prepared.values()])))
            except JobCancelled as e:
                # every member was cancelled: nothing is delivered, and no
                # member runs again alone
                self._note_aborted(e)
                envelopes.update((k, None) for k in prepared)
            except Exception:  # noqa: BLE001 — every member runs alone instead
                logger.exception("coalesced pass for %s failed; serving its jobs alone",
                                 [jobs[k].get("id") for k in prepared])
        for k, (callback, args) in prepared.items():
            if k not in envelopes:
                envelopes[k] = self._run_one(jobs[k], callback, args)
        return [envelopes[k] for k in range(len(jobs))]

    def _run_pass(self, requests: list[dict]) -> list[dict | None]:
        """One coalesced pass over formatted job arguments -> envelopes,
        None for a member cancelled during the pass."""
        # before anything of the requests changes, so that each member
        # runs alone unchanged
        faults.fire("oom_batched", exc=torch.OutOfMemoryError(
            "CUDA out of memory: injected (fault oom_batched)"))
        requests = [dict(args) for args in requests]
        for args in requests:
            if args.get("seed") is None:
                args["seed"] = random.getrandbits(63)
        ids = [args.get("id") for args in requests]
        logger.info("coalesced pass of %d jobs %s", len(requests), ids)
        started = time.perf_counter()
        with trace_job(",".join(str(i) for i in ids)):
            outs = diffusion_batched_callback(
                self.identifier(), requests, registry=self.registry,
                lora_slots_max=int(self.settings.lora_slots_max),
                denoise_chunk_steps=int(self.settings.denoise_chunk_steps))
        if len(outs) != len(requests):
            raise RuntimeError(f"the pass returned {len(outs)} envelopes for "
                               f"{len(requests)} jobs")
        elapsed = round(time.perf_counter() - started, 4)
        envelopes = []
        for args, (artifacts, pipeline_config) in zip(requests, outs):
            if pipeline_config.get("cancelled"):
                envelopes.append(None)
                continue
            pipeline_config["seed"] = args["seed"]
            pipeline_config.setdefault("timings", {})["job_s"] = elapsed
            envelopes.append({"id": args.get("id"), "artifacts": artifacts,
                              "nsfw": pipeline_config.get("nsfw", False),
                              "worker_version": __version__,
                              "pipeline_config": pipeline_config})
        return envelopes

    # --- the device task and the watchdog ---

    def _on_device(self, jobs: list[dict]) -> list[dict | None]:
        """One work item on the device thread, holding the device."""
        with self._device_lock:
            # a hung pass holds the device, as a real one would
            faults.hang("hang_denoise")
            return self.execute_group(jobs)

    def pass_deadline(self, jobs: list[dict]) -> float | None:
        """The watchdog's deadline for one work item (None: off). A model
        not resident yet gets `job_deadline_compile_scale`; a coalesced
        pass is budgeted for its worst case, every member run alone after
        the pass failed. The jobs' own `deadline_s` caps it when every
        member has one (the loosest: one tight deadline must not cost its
        batchmates their pass), and arms it even when the setting is off."""
        s = self.settings
        base = float(s.job_deadline_s or 0.0)
        deadline = None
        if base > 0:
            resident = set(self.registry.resident_models())
            scale = 1.0
            if any(job.get("model_name") not in resident for job in jobs):
                scale = max(float(s.job_deadline_compile_scale), 1.0)
            deadline = base * scale * max(len(jobs), 1)
        caps = [_deadline_cap_of(job) for job in jobs]
        if caps and all(c > 0 for c in caps):
            deadline = max(caps) if deadline is None else min(deadline, max(caps))
        return deadline

    async def _device_pass(self, jobs: list[dict]) -> list[dict | None]:
        loop = asyncio.get_running_loop()
        deadline = self.pass_deadline(jobs)
        fut = loop.run_in_executor(self._executor, self._on_device, jobs)
        if deadline is None:
            return await fut
        try:
            return await asyncio.wait_for(asyncio.shield(fut), deadline)
        except asyncio.TimeoutError:
            return self._expire_pass(fut, jobs, deadline)

    def _expire_pass(self, fut, jobs: list[dict], deadline: float) -> list[dict]:
        """A pass outlived its deadline: quarantine the device, give every
        member the transient-error envelope (the hive may resubmit it), and
        leave the hung pass to end or not in the background; the probe
        decides when the device returns."""
        kind = "batched" if len(jobs) > 1 else "solo"
        _WATCHDOG_EXPIRED.inc(len(jobs), kind=kind)
        logger.error("watchdog: %s pass exceeded its %.1fs deadline (jobs %s); "
                     "quarantining the device", kind, deadline, [j.get("id") for j in jobs])
        # the orphaned future may raise much later: consume it
        fut.add_done_callback(lambda f: f.cancelled() or f.exception())
        self._quarantined = True
        self._in_service.clear()
        self._update_gauges()
        probe = asyncio.create_task(self._quarantine_probe(), name="quarantine_probe")
        self._probe_tasks.add(probe)
        probe.add_done_callback(self._probe_tasks.discard)
        results = []
        for job in jobs:
            err = TimeoutError(f"job execution exceeded the {deadline:g}s watchdog deadline; "
                               "the device was quarantined and the job may be resubmitted")
            artifacts, pipeline_config = exception_image(err, job.get("content_type")
                                                         or "image/jpeg")
            results.append({"id": job.get("id"), "artifacts": artifacts, "nsfw": False,
                            "worker_version": __version__,
                            "pipeline_config": pipeline_config})
        return results

    async def _quarantine_probe(self) -> None:
        """Wait (bounded) for the hung pass to release the device, then run
        the probe. Pass -> the device returns to service; failed or still
        held -> it stays out, and the worker takes no more work."""
        grace = max(float(self.settings.quarantine_probe_grace_s), 0.0)
        t0 = time.monotonic()
        while self._device_lock.locked() and time.monotonic() - t0 < grace:
            await asyncio.sleep(0.05)
        waited = time.monotonic() - t0
        if self._device_lock.locked():
            outcome = "wedged"
            logger.error("the device is still held %.0fs after the watchdog expiry; it "
                         "stays quarantined", grace)
        else:
            # the default executor: the device thread may be the hung one
            ok = await asyncio.get_running_loop().run_in_executor(None, self.smoke_probe)
            outcome = "ok" if ok else "failed"
            if ok:
                self._quarantined = False
                self._in_service.set()
                logger.warning("the device passed the probe; back in service")
            else:
                logger.error("the device failed the probe; it stays quarantined")
        _WATCHDOG_PROBES.inc(outcome=outcome)
        self.last_probe = {"outcome": outcome, "device": str(self.device),
                           "waited_s": round(waited, 3), "at": time.monotonic()}
        self._update_gauges()
        if self._changed is not None:
            self._changed.set()

    def smoke_probe(self) -> bool:
        """A tiny matmul on the device, synchronously. True = the device
        computes and may return to service; False = it is busy or failed."""
        if not self._device_lock.acquire(blocking=False):
            return False
        try:
            x = torch.eye(8, dtype=torch.float32, device=self.device)
            y = x @ (2.0 * x)
            synchronize(self.device)
            return bool(torch.equal(y.cpu(), 2.0 * torch.eye(8)))
        except Exception:  # noqa: BLE001 — any device error keeps it quarantined
            logger.exception("probe failed on %s", self.device)
            return False
        finally:
            self._device_lock.release()

    async def _serve(self, scheduler: BatchScheduler, changed: asyncio.Event) -> None:
        """The device task: take work items in order, run them off the event
        loop, spool their envelopes for the uploader and go on."""
        while True:
            # a quarantined device takes no work until the probe returns it
            await self._in_service.wait()
            jobs = await scheduler.get()
            picked_up = time.monotonic()
            queue_wait, traces = self._take_meta(jobs, picked_up)
            stage_ids = {str(job.get("id")) for job in jobs if stage_of(job) is not None}
            self._busy = True
            self._executing = {str(job.get("id")) for job in jobs}
            self._update_gauges()
            try:
                results = await self._device_pass(jobs)
                folded = False
                for result in results:
                    # a job cancelled during its pass has no envelope
                    if result is not None:
                        self._finish_result(result, queue_wait, traces)
                        # one sample a physical pass: the envelopes of a
                        # coalesced pass carry its timings each
                        cfg = result["pipeline_config"]
                        if not (folded and "batched_with" in cfg):
                            self._note_stage_stats(cfg.get("timings") or {})
                            folded = folded or "batched_with" in cfg
                        await self._enqueue_result(result,
                                                   handoff=str(result.get("id")) in stage_ids)
                    self.jobs_done += 1
            finally:
                ended = time.monotonic()
                self._note_stage_stats({"pass_s": round(ended - picked_up, 4)})
                self.timeline.append({"ids": [str(job.get("id")) for job in jobs],
                                      "lane": "device", "start": picked_up, "end": ended})
                for job_id in self._executing:
                    cancel_registry.discard(job_id)
                self._executing = set()
                for job in jobs:
                    scheduler.task_done(job)
                self._busy = False
                self._update_gauges()
                changed.set()

    def _take_meta(self, jobs: list[dict], picked_up: float) -> tuple[dict, dict]:
        """Take the enqueue stamp and the hive's trace context off each job
        (neither is a pipeline argument) -> ({id: queue wait s}, {id:
        trace})."""
        queue_wait, traces = {}, {}
        for job in jobs:
            enqueued = job.pop("_enqueued", None)
            if enqueued is not None:
                queue_wait[job.get("id")] = picked_up - enqueued
            trace = job.pop("trace", None)
            if isinstance(trace, dict):
                traces[job.get("id")] = trace
        return queue_wait, traces

    def _note_stage_stats(self, timings: dict) -> None:
        fold_stage_stats(self._stage_stats, self._stats_alpha, timings)

    async def _stage_lane(self, changed: asyncio.Event) -> None:
        """One consumer of the host stage lane: takes a stage-job, runs its
        callback off the event loop and off the device thread, and ships
        its envelope through the same finish and outbox path as a pass. A
        job cancelled while queued is dropped on pickup."""
        queue = self._stage_queue
        while True:
            job = await queue.get()
            picked_up = time.monotonic()
            job_id = str(job.get("id"))
            self._stage_queued_ids.discard(job_id)
            if job_id in self._stage_cancelled:
                self._stage_cancelled.discard(job_id)
                queue.task_done()
                self._update_gauges()
                changed.set()
                continue
            self._stage_running.add(job_id)
            queue_wait, traces = self._take_meta([job], picked_up)
            job.pop("resume", None)
            self._update_gauges()
            try:
                result = await asyncio.to_thread(self.execute, job, True)
                if result is not None:
                    self._finish_result(result, queue_wait, traces)
                    self._note_stage_stats(result["pipeline_config"].get("timings") or {})
                    await self._enqueue_result(result, handoff=True)
                self.jobs_done += 1
            except Exception:  # noqa: BLE001 — the lane must go on
                logger.exception("stage lane failed on %s", job_id)
            finally:
                self.timeline.append({"ids": [job_id], "lane": "stage", "start": picked_up,
                                      "end": time.monotonic()})
                self._stage_running.discard(job_id)
                cancel_registry.discard(job_id)
                queue.task_done()
                self._update_gauges()
                changed.set()

    def _finish_result(self, result: dict, queue_wait: dict, traces: dict | None = None) -> None:
        """Stamp the queue wait and the hive's trace context into the
        envelope, observe its pass's stage spans (once for a coalesced
        pass), and count the job by outcome."""
        cfg = result.setdefault("pipeline_config", {})
        trace = (traces or {}).get(result.get("id"))
        if isinstance(trace, dict):
            cfg["trace"] = trace
        timings = cfg.setdefault("timings", {})
        wait = queue_wait.get(result.get("id"))
        if wait is not None:
            observe_stage("queue_wait", wait)
            timings["queue_wait_s"] = round(wait, 3)
        if (cfg.get("batch_rows") or [0])[0] == 0:
            for key, stage in STAGE_KEYS.items():
                if isinstance(timings.get(key), (int, float)):
                    observe_stage(stage, timings[key])
            if isinstance(timings.get("denoise_s"), (int, float)):
                observe_stage("denoise", timings["denoise_s"] + timings.get("decode_s", 0.0))
        if result.get("fatal_error"):
            outcome = "fatal"
        elif "error" in cfg:
            outcome = "error"
        else:
            outcome = "ok"
        _JOBS_COMPLETED.inc(outcome=outcome)

    # --- the uploader (outbox.py) ---

    async def _enqueue_result(self, result: dict, handoff: bool = False) -> None:
        """Spool the envelope (off the loop: a multi-MB envelope must not
        stall the polls), then queue it for delivery. From here the job
        cannot be lost silently: only the hive's ACK unlinks the file.
        `handoff`: a stage-job's envelope, whose delivery the next idle
        poll waits for."""
        # the sender rides the envelope: the hive attributes a late result
        # to the worker that made it
        result.setdefault("worker_name", self.settings.worker_name)
        if handoff:
            self._handoff_ids.add(str(result.get("id")))
        entry = await asyncio.to_thread(self.outbox.spool, result)
        await self._results.put(entry)
        self._update_gauges()

    async def _upload(self, changed: asyncio.Event) -> None:
        while True:
            entry = await self._results.get()
            self._delivering += 1
            try:
                await self._deliver(entry)
            except FaultInjected:
                # a simulated crash after the ACK, before the unlink: the
                # envelope stays spooled for the next start
                logger.error("injected crash before the unlink of %s's envelope", entry.job_id)
                self.crashed = True
                raise
            except Exception:  # noqa: BLE001 — the uploader must go on
                logger.exception("delivery of %s failed", entry.job_id)
            finally:
                self._delivering -= 1
                self._handoff_ids.discard(entry.job_id)
                self._update_gauges()
                changed.set()

    async def _submit(self, result: dict):
        """POST one envelope, one attempt, off the loop -> the hive's ACK."""
        return await asyncio.to_thread(self.hive.submit_result, result)

    async def _deliver(self, entry: OutboxEntry) -> None:
        """Upload one spooled envelope until the hive ACKs it (capped
        exponential backoff with jitter between attempts). A permanent
        refusal, or an ACK that discards the result, parks it on disk."""
        while True:
            try:
                t0 = time.perf_counter()
                ack = await self._submit(entry.result)
                observe_stage("submit", time.perf_counter() - t0)
                faults.fire("kill_before_ack")
                reason = None
                if isinstance(ack, dict):
                    if ack.get("cancelled"):
                        reason = "cancelled: hive revoked this job"
                    elif ack.get("expired"):
                        reason = "expired: job TTL lapsed at the hive"
                    elif ack.get("unknown_job"):
                        reason = "gone: hive no longer knows this job id"
                if reason is not None:
                    logger.warning("hive acknowledged but discarded result %s (%s); parking "
                                   "the envelope", entry.job_id, reason)
                    await asyncio.to_thread(self.outbox.park, entry, reason)
                    return
                await asyncio.to_thread(self.outbox.delivered, entry)
                return
            except FaultInjected:
                raise
            except HiveError as e:
                if e.permanent:
                    logger.error("hive permanently refused result %s (%s); parking the "
                                 "envelope on disk", entry.job_id, e)
                    await asyncio.to_thread(self.outbox.park, entry, str(e))
                    return
                err: Exception = e
            except Exception as e:  # noqa: BLE001 — unexpected: still never drop work
                err = e
            entry.retries += 1
            self.outbox.note_retry()
            delay = outbox_mod.backoff_delay(entry.retries)
            logger.warning("submit failed for %s (attempt %d: %s); retrying in %.1fs",
                           entry.job_id, entry.retries, err, delay)
            await asyncio.sleep(delay)

    # --- telemetry ---

    def _update_gauges(self) -> None:
        scheduler = self._scheduler
        if scheduler is not None:
            _JOBS_IN_FLIGHT.set(scheduler.outstanding_jobs)
            _QUEUE_DEPTH.set(scheduler.pending_jobs, queue="lingering")
            _QUEUE_DEPTH.set(scheduler.ready_jobs, queue="ready")
        if self._results is not None:
            _QUEUE_DEPTH.set(self._results.qsize() + self._delivering, queue="results")
        _QUEUE_DEPTH.set(self._stage_depth(), queue="stage")
        _SLICES_BUSY.set(int(self._busy))
        _SLICE_STATE.set(0 if self._quarantined else 1, state="active")
        _SLICE_STATE.set(1 if self._quarantined else 0, state="quarantined")
        self.outbox.refresh_gauges()

    def _stage_depth(self) -> int:
        """Stage-jobs queued on the lane or running there."""
        queued = self._stage_queue.qsize() if self._stage_queue is not None else 0
        return queued + len(self._stage_running)

    def health(self) -> dict:
        """/healthz: is this worker polling, what is resident, is the device
        in service. `degraded` (503) when polling stalled while it should
        poll, the device is quarantined, the outbox is saturated, or the
        card's free memory is below `memory_headroom_degraded`."""
        scheduler = self._scheduler
        draining = self._draining is not None and self._draining.is_set()
        age = None
        if self._last_poll_monotonic is not None:
            age = round(time.monotonic() - self._last_poll_monotonic, 1)
        reasons = []
        # the loop pauses its polls while draining, busy, quarantined or
        # full: a worker mid-denoise must not probe as unhealthy
        expects_polls = (not draining and not self._busy and not self._quarantined
                         and scheduler is not None and not scheduler.full())
        if expects_polls and age is not None and age > 3 * self.poll_seconds:
            reasons.append(f"last successful poll {age:.0f}s ago "
                           f"(cadence {self.poll_seconds}s)")
        if self._quarantined:
            reasons.append("1 slice(s) quarantined")
        if self.outbox.saturated:
            reasons.append(f"outbox saturated ({self.outbox.depth} spooled envelopes)")
        headroom = None
        threshold = float(self.settings.memory_headroom_degraded or 0.0)
        if threshold > 0:
            headroom = memory_census.device_headroom()
            if headroom is not None and headroom < threshold:
                reasons.append(f"device HBM headroom {headroom:.1%} below {threshold:.1%}")
        oldest = self.outbox.oldest_age_s()
        return {
            "status": "degraded" if reasons else "ok",
            "degraded_reasons": reasons,
            "worker_version": __version__,
            "last_poll_age_s": age,
            "memory_headroom_ratio": headroom,
            "draining": draining,
            "jobs_in_flight": scheduler.outstanding_jobs if scheduler is not None else 0,
            "results_pending": (self._results.qsize() + self._delivering
                                if self._results is not None else 0),
            "stage_lane": {
                "queued": self._stage_queue.qsize() if self._stage_queue is not None else 0,
                "inflight": len(self._stage_running),
                "workers": int(self.settings.stage_workers or 0),
            },
            "outbox": {
                "depth": self.outbox.depth,
                "oldest_age_s": round(oldest, 1) if oldest else 0,
                "saturated": self.outbox.saturated,
            },
            # the hive this worker is pinned to, and how often it moved
            "hive": {
                "active_endpoint": self.hive.hive_uri,
                "endpoints": list(self.hive.endpoints),
                "failovers": self.hive.failovers,
                "epoch": self.hive.epoch,
            },
            "resident_models": self.registry.resident_models(),
            "slices": [{
                "slice_id": 0,
                "chips": 1,
                "device": device_label(self.device),
                "busy": self._busy,
                "state": "quarantined" if self._quarantined else "active",
                "resident": self.registry.resident_models(),
            }],
        }

    async def _capture_profile(self, seconds: float) -> dict:
        """POST /debug/profile?seconds=N: a torch.profiler capture (CPU and,
        on the card, CUDA activities) of this process for `seconds`, written
        as a Chrome trace under $SDAAS_ROOT/profiles/. Gated by
        `profiler_capture` (PermissionError -> 403), one at a time, and not
        beside another torch.profiler of the process (RuntimeError -> 409)."""
        if not bool(self.settings.profiler_capture):
            raise PermissionError("profiler capture is disabled; set profiler_capture=true "
                                  "(CHIASWARM_PROFILER_CAPTURE=1) to arm it")
        if self._profiling or profiler_running():
            raise RuntimeError("a profiler capture is already running")
        self._profiling = True
        try:
            path = resolve_path("profiles") / (
                time.strftime("trace_%Y%m%d_%H%M%S")
                + f"_{time.time_ns() % 1_000_000_000:09d}.json")
            path.parent.mkdir(parents=True, exist_ok=True)
            # off the loop: the capture sleeps through its window while the
            # metrics app goes on answering
            detail = await asyncio.get_running_loop().run_in_executor(
                None, self._profile, seconds, path)
        finally:
            self._profiling = False
        logger.warning("profiler capture (%.1fs) written to %s", seconds, path)
        return {"path": str(path), "seconds": seconds, **detail}

    def _profile(self, seconds: float, path) -> dict:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            time.sleep(seconds)
        prof.export_chrome_trace(str(path))
        return {"bytes": path.stat().st_size,
                "activities": [a.name for a in activities]}

    async def _start_metrics_server(self) -> None:
        """GET /metrics, /healthz, /debug/programs, /debug/memory and POST
        /debug/profile on `metrics_host:metrics_port` (0 disables it).
        Never fatal: a busy port costs the scrape, not the worker."""
        port = int(self.settings.metrics_port or 0)
        if not port:
            return
        try:
            self._metrics_runner = await telemetry.start_metrics_server(
                port, health=self.health, host=self.settings.metrics_host,
                profile=self._capture_profile,
                # the profile hook mutates: it takes the worker's own token
                token=str(self.settings.sdaas_token or ""),
                programs=programs.snapshot, memory=memory_census.census)
            logger.info("metrics server on %s:%d", self.settings.metrics_host, port)
        except Exception as e:  # noqa: BLE001 — observability is an add-on
            logger.warning("metrics server unavailable: %s", e)

    # --- the poll loop ---

    def _cancel_job(self, job_id: str, scheduler: BatchScheduler) -> None:
        """Route one revocation: a job the scheduler holds is dropped (and
        counts as done); a running one is marked in the cancel registry,
        which its pass probes at its next chunk boundary; anything else
        (delivered, or never ours) is ignored."""
        job_id = str(job_id)
        if scheduler.cancel(job_id):
            stage = "held"
            self.jobs_done += 1
        elif job_id in self._stage_queued_ids and job_id not in self._stage_cancelled:
            # queued on the stage lane: dropped when a consumer takes it
            self._stage_cancelled.add(job_id)
            stage = "held"
            self.jobs_done += 1
        elif job_id in self._executing or job_id in self._stage_running:
            stage = "executing"
            cancel_registry.cancel(job_id)
            logger.warning("hive cancelled running job %s; its pass stops at the next chunk "
                           "boundary", job_id)
        else:
            stage = "unknown"
        _JOBS_CANCELLED.inc(stage=stage)
        self.cancels[job_id] = {"stage": stage, "marked_at": time.monotonic()}
        while len(self.cancels) > MAX_CANCEL_RECORDS:
            self.cancels.pop(next(iter(self.cancels)))

    async def _wait_for_handoffs(self) -> None:
        """Wait until every spooled stage-job envelope is delivered or
        parked, or HANDOFF_WAIT_SECONDS have passed, or the worker stops."""
        deadline = time.monotonic() + HANDOFF_WAIT_SECONDS
        while (self._handoff_ids and not self._stopping.is_set()
               and not self._draining.is_set()):
            left = deadline - time.monotonic()
            if left <= 0:
                break
            self._changed.clear()
            await self._pause(left)

    async def _intake(self, jobs: list[dict], scheduler: BatchScheduler) -> None:
        """One reply's jobs, in the order they came: a gang's members (one
        `trace.gang` id) into the scheduler together, host stage-jobs onto
        the stage lane, every other job into the scheduler alone. A
        stage-job's predecessor artifacts are fetched first."""
        gangs: dict[str, list[dict]] = {}
        intake: list[tuple[str, object]] = []
        for job in jobs:
            logger.info("got job %s", job.get("id"))
            _JOBS_POLLED.inc()
            # the queue wait starts here; the device task or the lane pops it
            job["_enqueued"] = time.monotonic()
            gang_id = None
            trace = job.get("trace")
            if isinstance(trace, dict):
                trace.setdefault("received_wall", round(time.time(), 3))
                gang = trace.get("gang")
                if isinstance(gang, dict) and gang.get("id"):
                    gang_id = str(gang["id"])
            if isinstance(job.get("stage"), dict):
                await asyncio.to_thread(self._resolve_stage_inputs, job)
            if stage_of(job) in CPU_STAGES:
                intake.append(("stage", job))
            elif gang_id is None:
                intake.append(("job", job))
            else:
                if gang_id not in gangs:
                    intake.append(("gang", gang_id))
                gangs.setdefault(gang_id, []).append(job)
        for kind, item in intake:
            if kind == "gang":
                await scheduler.put_gang(gangs[item])
            elif kind == "stage":
                self._stage_queued_ids.add(str(item.get("id")))
                self._stage_queue.put_nowait(item)
            else:
                await scheduler.put(item)

    def _resolve_stage_inputs(self, job: dict) -> None:
        """Hydrate a stage-job's handoff: each predecessor artifact arrives
        as a spool reference ({sha256, bytes, href}); its bytes are fetched
        through the authed client and stamped back as `blob`. A failed fetch
        leaves it out: the callback then reports the missing input as a
        fatal envelope."""
        for entry in job["stage"].get("inputs") or []:
            artifacts = entry.get("artifacts") if isinstance(entry, dict) else None
            if not isinstance(artifacts, dict):
                continue
            for art in artifacts.values():
                if not isinstance(art, dict) or art.get("blob") or not art.get("href"):
                    continue
                blob = self.hive.fetch_artifact(str(art["href"]))
                if blob is not None:
                    art["blob"] = base64.b64encode(blob).decode("ascii")

    def stop(self, drain: bool = False) -> None:
        """Stop a running worker, from any thread. drain=False stops at once
        (spooled envelopes survive on disk for the next start); drain=True
        (SIGTERM) stops taking work, finishes the passes in flight and
        flushes the outbox, for at most `drain_deadline_s`."""
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(self._stop, drain)

    def _stop(self, drain: bool) -> None:
        if self._stopping is None:
            return
        if drain:
            if not self._draining.is_set():
                logger.warning("drain: polls stopped; finishing the passes in flight and "
                               "the outbox")
            self._draining.set()
        else:
            self._stopping.set()
        self._changed.set()

    async def _pause(self, seconds: float) -> None:
        """Sleep up to `seconds`, or until something changes (a pass ended,
        a delivery ended, a stop)."""
        try:
            await asyncio.wait_for(self._changed.wait(), seconds)
        except asyncio.TimeoutError:
            pass

    async def run(self, max_jobs: int | None = None) -> None:
        """Poll and serve until `max_jobs` jobs are done (forever without
        it), or until `stop()`; returns once every job taken is served and
        every envelope delivered or parked, or at the drain's deadline, or
        at a simulated crash (`kill_before_ack`)."""
        loop = asyncio.get_running_loop()
        scheduler = self.scheduler()
        self._scheduler = scheduler
        changed = self._changed = asyncio.Event()
        self._stopping, self._draining = asyncio.Event(), asyncio.Event()
        self._in_service = asyncio.Event()
        self._quarantined = False
        self._in_service.set()
        self._results = asyncio.Queue()
        self._delivering = 0
        self.crashed = False
        self._loop = loop
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="device")
        self._stage_queue = asyncio.Queue()
        self._stage_queued_ids.clear()
        self._stage_cancelled.clear()
        self._handoff_ids.clear()
        _SLICES_TOTAL.set(1)
        sigterm = None
        try:
            # a rolling restart sends SIGTERM: drain instead of dropping work
            previous = signal.getsignal(signal.SIGTERM)
            loop.add_signal_handler(signal.SIGTERM, self.stop, True)
            sigterm = previous
        except (NotImplementedError, RuntimeError, ValueError):
            pass  # not the main thread: stop(drain=True) still works
        await self._start_metrics_server()
        # redeliver what a previous process spooled and never saw ACKed,
        # unless another live worker shares the spool
        if await asyncio.to_thread(self.outbox.claim):
            recovered = await asyncio.to_thread(self.outbox.recover)
            self.outbox.share()
            for entry in recovered:
                self._results.put_nowait(entry)
            if recovered:
                logger.warning("outbox: redelivering %d spooled result(s) from a previous run",
                               len(recovered))
        server = asyncio.create_task(self._serve(scheduler, changed))
        uploader = asyncio.create_task(self._upload(changed))
        lanes = [asyncio.create_task(self._stage_lane(changed))
                 for _ in range(max(int(self.settings.stage_workers or 0), 0))]
        backoff = self.poll_seconds
        try:
            while not self._stopping.is_set() and not self._draining.is_set():
                if max_jobs is not None and self.jobs_done >= max_jobs:
                    break
                if server.done():
                    server.result()  # the device task died: raise its error
                if uploader.done():
                    break  # a simulated crash
                changed.clear()
                # busy (or out of service): the cancel-only heartbeat, which
                # takes no job but brings the hive's revocations
                heartbeat = self._busy or scheduler.full() or self._quarantined
                if not heartbeat and self._handoff_ids:
                    # the hive admits a stage's successor on delivery: let
                    # the handoffs land so that this reply can carry it
                    await self._wait_for_handoffs()
                    heartbeat = self._busy or scheduler.full() or self._quarantined
                caps = self.capabilities()
                if heartbeat:
                    caps["cancel_only"] = 1
                try:
                    jobs = await asyncio.to_thread(self.hive.ask_for_work, caps)
                except HiveError as e:
                    _POLL_ERRORS.inc()
                    backoff = _next_backoff(backoff, self.poll_seconds, self.backoff_cap_seconds)
                    logger.warning("ask_for_work failed: %s; next poll in %.1fs", e, backoff)
                    await self._pause(backoff)
                    continue
                backoff = self.poll_seconds
                self._last_poll_monotonic = time.monotonic()
                _LAST_POLL.set(time.time())
                await self._intake(jobs, scheduler)
                for job_id in self.hive.last_cancels:
                    self._cancel_job(job_id, scheduler)
                self._update_gauges()
                if heartbeat:
                    await self._pause(self.heartbeat_seconds)
                elif not jobs:
                    await self._pause(self.poll_seconds)
            # every job taken is served and every envelope delivered or
            # parked before the loop ends (at most drain_deadline_s when
            # draining)
            scheduler.close()
            deadline = None
            if self._draining.is_set():
                deadline = time.monotonic() + max(float(self.settings.drain_deadline_s), 0.0)
            while not self._stopping.is_set() and not uploader.done():
                if server.done():
                    server.result()
                if (scheduler.outstanding_jobs == 0 and self._stage_depth() == 0
                        and self._results.empty() and self._delivering == 0):
                    if deadline is not None:
                        logger.warning("drain complete: no work in flight")
                    break
                left = 1.0 if deadline is None else deadline - time.monotonic()
                if left <= 0:
                    logger.error("drain deadline hit with %d job(s) in flight and %d spooled "
                                 "envelope(s); exiting, spooled results redeliver on restart",
                                 scheduler.outstanding_jobs, self.outbox.depth)
                    break
                changed.clear()
                await self._pause(min(left, 1.0))
        finally:
            if sigterm is not None:
                try:
                    loop.remove_signal_handler(signal.SIGTERM)
                    signal.signal(signal.SIGTERM, sigterm)
                except (NotImplementedError, RuntimeError, ValueError, TypeError):
                    pass
            scheduler.close()
            tasks = [server, uploader, *lanes, *self._probe_tasks]
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            # the partial uploads in flight land before the loop goes
            if self._uploads:
                await asyncio.wait([asyncio.wrap_future(f) for f in list(self._uploads)],
                                   timeout=30)
            if self._metrics_runner is not None:
                await self._metrics_runner.cleanup()
                self._metrics_runner = None
            # a hung pass keeps its thread; nothing waits for it
            self._executor.shutdown(wait=False, cancel_futures=True)
            self.outbox.release()
            self._loop = None


def main(argv=None) -> None:
    """Console entry point. Runs on the card; `--device cpu` is for tests."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    opts = parser.parse_args(argv)
    settings = load_settings()
    worker = Worker(settings=settings, device=opts.device)
    setup_stream("INFO", settings.log_format)
    try:
        asyncio.run(worker.run())
    except KeyboardInterrupt:
        print("done")


if __name__ == "__main__":
    main()
