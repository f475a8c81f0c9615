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

The outbox, telemetry, geometry and stage graphs are later slices.

Run it with `python -m chiaswarm_tpu_torch.worker` (on the card; settings
from $SDAAS_ROOT/settings.json and the SDAAS_* variables).
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import logging
import random
import time

from . import __version__
from . import cancel as cancel_registry
from . import checkpoint
from .batching import BatchScheduler
from .capacity import coalesce_rows_limit, default_canvas, fit_batch
from .device import device_label, memory_gb, resolve_device
from .embed_cache import from_settings
from .hive import HiveClient, HiveError
from .job_arguments import format_args
from .lora_cache import LoraCache
from .cancel import JobCancelled
from .post_processors.output_processor import (
    exception_image,
    fatal_exception_response,
    image_to_buffer,
    to_pil,
)
from .registry import Registry, unconverted_family_keywords
from .settings import load_settings
from .workflows.diffusion import diffusion_batched_callback, diffusion_callback

logger = logging.getLogger(__name__)

# the model whose resident fit `flux_runnable` advertises
FLUX_DEV = "black-forest-labs/FLUX.1-dev"
POLL_SECONDS = 11.0
ERROR_BACKOFF_SECONDS = 121.0
# the revocations `Worker.cancels` keeps, newest last
MAX_CANCEL_RECORDS = 256


class Worker:
    def __init__(self, settings=None, device=None, registry: Registry | None = None,
                 poll_seconds: float = POLL_SECONDS, heartbeat_seconds: float | None = None):
        """`poll_seconds` between polls of an idle worker; `heartbeat_seconds`
        between the cancel-only polls of a busy one (`poll_seconds` unset)."""
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
        return {
            # legacy keys a reference hive understands
            "memory": gb << 30,
            "gpu": device_label(self.device),
            "chips": 1,
            "hbm_gb": gb,
            "topology": f"{self.device.type}x1",
            "backend": "torch",
            "resident_models": ",".join(self.registry.resident_models()),
            "jobs_completed": self.jobs_done,
            # model-name keywords of the families this worker cannot serve,
            # which a capability-aware hive does not hand it
            "unconverted_families": ",".join(unconverted_family_keywords()),
            "flux_runnable": int(fit_batch(self.device, FLUX_DEV, 1, 1024) >= 1),
            # a redelivered job may come with a checkpoint to resume from
            "resume_capable": int(int(self.settings.denoise_chunk_steps) > 0
                                  and int(self.settings.checkpoint_every_chunks) > 0),
        }

    def execute(self, job: dict) -> dict | None:
        """Run one job to its result envelope (never raises for a job's
        own failure: ValueError/TypeError give a fatal envelope, anything
        else an error-image artifact the hive may retry; None when the hive
        cancelled the job during its pass). A diffusion job's pass is
        chunked, checkpointed and previewed as the settings say, and
        resumed from the job's `resume` offer."""
        job = dict(job)
        offer = job.pop("resume", None)
        try:
            callback, args = format_args(job, self.settings, self.device)
        except Exception as e:  # noqa: BLE001 — malformed job: never resubmit
            logger.exception("format_args failed for job %s", job.get("id"))
            return fatal_exception_response(e, job.get("id"), job)
        if callback is diffusion_callback and int(self.settings.denoise_chunk_steps) > 0:
            self._arm(str(job.get("id")), args, offer)
        return self._run_one(job, callback, args)

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
            return None
        if blob is None:
            logger.warning("resume offer for %s: checkpoint fetch failed; running the full "
                           "pass", job_id)
            return None
        try:
            state = checkpoint.unpack(blob)
        except Exception as e:  # noqa: BLE001 — never a job error
            logger.warning("resume offer for %s: checkpoint unpack failed (%r); running the "
                           "full pass", job_id, e)
            return None
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
                logger.exception("checkpoint pack failed for %s", job_id)
                return
            if max_bytes > 0 and len(blob) > max_bytes:
                logger.warning("checkpoint for %s at step %d is %d bytes "
                               "(checkpoint_max_bytes %d); skipped", job_id, step, len(blob),
                               max_bytes)
                return
            self._ship("checkpoint", job_id, {
                "step": int(step), "signature": signature,
                "worker_name": self.settings.worker_name,
                "blob": base64.b64encode(blob).decode("ascii")})

        return ship

    def _preview_shipper(self, job_id: str):
        """The preview callback of one pass: the decoded boundary pixels as a
        JPEG, uploaded fire and forget. A failed encode costs the preview,
        never the pass."""

        def ship(step, pixels):
            try:
                buffer = image_to_buffer(to_pil(pixels[0]), "image/jpeg")
            except Exception:  # noqa: BLE001 — the pass goes on without it
                logger.exception("preview encode failed for %s", job_id)
                return
            self._ship("preview", job_id, {
                "step": int(step), "content_type": "image/jpeg",
                "worker_name": self.settings.worker_name,
                "blob": base64.b64encode(buffer.getvalue()).decode("ascii")})

        return ship

    def _ship(self, kind: str, job_id: str, payload: dict) -> None:
        """Upload one partial from the device thread: on the event loop
        when the worker runs one (the pass never waits for it), else at
        once. A failed upload costs the partial, never the pass."""
        loop = self._loop
        if loop is None or loop.is_closed():
            try:
                self.hive.post_partial(kind, job_id, payload)
            except Exception:  # noqa: BLE001 — the pass goes on without it
                logger.exception("%s upload failed for %s", kind, job_id)
            return
        upload = asyncio.to_thread(self.hive.post_partial, kind, job_id, payload)
        try:
            future = asyncio.run_coroutine_threadsafe(upload, loop)
        except RuntimeError:  # the loop closed after the check
            upload.close()
            logger.warning("%s for %s dropped: the event loop is gone", kind, job_id)
            return
        self._uploads.add(future)
        future.add_done_callback(self._uploads.discard)

    def _run_one(self, job: dict, callback, args: dict) -> dict | None:
        job_id = job.get("id")
        args.pop("id", None)
        model_name = args.pop("model_name", "")
        seed = args.pop("seed", None)
        if seed is None:
            seed = random.getrandbits(63)
        if callback is diffusion_callback:
            args.update(job_id=job_id, denoise_chunk_steps=int(self.settings.denoise_chunk_steps))
        started = time.perf_counter()
        try:
            artifacts, pipeline_config = callback(
                self.identifier(), model_name, registry=self.registry, seed=seed, **args)
        except JobCancelled as e:
            self._note_aborted(e)
            return None
        except (ValueError, TypeError) as e:
            logger.exception("job %s failed (fatal)", job_id)
            return fatal_exception_response(e, job_id, job)
        except Exception as e:  # noqa: BLE001 — transient: report as an artifact
            logger.exception("job %s failed", job_id)
            artifacts, pipeline_config = exception_image(e, job.get("content_type", "image/jpeg"))
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
        requests = [dict(args) for args in requests]
        for args in requests:
            if args.get("seed") is None:
                args["seed"] = random.getrandbits(63)
        logger.info("coalesced pass of %d jobs %s", len(requests),
                    [args.get("id") for args in requests])
        started = time.perf_counter()
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

    async def _submit(self, result: dict) -> None:
        result.setdefault("worker_name", self.settings.worker_name)
        try:
            await asyncio.to_thread(self.hive.submit_result, result)
        except HiveError:
            # one retry: the artifacts cost a whole denoise pass
            logger.warning("result upload failed for %s; retrying once", result.get("id"))
            await asyncio.sleep(1.0)
            await asyncio.to_thread(self.hive.submit_result, result)

    async def _serve(self, scheduler: BatchScheduler, changed: asyncio.Event) -> None:
        """The device task: take work items in order, run them off the event
        loop, upload their envelopes."""
        while True:
            jobs = await scheduler.get()
            self._busy = True
            self._executing = {str(job.get("id")) for job in jobs}
            try:
                # GPU work off the event loop, one work item at a time
                results = await asyncio.to_thread(self.execute_group, jobs)
                for result in results:
                    # a job cancelled during its pass has no envelope
                    if result is not None:
                        try:
                            await self._submit(result)
                        except HiveError:
                            logger.exception("dropping the result of job %s",
                                             result.get("id"))
                    self.jobs_done += 1
            finally:
                for job_id in self._executing:
                    cancel_registry.discard(job_id)
                self._executing = set()
                for _ in jobs:
                    scheduler.task_done()
                self._busy = False
                changed.set()

    def _cancel_job(self, job_id: str, scheduler: BatchScheduler) -> None:
        """Route one revocation: a job the scheduler holds is dropped (and
        counts as done); a running one is marked in the cancel registry,
        which its pass probes at its next chunk boundary; anything else
        (delivered, or never ours) is ignored."""
        job_id = str(job_id)
        if scheduler.cancel(job_id):
            stage = "held"
            self.jobs_done += 1
        elif job_id in self._executing:
            stage = "executing"
            cancel_registry.cancel(job_id)
            logger.warning("hive cancelled running job %s; its pass stops at the next chunk "
                           "boundary", job_id)
        else:
            stage = "unknown"
        self.cancels[job_id] = {"stage": stage, "marked_at": time.monotonic()}
        while len(self.cancels) > MAX_CANCEL_RECORDS:
            self.cancels.pop(next(iter(self.cancels)))

    async def run(self, max_jobs: int | None = None) -> None:
        """Poll and serve forever, or until `max_jobs` jobs are done."""
        scheduler = self.scheduler()
        changed = asyncio.Event()
        self._loop = asyncio.get_running_loop()
        server = asyncio.create_task(self._serve(scheduler, changed))
        try:
            while max_jobs is None or self.jobs_done < max_jobs:
                if server.done():
                    server.result()  # the device task died: raise its error
                # busy: the cancel-only heartbeat, which takes no job but
                # brings the hive's revocations of the running ones
                heartbeat = self._busy or scheduler.full()
                caps = self.capabilities()
                if heartbeat:
                    caps["cancel_only"] = 1
                    changed.clear()
                try:
                    jobs = await asyncio.to_thread(self.hive.ask_for_work, caps)
                except HiveError as e:
                    logger.warning("ask_for_work failed: %s", e)
                    await asyncio.sleep(ERROR_BACKOFF_SECONDS)
                    continue
                for job in jobs:
                    logger.info("got job %s", job.get("id"))
                    await scheduler.put(job)
                for job_id in self.hive.last_cancels:
                    self._cancel_job(job_id, scheduler)
                if heartbeat:
                    try:
                        await asyncio.wait_for(changed.wait(), self.heartbeat_seconds)
                    except asyncio.TimeoutError:
                        pass
                elif not jobs:
                    await asyncio.sleep(self.poll_seconds)
            # every job taken is served before the loop ends
            scheduler.close()
            while scheduler.outstanding_jobs and not server.done():
                changed.clear()
                await changed.wait()
        finally:
            scheduler.close()
            server.cancel()
            try:
                await server
            except asyncio.CancelledError:
                pass
            # the partial uploads in flight land before the loop goes
            if self._uploads:
                await asyncio.wait([asyncio.wrap_future(f) for f in list(self._uploads)],
                                   timeout=30)
            self._loop = None


def main(argv=None) -> None:
    """Console entry point. Runs on the card; `--device cpu` is for tests."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    opts = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    worker = Worker(device=opts.device)
    try:
        asyncio.run(worker.run())
    except KeyboardInterrupt:
        print("done")


if __name__ == "__main__":
    main()
