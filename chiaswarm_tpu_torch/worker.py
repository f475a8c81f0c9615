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
its own fatal envelope. Every job gets exactly one envelope. The poll
loop asks for work only while the device is idle and nothing released
waits for it.

The outbox, telemetry, resumable checkpoints, geometry and stage graphs
are later slices.

Run it with `python -m chiaswarm_tpu_torch.worker` (on the card; settings
from $SDAAS_ROOT/settings.json and the SDAAS_* variables).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import random
import time

from . import __version__
from .batching import BatchScheduler
from .capacity import coalesce_rows_limit, default_canvas, fit_batch
from .device import device_label, memory_gb, resolve_device
from .embed_cache import from_settings
from .hive import HiveClient, HiveError
from .job_arguments import format_args
from .lora_cache import LoraCache
from .post_processors.output_processor import exception_image, fatal_exception_response
from .registry import Registry, unconverted_family_keywords
from .settings import load_settings
from .workflows.diffusion import diffusion_batched_callback, diffusion_callback

logger = logging.getLogger(__name__)

# the model whose resident fit `flux_runnable` advertises
FLUX_DEV = "black-forest-labs/FLUX.1-dev"
POLL_SECONDS = 11.0
ERROR_BACKOFF_SECONDS = 121.0


class Worker:
    def __init__(self, settings=None, device=None, registry: Registry | None = None,
                 poll_seconds: float = POLL_SECONDS):
        self.settings = settings or load_settings()
        self.device = resolve_device(device)
        self.registry = registry or Registry(
            self.device, self.settings.model_root_dir, self.settings.lora_root_dir,
            LoraCache(int(self.settings.lora_cache_mb) << 20,
                      int(self.settings.lora_operand_cache_mb) << 20),
            from_settings(self.settings.embed_cache_mb), self.settings.safety_checker_model)
        self.hive = HiveClient(self.settings)
        self.poll_seconds = poll_seconds
        self.jobs_done = 0
        self._busy = False

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
        }

    def execute(self, job: dict) -> dict:
        """Run one job to its result envelope (never raises for a job's
        own failure: ValueError/TypeError give a fatal envelope, anything
        else an error-image artifact the hive may retry)."""
        try:
            callback, args = format_args(job, self.settings, self.device)
        except Exception as e:  # noqa: BLE001 — malformed job: never resubmit
            logger.exception("format_args failed for job %s", job.get("id"))
            return fatal_exception_response(e, job.get("id"), job)
        return self._run_one(job, callback, args)

    def _run_one(self, job: dict, callback, args: dict) -> dict:
        job_id = job.get("id")
        args.pop("id", None)
        model_name = args.pop("model_name", "")
        seed = args.pop("seed", None)
        if seed is None:
            seed = random.getrandbits(63)
        started = time.perf_counter()
        try:
            artifacts, pipeline_config = callback(
                self.identifier(), model_name, registry=self.registry, seed=seed, **args)
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

    def execute_group(self, jobs: list[dict]) -> list[dict]:
        """A work item of the scheduler -> one envelope per job, in order."""
        if len(jobs) == 1:
            return [self.execute(jobs[0])]
        envelopes: dict[int, dict] = {}
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
            except Exception:  # noqa: BLE001 — every member runs alone instead
                logger.exception("coalesced pass for %s failed; serving its jobs alone",
                                 [jobs[k].get("id") for k in prepared])
        for k, (callback, args) in prepared.items():
            if k not in envelopes:
                envelopes[k] = self._run_one(jobs[k], callback, args)
        return [envelopes[k] for k in range(len(jobs))]

    def _run_pass(self, requests: list[dict]) -> list[dict]:
        """One coalesced pass over formatted job arguments -> envelopes."""
        requests = [dict(args) for args in requests]
        for args in requests:
            if args.get("seed") is None:
                args["seed"] = random.getrandbits(63)
        logger.info("coalesced pass of %d jobs %s", len(requests),
                    [args.get("id") for args in requests])
        started = time.perf_counter()
        outs = diffusion_batched_callback(self.identifier(), requests, registry=self.registry,
                                          lora_slots_max=int(self.settings.lora_slots_max))
        if len(outs) != len(requests):
            raise RuntimeError(f"the pass returned {len(outs)} envelopes for "
                               f"{len(requests)} jobs")
        elapsed = round(time.perf_counter() - started, 4)
        envelopes = []
        for args, (artifacts, pipeline_config) in zip(requests, outs):
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
            try:
                # GPU work off the event loop, one work item at a time
                results = await asyncio.to_thread(self.execute_group, jobs)
                for result in results:
                    try:
                        await self._submit(result)
                    except HiveError:
                        logger.exception("dropping the result of job %s", result.get("id"))
                    self.jobs_done += 1
            finally:
                for _ in jobs:
                    scheduler.task_done()
                self._busy = False
                changed.set()

    async def run(self, max_jobs: int | None = None) -> None:
        """Poll and serve forever, or until `max_jobs` jobs are done."""
        scheduler = self.scheduler()
        changed = asyncio.Event()
        server = asyncio.create_task(self._serve(scheduler, changed))
        try:
            while max_jobs is None or self.jobs_done < max_jobs:
                if server.done():
                    server.result()  # the device task died: raise its error
                if self._busy or scheduler.full():
                    changed.clear()
                    try:
                        await asyncio.wait_for(changed.wait(), self.poll_seconds)
                    except asyncio.TimeoutError:
                        pass
                    continue
                try:
                    jobs = await asyncio.to_thread(self.hive.ask_for_work, self.capabilities())
                except HiveError as e:
                    logger.warning("ask_for_work failed: %s", e)
                    await asyncio.sleep(ERROR_BACKOFF_SECONDS)
                    continue
                for job in jobs:
                    logger.info("got job %s", job.get("id"))
                    await scheduler.put(job)
                if not jobs:
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
