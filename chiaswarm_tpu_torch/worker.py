"""The port's worker: poll the hive -> format -> run -> POST the envelope.

The core loop of chiaswarm_tpu/worker.py with the same wire shapes:
bearer auth, `worker_version`, a capability advertisement with the GPU in
the legacy `gpu`/`memory` keys as well as `chips`/`hbm_gb`, and result
envelopes {id, artifacts (b64 + sha256), nsfw, worker_version,
pipeline_config (with timings), fatal_error on unrecoverable jobs}. One
job runs at a time on one device. The outbox, telemetry, batching,
resumable checkpoints, geometry and stage graphs are later slices.

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
from .device import device_label, memory_gb, resolve_device
from .hive import HiveClient, HiveError
from .job_arguments import format_args
from .lora_cache import LoraCache
from .post_processors.output_processor import exception_image, fatal_exception_response
from .registry import Registry
from .settings import load_settings

logger = logging.getLogger(__name__)

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
                      int(self.settings.lora_operand_cache_mb) << 20))
        self.hive = HiveClient(self.settings)
        self.poll_seconds = poll_seconds
        self.jobs_done = 0

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
        }

    def execute(self, job: dict) -> dict:
        """Run one job to its result envelope (never raises for a job's
        own failure: ValueError/TypeError give a fatal envelope, anything
        else an error-image artifact the hive may retry)."""
        job_id = job.get("id")
        try:
            callback, args = format_args(job, self.settings)
        except Exception as e:  # noqa: BLE001 — malformed job: never resubmit
            logger.exception("format_args failed for job %s", job_id)
            return fatal_exception_response(e, job_id, job)
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

    async def _submit(self, result: dict) -> None:
        result.setdefault("worker_name", self.settings.worker_name)
        try:
            await asyncio.to_thread(self.hive.submit_result, result)
        except HiveError:
            # one retry: the artifacts cost a whole denoise pass
            logger.warning("result upload failed for %s; retrying once", result.get("id"))
            await asyncio.sleep(1.0)
            await asyncio.to_thread(self.hive.submit_result, result)

    async def run(self, max_jobs: int | None = None) -> None:
        """Poll and serve forever, or until `max_jobs` jobs are done."""
        while max_jobs is None or self.jobs_done < max_jobs:
            try:
                jobs = await asyncio.to_thread(self.hive.ask_for_work, self.capabilities())
            except HiveError as e:
                logger.warning("ask_for_work failed: %s", e)
                await asyncio.sleep(ERROR_BACKOFF_SECONDS)
                continue
            for job in jobs:
                logger.info("got job %s", job.get("id"))
                # GPU work off the event loop, one job at a time
                result = await asyncio.to_thread(self.execute, job)
                try:
                    await self._submit(result)
                except HiveError:
                    logger.exception("dropping the result of job %s", job.get("id"))
                self.jobs_done += 1
            if not jobs:
                await asyncio.sleep(self.poll_seconds)


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
