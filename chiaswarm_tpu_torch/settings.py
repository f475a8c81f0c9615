"""Worker settings: the subset of chiaswarm_tpu/settings.py that the
port's worker reads, from the same file ($SDAAS_ROOT/settings.json, else
~/.sdaas/settings.json) and the same environment overrides."""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path


@dataclasses.dataclass
class Settings:
    sdaas_token: str = ""
    sdaas_uri: str = "http://localhost:9511"
    worker_name: str = "worker"
    model_root_dir: str = "~/.sdaas/models"
    # where a job's bare LoRA name (and a textual inversion) is looked up
    lora_root_dir: str = "~/lora"
    # byte caps (MiB) of the adapter caches (lora_cache.py): raw factors on
    # the host, and their stacks on the device; 0 disables caching
    # (adapters still load, once per job)
    lora_cache_mb: int = 256
    lora_operand_cache_mb: int = 512
    # cross-job batching (batching.py): how long a coalescable job waits
    # for batchmates, and the most jobs one group holds (<= 1, or a linger
    # of 0, serves every job alone)
    batch_linger_ms: float = 50.0
    max_coalesce: int = 8
    # byte cap (MiB) of the encoded-prompt cache (embed_cache.py); 0 turns
    # it off
    embed_cache_mb: int = 64
    # most distinct adapters one coalesced pass carries
    lora_slots_max: int = 8
    # the NSFW safety checker feeding the envelope flag, a model directory
    # under model_root_dir ("" disables it; pipelines/safety.py)
    safety_checker_model: str = "CompVis/stable-diffusion-safety-checker"
    # the detectors of the `depth` and `openpose` preprocessors, model
    # directories under model_root_dir (pipelines/aux_models.py)
    depth_model: str = "Intel/dpt-large"
    pose_model: str = "lllyasviel/ControlNet-openpose"
    # chunked denoise (pipelines/stable_diffusion.py): the host syncs the
    # device and probes the cancel registry (cancel.py) every this many
    # steps, so a cancelled job frees the device within one chunk; 0 runs
    # the loop through. Chunked and unchunked images are bit for bit equal
    denoise_chunk_steps: int = 0
    # ship a checkpoint (latents, scheduler state, step, generator state;
    # checkpoint.py) to the hive every this many chunk boundaries, so a
    # redelivered job resumes at step K; needs denoise_chunk_steps > 0,
    # 0 disables
    checkpoint_every_chunks: int = 0
    # the largest checkpoint blob shipped (bytes); a larger one is skipped
    checkpoint_max_bytes: int = 8388608
    # decode the live latents into a JPEG preview for the hive every this
    # many chunk boundaries; 0 disables
    preview_every_chunks: int = 0
    # --- the worker plane (telemetry.py, outbox.py, faults.py) ---
    # arm the on-demand profiler capture on the metrics app (POST
    # /debug/profile?seconds=N writes a torch.profiler Chrome trace under
    # $SDAAS_ROOT/profiles/); off by default: a profile exposes prompts
    # and timings
    profiler_capture: bool = False
    # local /metrics + /healthz HTTP port; 0 disables the server (the
    # in-process instrumentation stays on either way)
    metrics_port: int = 8061
    # bind address of the metrics server; loopback unless the operator
    # opts in
    metrics_host: str = "127.0.0.1"
    # log line format: "plain" | "json" (one object per line carrying the
    # active job_id, log_setup.JsonFormatter)
    log_format: str = "plain"
    # per-pass execution deadline of the watchdog; 0 disables. On expiry
    # each job of the pass gets the transient-error envelope and the
    # device is quarantined until it passes a probe
    job_deadline_s: float = 900.0
    # deadline multiplier when the job's model is not resident yet (its
    # build and first pass take longer)
    job_deadline_compile_scale: float = 4.0
    # how long the quarantine probe waits for a hung pass to release the
    # device before writing it off (the worker then takes no more work)
    quarantine_probe_grace_s: float = 30.0
    # stop(drain=True) / SIGTERM: how long the passes in flight and the
    # outbox get to finish before the worker exits anyway (spooled
    # envelopes survive)
    drain_deadline_s: float = 120.0
    # durable result spool directory (relative to $SDAAS_ROOT)
    outbox_dir: str = "outbox"
    # spooled-envelope count at which /healthz turns degraded (0 = never)
    outbox_max_entries: int = 512
    # deterministic fault-injection spec (faults.py), e.g.
    # "drop_submit=3,hang_denoise=1"; empty = no faults armed
    fault_injection: str = ""
    # /healthz reports degraded when the card's free fraction
    # (memory_census.device_headroom) drops below this; 0 disables
    memory_headroom_degraded: float = 0.0
    # --- several hives, gangs and stage graphs (hive.py, worker.py) ---
    # comma-separated hive site URIs in preference order (primary first,
    # standbys after); the client pins to one and fails over on
    # consecutive transport errors or a not-primary 409. Empty = the
    # single sdaas_uri
    sdaas_uris: str = ""
    # consecutive transport errors (or 5xx) on the pinned hive endpoint
    # before the client pins to the next one
    hive_failover_errors: int = 2
    # EWMA smoothing factor of the per-stage stats blob piggybacked on
    # /work polls (the hive's straggler detector reads it)
    hive_stats_ewma_alpha: float = 0.2
    # the workflow stages this worker advertises on /work: "auto" (every
    # stage; the host stages only while the stage lane has consumers),
    # "none" (no advertisement: the worker never sees a stage-job) or an
    # explicit comma-separated list
    stage_roles: str = "auto"
    # consumers of the host stage lane (encode / decode jobs run beside
    # the device, so the decode of one pass overlaps the denoise of the
    # next); 0 disables the lane and "auto" then leaves the host stages out
    stage_workers: int = 2


_ENV_OVERRIDES = {
    "SDAAS_TOKEN": "sdaas_token",
    "SDAAS_URI": "sdaas_uri",
    "SDAAS_WORKERNAME": "worker_name",
    "CHIASWARM_MODEL_ROOT_DIR": "model_root_dir",
    "CHIASWARM_LORA_ROOT_DIR": "lora_root_dir",
    "CHIASWARM_LORA_CACHE_MB": "lora_cache_mb",
    "CHIASWARM_LORA_OPERAND_CACHE_MB": "lora_operand_cache_mb",
    "SDAAS_BATCH_LINGER_MS": "batch_linger_ms",
    "SDAAS_MAX_COALESCE": "max_coalesce",
    "CHIASWARM_EMBED_CACHE_MB": "embed_cache_mb",
    "CHIASWARM_LORA_SLOTS_MAX": "lora_slots_max",
    "CHIASWARM_SAFETY_CHECKER_MODEL": "safety_checker_model",
    "CHIASWARM_DEPTH_MODEL": "depth_model",
    "CHIASWARM_POSE_MODEL": "pose_model",
    "CHIASWARM_DENOISE_CHUNK_STEPS": "denoise_chunk_steps",
    "CHIASWARM_CHECKPOINT_EVERY_CHUNKS": "checkpoint_every_chunks",
    "CHIASWARM_CHECKPOINT_MAX_BYTES": "checkpoint_max_bytes",
    "CHIASWARM_PREVIEW_EVERY_CHUNKS": "preview_every_chunks",
    "CHIASWARM_PROFILER_CAPTURE": "profiler_capture",
    "CHIASWARM_METRICS_PORT": "metrics_port",
    "CHIASWARM_METRICS_HOST": "metrics_host",
    "CHIASWARM_LOG_FORMAT": "log_format",
    "CHIASWARM_JOB_DEADLINE_S": "job_deadline_s",
    "CHIASWARM_JOB_DEADLINE_COMPILE_SCALE": "job_deadline_compile_scale",
    "CHIASWARM_QUARANTINE_PROBE_GRACE_S": "quarantine_probe_grace_s",
    "CHIASWARM_DRAIN_DEADLINE_S": "drain_deadline_s",
    "CHIASWARM_OUTBOX_DIR": "outbox_dir",
    "CHIASWARM_OUTBOX_MAX_ENTRIES": "outbox_max_entries",
    "CHIASWARM_FAULTS": "fault_injection",
    "CHIASWARM_MEMORY_HEADROOM_DEGRADED": "memory_headroom_degraded",
    "CHIASWARM_HIVE_URIS": "sdaas_uris",
    "CHIASWARM_HIVE_FAILOVER_ERRORS": "hive_failover_errors",
    "CHIASWARM_HIVE_STATS_EWMA_ALPHA": "hive_stats_ewma_alpha",
    "CHIASWARM_STAGE_ROLES": "stage_roles",
    "CHIASWARM_STAGE_WORKERS": "stage_workers",
}


def settings_dir() -> Path:
    return Path(os.environ.get("SDAAS_ROOT") or "~/.sdaas/").expanduser()


def settings_path() -> Path:
    return settings_dir() / "settings.json"


def resolve_path(path: str | Path) -> Path:
    """`path` under $SDAAS_ROOT (an absolute path stays as it is), its
    parent created."""
    full = settings_dir() / path
    full.parent.mkdir(parents=True, exist_ok=True)
    return full


def save_settings(settings: Settings) -> None:
    """Write every field to the settings file (the setup CLI)."""
    path = settings_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dataclasses.asdict(settings), indent=2))


def load_settings() -> Settings:
    """The settings file's known fields (a missing or unreadable file
    gives the defaults), then the environment overrides, cast to each
    field's type."""
    try:
        raw = json.loads(settings_path().read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        raw = {}
    fields = {f.name: f for f in dataclasses.fields(Settings)}
    settings = Settings(**{k: v for k, v in raw.items() if k in fields})
    for env_key, attr in _ENV_OVERRIDES.items():
        value = os.getenv(env_key)
        if value is not None:
            kind = type(fields[attr].default)
            if kind is bool:
                # bool("0") is True: parse the usual spellings instead
                setattr(settings, attr, value.strip().lower() in ("1", "true", "yes", "on"))
            else:
                setattr(settings, attr, kind(value))
    return settings
