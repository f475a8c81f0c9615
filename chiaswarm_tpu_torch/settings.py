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


_ENV_OVERRIDES = {
    "SDAAS_TOKEN": "sdaas_token",
    "SDAAS_URI": "sdaas_uri",
    "SDAAS_WORKERNAME": "worker_name",
    "CHIASWARM_MODEL_ROOT_DIR": "model_root_dir",
    "CHIASWARM_LORA_ROOT_DIR": "lora_root_dir",
    "CHIASWARM_LORA_CACHE_MB": "lora_cache_mb",
    "CHIASWARM_LORA_OPERAND_CACHE_MB": "lora_operand_cache_mb",
}


def settings_path() -> Path:
    return Path(os.environ.get("SDAAS_ROOT") or "~/.sdaas/").expanduser() / "settings.json"


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
            setattr(settings, attr, kind(value))
    return settings
