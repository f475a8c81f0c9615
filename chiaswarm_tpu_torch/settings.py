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


_ENV_OVERRIDES = {
    "SDAAS_TOKEN": "sdaas_token",
    "SDAAS_URI": "sdaas_uri",
    "SDAAS_WORKERNAME": "worker_name",
    "CHIASWARM_MODEL_ROOT_DIR": "model_root_dir",
}


def settings_path() -> Path:
    return Path(os.environ.get("SDAAS_ROOT") or "~/.sdaas/").expanduser() / "settings.json"


def load_settings() -> Settings:
    """The settings file's known fields (a missing or unreadable file
    gives the defaults), then the environment overrides."""
    try:
        raw = json.loads(settings_path().read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        raw = {}
    fields = {f.name for f in dataclasses.fields(Settings)}
    settings = Settings(**{k: v for k, v in raw.items() if k in fields})
    for env_key, attr in _ENV_OVERRIDES.items():
        value = os.getenv(env_key)
        if value is not None:
            setattr(settings, attr, value)
    return settings
