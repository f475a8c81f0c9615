"""Log formatting: the counterpart of chiaswarm_tpu/log_setup.py.

`log_format="json"` (`Settings.log_format`, `CHIASWARM_LOG_FORMAT`) swaps
the plain formatter for one JSON object per line whose records carry the
active `job_id`: passed explicitly with
``logger.info(..., extra={"job_id": ...})`` or picked up from the
telemetry contextvar that `trace_job` pins around each job on the
worker's device thread. Plain stays the default. The port's entry point
logs to stderr (`setup_stream`); the JAX worker's rotating log file has
no counterpart (no `log_filename` setting).
"""

from __future__ import annotations

import json
import logging

from .telemetry import current_job_id

PLAIN_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"


class JsonFormatter(logging.Formatter):
    """One JSON object per line; `job_id` rides every record logged while a
    job trace is active, so a grep for one job id yields its whole story."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        job_id = getattr(record, "job_id", None)
        if job_id is None:
            job_id = current_job_id.get()
        if job_id is not None:
            payload["job_id"] = str(job_id)
        if record.exc_info:
            payload["exc_info"] = self.formatException(record.exc_info)
        return json.dumps(payload, ensure_ascii=False)


def formatter(log_format: str = "plain") -> logging.Formatter:
    return JsonFormatter() if log_format == "json" else logging.Formatter(PLAIN_FORMAT)


def setup_stream(log_level: str = "INFO", log_format: str = "plain") -> logging.Handler:
    """Log to stderr in `log_format`; returns the handler it added."""
    handler = logging.StreamHandler()
    handler.setFormatter(formatter(log_format))
    root = logging.getLogger()
    root.setLevel(log_level)
    root.addHandler(handler)
    return handler
