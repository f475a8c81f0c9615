"""Hive REST client: GET /api/work, POST /api/results.

The wire shapes of chiaswarm_tpu/hive.py (bearer auth, `worker_version`
and `worker_name` plus the capability advertisement on the poll's query,
the result envelope as the JSON body), over stdlib `urllib`. The calls
block; the worker runs them in a thread so its event loop stays free.
Failover across several hives, epochs and partial uploads are later
slices.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.parse
import urllib.request
from typing import Any

from . import __version__

logger = logging.getLogger(__name__)

USER_AGENT = f"chiaSWARM.worker-torch/{__version__}"
ASK_TIMEOUT_S = 10
SUBMIT_TIMEOUT_S = 60


class HiveError(Exception):
    """A hive request failed (transport error or a non-2xx status)."""


def api_base(sdaas_uri: str) -> str:
    uri = str(sdaas_uri).rstrip("/")
    return uri if uri.endswith("/api") else f"{uri}/api"


class HiveClient:
    def __init__(self, settings):
        self.settings = settings
        self.base = api_base(settings.sdaas_uri)

    def _headers(self) -> dict[str, str]:
        return {
            "Content-type": "application/json",
            "Authorization": f"Bearer {self.settings.sdaas_token}",
            "user-agent": USER_AGENT,
        }

    def _request(self, method: str, url: str, body: bytes | None, timeout: float):
        req = urllib.request.Request(url, data=body, method=method, headers=self._headers())
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            detail = e.read().decode("utf-8", "replace")[:200]
            raise HiveError(f"{method} {url}: HTTP {e.code} {detail}") from e
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            raise HiveError(f"{method} {url}: {e}") from e

    def ask_for_work(self, capabilities: dict[str, Any]) -> list[dict]:
        """Poll for jobs, advertising this worker's capabilities."""
        params = {
            "worker_version": __version__,
            "worker_name": self.settings.worker_name,
            **{k: str(v) for k, v in capabilities.items()},
        }
        url = f"{self.base}/work?{urllib.parse.urlencode(params)}"
        payload = self._request("GET", url, None, ASK_TIMEOUT_S)
        jobs = payload.get("jobs", [])
        if not isinstance(jobs, list):
            raise HiveError(f"malformed /work response: {payload!r:.200}")
        return jobs

    def submit_result(self, result: dict) -> dict:
        """POST one result envelope; returns the hive's ack."""
        ack = self._request("POST", f"{self.base}/results",
                            json.dumps(result).encode(), SUBMIT_TIMEOUT_S)
        logger.info("result ack: %s", ack)
        return ack
