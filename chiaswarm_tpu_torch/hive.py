"""Hive REST client: GET /api/work, POST /api/results, and the partial
uploads and artifact fetch of a chunked pass.

The wire shapes of chiaswarm_tpu/hive.py (bearer auth, `worker_version`
and `worker_name` plus the capability advertisement on the poll's query,
the result envelope as the JSON body), over stdlib `urllib`. The calls
block; the worker runs them in a thread so its event loop stays free.
Each `/work` reply's `cancels` (the hive's revocations of this worker's
leases) is kept in `last_cancels` until the next poll. `post_partial`
(a checkpoint or a preview, POST /api/jobs/{id}/{kind}) and
`fetch_artifact` (a resume offer's blob) are best effort: every failure
returns None. A 4xx answer raises `HiveError(permanent=True)`: the
worker's outbox parks such an envelope instead of retrying a refusal the
hive will repeat. Each request's latency and failures feed
`swarm_hive_request_seconds{endpoint}` and `swarm_hive_errors_total`;
`submit_result` is the `drop_submit` fault point (faults.py). Failover
across several hives and epochs come with a later slice (ROADMAP).
"""

from __future__ import annotations

import http.client
import json
import logging
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any

from . import __version__, faults, telemetry

logger = logging.getLogger(__name__)

USER_AGENT = f"chiaSWARM.worker-torch/{__version__}"
ASK_TIMEOUT_S = 10
SUBMIT_TIMEOUT_S = 60


_REQUEST_SECONDS = telemetry.histogram(
    "swarm_hive_request_seconds",
    "Hive HTTP round-trip latency by endpoint (errors included)",
    ("endpoint",),
)
_ERRORS = telemetry.counter(
    "swarm_hive_errors_total",
    "Hive HTTP requests that raised, by endpoint",
    ("endpoint",),
)


class HiveError(Exception):
    """A hive request failed (transport error or a non-2xx status).

    `permanent` is True for a client error (4xx): the outbox parks such
    an envelope instead of retrying a refusal the hive will repeat."""

    def __init__(self, message: str, permanent: bool = False):
        super().__init__(message)
        self.permanent = permanent


def api_base(sdaas_uri: str) -> str:
    uri = str(sdaas_uri).rstrip("/")
    return uri if uri.endswith("/api") else f"{uri}/api"


class HiveClient:
    def __init__(self, settings):
        self.settings = settings
        self.base = api_base(settings.sdaas_uri)
        # the job ids the last /work reply revoked
        self.last_cancels: list[str] = []

    def _headers(self) -> dict[str, str]:
        return {
            "Content-type": "application/json",
            "Authorization": f"Bearer {self.settings.sdaas_token}",
            "user-agent": USER_AGENT,
        }

    def _request(self, method: str, url: str, body: bytes | None, timeout: float,
                 endpoint: str):
        req = urllib.request.Request(url, data=body, method=method, headers=self._headers())
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            _ERRORS.inc(endpoint=endpoint)
            detail = e.read().decode("utf-8", "replace")[:200]
            raise HiveError(f"{method} {url}: HTTP {e.code} {detail}",
                            permanent=400 <= e.code < 500) from e
        except (urllib.error.URLError, http.client.HTTPException, OSError,
                json.JSONDecodeError) as e:
            _ERRORS.inc(endpoint=endpoint)
            raise HiveError(f"{method} {url}: {e}") from e
        finally:
            _REQUEST_SECONDS.observe(time.perf_counter() - t0, endpoint=endpoint)

    def ask_for_work(self, capabilities: dict[str, Any]) -> list[dict]:
        """Poll for jobs, advertising this worker's capabilities."""
        params = {
            "worker_version": __version__,
            "worker_name": self.settings.worker_name,
            **{k: str(v) for k, v in capabilities.items()},
        }
        url = f"{self.base}/work?{urllib.parse.urlencode(params)}"
        self.last_cancels = []
        payload = self._request("GET", url, None, ASK_TIMEOUT_S, "work")
        # revocations ride the same reply; they hold until the next poll
        self.last_cancels = [str(c) for c in (payload.get("cancels") or []) if c]
        jobs = payload.get("jobs", [])
        if not isinstance(jobs, list):
            raise HiveError(f"malformed /work response: {payload!r:.200}")
        return jobs

    def submit_result(self, result: dict) -> dict:
        """POST one result envelope, one attempt (the worker's outbox
        retries); returns the hive's ack."""
        # the POST never leaves the worker: the transport error of a
        # dropped connection, classified as a real one is
        faults.fire("drop_submit", exc=HiveError(
            f"POST {self.base}/results: injected fault: drop_submit"))
        ack = self._request("POST", f"{self.base}/results",
                            json.dumps(result).encode(), SUBMIT_TIMEOUT_S, "results")
        logger.info("result ack: %s", ack)
        return ack

    def fetch_artifact(self, href: str) -> bytes | None:
        """GET one blob by its site-absolute href (`/api/artifacts/<digest>`,
        as a resume offer carries it); None on any failure."""
        root = self.base[:-len("/api")]
        req = urllib.request.Request(f"{root}{href}", method="GET", headers=self._headers())
        try:
            with urllib.request.urlopen(req, timeout=SUBMIT_TIMEOUT_S) as resp:
                return resp.read()
        except (urllib.error.URLError, http.client.HTTPException, OSError, ValueError) as e:
            # a torn body (IncompleteRead) too: the caller runs the full pass
            logger.warning("artifact fetch %s failed: %s", href, e)
            return None

    def post_partial(self, kind: str, job_id: str, payload: dict) -> dict | None:
        """POST one mid-pass partial (`kind` "checkpoint" or "preview");
        the hive's ack, or None on a refusal (a 409 once the lease moved
        or the job settled) or a transport error."""
        try:
            return self._request("POST", f"{self.base}/jobs/{job_id}/{kind}",
                                 json.dumps(payload).encode(), SUBMIT_TIMEOUT_S, kind)
        except HiveError as e:
            logger.info("%s upload for %s refused or failed: %s", kind, job_id, e)
            return None
