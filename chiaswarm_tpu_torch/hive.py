"""Hive REST client: GET /api/work, POST /api/results, and the partial
uploads and artifact fetch of a chunked pass, over one hive or several.

The wire shapes of chiaswarm_tpu/hive.py (bearer auth, `worker_version`
and `worker_name` plus the capability advertisement on the poll's query,
the result envelope as the JSON body), over stdlib `urllib`. The calls
block; the worker runs them in threads (the poll thread, the uploader, the
partial shippers, the stage lane), so the failover state below is kept
under one lock. Each `/work` reply's `cancels` (the hive's revocations of
this worker's leases) is kept in `last_cancels` until the next poll.
`post_partial` (a checkpoint or a preview, POST /api/jobs/{id}/{kind}) and
`fetch_artifact` (a resume offer's blob, a stage-job's input) are best
effort: every failure returns None. `submit_workflow` (POST
/api/workflows) and `get_models` (the public catalog, GET /api/models,
saved to $SDAAS_ROOT/models.json; also a module function) are JAX's
client calls. A 4xx answer raises
`HiveError(permanent=True)`: the worker's outbox parks such an envelope
instead of retrying a refusal the hive will repeat. Each request's latency
and failures feed `swarm_hive_request_seconds{endpoint}` and
`swarm_hive_errors_total`; `submit_result` is the `drop_submit` fault
point (faults.py).

Several hives, as the JAX client serves them (hive_server/replication.py
is the serving half): `hive_endpoints` reads `sdaas_uris`
(CHIASWARM_HIVE_URIS, primary first, standbys after) and the client pins
to one. It fails over, pinning the next endpoint, after
`hive_failover_errors` consecutive transport errors or 5xx answers of the
pinned one (any other 4xx proves it alive: a success of reachability), and
at once on a not-primary refusal (a 409 on /work or /results, from a
standby or a deposed primary): `HiveNotPrimary`, after which the same call
tries the next endpoint, one cycle at most. Errors of an endpoint that is
no longer pinned do not count, so two threads that fail together fail over
once. The client keeps the largest fencing epoch a hive advertised
(`X-Hive-Epoch`), echoes it on every request and persists it under
$SDAAS_ROOT in JAX's file `hive_epoch` (the number as text), so that a
restarted worker, or one that switched between the JAX worker and the
port, keeps its fence. Its metrics are JAX's: `swarm_hive_failover_total`,
`swarm_hive_endpoint_errors_total{uri}`, `swarm_hive_active_endpoint{uri}`
and `swarm_hive_retries_total{endpoint}` (the not-primary retries on the
next endpoint: the port's client makes one attempt otherwise, and the
outbox retries).
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any

from . import __version__, faults, telemetry
from .settings import Settings, resolve_path

logger = logging.getLogger(__name__)

USER_AGENT = f"chiaSWARM.worker-torch/{__version__}"
ASK_TIMEOUT_S = 10
SUBMIT_TIMEOUT_S = 60
# the worker host's largest fencing epoch, under $SDAAS_ROOT (JAX's file)
EPOCH_FILENAME = "hive_epoch"


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
_RETRIES = telemetry.counter(
    "swarm_hive_retries_total",
    "Hive requests retried after a transient failure, by endpoint",
    ("endpoint",),
)
_FAILOVERS = telemetry.counter(
    "swarm_hive_failover_total",
    "Worker-side hive failovers (the client pinned to the next "
    "configured endpoint after transport errors or a not-primary 409)",
)
_ENDPOINT_ERRORS = telemetry.counter(
    "swarm_hive_endpoint_errors_total",
    "Transport-level hive failures by configured endpoint URI",
    ("uri",),
)
_ACTIVE_ENDPOINT = telemetry.gauge(
    "swarm_hive_active_endpoint",
    "1 for the hive endpoint this worker is currently pinned to, "
    "0 for the others",
    ("uri",),
)


class HiveError(Exception):
    """A hive request failed (transport error or a non-2xx status).

    `permanent` is True for a client error (4xx): the outbox parks such
    an envelope instead of retrying a refusal the hive will repeat."""

    def __init__(self, message: str, permanent: bool = False):
        super().__init__(message)
        self.permanent = permanent


class HiveNotPrimary(Exception):
    """The pinned endpoint answered 409: a standby still replicating, or a
    primary deposed by a newer epoch. Transient: the pin has moved on."""


def api_base(sdaas_uri: str) -> str:
    uri = str(sdaas_uri).rstrip("/")
    return uri if uri.endswith("/api") else f"{uri}/api"


def hive_endpoints(settings) -> list[str]:
    """The API endpoints in preference order: `sdaas_uris` (commas or
    semicolons between site URIs), else the single `sdaas_uri`; each
    normalised to its `/api` base."""
    raw = str(settings.sdaas_uris or "")
    uris = [u.strip().rstrip("/") for u in raw.replace(";", ",").split(",") if u.strip()]
    if not uris:
        uris = [str(settings.sdaas_uri).rstrip("/")]
    return [api_base(u) for u in uris]


def load_epoch() -> int:
    """The persisted fencing epoch; 0 when there is none or it is unreadable."""
    try:
        return int(resolve_path(EPOCH_FILENAME).read_text().strip())
    except (OSError, ValueError):
        return 0


def persist_epoch(epoch: int) -> None:
    """Write the epoch as JAX does (tmp + rename). Best effort: a failed
    write leaves the fence in memory for this process only."""
    try:
        path = resolve_path(EPOCH_FILENAME)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(str(int(epoch)))
        os.replace(tmp, path)
    except OSError:
        logger.warning("could not persist hive epoch %d; fencing is in-memory only for "
                       "this process", epoch)


class HiveClient:
    def __init__(self, settings):
        self.settings = settings
        self.endpoints = hive_endpoints(settings)
        # the pin, the error streak and the epoch: one lock for all three
        self._lock = threading.Lock()
        self._pin = 0
        self._consecutive_errors = 0
        self._failover_errors = max(int(settings.hive_failover_errors or 2), 1)
        self.failovers = 0
        # echoed on every request, so that a deposed primary recognises
        # itself and refuses
        self.epoch = load_epoch()
        # the job ids the last /work reply revoked
        self.last_cancels: list[str] = []
        self._refresh_active_gauge()

    @property
    def hive_uri(self) -> str:
        """The endpoint this client is pinned to."""
        return self.endpoints[self._pin]

    def _headers(self) -> dict[str, str]:
        headers = {
            "Content-type": "application/json",
            "Authorization": f"Bearer {self.settings.sdaas_token}",
            "user-agent": USER_AGENT,
        }
        epoch = self.epoch
        if epoch > 0:
            headers["X-Hive-Epoch"] = str(epoch)
        return headers

    # --- failover bookkeeping (every caller holds no lock) ---

    def _refresh_active_gauge(self) -> None:
        pinned = self.hive_uri
        for uri in self.endpoints:
            _ACTIVE_ENDPOINT.set(1 if uri == pinned else 0, uri=uri)

    def _failover_from(self, uri: str, reason: str) -> None:
        """Pin the endpoint after `uri`, unless another thread already
        moved the pin off it (or there is only one endpoint)."""
        with self._lock:
            if self.hive_uri != uri:
                return
            self._consecutive_errors = 0
            if len(self.endpoints) <= 1:
                return
            self._pin = (self._pin + 1) % len(self.endpoints)
            self.failovers += 1
            new = self.hive_uri
            self._refresh_active_gauge()
        _FAILOVERS.inc()
        logger.warning("hive failover: %s -> %s (%s)", uri, new, reason)

    def _note_transport_error(self, uri: str) -> None:
        _ENDPOINT_ERRORS.inc(uri=uri)
        with self._lock:
            if self.hive_uri != uri:
                return  # an error of an endpoint already left behind
            self._consecutive_errors += 1
            streak = self._consecutive_errors
        if streak >= self._failover_errors:
            self._failover_from(uri, f"{streak} consecutive transport errors")

    def _note_success(self, uri: str) -> None:
        with self._lock:
            if self.hive_uri == uri:
                self._consecutive_errors = 0

    def _note_epoch(self, headers) -> None:
        try:
            seen = int((headers or {}).get("X-Hive-Epoch", ""))
        except (TypeError, ValueError):
            return
        with self._lock:
            if seen <= self.epoch:
                return
            self.epoch = seen
            # rare: epochs move only on promotions
            persist_epoch(seen)

    # --- requests ---

    def _request(self, method: str, path: str, body: bytes | None, timeout: float,
                 endpoint: str, not_primary: bool = False):
        """One request to the pinned endpoint -> the decoded JSON body.
        With `not_primary`, a 409 fails over and raises HiveNotPrimary."""
        uri = self.hive_uri
        req = urllib.request.Request(f"{uri}{path}", data=body, method=method,
                                     headers=self._headers())
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                self._note_epoch(resp.headers)
                payload = json.loads(resp.read() or b"{}")
            self._note_success(uri)
            return payload
        except urllib.error.HTTPError as e:
            self._note_epoch(e.headers)
            detail = e.read().decode("utf-8", "replace")[:200]
            if e.code == 409 and not_primary:
                try:
                    message = json.loads(detail).get("message", "not primary")
                except (ValueError, AttributeError):
                    message = "not primary"
                logger.warning("hive %s refused as not-primary: %s", uri, message)
                self._failover_from(uri, message)
                raise HiveNotPrimary(message) from e
            _ERRORS.inc(endpoint=endpoint)
            if e.code >= 500:
                self._note_transport_error(uri)
            else:
                self._note_success(uri)
            raise HiveError(f"{method} {uri}{path}: HTTP {e.code} {detail}",
                            permanent=400 <= e.code < 500) from e
        except (urllib.error.URLError, http.client.HTTPException, OSError,
                json.JSONDecodeError) as e:
            _ERRORS.inc(endpoint=endpoint)
            self._note_transport_error(uri)
            raise HiveError(f"{method} {uri}{path}: {e}") from e
        finally:
            _REQUEST_SECONDS.observe(time.perf_counter() - t0, endpoint=endpoint)

    def _on_each_endpoint(self, attempt, endpoint: str):
        """`attempt()` on the pinned endpoint and, after each not-primary
        refusal, on the next: one cycle at most. Raises HiveError when every
        endpoint refused, naming the remedy for a fence that outlived a
        rebuilt fleet."""
        last: Exception | None = None
        for k in range(len(self.endpoints)):
            if k:
                _RETRIES.inc(endpoint=endpoint)
            try:
                return attempt()
            except HiveNotPrimary as e:
                last = e
        remedy = ""
        if self.epoch > 0 and "stale hive epoch" in str(last):
            # every hive is behind the persisted epoch: a failover in flight,
            # or a fleet rebuilt from scratch that this fence outlived
            remedy = (f"; if the hive fleet was rebuilt (fresh epoch 0), delete "
                      f"{EPOCH_FILENAME} under $SDAAS_ROOT on this worker to reset its "
                      f"fencing epoch ({self.epoch})")
        raise HiveError(f"every hive endpoint refused as not-primary: {last}{remedy}") from last

    def ask_for_work(self, capabilities: dict[str, Any]) -> list[dict]:
        """Poll for jobs, advertising this worker's capabilities."""
        params = {
            "worker_version": __version__,
            "worker_name": self.settings.worker_name,
            **{k: str(v) for k, v in capabilities.items()},
        }
        path = f"/work?{urllib.parse.urlencode(params)}"
        self.last_cancels = []
        payload = self._on_each_endpoint(
            lambda: self._request("GET", path, None, ASK_TIMEOUT_S, "work", not_primary=True),
            "work")
        # revocations ride the same reply; they hold until the next poll
        self.last_cancels = [str(c) for c in (payload.get("cancels") or []) if c]
        jobs = payload.get("jobs", [])
        if not isinstance(jobs, list):
            raise HiveError(f"malformed /work response: {payload!r:.200}")
        return jobs

    def _submit_once(self, body: bytes) -> dict:
        # the POST never leaves the worker: the transport error of a
        # dropped connection, classified as a real one is
        try:
            faults.fire("drop_submit", exc=HiveError(
                f"POST {self.hive_uri}/results: injected fault: drop_submit"))
        except HiveError:
            _ERRORS.inc(endpoint="results")
            self._note_transport_error(self.hive_uri)
            raise
        return self._request("POST", "/results", body, SUBMIT_TIMEOUT_S, "results",
                             not_primary=True)

    def submit_result(self, result: dict) -> dict:
        """POST one result envelope, one attempt on each endpoint that
        refuses as not-primary (the worker's outbox retries anything else);
        returns the hive's ack."""
        body = json.dumps(result).encode()
        ack = self._on_each_endpoint(lambda: self._submit_once(body), "results")
        logger.info("result ack: %s", ack)
        return ack

    def fetch_artifact(self, href: str) -> bytes | None:
        """GET one blob by its href: site-absolute (`/api/artifacts/<digest>`,
        on the pinned hive) or an absolute URL, fetched as given. None on
        any failure."""
        uri = self.hive_uri
        url = href if href.startswith(("http://", "https://")) else f"{uri[:-len('/api')]}{href}"
        req = urllib.request.Request(url, method="GET", headers=self._headers())
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=SUBMIT_TIMEOUT_S) as resp:
                self._note_epoch(resp.headers)
                blob = resp.read()
            self._note_success(uri)
            return blob
        except urllib.error.HTTPError as e:
            self._note_epoch(e.headers)
            logger.warning("artifact fetch %s answered %d", href, e.code)
            return None
        except (urllib.error.URLError, http.client.HTTPException, OSError, ValueError) as e:
            # a torn body (IncompleteRead) too: the caller degrades
            _ERRORS.inc(endpoint="artifact")
            self._note_transport_error(uri)
            logger.warning("artifact fetch %s failed: %s", href, e)
            return None
        finally:
            _REQUEST_SECONDS.observe(time.perf_counter() - t0, endpoint="artifact")

    def post_partial(self, kind: str, job_id: str, payload: dict) -> dict | None:
        """POST one mid-pass partial (`kind` "checkpoint" or "preview") to
        the pinned hive; the hive's ack, or None on a refusal (a 409 once
        the lease moved or the job settled) or a transport error."""
        try:
            return self._request("POST", f"/jobs/{job_id}/{kind}",
                                 json.dumps(payload).encode(), SUBMIT_TIMEOUT_S, kind)
        except HiveError as e:
            logger.info("%s upload for %s refused or failed: %s", kind, job_id, e)
            return None

    def submit_workflow(self, payload: dict) -> dict:
        """POST one multi-stage workflow to /api/workflows on the pinned
        hive, one attempt (the submit is cheap to retry at the caller's
        policy, unlike a result envelope), as JAX's client. -> the hive's
        reply; raises HiveError on any non-2xx."""
        return self._request("POST", "/workflows", json.dumps(payload).encode(),
                             SUBMIT_TIMEOUT_S, "workflows")

    def get_models(self) -> list[dict]:
        """The hive's model catalog (`language_models` then `models`), from
        each endpoint once, starting at the pin (every hive serves it, a
        standby too); saved to $SDAAS_ROOT/models.json on success, as
        JAX's client. Raises the last failure."""
        last: Exception | None = None
        for offset in range(len(self.endpoints)):
            uri = self.endpoints[(self._pin + offset) % len(self.endpoints)]
            try:
                return self._get_models_once(uri)
            except Exception as e:  # noqa: BLE001 — the next hive may answer
                last = e
                if offset + 1 < len(self.endpoints):
                    logger.warning("model catalog fetch from %s failed (%s); trying the "
                                   "next hive", uri, e)
        raise last

    def _get_models_once(self, base: str) -> list[dict]:
        # the catalog is public: no bearer token, as the reference sends
        url = f"{base}/models" if base.endswith("/api") else f"{base}/api/models"
        req = urllib.request.Request(url, method="GET", headers={"user-agent": USER_AGENT})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=ASK_TIMEOUT_S) as resp:
                data = json.loads(resp.read())
            resolve_path("models.json").write_text(json.dumps(data, indent=2))
            return data["language_models"] + data["models"]
        except Exception:
            _ERRORS.inc(endpoint="models")
            raise
        finally:
            _REQUEST_SECONDS.observe(time.perf_counter() - t0, endpoint="models")


def get_models(hive_uri: str) -> list[dict]:
    """The catalog of the hive at `hive_uri` (a site URI or its /api base),
    as JAX's module function."""
    return HiveClient(Settings(sdaas_uri=hive_uri, sdaas_token="")).get_models()
