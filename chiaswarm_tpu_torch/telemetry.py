"""Process-wide telemetry: metrics registry, per-job trace spans, local HTTP.

The counterpart of chiaswarm_tpu/telemetry.py (copied; the port imports
nothing of the JAX package), with the same exposition bytes:

- a stdlib-only metrics registry (`Counter`, `Gauge`, `Histogram` with
  fixed buckets) rendering the Prometheus text exposition format, locked
  per metric and per registry: the device thread, the event loop and the
  metrics app all touch it;
- `Span` / `JobTrace` / `trace_job`, which stamp per-stage wall time into
  the process-wide `swarm_job_stage_seconds{stage=...}` histogram and the
  job's `timings` dict, and pin `current_job_id` for log correlation
  (log_setup.JsonFormatter reads it);
- an aiohttp app (`GET /metrics`, `GET /healthz`, and the `/debug/*`
  routes) that the worker starts on `Settings.metrics_host:metrics_port`
  (`CHIASWARM_METRICS_PORT`; 0 disables the server, the instrumentation
  stays on). aiohttp is imported only when the app is built.
"""

from __future__ import annotations

import bisect
import contextvars
import threading
import time

# per-job stage timings land here; label value = stage name
STAGE_METRIC = "swarm_job_stage_seconds"
_STAGE_HELP = "Per-job wall-clock seconds by lifecycle stage"

# generic latency buckets: 5 ms poll hops up to multi-minute passes
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

# the job id of the currently-executing job, for log correlation
# (log_setup.JsonFormatter reads it); set by trace_job / worker threads
current_job_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "chiaswarm_job_id", default=None
)


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _sample_line(name: str, labelnames, labelvalues, value: float,
                 extra: tuple[str, str] | None = None) -> str:
    """One exposition line; labels render in DECLARED order (stable), with
    an optional trailing (name, value) pair — histograms put `le` last."""
    pairs = list(zip(labelnames, labelvalues))
    if extra is not None:
        pairs.append(extra)
    if pairs:
        lbl = ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs)
        return f"{name}{{{lbl}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: dict[tuple, object] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got "
                f"{tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def remove(self, **labels) -> None:
        """Drop one label combination's series. Bounded-cardinality
        surfaces (per-tenant usage gauges folded to top-K, per-worker
        outlier flags pruned with the directory) retire label values
        here instead of exposing stale series forever."""
        with self._lock:
            self._values.pop(self._key(labels), None)

    def samples(self) -> list[str]:
        raise NotImplementedError

    def render(self) -> str:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        lines.extend(self.samples())
        return "\n".join(lines)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))

    def total(self) -> float:
        """Sum across every label combination (heartbeat snapshots)."""
        with self._lock:
            return float(sum(self._values.values()))

    def samples(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [
            _sample_line(self.name, self.labelnames, key, v)
            for key, v in items
        ]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))

    def samples(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [
            _sample_line(self.name, self.labelnames, key, v)
            for key, v in items
        ]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", labelnames=(),
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = tuple(bounds)

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                # per-bound counts + overflow slot, running sum, count
                state = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._values[key] = state
            state[0][bisect.bisect_left(self.buckets, v)] += 1
            state[1] += v
            state[2] += 1

    def count(self, **labels) -> int:
        with self._lock:
            state = self._values.get(self._key(labels))
            return int(state[2]) if state else 0

    def sum(self, **labels) -> float:
        with self._lock:
            state = self._values.get(self._key(labels))
            return float(state[1]) if state else 0.0

    def label_values(self, labelname: str) -> list[str]:
        """Distinct observed values of one label (e.g. every stage seen)."""
        idx = self.labelnames.index(labelname)
        with self._lock:
            return sorted({key[idx] for key in self._values})

    def samples(self) -> list[str]:
        with self._lock:
            items = sorted(
                (key, [list(s[0]), s[1], s[2]])
                for key, s in self._values.items()
            )
        lines = []
        for key, (counts, total, n) in items:
            cumulative = 0
            for bound, c in zip(self.buckets, counts):
                cumulative += c
                lines.append(_sample_line(
                    f"{self.name}_bucket", self.labelnames, key, cumulative,
                    extra=("le", _fmt_value(bound)),
                ))
            lines.append(_sample_line(
                f"{self.name}_bucket", self.labelnames, key, n,
                extra=("le", "+Inf"),
            ))
            lines.append(_sample_line(
                f"{self.name}_sum", self.labelnames, key, total))
            lines.append(_sample_line(
                f"{self.name}_count", self.labelnames, key, n))
        return lines


class Registry:
    """Get-or-create metric container; one module-level instance serves the
    whole process (the device thread + the asyncio loop)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {name} already registered with a different "
                        "type or label set"
                    )
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        return "\n".join(m.render() for m in metrics) + "\n"


REGISTRY = Registry()


def counter(name, help="", labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


# --- spans -----------------------------------------------------------------


def observe_stage(stage: str, seconds: float, registry: Registry | None = None
                  ) -> None:
    (registry or REGISTRY).histogram(
        STAGE_METRIC, _STAGE_HELP, ("stage",)
    ).observe(seconds, stage=stage)


class Span:
    """Times one stage of a job; on exit the elapsed wall clock lands in
    the stage histogram AND (when a timings dict is given) in
    `timings[key or f"{stage}_s"]` rounded the way the existing envelope
    timings are. Records on exception too — a failed denoise still spent
    the time."""

    def __init__(self, stage: str, timings: dict | None = None, *,
                 key: str | None = None, registry: Registry | None = None):
        self.stage = stage
        self.timings = timings
        self.key = key or f"{stage}_s"
        self.registry = registry
        self.elapsed: float | None = None

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
        observe_stage(self.stage, self.elapsed, self.registry)
        if self.timings is not None:
            self.timings[self.key] = round(self.elapsed, 3)


class JobTrace:
    """Per-job trace: a context manager that pins `current_job_id` for log
    correlation and hands out `stage()` spans all writing into one shared
    timings dict (the one that ends up in the job's pipeline_config)."""

    def __init__(self, job_id: str | None = None, timings: dict | None = None,
                 registry: Registry | None = None):
        self.job_id = job_id
        self.timings = timings if timings is not None else {}
        self.registry = registry
        self._token = None

    def __enter__(self) -> "JobTrace":
        if self.job_id is not None:
            self._token = current_job_id.set(str(self.job_id))
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            current_job_id.reset(self._token)
            self._token = None

    def stage(self, stage: str, key: str | None = None) -> Span:
        return Span(stage, self.timings, key=key, registry=self.registry)

    def record(self, stage: str, seconds: float, key: str | None = None
               ) -> None:
        """A stage measured elsewhere (e.g. queue wait stamped by the
        scheduler) joins the same histogram + timings dict."""
        observe_stage(stage, seconds, self.registry)
        self.timings[key or f"{stage}_s"] = round(seconds, 3)


def trace_job(job_id: str | None = None, timings: dict | None = None,
              registry: Registry | None = None) -> JobTrace:
    return JobTrace(job_id, timings, registry)


# --- HTTP exposition -------------------------------------------------------


# profiler captures may not stack and a runaway duration would pin the
# trace machinery for the whole window — bound one capture hard
PROFILE_MAX_SECONDS = 120.0


def build_metrics_app(registry: Registry | None = None, health=None,
                      profile=None, token: str = "", programs=None,
                      memory=None):
    """aiohttp app with GET /metrics (Prometheus text) and GET /healthz
    (JSON from the caller's `health()` snapshot; a payload carrying
    `status` != "ok" answers 503 so probes can act on it). aiohttp is
    imported lazily — the registry itself must stay dependency-free.

    `profile` (optional) is an async callable `(seconds) -> dict` wired
    to POST /debug/profile?seconds=N — the worker passes its on-demand
    torch.profiler capture (writes a Chrome trace under
    $SDAAS_ROOT/profiles/). The callable raising PermissionError maps to
    403 (the Settings.profiler_capture gate), RuntimeError to 409 (a
    capture already running); no callable, no route. Unlike the
    read-only GETs, /debug/profile MUTATES (pins an executor thread,
    writes prompt-exposing traces to disk), so when `token` is set it
    requires the same bearer auth the hive APIs use — a worker whose
    metrics_host is widened off loopback must not expose an anonymous
    write endpoint (empty token = dev mode, matching the hive).

    `programs` / `memory` (optional) are sync callables returning
    JSON-ready dicts, wired to GET /debug/programs (the pass and kernel
    ledger, programs.snapshot) and GET /debug/memory (the byte census,
    memory_census.census). Read-only like
    /metrics; no callable, no route."""
    from aiohttp import web

    reg = registry or REGISTRY

    async def metrics(_request):
        return web.Response(
            text=reg.render(),
            headers={"Content-Type": "text/plain; version=0.0.4; charset=utf-8"},
        )

    async def healthz(_request):
        payload = {"status": "ok"}
        if health is not None:
            try:
                payload.update(health() or {})
            except Exception as e:  # a broken probe must still answer
                return web.json_response(
                    {"status": "error", "error": f"{type(e).__name__}: {e}"},
                    status=503,
                )
        status = 200 if payload.get("status") == "ok" else 503
        return web.json_response(payload, status=status)

    async def debug_profile(request):
        if token and request.headers.get(
                "Authorization", "") != f"Bearer {token}":
            return web.json_response(
                {"message": "unauthorized"}, status=401)
        try:
            seconds = float(request.query.get("seconds", "2"))
        except ValueError:
            return web.json_response(
                {"message": "seconds must be a number"}, status=400)
        if not 0 < seconds <= PROFILE_MAX_SECONDS:
            return web.json_response(
                {"message": f"seconds must be in (0, "
                            f"{PROFILE_MAX_SECONDS:g}]"}, status=400)
        try:
            detail = await profile(seconds)
        except PermissionError as e:
            return web.json_response({"message": str(e)}, status=403)
        except RuntimeError as e:
            return web.json_response({"message": str(e)}, status=409)
        except Exception as e:  # profiling must never kill the app
            return web.json_response(
                {"message": f"{type(e).__name__}: {e}"}, status=500)
        return web.json_response({"status": "ok", **(detail or {})})

    def debug_snapshot(provider):
        async def handler(_request):
            try:
                payload = provider() or {}
            except Exception as e:  # a broken ledger must not kill the app
                return web.json_response(
                    {"message": f"{type(e).__name__}: {e}"}, status=500)
            return web.json_response(payload)
        return handler

    app = web.Application()
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/healthz", healthz)
    if profile is not None:
        app.router.add_post("/debug/profile", debug_profile)
    if programs is not None:
        app.router.add_get("/debug/programs", debug_snapshot(programs))
    if memory is not None:
        app.router.add_get("/debug/memory", debug_snapshot(memory))
    return app


async def start_metrics_server(port: int, registry: Registry | None = None,
                               health=None, host: str = "127.0.0.1",
                               profile=None, token: str = "",
                               programs=None, memory=None):
    """Bind the telemetry app; returns the AppRunner (caller cleans up) or
    None when port is falsy (CHIASWARM_METRICS_PORT=0 opt-out)."""
    if not port:
        return None
    from aiohttp import web

    runner = web.AppRunner(
        build_metrics_app(registry, health, profile, token,
                          programs=programs, memory=memory))
    await runner.setup()
    await web.TCPSite(runner, host, int(port)).start()
    return runner
