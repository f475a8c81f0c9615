"""The port's worker plane on the CPU, held against the JAX package and its
jax-free tools (no JAX jit compile: every module here is host code).

- telemetry: `Registry.render()` is byte-identical to
  `chiaswarm_tpu.telemetry.Registry`'s for the same operations; a served
  worker's `/metrics` and `/healthz` are read by `tools/metrics_dump.py`
  `parse_metrics` and `tools/swarm_top.py` `render_worker`, and its
  `/debug/programs` and `/debug/memory` answer.
- the outbox: a port-spooled envelope is recovered equal by
  `chiaswarm_tpu.outbox.Outbox.recover()`, and the reverse;
  `tools/outbox_inspect.py --json` lists port entries, parked ones with
  their reason.
- every fault point of the port's worker, through the port's fake hive:
  `drop_submit`, a dropped connection before the ACK, the 4xx park, the
  disposition ACKs, `kill_before_ack` and redelivery by a new worker,
  `hang_denoise` and the watchdog's quarantine and probe, the drain (by
  `stop(drain=True)` and by SIGTERM), `oom_batched`,
  `hang_after_checkpoint`; and the profile capture's gating (401, 403,
  409). No envelope is dropped: each is delivered, parked, or spooled for
  the next start.
- settings, log format and the fake hive's duplicate count.
"""

import asyncio
import json
import logging
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from chiaswarm_tpu_torch import faults, log_setup, memory_census, telemetry
from chiaswarm_tpu_torch import outbox as outbox_mod
from chiaswarm_tpu_torch import programs as programs_mod
from chiaswarm_tpu_torch import settings as settings_mod
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.settings import Settings

REPO = Path(__file__).resolve().parents[1]
TOKEN = "plane-token"


@pytest.fixture(autouse=True)
def clean_faults(monkeypatch):
    faults.configure("")
    # short retry delays: the backoff's shape is tested on its own
    monkeypatch.setattr(outbox_mod, "BACKOFF_BASE_S", 0.01)
    monkeypatch.setattr(outbox_mod, "BACKOFF_CAP_S", 0.05)
    yield
    faults.configure("")


@pytest.fixture
def root(tmp_path, monkeypatch):
    """An isolated $SDAAS_ROOT: the outbox and the profiles land here."""
    path = tmp_path / "sdaas"
    monkeypatch.setenv("SDAAS_ROOT", str(path))
    return path


@pytest.fixture
def hive():
    h = FakeHive(token=TOKEN)
    yield h
    h.close()


def _tools():
    sys.path.insert(0, str(REPO / "tools"))
    import metrics_dump
    import swarm_top

    return metrics_dump, swarm_top


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _settings(hive, **overrides) -> Settings:
    fields = dict(sdaas_token=TOKEN, sdaas_uri=hive.uri, worker_name="plane-worker",
                  metrics_port=0, max_coalesce=1)
    fields.update(overrides)
    return Settings(**fields)


def _worker(hive, **overrides) -> worker_mod.Worker:
    from chiaswarm_tpu_torch.registry import Registry

    registry = Registry(torch.device("cpu"), safety_checker_model="")
    return worker_mod.Worker(settings=_settings(hive, **overrides), device="cpu",
                             registry=registry, poll_seconds=0.01, heartbeat_seconds=0.01)


def _echo(job_id: str, **extra) -> dict:
    return {"id": job_id, "workflow": "echo", "model_name": "none", "prompt": job_id, **extra}


def _tiny(job_id: str, seed: int = 3, steps: int = 2, **extra) -> dict:
    return {"id": job_id, "workflow": "txt2img",
            "model_name": "stabilityai/stable-diffusion-xl-base-1.0", "prompt": "a cat",
            "height": 64, "width": 64, "num_inference_steps": steps, "seed": seed,
            "content_type": "image/png", "parameters": {"test_tiny_model": True}, **extra}


def _run(worker, max_jobs=None, side=None, timeout=120.0):
    """Run the worker on this thread's loop; `side(worker)` runs in a thread
    beside it (it may scrape, wait, stop). -> what `side` returned."""
    out = {}

    async def main():
        loop = asyncio.get_running_loop()
        runner = asyncio.ensure_future(worker.run(max_jobs=max_jobs))
        if side is not None:
            out["side"] = await loop.run_in_executor(None, side, worker)
        await asyncio.wait_for(runner, timeout)

    asyncio.run(asyncio.wait_for(main(), timeout + 30))
    return out.get("side")


def _until(cond, timeout=30.0, step=0.01):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError("condition not met")
        time.sleep(step)


def _get(url: str, token: str | None = None, method: str = "GET"):
    req = urllib.request.Request(url, method=method, data=b"" if method == "POST" else None)
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _spool(root) -> list[str]:
    box = root / "outbox"
    return sorted(p.name for p in box.iterdir() if p.name.endswith((".json", ".parked")))


# --- telemetry ---------------------------------------------------------------


def _drive(tm):
    """The same operations on either package's telemetry module -> render()."""
    reg = tm.Registry()
    c = reg.counter("swarm_test_total", "A counter\nwith a newline", ("kind", "slot"))
    c.inc(kind="a", slot=1)
    c.inc(2.5, kind='q"uote\\d\nnl', slot="x")
    reg.counter("swarm_plain_total").inc(3)
    g = reg.gauge("swarm_test_gauge", "A gauge", ("model",))
    g.set(0.1234, model="m1")
    g.set(float("inf"), model="m2")
    g.set(-2.0, model="m3")
    g.inc(1e16, model="m4")
    g.dec(0.5, model="m1")
    g.set(7, model="gone")
    g.remove(model="gone")
    h = reg.histogram("swarm_test_seconds", "A histogram", ("stage",))
    for v in (0.001, 0.005, 0.3, 2.0, 500.0, 0.0):
        h.observe(v, stage="denoise")
    h.observe(1.5, stage="submit")
    reg.histogram("swarm_rows", "Rows", buckets=(1, 2, 4, 8)).observe(3)
    reg.gauge("swarm_empty_gauge", "never set")
    return reg.render()


def test_registry_render_is_byte_identical_to_jax():
    from chiaswarm_tpu import telemetry as jax_telemetry

    ours = _drive(telemetry)
    assert ours == _drive(jax_telemetry)
    assert 'le="+Inf"' in ours and "swarm_test_gauge{model=\"m2\"} +Inf" in ours
    with pytest.raises(ValueError):
        telemetry.Registry().counter("x").inc(-1)


def test_served_worker_is_read_by_metrics_dump_and_swarm_top(hive, root):
    # the pass ledger is process-wide: another test's tiny-xl pass would
    # add a second entry for the model
    programs_mod.reset()
    metrics_dump, swarm_top = _tools()
    port = _free_port()
    worker = _worker(hive, metrics_port=port)
    hive.enqueue(_echo("plane-echo"), _tiny("plane-tti"))
    base = f"http://127.0.0.1:{port}"

    def side(w):
        hive.wait_for_results(2, timeout=120)
        _until(lambda: w.outbox.depth == 0)
        status, body = _get(f"{base}/metrics")
        assert status == 200
        health_status, health = _get(f"{base}/healthz")
        programs = json.loads(_get(f"{base}/debug/programs")[1])
        memory = json.loads(_get(f"{base}/debug/memory")[1])
        w.stop()
        return body.decode(), health_status, json.loads(health), programs, memory

    text, health_status, health, programs, memory = _run(worker, side=side)
    samples = metrics_dump.parse_metrics(text)
    names = {name for name, _, _ in samples}
    for name in ("swarm_jobs_completed_total", "swarm_jobs_polled_total",
                 "swarm_outbox_delivered_total", "swarm_pass_flops_total",
                 "swarm_batch_flush_total", "swarm_job_stage_seconds_bucket",
                 "swarm_embed_cache_total", "swarm_last_poll_unixtime"):
        assert name in names, name
    stages = {row["stage"] for row in metrics_dump.stage_rows(samples)}
    assert {"queue_wait", "submit", "text_encode", "denoise"} <= stages
    assert health_status == 200 and health["status"] == "ok"
    assert health["outbox"]["depth"] == 0 and health["slices"][0]["state"] == "active"
    snap = swarm_top.Snapshot(base, samples, health)
    frame = "\n".join(swarm_top.render_worker(snap, None))
    assert "status=ok" in frame and "outbox=0" in frame
    assert "cost" in frame and "stages" in frame
    assert metrics_dump.cost_line(samples).startswith("cost")
    [entry] = [p for p in programs["programs"] if p["model"] == "test/tiny-xl"]
    assert entry["calls"] >= 1 and abs(entry["divergence"] - 1.0) < 0.01
    stores = memory["stores"]
    assert {"embed_cache", "lora_factor_cache", "lora_operand_cache", "outbox",
            "program_ledger"} <= set(stores)
    assert memory["total_bytes"] == sum(s["bytes"] for s in stores.values())
    assert "devices" not in memory  # the CPU reports no device


def test_stop_before_any_job_returns_and_releases_the_port(hive, root):
    port = _free_port()
    worker = _worker(hive, metrics_port=port)

    def side(w):
        _until(lambda: hive.polls)
        status, _ = _get(f"http://127.0.0.1:{port}/healthz")
        w.stop()
        return status

    assert _run(worker, side=side) == 200
    with socket.socket() as s:  # the app is gone with the run
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))


def test_metrics_port_in_use_is_not_fatal(hive, root, caplog):
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        worker = _worker(hive, metrics_port=busy.getsockname()[1])
        hive.enqueue(_echo("busy-port"))
        with caplog.at_level(logging.WARNING):
            _run(worker, max_jobs=1)
    assert [r["id"] for r in hive.results] == ["busy-port"]
    assert "metrics server unavailable" in caplog.text


# --- the outbox against the JAX package's ------------------------------------


def test_outbox_files_are_read_both_ways(tmp_path):
    from chiaswarm_tpu import outbox as jax_outbox

    envelope = {"id": "both/ways 1", "artifacts": {"primary": {"blob": "aGk=",
                                                             "sha256_hash": "x"}},
                "pipeline_config": {"timings": {"job_s": 1.5}, "seed": 7}, "nsfw": False}
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    ours = outbox_mod.Outbox(port_dir)
    entry = ours.spool(dict(envelope, id="port-a"))
    parked = ours.spool(dict(envelope, id="port-b"))
    parked.retries = 3
    ours.park(parked, "HTTP 422 refused")
    # <time_ns, 20 digits>-<seq, 4 digits>-<job id>.json, as the JAX spool names them
    assert re.fullmatch(r"\d{20}-\d{4}-port-a\.json", entry.path.name)
    read = jax_outbox.Outbox(port_dir).recover()
    assert [(e.job_id, e.result, e.parked, e.retries) for e in read] == [
        ("port-a", dict(envelope, id="port-a"), False, 0),
        ("port-b", dict(envelope, id="port-b"), True, 3)]
    theirs = jax_outbox.Outbox(jax_dir)
    theirs.spool(envelope)
    back = outbox_mod.Outbox(jax_dir).recover()
    assert [(e.job_id, e.result) for e in back] == [("both/ways 1", envelope)]
    assert back[0].path.name.endswith("-both_ways_1.json")

    proc = subprocess.run([sys.executable, str(REPO / "tools" / "outbox_inspect.py"), "--json",
                           "--dir", str(port_dir)], capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = {r["job_id"]: r for r in json.loads(proc.stdout)["entries"]}
    assert rows["port-a"]["state"] == "spooled" and rows["port-a"]["park_reason"] is None
    assert rows["port-b"]["state"] == "parked" and rows["port-b"]["retries"] == 3
    assert rows["port-b"]["park_reason"] == "HTTP 422 refused"


def test_backoff_delay_is_capped_with_jitter_as_in_jax():
    from chiaswarm_tpu import outbox as jax_outbox

    for retries in range(8):
        ceiling = min(30.0, 0.5 * 2 ** max(retries - 1, 0))
        for _ in range(20):
            d = outbox_mod.backoff_delay(retries, base=0.5, cap=30.0)
            assert ceiling / 2 <= d <= ceiling
    assert (jax_outbox.BACKOFF_BASE_S, jax_outbox.BACKOFF_CAP_S) == (0.5, 30.0)


def test_a_live_worker_keeps_its_spool_from_another(tmp_path):
    first, second = outbox_mod.Outbox(tmp_path), outbox_mod.Outbox(tmp_path)
    assert first.claim()
    first.share()
    assert not second.claim()  # shared with a live worker: recover nothing
    first.release()
    second.release()
    assert second.claim()
    second.release()


# --- the fault points through the fake hive ----------------------------------


def test_drop_submit_is_delivered_after_two_retries(hive, root):
    faults.configure("drop_submit=2")
    retries = telemetry.REGISTRY.get("swarm_outbox_retries_total").value()
    worker = _worker(hive)
    hive.enqueue(_echo("dropped-twice"))
    _run(worker, max_jobs=1)
    assert [r["id"] for r in hive.results] == ["dropped-twice"]
    assert faults.get_plan().fired("drop_submit") == 2
    assert telemetry.REGISTRY.get("swarm_outbox_retries_total").value() == retries + 2
    assert _spool(root) == [] and hive.duplicates == 0


def test_connection_dropped_before_the_ack_is_retried(hive, root):
    hive.drop_results_times = 2
    worker = _worker(hive)
    hive.enqueue(_echo("severed"))
    _run(worker, max_jobs=1)
    assert [r["id"] for r in hive.results] == ["severed"]
    assert hive.result_attempts == 3 and hive.duplicates == 0 and _spool(root) == []


def test_permanent_refusal_is_parked_on_disk(hive, root):
    hive.refuse("refused", 422)
    parked = telemetry.REGISTRY.get("swarm_outbox_parked_total").value()
    worker = _worker(hive)
    hive.enqueue(_echo("refused"), _echo("accepted"))
    _run(worker, max_jobs=2)
    assert [r["id"] for r in hive.results] == ["accepted"]
    [name] = _spool(root)
    assert name.endswith("-refused.json.parked")
    payload = json.loads((root / "outbox" / name).read_text())
    assert "HTTP 422" in payload["park_reason"] and payload["result"]["id"] == "refused"
    assert telemetry.REGISTRY.get("swarm_outbox_parked_total").value() == parked + 1
    assert worker.health()["outbox"]["depth"] == 1


@pytest.mark.parametrize("disposition,reason", [("cancelled", "cancelled:"),
                                                ("expired", "expired:"),
                                                ("unknown_job", "gone:")])
def test_disposition_acks_park_the_envelope(hive, root, disposition, reason):
    hive.dispose("disposed", disposition)
    worker = _worker(hive)
    hive.enqueue(_echo("disposed"))
    _run(worker, max_jobs=1)
    assert not hive.results and [r["id"] for r in hive.disposed] == ["disposed"]
    [name] = _spool(root)
    payload = json.loads((root / "outbox" / name).read_text())
    assert name.endswith(".json.parked") and payload["park_reason"].startswith(reason)


def test_kill_before_ack_is_redelivered_by_the_next_worker(hive, root):
    faults.configure("kill_before_ack=1")
    first = _worker(hive)
    hive.enqueue(_echo("crash-after-ack"))
    _run(first, max_jobs=1)
    # the simulated crash came after the ACK and before the unlink
    assert first.crashed and len(hive.results) == 1 and len(_spool(root)) == 1
    faults.configure("")
    second = _worker(hive)
    recovered = telemetry.REGISTRY.get("swarm_outbox_recovered_total").value()
    _run(second, side=lambda w: (_until(lambda: len(hive.results) == 2),
                                 _until(lambda: w.outbox.depth == 0), w.stop()))
    bodies = hive.bodies["crash-after-ack"]
    assert len(bodies) == 2 and bodies[0] == bodies[1] and hive.duplicates == 1
    assert telemetry.REGISTRY.get("swarm_outbox_recovered_total").value() == recovered + 1
    assert _spool(root) == [] and not second.crashed


def test_watchdog_quarantines_and_the_probe_returns_the_device(hive, root):
    faults.configure("hang_denoise=1", hang_timeout_s=60.0)
    expired = telemetry.REGISTRY.get("swarm_watchdog_expired_total").value(kind="solo")
    port = _free_port()
    # the deadline also holds the job after the hang: room for a loaded box
    worker = _worker(hive, metrics_port=port, job_deadline_s=2.0,
                     job_deadline_compile_scale=1.0, quarantine_probe_grace_s=30.0)
    hive.enqueue(_echo("hung"))

    def side(w):
        hive.wait_for_results(1, timeout=60)
        status, body = _get(f"http://127.0.0.1:{port}/healthz")
        health = json.loads(body)
        # the hung pass still holds the device: no job is taken meanwhile
        hive.enqueue(_echo("after-hang"))
        time.sleep(0.3)
        held = len(hive.results)
        faults.get_plan().release_hangs()
        hive.wait_for_results(2, timeout=60)
        return status, health, held

    status, health, held = _run(worker, max_jobs=2, side=side)
    hung = hive.results[0]
    assert hung["id"] == "hung" and not hung.get("fatal_error")
    assert "watchdog" in hung["pipeline_config"]["error"]
    assert status == 503 and health["status"] == "degraded"
    assert "1 slice(s) quarantined" in health["degraded_reasons"]
    assert health["slices"][0]["state"] == "quarantined" and held == 1
    assert [r["id"] for r in hive.results] == ["hung", "after-hang"]
    assert worker.last_probe["outcome"] == "ok" and worker.last_probe["device"] == "cpu"
    assert telemetry.REGISTRY.get("swarm_watchdog_expired_total").value(kind="solo") == (
        expired + 1)
    assert worker.health()["status"] == "ok"


def test_deadline_is_scaled_for_a_cold_model_and_capped_by_the_job(hive, root):
    worker = _worker(hive, job_deadline_s=10.0, job_deadline_compile_scale=4.0)
    assert worker.pass_deadline([_tiny("a")]) == 40.0  # the model is not resident
    assert worker.pass_deadline([_tiny("a"), _tiny("b")]) == 80.0
    assert worker.pass_deadline([_tiny("a", deadline_s=5)]) == 5.0
    # a group is capped only when every member has a deadline, by the loosest
    assert worker.pass_deadline([_tiny("a", deadline_s=5), _tiny("b")]) == 80.0
    assert worker.pass_deadline([_tiny("a", deadline_s=5), _tiny("b", deadline_s=9)]) == 9.0
    assert worker.pass_deadline([_tiny("a", deadline_s="soon")]) == 40.0
    off = _worker(hive, job_deadline_s=0.0)
    assert off.pass_deadline([_tiny("a")]) is None
    assert off.pass_deadline([_tiny("a", deadline_s=2)]) == 2.0


def test_drain_finishes_the_pass_in_flight_and_flushes(hive, root):
    faults.configure("hang_denoise=1", hang_timeout_s=60.0)
    worker = _worker(hive, job_deadline_s=0.0, drain_deadline_s=30.0)
    hive.enqueue(_echo("in-flight"))

    def side(w):
        plan = faults.get_plan()
        _until(lambda: plan.hanging == 1)
        w.stop(drain=True)
        time.sleep(0.3)
        # draining, not dead: nothing delivered, nothing new polled
        draining = w.health()["draining"]
        polls = len(hive.polls)
        hive.enqueue(_echo("never-taken"))
        time.sleep(0.2)
        plan.release_hangs()
        return draining, polls, list(hive.results)

    draining, polls, before = _run(worker, side=side)
    assert draining and before == []
    assert [r["id"] for r in hive.results] == ["in-flight"]
    assert len(hive.polls) == polls and hive.jobs[0]["id"] == "never-taken"
    assert _spool(root) == []


def test_sigterm_drains(hive, root):
    worker = _worker(hive, job_deadline_s=0.0)
    faults.configure("hang_denoise=1", hang_timeout_s=60.0)
    hive.enqueue(_echo("sigterm"))

    def side(w):
        _until(lambda: faults.get_plan().hanging == 1)
        handler = signal.getsignal(signal.SIGTERM)
        # the worker's loop handles SIGTERM (never the default, which kills)
        assert handler not in (signal.SIG_DFL, signal.SIG_IGN, None)
        os.kill(os.getpid(), signal.SIGTERM)
        _until(lambda: w.health()["draining"])
        faults.get_plan().release_hangs()

    before = signal.getsignal(signal.SIGTERM)
    _run(worker, side=side)
    assert [r["id"] for r in hive.results] == ["sigterm"] and _spool(root) == []
    # the handler the process had before the run is back
    assert signal.getsignal(signal.SIGTERM) == before


def test_oom_in_a_coalesced_pass_serves_each_member_alone(hive, root):
    faults.configure("oom_batched=1")
    worker = _worker(hive, max_coalesce=4, batch_linger_ms=500.0)
    hive.enqueue(_tiny("oom-a", seed=1), _tiny("oom-b", seed=2))
    _run(worker, max_jobs=2)
    assert faults.get_plan().fired("oom_batched") == 1
    results = {r["id"]: r for r in hive.results}
    assert set(results) == {"oom-a", "oom-b"}
    for r in results.values():
        cfg = r["pipeline_config"]
        assert "batched_with" not in cfg and "error" not in cfg and not r.get("fatal_error")


def test_hang_after_checkpoint_blocks_past_a_shipped_checkpoint(hive, root):
    faults.configure("hang_after_checkpoint=1", hang_timeout_s=0.5)
    worker = _worker(hive, denoise_chunk_steps=1, checkpoint_every_chunks=1)
    hive.enqueue(_tiny("ckpt-hang", steps=3))
    _run(worker, max_jobs=1)
    plan = faults.get_plan()
    assert plan.fired("hang_after_checkpoint") == 1
    assert [p["kind"] for p in hive.partials] == ["checkpoint", "checkpoint"]
    assert [r["id"] for r in hive.results] == ["ckpt-hang"]
    shipped = telemetry.REGISTRY.get("swarm_checkpoints_total").value(outcome="shipped")
    assert shipped >= 2


def test_profile_capture_gating(hive, root):
    port = _free_port()
    url = f"http://127.0.0.1:{port}/debug/profile"
    worker = _worker(hive, metrics_port=port, profiler_capture=True)
    closed = _worker(hive, metrics_port=_free_port(), profiler_capture=False)

    def side(w):
        _until(lambda: hive.polls)
        out = {"anonymous": _get(f"{url}?seconds=0.2", method="POST")[0],
               "wrong": _get(f"{url}?seconds=0.2", token="nope", method="POST")[0],
               "bad": _get(f"{url}?seconds=-1", token=TOKEN, method="POST")[0]}
        first = {}
        t = threading.Thread(target=lambda: first.update(
            r=_get(f"{url}?seconds=1.0", token=TOKEN, method="POST")))
        t.start()
        _until(lambda: w._profiling)
        out["concurrent"] = _get(f"{url}?seconds=0.2", token=TOKEN, method="POST")[0]
        t.join()
        out["first"] = first["r"]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out["beside_another"] = _get(f"{url}?seconds=0.2", token=TOKEN, method="POST")[0]
        w.stop()
        return out

    out = _run(worker, side=side)
    assert (out["anonymous"], out["wrong"], out["bad"]) == (401, 401, 400)
    assert out["concurrent"] == 409 and out["beside_another"] == 409
    status, body = out["first"]
    detail = json.loads(body)
    assert status == 200 and detail["status"] == "ok" and detail["activities"] == ["CPU"]
    path = Path(detail["path"])
    assert path.parent == root / "profiles" and "traceEvents" in json.loads(path.read_text())

    polled = len(hive.polls)

    def unarmed(w):
        # this worker's first poll: its metrics app is up by then
        _until(lambda: len(hive.polls) > polled)
        status = _get(f"http://127.0.0.1:{w.settings.metrics_port}/debug/profile?seconds=0.2",
                      token=TOKEN, method="POST")[0]
        w.stop()
        return status

    assert _run(closed, side=unarmed) == 403


# --- settings, logs, the fake hive --------------------------------------------


PLANE_KNOBS = ("profiler_capture", "metrics_port", "metrics_host", "log_format",
               "job_deadline_s", "job_deadline_compile_scale", "quarantine_probe_grace_s",
               "drain_deadline_s", "outbox_dir", "outbox_max_entries", "fault_injection",
               "memory_headroom_degraded")


def test_plane_settings_match_jax_names_defaults_and_variables(monkeypatch, root):
    from chiaswarm_tpu import settings as jax_settings

    ours, theirs = Settings(), jax_settings.Settings()
    for knob in PLANE_KNOBS:
        assert getattr(ours, knob) == getattr(theirs, knob), knob
    ours_env = {v: k for k, v in settings_mod._ENV_OVERRIDES.items()}
    theirs_env = {v: k for k, v in jax_settings._ENV_OVERRIDES.items()}
    assert {k: ours_env[k] for k in PLANE_KNOBS} == {k: theirs_env[k] for k in PLANE_KNOBS}
    monkeypatch.setenv("CHIASWARM_PROFILER_CAPTURE", "0")
    monkeypatch.setenv("CHIASWARM_METRICS_PORT", "0")
    monkeypatch.setenv("CHIASWARM_FAULTS", "drop_submit=1")
    loaded = settings_mod.load_settings()
    assert loaded.profiler_capture is False and loaded.metrics_port == 0
    assert loaded.fault_injection == "drop_submit=1"
    monkeypatch.setenv("CHIASWARM_PROFILER_CAPTURE", "true")
    assert settings_mod.load_settings().profiler_capture is True


def test_json_log_lines_carry_the_job_id():
    record = logging.LogRecord("chiaswarm_tpu_torch.worker", logging.INFO, __file__, 1,
                               "served %s", ("x",), None)
    formatter = log_setup.JsonFormatter()
    assert "job_id" not in json.loads(formatter.format(record))
    with telemetry.trace_job("job-42"):
        line = json.loads(formatter.format(record))
    assert line["job_id"] == "job-42" and line["message"] == "served x"
    assert isinstance(log_setup.formatter("plain"), logging.Formatter)
    assert isinstance(log_setup.formatter("json"), log_setup.JsonFormatter)


def test_fault_plan_parses_and_counts_as_jax():
    from chiaswarm_tpu.faults import FaultPlan as JaxPlan

    spec = "drop_submit=2, hang_denoise=1;hang_timeout=0.01,bogus=x"
    ours, theirs = faults.FaultPlan(spec), JaxPlan(spec)
    for plan in (ours, theirs):
        assert plan.hang_timeout_s == 0.01 and plan.active("drop_submit")
        with pytest.raises(faults.FaultInjected if plan is ours else Exception):
            plan.fire("drop_submit")
        plan.hang("hang_denoise")
        assert plan.fired("hang_denoise") == 1 and not plan.active("hang_denoise")
        assert not plan.active("bogus")


def test_memory_census_of_the_worker_stores(hive, root):
    worker = _worker(hive)
    worker.outbox.spool({"id": "census", "artifacts": {}})
    census = memory_census.census()
    assert census["stores"]["outbox"]["entries"] == 1
    assert census["total_bytes"] == sum(s["bytes"] for s in census["stores"].values())
    assert memory_census.device_headroom() is None
    exposition = telemetry.REGISTRY.render()
    assert 'swarm_memory_store_bytes{store="outbox"}' in exposition


def test_chip_smoke_worker_plane_path_rehearses_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's worker-plane path at a tiny size on the CPU, with a
    peak of 1 TFLOP/s given by BENCH_PEAK_TFLOPS (the CPU has none): every
    envelope, MFU, divergence, fault, drain and profile check runs;
    launches are printed, not held."""
    import importlib.util

    from chiaswarm_tpu_torch.registry import Registry

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "1.0")
    registries = [Registry(torch.device("cpu"), str(tmp_path / "models"), safety_checker_model="")
                  for _ in range(2)]
    paths, served = smoke.serve_worker_plane_path(
        "cpu", *registries, {"flash_attention": 0, "group_norm": 0}, device="cpu",
        sdxl="test/tiny-xl", sd15="test/tiny-sd", size_xl=64, size15=64, steps=3,
        profile_s=0.2, peak=1.0, hang_deadline_s=5.0, hold=False)
    assert set(paths) == {"plane_sdxl", "plane_sd15"}
    for kind in paths:
        job = served["jobs"][kind]
        assert 0 < job["cost"]["mfu"] <= 1 and abs(job["divergence"] - 1) < 0.05
    assert served["watchdog"]["probe"]["outcome"] == "ok" and served["drain_s"] > 0
    assert len(served["spool_ms"]) == 5 and served["profile"]["bytes"] > 0
