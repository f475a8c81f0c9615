"""chiaswarm_tpu_torch among several hives, gangs, adapter prescans and
stage graphs, on the CPU, held against the JAX package.

- The 409 fault: a hive that answers /results with 409 "not primary",
  a standby configured. Before the repair the port's client classed every
  4xx as permanent and the outbox parked the finished envelope; now it is
  delivered on the standby and nothing is parked. A real refusal (422)
  still parks.
- Parity with JAX's jax-free functions on the same inputs: `hive_endpoints`,
  the persisted epoch read both ways, `_next_backoff` (equal draws under
  one random seed, and its bounds), `stage_of` and the coalesce key's stage
  element, `_stage_roles`, the `stats` EWMA fold, `put_gang`'s chunks and
  flush reasons, `pack_raw` / `unpack_raw` both ways and `encode_callback`
  (equal bytes), `prescan_adapter_chunks`' verdicts. The failover state
  under threads: one failover for one outage.
- Through the repo's own hive (`HiveServer`, in process): a gang reply is
  one pass whose envelopes echo the trace the hive's timeline reads; a
  workflow posted to /api/workflows is served stage by stage (encode and
  decode on the stage lane) to `done`, its final artifact's sha256 the
  monolithic job's (same seed; the tiny checker on both paths).
- Failover against JAX's test hive double (tests/fake_hive.py): a 409 on
  /work moves the pin within the poll, transport errors move it after
  `hive_failover_errors`, the epoch is echoed and persisted.
- The prescan: nine jobs with nine distinct adapters split over two passes
  (the second over the slots cap) are refused before any UNet call, then
  served member by member.

No JAX model compiles; one module-scoped tiny port pipeline (test/tiny-sd,
f32 on the CPU) serves every job. Images are compared bit for bit (the
same program on the same inputs).
"""

import asyncio
import base64
import json
import random
import sys
import threading
import types

import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu_torch import batching, coalesce, hive, telemetry
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
from chiaswarm_tpu_torch.registry import Registry
from chiaswarm_tpu_torch.settings import Settings
from chiaswarm_tpu_torch.workflows import stages

MODEL = "test/tiny-sd"
TOKEN = "tok"


@pytest.fixture(scope="module")
def tiny_sd():
    return SDPipeline(MODEL, device="cpu")


def _registry(pipe, checker: str = "") -> Registry:
    registry = Registry(torch.device("cpu"), safety_checker_model=checker)
    registry._pipelines[(MODEL, "sd")] = pipe
    return registry


def _txt(job_id: str, seed: int = 11, steps: int = 3, **extra) -> dict:
    return {"id": job_id, "workflow": "txt2img", "model_name": MODEL,
            "prompt": f"a lighthouse, {job_id}", "height": 64, "width": 64, "seed": seed,
            "num_inference_steps": steps, "content_type": "image/png",
            "parameters": {"scheduler_type": "DPMSolverMultistepScheduler"}, **extra}


def _echo(job_id: str) -> dict:
    return {"id": job_id, "workflow": "echo", "model_name": "none", "prompt": job_id}


def _spool(root) -> list[str]:
    box = root / "outbox"
    return sorted(p.name for p in box.iterdir()) if box.is_dir() else []


# --- section 0: the 409 that parked a finished envelope ---

@pytest.mark.parametrize("status", [409, 422])
def test_not_primary_result_is_delivered_on_the_standby(status, sdaas_root):
    """A 409 "not primary" on /results delivers the envelope on the next
    endpoint, with the epoch echoed and persisted, and parks nothing (the
    parent tree parked it: the port's client took every 4xx as
    permanent); a 422 is a real refusal and still parks."""
    primary, standby = FakeHive(token=TOKEN), FakeHive(token=TOKEN)
    try:
        if status == 409:
            primary.not_primary(epoch=2, endpoints=("results",))
        else:
            primary.refuse("j409", status)
        settings = Settings(sdaas_token=TOKEN, sdaas_uri=primary.uri, worker_name="w409",
                            metrics_port=0)
        settings.sdaas_uris = f"{primary.uri},{standby.uri}"
        worker = worker_mod.Worker(settings=settings, device="cpu",
                                   registry=_registry(None), poll_seconds=0.01)
        primary.enqueue(_echo("j409"))
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=1), timeout=60))
    finally:
        primary.close()
        standby.close()
    parked = [name for name in _spool(sdaas_root) if name.endswith(".parked")]
    if status == 409:
        assert [r["id"] for r in standby.results] == ["j409"] and not primary.results
        assert not parked
        assert ("/api/results", "2") in standby.epochs_seen
        assert (sdaas_root / "hive_epoch").read_text() == "2"
        assert worker.hive.failovers == 1 and worker.hive.hive_uri == f"{standby.uri}/api"
    else:
        assert len(parked) == 1 and not standby.results and worker.hive.failovers == 0


# --- parity with the JAX package's jax-free functions ---

@pytest.mark.parametrize("uris", [
    "", "http://a:1", "http://a:1/api", "http://a:1/,http://b:2/api/",
    " http://a:1 ; http://b:2 ,, ", "https://h.example/api;https://s.example",
])
def test_hive_endpoints_match_jax(uris):
    from chiaswarm_tpu.hive import hive_endpoints as jax_endpoints

    settings = types.SimpleNamespace(sdaas_uris=uris, sdaas_uri="http://single:9511/")
    assert hive.hive_endpoints(settings) == jax_endpoints(settings)
    port_settings = Settings(sdaas_uri="http://single:9511/")
    port_settings.sdaas_uris = uris
    client = hive.HiveClient(port_settings)
    assert client.endpoints == jax_endpoints(settings) and client.hive_uri == client.endpoints[0]


@pytest.mark.parametrize("epoch", [1, 7, 123456])
def test_epoch_file_reads_across_packages(epoch, sdaas_root):
    from chiaswarm_tpu import hive as jax_hive

    jax_hive._persist_epoch(epoch)
    assert hive.load_epoch() == epoch
    # a restarted port client fences with it
    client = hive.HiveClient(Settings(sdaas_uri="http://h:1"))
    assert client.epoch == epoch and client._headers()["X-Hive-Epoch"] == str(epoch)
    hive.persist_epoch(epoch + 1)
    assert jax_hive._load_persisted_epoch() == epoch + 1
    (sdaas_root / hive.EPOCH_FILENAME).write_text("garbage")
    assert hive.load_epoch() == jax_hive._load_persisted_epoch() == 0


@pytest.mark.parametrize("prev", [0.0, 5.0, 11.0, 20.0, 50.0, 121.0, 500.0])
def test_next_backoff_matches_jax(prev):
    from chiaswarm_tpu.worker import _next_backoff as jax_backoff

    for seed in range(20):
        random.seed(seed)
        want = jax_backoff(prev)
        random.seed(seed)
        got = worker_mod._next_backoff(prev)
        assert got == want
        assert worker_mod.POLL_SECONDS <= got <= worker_mod.ERROR_BACKOFF_SECONDS
        assert got <= max(prev, worker_mod.POLL_SECONDS) * 3
    # the smoke's small cap
    assert 0.05 <= worker_mod._next_backoff(prev, 0.05, 0.2) <= 0.2


STAGE_JOBS = {
    "monolithic": _txt("m"),
    "denoise": {**_txt("d"), "stage": {"name": "denoise", "handoff": "raw"}},
    "denoise-other": {**_txt("d2", seed=4), "stage": {"name": "denoise", "index": 1}},
    "encode": {**_txt("e"), "stage": {"name": "encode"}},
    "decode": {**_txt("x"), "stage": {"name": "decode"}},
    "upscale": {**_txt("u"), "stage": {"name": "upscale"}},
    "no-name": {**_txt("n"), "stage": {"workflow": "w"}},
    "not-a-dict": {**_txt("s"), "stage": "denoise"},
}


@pytest.mark.parametrize("name", sorted(STAGE_JOBS))
def test_stage_of_and_the_key_match_jax(name, sdaas_root):
    from chiaswarm_tpu import coalesce as jax_coalesce

    job = STAGE_JOBS[name]
    assert coalesce.stage_of(job) == jax_coalesce.stage_of(job)
    assert coalesce.coalesce_key(dict(job)) == jax_coalesce.coalesce_key(dict(job))
    assert coalesce.CHIP_STAGES == jax_coalesce.CHIP_STAGES
    assert coalesce.CPU_STAGES == jax_coalesce.CPU_STAGES


def test_denoise_stages_coalesce_only_with_each_other():
    keys = {name: coalesce.coalesce_key(job) for name, job in STAGE_JOBS.items()}
    assert keys["denoise"] == keys["denoise-other"] is not None
    assert keys["denoise"] != keys["monolithic"] and keys["monolithic"] is not None
    assert all(keys[n] is None for n in ("encode", "decode", "upscale"))


@pytest.mark.parametrize("roles,lane", [
    ("auto", 2), ("auto", 0), ("encode,denoise , decode", 2), ("encode,denoise,decode", 0),
    ("none", 2), ("NONE", 0), ("", 1), ("denoise", 1),
])
def test_stage_roles_match_jax(roles, lane):
    from chiaswarm_tpu.worker import Worker as JaxWorker

    stub = types.SimpleNamespace(settings=types.SimpleNamespace(stage_roles=roles,
                                                                stage_workers=lane))
    assert worker_mod.Worker._stage_roles(stub) == JaxWorker._stage_roles(stub)


TIMINGS = [
    {"job_s": 1.5, "pass_s": 1.7, "queue_wait_s": 9.0, "encode_s": 0.01},
    {"job_s": 1.1, "text_encode_s": 0.2, "handoff_s": 0.3, "steps": 30, "flag_s": True},
    {"job_s": "2.5", "bad_s": "x", "neg_s": -1.0, "pass_s": 2.0},
    {"job_s": 0.9, "decode_s": 0.4},
]


@pytest.mark.parametrize("alpha", [0.2, 0.5, 1.0])
def test_stats_fold_matches_jax(alpha):
    """The fold over the same timings sequence equals JAX's; the pass's
    `denoise_s + decode_s` folds as JAX folds one `denoise_s` span."""
    from chiaswarm_tpu.worker import Worker as JaxWorker

    stub = types.SimpleNamespace(_stage_stats={}, _stats_alpha=alpha)
    ours: dict = {}
    for timings in TIMINGS:
        JaxWorker._note_stage_stats(stub, dict(timings))
        worker_mod.fold_stage_stats(ours, alpha, dict(timings))
    assert ours == stub._stage_stats
    split, joined = {}, types.SimpleNamespace(_stage_stats={}, _stats_alpha=alpha)
    for denoise, decode in ((2.0, 0.1), (2.5, 0.2)):
        worker_mod.fold_stage_stats(split, alpha, {"denoise_s": denoise, "decode_s": decode})
        JaxWorker._note_stage_stats(joined, {"denoise_s": denoise + decode})
    assert split == joined._stage_stats


def _gang_job(i: int, **extra) -> dict:
    job = {"id": f"g{i}", "workflow": "txt2img", "model_name": "stabilityai/stable-diffusion-2-1",
           "prompt": f"member {i}", "height": 64, "width": 64, "num_inference_steps": 2,
           "parameters": {"test_tiny_model": True},
           "trace": {"gang": {"id": "x", "size": 3, "index": i}}}
    job.update(extra)
    return job


GANGS = {
    "one": dict(jobs=[_gang_job(i) for i in range(3)], kw={}),
    "max-coalesce": dict(jobs=[_gang_job(i) for i in range(3)] + [_echo("odd")],
                         kw=dict(max_coalesce=2)),
    "rows-limit": dict(jobs=[_gang_job(i) for i in range(3)], kw=dict(rows_limit=lambda job: 2)),
    "nine": dict(jobs=[_gang_job(i) for i in range(9)], kw=dict(max_coalesce=8)),
    "multi-image": dict(jobs=[_gang_job(0, num_images_per_prompt=3), _gang_job(1),
                              _gang_job(2, num_images_per_prompt=4)],
                        kw=dict(rows_limit=lambda job: 5)),
    "adapters": dict(jobs=[_gang_job(i, lora=f"style-{i % 3}") for i in range(6)],
                     kw=dict(lora_slots=2)),
    "interactive": dict(jobs=[_gang_job(0, priority="interactive"), _gang_job(1)], kw={}),
    "closed": dict(jobs=[_gang_job(i) for i in range(2)], kw={}, closed=True),
    "solo-gang": dict(jobs=[_gang_job(0)], kw={}),
}


def _drive(module, case) -> tuple:
    """Put a case's gang into `module`'s scheduler -> (groups of ids, the
    flush reasons counted, outstanding rows before and after the gets)."""
    counter = module._FLUSHES

    async def scenario():
        before = {r: counter.value(reason=r) for r in ("gang", "solo", "linger", "size")}
        sched = module.BatchScheduler(linger_s=60.0, **{"max_coalesce": 8, **case["kw"]})
        if case.get("closed"):
            sched.close()
        jobs = json.loads(json.dumps(case["jobs"]))
        await sched.put_gang(jobs)
        rows = sched.outstanding_rows
        groups = []
        while sched.ready_jobs:
            group = await asyncio.wait_for(sched.get(), 1.0)
            groups.append([(j["id"], j.get("trace", {}).get("coalesced_with")) for j in group])
        executing = sched.outstanding_rows
        for group in groups:
            for job_id, _ in group:
                sched.task_done(next(j for j in jobs if j["id"] == job_id))
        flushed = {r: counter.value(reason=r) - before[r] for r in before}
        return groups, flushed, rows, executing, sched.outstanding_rows, sched.pending_jobs

    return asyncio.run(scenario())


@pytest.mark.parametrize("name", sorted(GANGS))
def test_put_gang_matches_jax(name, sdaas_root):
    from chiaswarm_tpu import batching as jax_batching

    case = GANGS[name]
    assert _drive(batching, case) == _drive(jax_batching, case)


def test_pack_raw_reads_across_packages():
    from chiaswarm_tpu.workflows import stages as jax_stages

    rng = np.random.default_rng(3)
    rows = [Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)) for _ in range(3)]
    ours, theirs = stages.pack_raw(rows), jax_stages.pack_raw(rows)
    assert ours == theirs
    # arrays pack as their images do
    assert stages.pack_raw([np.asarray(im) for im in rows]) == ours
    for packed, unpack in ((ours, jax_stages.unpack_raw), (theirs, stages.unpack_raw)):
        back = unpack(base64.b64decode(packed["blob"]))
        assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(back, rows))


def test_encode_stage_matches_jax():
    from chiaswarm_tpu.workflows import stages as jax_stages

    kw = dict(prompt="a red fox in fresh snow", negative_prompt="blurry")
    ours, cfg = stages.encode_callback("cpu", MODEL, **kw)
    theirs, jax_cfg = jax_stages.encode_callback("cpu", MODEL, **kw)
    assert ours == theirs
    assert {k: v for k, v in cfg.items() if k != "timings"} == {
        k: v for k, v in jax_cfg.items() if k != "timings"}


def _in_threads(fn, n: int = 32) -> None:
    """`fn` on `n` threads released together, the interpreter switching
    threads as often as it can; every thread must finish."""
    start = threading.Barrier(n)

    def run():
        start.wait(10)
        fn()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)


def test_failover_state_is_shared_by_threads(sdaas_root):
    """Thirty-two threads that see the same endpoint fail fail over once;
    errors of an endpoint already left behind do not count."""
    settings = Settings(sdaas_uri="http://a:1", hive_failover_errors=1)
    settings.sdaas_uris = "http://a:1,http://b:2"
    client = hive.HiveClient(settings)
    failovers = telemetry.REGISTRY.get("swarm_hive_failover_total")
    before = failovers.value()
    _in_threads(lambda: client._note_transport_error("http://a:1/api"))
    assert client.failovers == 1 and failovers.value() - before == 1
    assert client.hive_uri == "http://b:2/api"
    active = telemetry.REGISTRY.get("swarm_hive_active_endpoint")
    assert active.value(uri="http://b:2/api") == 1 and active.value(uri="http://a:1/api") == 0


def test_launch_counter_counts_every_thread():
    """The stage lane's checker launches beside the device thread's pass:
    no launch is lost from the kernels' counters."""
    from chiaswarm_tpu_torch.ops._launch import LaunchCounter

    counter = LaunchCounter()

    def note():
        for k in range(500):
            counter.note(("shape", k % 3), route=("wgmma", k % 2))

    _in_threads(note)
    assert counter.launches == 32 * 500 == sum(counter.shapes.values())
    assert sum(counter.routes.values()) == 32 * 500


# --- failover against JAX's hive double ---

@pytest.mark.parametrize("mode", ["not_primary_work", "transport"])
def test_failover_against_the_jax_hive_double(mode, sdaas_root):
    from tests.fake_hive import FakeHive as JaxFakeHive

    endpoint_errors = telemetry.REGISTRY.get("swarm_hive_endpoint_errors_total")

    async def scenario():
        primary, standby = await JaxFakeHive().start(), await JaxFakeHive().start()
        try:
            if mode == "not_primary_work":
                primary.not_primary = "standby replicating"
                primary.epoch = 3
            else:
                primary.sever_all = True
            standby.epoch = 3
            standby.add_job(_echo("fo-1"))
            settings = Settings(sdaas_token=TOKEN, sdaas_uri=primary.uri, worker_name="fo",
                                metrics_port=0, hive_failover_errors=2)
            settings.sdaas_uris = f"{primary.uri},{standby.uri}"
            worker = worker_mod.Worker(settings=settings, device="cpu",
                                       registry=_registry(None), poll_seconds=0.01,
                                       backoff_cap_seconds=0.05)
            before = endpoint_errors.value(uri=primary.uri)
            await asyncio.wait_for(worker.run(max_jobs=1), timeout=60)
            return primary, standby, worker, endpoint_errors.value(uri=primary.uri) - before
        finally:
            await primary.stop()
            await standby.stop()

    primary, standby, worker, errors = asyncio.run(scenario())
    assert [r["id"] for r in standby.results] == ["fo-1"]
    assert worker.hive.failovers == 1 and worker.hive.hive_uri == standby.uri
    health = worker.health()["hive"]
    assert health["active_endpoint"] == standby.uri and health["failovers"] == 1
    assert health["endpoints"] == [primary.uri, standby.uri]
    if mode == "not_primary_work":
        # the 409 taught the epoch; every later request echoes it
        assert errors == 0 and health["epoch"] == 3
        assert standby.seen_epochs and set(standby.seen_epochs) == {"3"}
        assert (sdaas_root / "hive_epoch").read_text() == "3"
    else:
        assert errors == 2 and len(primary.work_requests) == 2
        assert health["epoch"] == 3 and (sdaas_root / "hive_epoch").read_text() == "3"


def test_every_endpoint_not_primary_names_the_remedy(sdaas_root):
    """Every hive behind the persisted epoch (a fleet rebuilt from scratch):
    the poll fails, transiently, naming the file to delete."""
    hives = [FakeHive(token=TOKEN), FakeHive(token=TOKEN)]
    try:
        for h in hives:
            # a stale-epoch refusal, worded as the repo's hive words it
            h.not_primary(epoch=1, message="not primary: stale hive epoch 1 (the swarm is at "
                                           "epoch 5; this hive was deposed)")
        hive.persist_epoch(5)
        settings = Settings(sdaas_token=TOKEN, sdaas_uri=hives[0].uri)
        settings.sdaas_uris = ",".join(h.uri for h in hives)
        client = hive.HiveClient(settings)
        with pytest.raises(hive.HiveError, match="delete hive_epoch under") as err:
            client.ask_for_work({})
        assert not err.value.permanent and client.failovers == 2 and client.epoch == 5
        assert [e for _, e in hives[0].epochs_seen] == ["5"]
        assert [e for _, e in hives[1].epochs_seen] == ["5"]
    finally:
        for h in hives:
            h.close()


# --- through the repo's hive ---

async def _post(session, url: str, payload: dict) -> dict:
    async with session.post(url, json=payload, headers={"Authorization": f"Bearer {TOKEN}"}) as r:
        assert r.status == 200, await r.text()
        return await r.json()


def test_gang_reply_through_the_repos_hive(tiny_sd, sdaas_root):
    import aiohttp

    from chiaswarm_tpu.hive_server import HiveServer
    from chiaswarm_tpu.hive_server.trace import trace_missing
    from chiaswarm_tpu.settings import Settings as HiveSettings

    async def scenario():
        settings = HiveSettings(sdaas_token=TOKEN, hive_port=0, metrics_port=0,
                                hive_gang_max=4, hive_max_jobs_per_poll=8, hive_wal_dir="")
        async with HiveServer(settings, port=0) as server, aiohttp.ClientSession() as session:
            for i in range(3):
                await _post(session, f"{server.api_uri}/jobs", _txt(f"gang-{i}", seed=20 + i))
            worker = worker_mod.Worker(
                settings=Settings(sdaas_token=TOKEN, sdaas_uri=server.api_uri,
                                  worker_name="gang-w", metrics_port=0, max_coalesce=4),
                device="cpu", registry=_registry(tiny_sd), poll_seconds=0.01)
            await asyncio.wait_for(worker.run(max_jobs=3), timeout=120)
            traces = {}
            for i in range(3):
                async with session.get(f"{server.api_uri}/jobs/gang-{i}/trace",
                                       headers={"Authorization": f"Bearer {TOKEN}"}) as r:
                    traces[f"gang-{i}"] = await r.json()
            return server, traces

    server, traces = asyncio.run(asyncio.wait_for(scenario(), timeout=180))
    records = [server.queue.records[f"gang-{i}"] for i in range(3)]
    assert all(r.state == "done" for r in records)
    configs = [r.result["pipeline_config"] for r in records]
    assert all(c["batched_with"] == 3 and c["padded_rows"] == 4 for c in configs)
    gang_ids = {c["trace"]["gang"]["id"] for c in configs}
    assert len(gang_ids) == 1
    for job_id, payload in traces.items():
        assert trace_missing(payload) == [], (job_id, trace_missing(payload))
        echoed = payload["worker"]["trace"]
        assert echoed["gang"]["id"] in gang_ids and echoed["coalesced_with"] == 2
        assert echoed["lingered_s"] == 0.0 and "received_wall" in echoed
        dispatch = [e for e in payload["events"] if e.get("event") == "dispatch"][-1]
        assert dispatch["gang"] == echoed["gang"]["id"] and dispatch["gang_size"] == 3


def test_workflow_through_the_repos_hive(tiny_sd, sdaas_root):
    """encode -> denoise (raw handoff) -> decode, each stage a lease of its
    own, served to `done`; the final artifact is the monolithic job's."""
    import aiohttp

    from chiaswarm_tpu.hive_server import HiveServer
    from chiaswarm_tpu.settings import Settings as HiveSettings

    base = _txt("unused", seed=77)
    payload = {k: v for k, v in base.items() if k != "id"}

    async def scenario():
        settings = HiveSettings(sdaas_token=TOKEN, hive_port=0, metrics_port=0, hive_wal_dir="")
        async with HiveServer(settings, port=0) as server, aiohttp.ClientSession() as session:
            ack = await _post(session, f"{server.api_uri}/workflows", {"id": "wf1", **payload})
            await _post(session, f"{server.api_uri}/jobs", {"id": "mono", **payload})
            worker = worker_mod.Worker(
                settings=Settings(sdaas_token=TOKEN, sdaas_uri=server.api_uri,
                                  worker_name="stage-w", metrics_port=0),
                device="cpu", registry=_registry(tiny_sd, checker="test/tiny-safety-checker"),
                poll_seconds=0.01)
            await asyncio.wait_for(worker.run(max_jobs=4), timeout=120)
            async with session.get(f"{server.api_uri}/workflows/wf1",
                                   headers={"Authorization": f"Bearer {TOKEN}"}) as r:
                status = await r.json()
            return server, ack, status, worker

    server, ack, status, worker = asyncio.run(asyncio.wait_for(scenario(), timeout=180))
    assert [s["stage"] for s in ack["stages"]] == ["encode", "denoise", "decode"]
    assert status["status"] == "done", status
    records = server.queue.records
    decode = records["wf1-s2-decode"].result
    mono = records["mono"].result
    assert decode["artifacts"]["primary"]["sha256_hash"] == mono["artifacts"]["primary"][
        "sha256_hash"]
    assert decode["pipeline_config"]["nsfw_checked"] and mono["pipeline_config"]["nsfw_checked"]
    assert decode["pipeline_config"]["nsfw"] == mono["pipeline_config"]["nsfw"]
    denoise = records["wf1-s1-denoise"].result
    assert set(denoise["artifacts"]) == {"raw"}
    assert denoise["artifacts"]["raw"]["content_type"] == stages.RAW_CONTENT_TYPE
    # encode and decode ran on the lane, denoise on the device
    lanes = {tuple(item["ids"]): item["lane"] for item in worker.timeline}
    assert lanes[("wf1-s0-encode",)] == lanes[("wf1-s2-decode",)] == "stage"
    assert lanes[("wf1-s1-denoise",)] == "device"
    assert records["wf1-s2-decode"].result["pipeline_config"]["device"] == "cpu"
    advertised = worker.capabilities()
    assert set(advertised["stages"].split(",")) == coalesce.CHIP_STAGES | coalesce.CPU_STAGES
    stats = json.loads(advertised["stats"])
    assert {"denoise", "encode", "decode", "pass", "job"} <= set(stats["s"])
    assert worker.health()["stage_lane"] == {"queued": 0, "inflight": 0, "workers": 2}


def test_stage_lane_cancels_and_drains(tiny_sd, sdaas_root):
    """A cancel reaches a stage-job still queued on the lane (dropped, no
    envelope), and the run waits for the lane before it returns."""
    fake = FakeHive(token=TOKEN)
    try:
        wf = fake.submit_workflow({k: v for k, v in _txt("x", seed=5).items() if k != "id"}, "wfc")
        worker = worker_mod.Worker(
            settings=Settings(sdaas_token=TOKEN, sdaas_uri=fake.uri, worker_name="lane",
                              metrics_port=0, stage_workers=1),
            device="cpu", registry=_registry(tiny_sd), poll_seconds=0.01)
        gate = threading.Event()
        ran = []
        original = worker.execute

        def held(job, host=False):
            gate.wait(30)
            ran.append(job["id"])
            return original(job, host)

        worker.execute = held

        async def scenario():
            runner = asyncio.ensure_future(worker.run(max_jobs=1))
            while "wfc-s0-encode" not in worker._stage_running:
                await asyncio.sleep(0.01)
            # a second host stage-job waits behind the held one
            fake.enqueue({"id": "held-2", "workflow": "txt2img", "model_name": MODEL,
                          "stage": {"name": "encode", "workflow": "other", "index": 0}})
            while "held-2" not in worker._stage_queued_ids:
                await asyncio.sleep(0.01)
            worker._cancel_job("held-2", worker._scheduler)
            assert worker.health()["stage_lane"]["queued"] == 1
            gate.set()
            await asyncio.wait_for(runner, 60)

        asyncio.run(asyncio.wait_for(scenario(), timeout=90))
    finally:
        fake.close()
    assert ran == ["wfc-s0-encode"] and wf[0] == "wfc-s0-encode"
    assert [r["id"] for r in fake.results] == ["wfc-s0-encode"]
    assert worker.cancels["held-2"]["stage"] == "held"
    assert worker._stage_depth() == 0


# --- the adapter prescan ---

def _lora_files(tiny_sd, root, n: int) -> list[str]:
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    names = []
    for i in range(n):
        smoke.write_lora(root / f"style-{i}.safetensors", tiny_sd, "kohya", rank=2, seed=i)
        names.append(f"style-{i}.safetensors")
    return names


@pytest.mark.parametrize("layout,cap", [
    ([[1, 2], [3, 4, 5]], 3), ([[1, 2, 3, 4], [5]], 3), ([[1, None], [None]], 1),
    ([[None, None]], 0), ([[1, 1, 2], [2, 3]], 2), ([[1, 2, 3], [4, 5, 6, 7]], 3),
])
def test_prescan_verdicts_match_jax(layout, cap, sdaas_root):
    from chiaswarm_tpu.pipelines.stable_diffusion import SDPipeline as JaxSD

    chunks = [[{"job_id": f"j{k}", "lora": None if a is None else {"lora": f"a{a}"}}
               for k, a in enumerate(chunk)] for chunk in layout]
    stub = types.SimpleNamespace(_adapter_delta_factors=lambda lora: {})
    stub._require_runtime_delta = JaxSD._require_runtime_delta
    stub._adapter_slots_cap = JaxSD._adapter_slots_cap
    stub._scan_adapter_specs = lambda specs: JaxSD._scan_adapter_specs(stub, specs)

    def verdict(fn):
        try:
            fn()
            return None
        except ValueError as e:
            return str(e)

    want = verdict(lambda: JaxSD.prescan_adapter_chunks(stub, chunks, max(cap, 1)))
    got = verdict(lambda: SDPipeline.prescan_adapter_chunks(
        types.SimpleNamespace(_check_adapter_slots=SDPipeline._check_adapter_slots),
        chunks, max(cap, 1)))
    assert got == want


def test_prescan_refuses_before_any_unet_call(tiny_sd, tmp_path, monkeypatch, sdaas_root):
    """Nine jobs, nine distinct adapters, two passes (8 images, then 8
    one-image jobs, with 7 slots): refused before the first pass's UNet
    call, then served member by member, as JAX's worker serves a refused
    group."""
    from chiaswarm_tpu_torch.workflows import diffusion

    names = _lora_files(tiny_sd, tmp_path / "loras", 9)
    monkeypatch.setattr(diffusion, "coalesced_fit", lambda *a, **k: 8)
    calls = {"unet": 0, "run_batched": 0, "prescan": []}
    hook = tiny_sd.unet.register_forward_pre_hook(
        lambda *_: calls.__setitem__("unet", calls["unet"] + 1))
    original_prescan = SDPipeline.prescan_adapter_chunks
    original_batched = SDPipeline.run_batched

    def prescan(self, chunks, lora_slots_max=8):
        calls["prescan"].append(([len(c) for c in chunks], calls["unet"]))
        return original_prescan(self, chunks, lora_slots_max)

    def run_batched(self, *args, **kwargs):
        calls["run_batched"] += 1
        return original_batched(self, *args, **kwargs)

    monkeypatch.setattr(SDPipeline, "prescan_adapter_chunks", prescan)
    monkeypatch.setattr(SDPipeline, "run_batched", run_batched)
    jobs = [_txt(f"p{i}", seed=30 + i, steps=2, lora=names[i],
                 **({"num_images_per_prompt": 8} if i == 0 else {})) for i in range(9)]
    for job in jobs:
        job["parameters"]["num_images_per_prompt"] = job.pop("num_images_per_prompt", 1)
    worker = worker_mod.Worker(
        settings=Settings(lora_root_dir=str(tmp_path / "loras"), lora_slots_max=7,
                          metrics_port=0),
        device="cpu", registry=_registry(tiny_sd), poll_seconds=0.01)
    try:
        envelopes = worker.execute_group(jobs)
    finally:
        hook.remove()
    assert calls["prescan"] == [([1, 8], 0)] and calls["run_batched"] == 0
    assert len(envelopes) == 9
    for job, env in zip(jobs, envelopes):
        cfg = env["pipeline_config"]
        assert env["id"] == job["id"] and "error" not in cfg and not env.get("fatal_error")
        assert "batched_with" not in cfg and cfg["lora_modules"]["matched"] > 0
    assert calls["unet"] == 9 * 2
