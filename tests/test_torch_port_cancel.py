"""chiaswarm_tpu_torch's hive cancels and chunked denoise, on one
module-scoped test/tiny-sd at 64^2 (f32, CPU, plain versions), port
against port bit for bit.

- A chunked pass (`denoise_chunk_steps` 3) equals the unchunked one for
  txt2img, img2img and a coalesced pass of two; a cancel token of another
  job leaves a pass alone.
- A marked solo raises `JobCancelled` at the first chunk boundary after
  the mark (and before its first step where it was marked before the
  pass); a cancelled member of a coalesced pass comes back None from the
  workflow, with no safety check or artifacts, while its batchmate's image
  is unchanged bit for bit; a pass whose every member is cancelled raises.
  A group split into several passes goes on serving its other passes
  when every member of one of them was cancelled.
  A mark is set from inside the pass (a forward pre-hook on the UNet), so
  where it lands does not depend on timing.
- `BatchScheduler.cancel`: the cases of tests/test_cancel.py that apply to
  one device (a lingering member, its adapter slot, an emptied group and
  its timer, a released item, an unknown id).
- The worker against the port's fake hive: a job the hive cancels through
  the heartbeat's `cancels` while it runs delivers nothing, and the next
  job is served; a held job cancelled before it runs is dropped; a
  JobCancelled never becomes an error envelope, and a wholly cancelled
  pass never serves its members again alone.
"""

import asyncio
import base64
import hashlib

import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu_torch import cancel
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.batching import BatchScheduler
from chiaswarm_tpu_torch.cancel import JobCancelled
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
from chiaswarm_tpu_torch.registry import Registry
from chiaswarm_tpu_torch.settings import Settings
from chiaswarm_tpu_torch.workflows.diffusion import diffusion_batched_callback

MODEL = "test/tiny-sd"
CHUNK = 3
SEED = 2024


@pytest.fixture(scope="module")
def tiny_sd():
    return SDPipeline(MODEL, device="cpu")


@pytest.fixture(autouse=True)
def clean_registry():
    cancel.get_registry().clear()
    yield
    cancel.get_registry().clear()


def _start_image():
    y, x = np.mgrid[0:64, 0:64].astype(np.float32) / 63.0
    return Image.fromarray((np.stack([x, y, 1.0 - x], axis=-1) * 255.0).astype(np.uint8))


MODES = {"txt2img": {}, "img2img": {"strength": 0.75}}


def _run(pipe, mode="txt2img", **kwargs):
    extra = dict(MODES[mode], image=_start_image()) if mode == "img2img" else {}
    images, config = pipe.run(prompt="cancel pin", height=64, width=64, num_inference_steps=9,
                              seed=SEED, **extra, **kwargs)
    return images[0], config


_REF: dict = {}


def _ref(pipe, mode: str):
    if mode not in _REF:
        _REF[mode] = _run(pipe, mode)[0]
    return _REF[mode]


class _MarkAt:
    """Marks `job_ids` cancelled when the UNet starts its `call`-th call
    (0-based) and counts the calls."""

    def __init__(self, pipe, job_ids, call: int):
        self.pipe, self.job_ids, self.call, self.calls = pipe, job_ids, call, 0

    def _hook(self, module, args):
        if self.calls == self.call:
            for job_id in self.job_ids:
                cancel.cancel(job_id)
        self.calls += 1

    def __enter__(self):
        self.handle = self.pipe.unet.register_forward_pre_hook(self._hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


# --- solo passes ---

@pytest.mark.parametrize("mode", sorted(MODES))
def test_chunked_pass_is_bitwise(tiny_sd, mode):
    out, cfg = _run(tiny_sd, mode, denoise_chunk_steps=CHUNK, job_id="chunked")
    np.testing.assert_array_equal(out, _ref(tiny_sd, mode))
    assert cfg["timings"]["unet_step_ms"] > 0


def test_foreign_token_leaves_a_pass_alone(tiny_sd):
    cancel.cancel("someone-else")
    with _MarkAt(tiny_sd, ["someone-else-too"], 1) as mark:
        out, _ = _run(tiny_sd, denoise_chunk_steps=CHUNK, job_id="mine")
    assert mark.calls == 9
    np.testing.assert_array_equal(out, _ref(tiny_sd, "txt2img"))


def test_marked_solo_raises_at_the_first_boundary(tiny_sd):
    with _MarkAt(tiny_sd, ["solo"], 1) as mark, pytest.raises(JobCancelled) as raised:
        _run(tiny_sd, denoise_chunk_steps=CHUNK, job_id="solo")
    assert raised.value.job_ids == ["solo"]
    # marked during step 1: the pass stops at the boundary before step 3
    assert mark.calls == CHUNK
    # marked before the pass: it stops before its first step, chunked or not
    for chunk in (0, CHUNK):
        with _MarkAt(tiny_sd, [], 0) as mark, pytest.raises(JobCancelled):
            _run(tiny_sd, denoise_chunk_steps=chunk, job_id="solo")
        assert mark.calls == 0
    # without a job id nothing is probed ("solo" is still marked)
    out, _ = _run(tiny_sd, denoise_chunk_steps=CHUNK)
    np.testing.assert_array_equal(out, _ref(tiny_sd, "txt2img"))


# --- coalesced passes ---

def _registry(pipe) -> Registry:
    registry = Registry(torch.device("cpu"), safety_checker_model="")
    registry._pipelines[(MODEL, "sd")] = pipe
    return registry


def _requests() -> list[dict]:
    return [{"id": job_id, "model_name": MODEL, "prompt": prompt, "seed": seed,
             "height": 64, "width": 64, "num_inference_steps": 6, "content_type": "image/png"}
            for job_id, prompt, seed in (("a", "a red cube", 3), ("b", "a blue sphere", 4))]


def _sha(artifacts: dict) -> str:
    return hashlib.sha256(base64.b64decode(artifacts["primary"]["blob"])).hexdigest()


def test_coalesced_chunked_pass_and_cancelled_member(tiny_sd):
    registry = _registry(tiny_sd)
    ref = diffusion_batched_callback("cpu", _requests(), registry=registry)
    chunked = diffusion_batched_callback("cpu", _requests(), registry=registry,
                                         denoise_chunk_steps=CHUNK)
    assert [_sha(a) for a, _ in chunked] == [_sha(a) for a, _ in ref]
    assert all(cfg["batched_with"] == 2 for _, cfg in ref)

    with _MarkAt(tiny_sd, ["b"], 1) as mark:
        out = diffusion_batched_callback("cpu", _requests(), registry=registry,
                                         denoise_chunk_steps=CHUNK)
    # the cancelled row kept computing with its batchmate
    assert mark.calls == 6
    (kept, kept_cfg), (gone, gone_cfg) = out
    assert gone is None and gone_cfg["cancelled"] is True and "nsfw" not in gone_cfg
    assert "cancelled" not in kept_cfg and _sha(kept) == _sha(ref[0][0])

    with _MarkAt(tiny_sd, ["a", "b"], 1) as mark, pytest.raises(JobCancelled) as raised:
        diffusion_batched_callback("cpu", _requests(), registry=registry,
                                   denoise_chunk_steps=CHUNK)
    assert sorted(raised.value.job_ids) == ["a", "b"] and mark.calls == CHUNK


def test_cancelled_sub_pass_spares_the_group(tiny_sd, monkeypatch):
    """A group split into passes of one job each: the pass whose only
    member was cancelled is flagged, the other is served; only a group
    whose every member was cancelled raises."""
    from chiaswarm_tpu_torch.workflows import diffusion

    registry = _registry(tiny_sd)
    ref = diffusion_batched_callback("cpu", _requests(), registry=registry)
    monkeypatch.setattr(diffusion, "coalesced_fit", lambda *args: 1)
    for gone in ("a", "b"):
        cancel.get_registry().clear()
        cancel.cancel(gone)
        out = diffusion_batched_callback("cpu", _requests(), registry=registry,
                                         denoise_chunk_steps=CHUNK)
        for (artifacts, config), want, request in zip(out, ref, _requests()):
            if request["id"] == gone:
                assert artifacts is None and config["cancelled"] is True
            else:
                assert "cancelled" not in config and config["batched_with"] == 2
                assert _sha(artifacts) == _sha(want[0])
    cancel.cancel("a")
    with pytest.raises(JobCancelled) as raised:
        diffusion_batched_callback("cpu", _requests(), registry=registry,
                                   denoise_chunk_steps=CHUNK)
    assert sorted(raised.value.job_ids) == ["a", "b"]


# --- the scheduler ---

def _txt2img(job_id: str) -> dict:
    return {"id": job_id, "workflow": "txt2img", "model_name": "m/a", "prompt": job_id,
            "height": 64, "width": 64, "num_inference_steps": 2}


def test_scheduler_cancel_drops_a_lingering_member():
    async def scenario():
        sched = BatchScheduler(linger_s=60.0, max_coalesce=8)
        await sched.put(_txt2img("lin-1"))
        await sched.put(_txt2img("lin-2"))
        assert sched.pending_jobs == 2 and sched.outstanding_jobs == 2
        assert sched.cancel("lin-1") is True
        assert sched.pending_jobs == 1 and sched.outstanding_jobs == 1
        [group] = sched._pending.values()
        assert group["rows"] == 1
        sched.flush_all()
        assert [j["id"] for j in await sched.get()] == ["lin-2"]

    asyncio.run(scenario())


def test_scheduler_cancel_releases_the_adapter_slot():
    async def scenario():
        sched = BatchScheduler(linger_s=60.0, max_coalesce=8, lora_slots=2)
        await sched.put(dict(_txt2img("ad-1"), lora="s1.safetensors"))
        await sched.put(dict(_txt2img("ad-2"), lora="s2.safetensors"))
        [group] = sched._pending.values()
        assert len(group["adapters"]) == 2
        assert sched.cancel("ad-1") is True
        assert len(group["adapters"]) == 1
        # a third distinct adapter now joins without a "slots" flush
        await sched.put(dict(_txt2img("ad-3"), lora="s3.safetensors"))
        assert sched.pending_jobs == 2 and len(group["adapters"]) == 2

    asyncio.run(scenario())


def test_scheduler_cancel_empties_the_group_and_its_timer():
    async def scenario():
        sched = BatchScheduler(linger_s=60.0, max_coalesce=8)
        await sched.put(_txt2img("only"))
        [group] = sched._pending.values()
        assert sched.cancel("only") is True
        assert sched.pending_jobs == 0 and sched.outstanding_jobs == 0
        assert not sched._pending and group["timer"].cancelled()

    asyncio.run(scenario())


def test_scheduler_cancel_drops_a_released_item():
    async def scenario():
        sched = BatchScheduler(linger_s=0.0, max_coalesce=1)
        await sched.put({"id": "solo-board", "workflow": "echo", "model_name": "none",
                         "prompt": "x"})
        assert sched._ready_jobs == 1 and sched.full() is False
        assert sched.cancel("solo-board") is True
        assert sched._ready_jobs == 0 and sched.outstanding_jobs == 0 and sched._board == []

    asyncio.run(scenario())


def test_scheduler_cancel_of_an_unknown_id_is_false():
    async def scenario():
        sched = BatchScheduler(linger_s=0.0)
        assert sched.cancel("nobody") is False

    asyncio.run(scenario())


# --- the worker ---

def _job(job_id: str, steps: int, seed: int = SEED) -> dict:
    return {"id": job_id, "workflow": "txt2img", "model_name": MODEL, "prompt": "cancel pin",
            "height": 64, "width": 64, "seed": seed, "num_inference_steps": steps,
            "content_type": "image/png"}


def _worker(hive, pipe, **settings) -> worker_mod.Worker:
    return worker_mod.Worker(
        settings=Settings(sdaas_token="tok", sdaas_uri=hive.uri, worker_name="cancel",
                          **settings),
        device="cpu", registry=_registry(pipe), poll_seconds=0.01, heartbeat_seconds=0.01)


def test_heartbeat_cancel_delivers_nothing_and_the_next_job_is_served(tiny_sd):
    hive = FakeHive(token="tok")
    try:
        worker = _worker(hive, tiny_sd, max_coalesce=1, denoise_chunk_steps=CHUNK,
                         preview_every_chunks=1)
        hive.cancel_after_first_partial("gone")
        hive.enqueue(_job("gone", 30), _job("next", 3))
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=2), timeout=120))
        assert [r["id"] for r in hive.results] == ["next"]
        assert not hive.results[0].get("fatal_error")
    finally:
        hive.close()
    record = worker.cancels["gone"]
    assert record["stage"] == "executing" and record["freed_at"] >= record["marked_at"]
    # the revocation came on a cancel-only poll, which took no job
    assert any(p.get("cancel_only") == "1" for p in hive.polls)
    # the pass stopped at a boundary, long before its 30 steps
    assert max(p["step"] for p in hive.partials if p["job_id"] == "gone") < 30
    assert not cancel.cancelled("gone")


def test_held_job_cancelled_before_it_runs_is_dropped(tiny_sd):
    hive = FakeHive(token="tok")
    try:
        worker = _worker(hive, tiny_sd, max_coalesce=8, batch_linger_ms=200.0)
        # both coalescable; the revocation rides the reply that hands them out
        hive.enqueue(_job("kept", 3), _job("dropped", 3, seed=5))
        hive.cancel("dropped")
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=2), timeout=120))
        assert [r["id"] for r in hive.results] == ["kept"]
    finally:
        hive.close()
    assert worker.cancels["dropped"]["stage"] == "held"
    assert "batched_with" not in hive.results[0]["pipeline_config"]


def test_job_cancelled_is_never_an_error_envelope(monkeypatch):
    worker = worker_mod.Worker(settings=Settings(), device="cpu",
                               registry=Registry(torch.device("cpu"), safety_checker_model=""))
    monkeypatch.setattr(worker_mod, "format_args",
                        lambda job, settings, device: (worker_mod.diffusion_callback, dict(job)))

    def aborted(requests):
        raise JobCancelled([r["id"] for r in requests])

    alone = []
    monkeypatch.setattr(worker, "_run_pass", aborted)
    monkeypatch.setattr(worker, "_run_one", lambda *args: alone.append(args))
    assert worker.execute_group([{"id": "x"}, {"id": "y"}]) == [None, None]
    assert not alone and "freed_at" in worker.cancels["x"]

    def callback(*args, **kwargs):
        raise JobCancelled(["z"])

    monkeypatch.undo()
    assert worker._run_one({"id": "z"}, callback, {"model_name": "m"}) is None
