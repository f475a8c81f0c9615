"""chiaswarm_tpu_torch's checkpoints, resume on redelivery and previews.

- The blob (`checkpoint.pack` / `unpack`): JAX's wire format both ways,
  bfloat16 leaves read through torch with `ml_dtypes` out of reach, and a
  ValueError on a garbage or truncated blob. `program_signature` changes
  with every ingredient and never equals the JAX package's for the same
  (model, key, dtype, geometry): a JAX worker's checkpoint is refused.
- Every solver's state as a checkpoint's fixed list of leaves and back.
- `SDPipeline.run` on one module-scoped test/tiny-sd at 64^2 (f32, CPU,
  plain versions), port against port bit for bit: an armed pass (chunks of
  3 steps, a checkpoint every 2 boundaries) equals the undisturbed one and
  checkpoints at steps 6, 12, 18 and 24 of 30 (the JAX package's own pins,
  tests/test_resume_denoise.py); the pass resumed from the packed and
  unpacked step-18 blob equals it too and stamps `resumed`, for DPM++ 2M,
  Euler ancestral (the port's own generator, whose state the blob carries)
  and 4-channel inpaint (its keep noise from the same generator); previews
  at steps 3 and 6 of 9; every degrade path (a wrong signature, JAX's
  signature, torn latents or leaves, no generator state, a step outside
  the pass, chunking off) runs the full pass to the same image.
- Against JAX: a 9-step job with chunks of 3, resumed in each package from
  its own step-6 checkpoint, JAX's initial noise injected into the port:
  the decoded images agree within 2/255 (the bound of the port's pipeline
  parity tests, tests/test_torch_port_pipeline.py: f32 on both sides,
  rounding to uint8 can flip a level).
- The worker against the port's fake hive: `resume_capable` exactly when
  chunking and checkpoints are both on; checkpoint and preview uploads in
  the JAX worker's payload shapes; a redelivered job's offer resumes it.
- Wire conformance with the repo's own hive (`HiveServer`, in process,
  short lease deadline): a first port worker ships a checkpoint and stops
  without delivering; the hive redelivers with a `resume` offer to a second
  port worker, whose result it accepts, stamped `resumed`.
"""

import asyncio
import base64
import http.client
import io
import json
import struct
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu_torch import checkpoint as ckpt
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
from chiaswarm_tpu_torch.post_processors.output_processor import (
    image_to_buffer,
    make_result,
    to_pil,
)
from chiaswarm_tpu_torch.registry import Registry
from chiaswarm_tpu_torch.schedulers import SCHEDULERS, get_scheduler
from chiaswarm_tpu_torch.settings import Settings
from chiaswarm_tpu_torch.worker import Worker

MODEL = "test/tiny-sd"
CHUNK = 3
SEED = 1811


@pytest.fixture(scope="module")
def tiny_sd():
    return SDPipeline(MODEL, device="cpu")


def _start_image():
    y, x = np.mgrid[0:64, 0:64].astype(np.float32) / 63.0
    rgb = np.stack([x, y, 0.5 * (x + y)], axis=-1) * 255.0
    return Image.fromarray(rgb.astype(np.uint8))


def _half_mask():
    mask = np.zeros((64, 64), np.uint8)
    mask[:, 32:] = 255
    return Image.fromarray(mask)


JOBS = {
    "dpm": dict(steps=30, scheduler_type="DPMSolverMultistepScheduler"),
    "ancestral": dict(steps=21, scheduler_type="EulerAncestralDiscreteScheduler"),
    "inpaint": dict(steps=21, scheduler_type="DPMSolverMultistepScheduler", inpaint=True),
}


def _run(pipe, steps=9, scheduler_type="DPMSolverMultistepScheduler", inpaint=False, **kwargs):
    extra = dict(image=_start_image(), mask_image=_half_mask(), strength=1.0) if inpaint else {}
    images, config = pipe.run(prompt="preemption pin", height=64, width=64,
                              num_inference_steps=steps, scheduler_type=scheduler_type,
                              seed=SEED, **extra, **kwargs)
    return images[0], config


_REF: dict = {}


def _ref(pipe, name: str):
    """The undisturbed pass of a job, rendered once per module."""
    if name not in _REF:
        _REF[name] = _run(pipe, **(JOBS[name] if name in JOBS else {}))
    return _REF[name]


# --- the blob and the signature ---

def test_blob_round_trips_without_ml_dtypes(monkeypatch):
    from chiaswarm_tpu import checkpoint as jax_ckpt
    import ml_dtypes

    latents = np.arange(2 * 4 * 8 * 8, dtype=np.float32).reshape(2, 4, 8, 8)
    bf16 = torch.linspace(-2, 2, 6, dtype=torch.bfloat16).reshape(2, 3)
    leaves = [np.float32(0.5), np.arange(6, dtype=np.int32).reshape(2, 3), bf16,
              np.array(True)]
    rng = torch.Generator().manual_seed(4).get_state()
    jax_blob = jax_ckpt.pack(7, latents, [np.float32(0.5), bf16.float().numpy().astype(
        ml_dtypes.bfloat16)], "jax-sig")
    # nothing of the port may reach for ml_dtypes (the card's machine lacks it)
    with monkeypatch.context() as blocked:
        blocked.setitem(sys.modules, "ml_dtypes", None)
        blob = ckpt.pack(12, torch.from_numpy(latents), leaves, "sig-abc", rng)
        out = ckpt.unpack(blob)
        # a JAX-written blob reads, its bfloat16 leaf as a torch tensor
        theirs = ckpt.unpack(jax_blob)
    assert out["step"] == 12 and out["signature"] == "sig-abc"
    np.testing.assert_array_equal(out["latents"], latents)
    got = out["state_leaves"]
    assert [str(x.dtype) for x in got] == ["float32", "int32", "torch.bfloat16", "bool"]
    assert torch.equal(got[2], bf16)
    np.testing.assert_array_equal(got[1], leaves[1])
    assert torch.equal(torch.from_numpy(out["rng"]), rng)
    assert theirs["step"] == 7 and theirs["signature"] == "jax-sig" and "rng" not in theirs
    assert torch.equal(theirs["state_leaves"][1], bf16)
    # and the port's blob reads in the JAX package (which ignores `rng`)
    mine = jax_ckpt.unpack(blob)
    np.testing.assert_array_equal(mine["latents"], latents)
    np.testing.assert_array_equal(np.asarray(mine["state_leaves"][2], np.float32),
                                  bf16.float().numpy())


def _blob_with_header(header) -> bytes:
    head = json.dumps(header).encode()
    return b"CSWCKPT1" + struct.pack("<I", len(head)) + head + bytes(64)


# headers that are JSON but not a checkpoint's
MALFORMED_HEADERS = {
    "list": [],
    "empty_spec": {"v": 1, "arrays": [{}]},
    "no_shape": {"v": 1, "arrays": [{"name": "latents", "dtype": "float32"}]},
    "shape_not_a_list": {"v": 1, "arrays": [{"name": "latents", "dtype": "float32",
                                             "shape": 4}]},
    "arrays_not_a_list": {"v": 1, "arrays": 7},
    "negative_shape": {"v": 1, "arrays": [{"name": "latents", "dtype": "float32",
                                           "shape": [-1, 4]}]},
    "object_dtype": {"v": 1, "arrays": [{"name": "latents", "dtype": "object",
                                         "shape": [1]}]},
    "leaves_not_a_number": {"v": 1, "leaves": "x", "arrays": [
        {"name": "latents", "dtype": "float32", "shape": [1]}]},
}


@pytest.mark.parametrize("blob", [
    b"",                              # empty
    b"junk-not-a-checkpoint",         # wrong magic
    b"CSWCKPT1\xff\xff\xff\xff",      # header length past the blob end
    b"CSWCKPT1\x02\x00\x00\x00{]",    # a header that is not JSON
    *(pytest.param(_blob_with_header(h), id=f"header_{name}")
      for name, h in MALFORMED_HEADERS.items()),
])
def test_unpack_refuses_garbage(blob):
    with pytest.raises(ValueError):
        ckpt.unpack(blob)


def test_unpack_refuses_truncated_blob():
    blob = ckpt.pack(3, np.zeros((1, 4, 8, 8), np.float32), [np.zeros(3, np.float32)], "s",
                     np.zeros(16, np.uint8))
    for cut in (1, 16, len(blob) - 40):
        with pytest.raises(ValueError):
            ckpt.unpack(blob[:-cut])


def test_program_signature_varies_with_every_ingredient_and_differs_from_jax():
    from chiaswarm_tpu import checkpoint as jax_ckpt

    base = ckpt.program_signature("m", ("k",), "float32", (1, 2))
    assert base == ckpt.program_signature("m", ("k",), "float32", (1, 2))
    assert base != ckpt.program_signature("m2", ("k",), "float32", (1, 2))
    assert base != ckpt.program_signature("m", ("k2",), "float32", (1, 2))
    assert base != ckpt.program_signature("m", ("k",), "bfloat16", (1, 2))
    assert base != ckpt.program_signature("m", ("k",), "float32", (2, 1))
    assert base != ckpt.program_signature("m", ("k",), "float32")
    for args in ((("m", ("k",), "float32", (1, 2))), ("m", ("k",), "float32")):
        assert ckpt.program_signature(*args) != jax_ckpt.program_signature(*args)


# --- the scheduler state as leaves ---

@pytest.mark.parametrize("name", sorted(n for n in SCHEDULERS if "FlowMatch" not in n))
def test_state_leaves_round_trip(name):
    sched = get_scheduler(name)
    schedule = sched.schedule(6)
    gen = torch.Generator().manual_seed(2)
    sample = torch.randn((1, 4, 8, 8), generator=gen)
    fresh = sched.init_state(sample)
    state = fresh
    for i in range(3):
        out = torch.randn(sample.shape, generator=gen)
        noise = torch.randn(sample.shape, generator=gen)
        state, sample = sched.step(schedule, state, i, sample, out, noise)
        leaves = [leaf.numpy() for leaf in sched.state_leaves(state, sample)]
        assert len(leaves) == len(sched.state_leaves(fresh, sample))
        back = sched.state_from_leaves(fresh, leaves, sample)
        assert len(back) == len(state)
        for a, b in zip(back, state):
            if isinstance(b, torch.Tensor):
                assert torch.equal(a, b)
            else:
                assert a == b
        # the next step from the restored state equals the live one's
        out = torch.randn(sample.shape, generator=gen)
        _, want = sched.step(schedule, state, i + 1, sample, out, noise)
        _, got = sched.step(schedule, back, i + 1, sample, out, noise)
        assert torch.equal(got, want)
    if leaves:
        with pytest.raises(ValueError):
            sched.state_from_leaves(fresh, leaves[:-1], sample)
        with pytest.raises(ValueError):
            sched.state_from_leaves(fresh, [np.zeros((1, 4, 4, 4), leaf.dtype)
                                            for leaf in leaves], sample)


# --- checkpoints, resume and previews, port against port ---

@pytest.mark.parametrize("name", sorted(JOBS))
def test_resume_from_step_18_is_bitwise(tiny_sd, name):
    job = JOBS[name]
    ref, ref_cfg = _ref(tiny_sd, name)
    assert "resumed" not in ref_cfg
    shipped = []
    armed, armed_cfg = _run(tiny_sd, **job, denoise_chunk_steps=CHUNK, checkpoint_every_chunks=2,
                            checkpoint_cb=lambda *cut: shipped.append(cut))
    # shipping checkpoints never perturbs the pass
    np.testing.assert_array_equal(armed, ref)
    assert "resumed" not in armed_cfg
    assert [cut[0] for cut in shipped] == list(range(6, job["steps"] - 1, 6))
    assert len({cut[3] for cut in shipped}) == 1
    step, latents, leaves, signature, rng = shipped[2]
    assert step == 18 and isinstance(latents, np.ndarray) and rng.dtype == np.uint8
    state = ckpt.unpack(ckpt.pack(step, latents, leaves, signature, rng))
    resumed, cfg = _run(tiny_sd, **job, denoise_chunk_steps=CHUNK, resume=state)
    np.testing.assert_array_equal(resumed, ref)
    assert cfg["resumed"] == {"from_step": 18, "recomputed_steps": job["steps"] - 18}
    assert cfg["timings"]["unet_step_ms"] > 0


def test_previews_at_cadence_without_perturbing(tiny_sd):
    ref, _ = _ref(tiny_sd, "nine")
    frames = []

    def preview(step, px):
        frames.append((step, px))
        time.sleep(0.1)

    out, cfg = _run(tiny_sd, denoise_chunk_steps=CHUNK, preview_every_chunks=1,
                    preview_cb=preview)
    np.testing.assert_array_equal(out, ref)
    assert "resumed" not in cfg
    assert [step for step, _ in frames] == [3, 6]
    for _, px in frames:
        assert px.shape == (1, 64, 64, 3) and px.dtype == np.uint8
    # the previews' time is the boundaries', not the steps'
    t = cfg["timings"]
    assert 0.2 <= t["boundary_s"] < t["denoise_s"]
    # (the stamped seconds are rounded to 0.1 ms, so the step to 0.02 ms)
    assert t["unet_step_ms"] == pytest.approx(
        1000.0 * (t["denoise_s"] - t["boundary_s"]) / 9, abs=0.02)


def _nine_step_checkpoint(pipe) -> dict:
    if "nine_ckpt" not in _REF:
        shipped = []
        _run(pipe, denoise_chunk_steps=CHUNK, checkpoint_every_chunks=2,
             checkpoint_cb=lambda *cut: shipped.append(cut))
        [(step, latents, leaves, signature, rng)] = shipped
        assert step == 6
        _REF["nine_ckpt"] = {"step": step, "latents": latents, "state_leaves": leaves,
                             "signature": signature, "rng": rng}
    return dict(_REF["nine_ckpt"])


def _jax_signature(offer):
    from chiaswarm_tpu import checkpoint as jax_ckpt

    # JAX's signature over the same ingredients the port hashes
    key = (MODEL, "txt2img", 4, "DPMSolverMultistepScheduler", False, 9, 0, (64, 64), 2, None)
    return {**offer, "signature": jax_ckpt.program_signature(MODEL, key, "torch.float32")}


DEGRADE = {
    "wrong_signature": lambda o: {**o, "signature": "f" * 16},
    "jax_signature": _jax_signature,
    "torn_latents": lambda o: {**o, "latents": np.zeros((1, 2, 3, 4), np.float32)},
    "torn_leaves": lambda o: {**o, "state_leaves": o["state_leaves"][:1]},
    "no_generator_state": lambda o: {k: v for k, v in o.items() if k != "rng"},
    "step_outside_the_pass": lambda o: {**o, "step": 12},
    "chunking_off": lambda o: o,
}


@pytest.mark.parametrize("case", sorted(DEGRADE))
def test_resume_degrades_to_the_full_pass(tiny_sd, case):
    """Resume is an optimisation, never a gate: each broken offer, and any
    offer with chunking off, runs the full pass to the same image."""
    ref, _ = _ref(tiny_sd, "nine")
    offer = DEGRADE[case](_nine_step_checkpoint(tiny_sd))
    out, cfg = _run(tiny_sd, denoise_chunk_steps=0 if case == "chunking_off" else CHUNK,
                    resume=offer)
    np.testing.assert_array_equal(out, ref)
    assert "resumed" not in cfg


def test_chunked_pass_without_callbacks_is_bitwise(tiny_sd):
    ref, _ = _ref(tiny_sd, "nine")
    out, _ = _run(tiny_sd, denoise_chunk_steps=CHUNK, checkpoint_every_chunks=2,
                  preview_every_chunks=1)
    np.testing.assert_array_equal(out, ref)


# --- against JAX ---

def _save_safetensors(pipe, root):
    from safetensors.numpy import save_file

    for sub, module in (("unet", pipe.unet), ("vae", pipe.vae),
                        ("text_encoder", pipe.text_encoders[0])):
        (root / sub).mkdir(parents=True)
        save_file({k: v.detach().numpy().copy() for k, v in module.state_dict().items()},
                  str(root / sub / "model.safetensors"))


def test_resumed_pass_matches_jax(tiny_sd, sdaas_root, tmp_path, monkeypatch):
    """Each package resumes a 9-step job from its own step-6 checkpoint;
    the images agree within 2/255."""
    from chiaswarm_tpu import checkpoint as jax_ckpt
    from chiaswarm_tpu.pipelines.stable_diffusion import SDPipeline as JaxSDPipeline

    _save_safetensors(tiny_sd, tmp_path / "models" / MODEL)
    monkeypatch.setenv("CHIASWARM_MODEL_ROOT_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("CHIASWARM_DENOISE_CHUNK_STEPS", str(CHUNK))
    reference = JaxSDPipeline(MODEL)
    job = dict(prompt="preemption pin", height=64, width=64, num_inference_steps=9,
               guidance_scale=7.5, scheduler_type="DPMSolverMultistepScheduler")

    theirs = []
    reference.run(rng=jax.random.key(SEED), checkpoint_every_chunks=2,
                  checkpoint_cb=lambda *cut: theirs.append(cut), **job)
    [(step, latents, leaves, signature)] = theirs
    assert step == 6
    want, want_cfg = reference.run(rng=jax.random.key(SEED), resume=jax_ckpt.unpack(
        jax_ckpt.pack(step, latents, leaves, signature)), **job)
    assert want_cfg["resumed"] == {"from_step": 6, "recomputed_steps": 3}

    # the JAX pipeline's draw: split(rng, 3) -> init_rng -> NHWC normal
    _, init_rng, _ = jax.random.split(jax.random.key(SEED), 3)
    noise = np.asarray(jax.random.normal(init_rng, (1, 32, 32, 4), jnp.float32))
    noise = noise.transpose(0, 3, 1, 2)
    mine = []
    tiny_sd.run(latents=noise, denoise_chunk_steps=CHUNK, checkpoint_every_chunks=2,
                checkpoint_cb=lambda *cut: mine.append(cut), **job)
    [cut] = mine
    got, cfg = tiny_sd.run(latents=noise, denoise_chunk_steps=CHUNK,
                           resume=ckpt.unpack(ckpt.pack(*cut)), **job)
    assert cfg["resumed"] == {"from_step": 6, "recomputed_steps": 3}
    want = np.asarray(want[0], np.int16)
    got = np.asarray(got[0], np.int16)
    assert got.shape == want.shape == (64, 64, 3)
    assert np.abs(got - want).max() <= 2


# --- the worker against the fake hive ---

@pytest.mark.parametrize("chunk,every,capable", [(0, 0, 0), (3, 0, 0), (0, 2, 0), (3, 2, 1)])
def test_resume_capable_advertised_exactly_when_armed(chunk, every, capable):
    settings = Settings(denoise_chunk_steps=chunk, checkpoint_every_chunks=every)
    registry = Registry(torch.device("cpu"), safety_checker_model="")
    worker = Worker(settings=settings, device="cpu", registry=registry)
    assert worker.capabilities()["resume_capable"] == capable


def _registry(pipe) -> Registry:
    registry = Registry(torch.device("cpu"), safety_checker_model="")
    registry._pipelines[(MODEL, "sd")] = pipe
    return registry


def _job(job_id: str, steps: int = 9) -> dict:
    return {"id": job_id, "workflow": "txt2img", "model_name": MODEL,
            "prompt": "preemption pin", "height": 64, "width": 64, "seed": SEED,
            "num_inference_steps": steps, "content_type": "image/png",
            "parameters": {"scheduler_type": "DPMSolverMultistepScheduler"}}


def _worker(hive, pipe, **settings) -> Worker:
    return Worker(settings=Settings(sdaas_token="tok", sdaas_uri=hive.uri, worker_name="resume",
                                    max_coalesce=1, **settings),
                  device="cpu", registry=_registry(pipe), poll_seconds=0.01,
                  heartbeat_seconds=0.01)


def _pixels(result: dict):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(
        result["artifacts"]["primary"]["blob"]))).convert("RGB"))


def test_worker_ships_partials_and_resumes_a_redelivery(tiny_sd):
    ref, _ = _ref(tiny_sd, "nine")
    hive = FakeHive(token="tok")
    try:
        worker = _worker(hive, tiny_sd, denoise_chunk_steps=CHUNK, checkpoint_every_chunks=2,
                         preview_every_chunks=1)
        hive.enqueue(_job("ship-1"))
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=1), timeout=120))
        assert hive.polls[0]["resume_capable"] == "1"
        [result] = hive.results
        np.testing.assert_array_equal(_pixels(result), ref)
        kinds = [(p["kind"], p["step"]) for p in hive.partials]
        assert kinds == [("preview", 3), ("checkpoint", 6), ("preview", 6)]
        # the JAX worker's payload shapes
        [ck] = [p for p in hive.partials if p["kind"] == "checkpoint"]
        assert ck["worker_name"] == "resume" and len(ck["signature"]) == 16
        state = ckpt.unpack(hive.artifacts[ck["sha256"]])
        assert state["step"] == 6 and state["signature"] == ck["signature"]
        for p in hive.partials:
            if p["kind"] == "preview":
                assert p["content_type"] == "image/jpeg"
                image = Image.open(io.BytesIO(hive.artifacts[p["sha256"]]))
                assert image.format == "JPEG" and image.size == (64, 64)

        hive.redeliver(_job("ship-1"))
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=2), timeout=120))
        resumed = hive.results[1]
        assert resumed["pipeline_config"]["resumed"] == {"from_step": 6, "recomputed_steps": 3}
        np.testing.assert_array_equal(_pixels(resumed), ref)
    finally:
        hive.close()


def _torn_fetch(worker):
    def fetch(href):
        raise http.client.IncompleteRead(b"CSWCKPT1", 100)

    worker.hive.fetch_artifact = fetch


# resume offers that cannot be used: each runs the full pass
BAD_OFFERS = {
    "header_list": lambda hive, worker: hive.put_checkpoint(
        "bad-offer", _blob_with_header([]), 6, "s" * 16),
    "header_empty_spec": lambda hive, worker: hive.put_checkpoint(
        "bad-offer", _blob_with_header({"v": 1, "arrays": [{}]}), 6, "s" * 16),
    "fetch_raises": lambda hive, worker: (hive.put_checkpoint(
        "bad-offer", b"CSWCKPT1", 6, "s" * 16), _torn_fetch(worker)),
}


@pytest.mark.parametrize("case", sorted(BAD_OFFERS))
def test_unusable_offer_runs_the_full_pass(tiny_sd, case):
    ref, _ = _ref(tiny_sd, "nine")
    hive = FakeHive(token="tok")
    try:
        worker = _worker(hive, tiny_sd, denoise_chunk_steps=CHUNK, checkpoint_every_chunks=2)
        BAD_OFFERS[case](hive, worker)
        hive.redeliver(_job("bad-offer"))
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=1), timeout=120))
        [result] = hive.results
        assert not result.get("fatal_error") and "resumed" not in result["pipeline_config"]
        np.testing.assert_array_equal(_pixels(result), ref)
    finally:
        hive.close()


def test_failed_partials_never_cost_the_job(tiny_sd, monkeypatch):
    """A checkpoint that does not pack and a preview that does not encode
    are dropped; the job is delivered all the same."""
    import chiaswarm_tpu_torch.worker as worker_mod

    def broken(*args, **kwargs):
        raise ValueError("broken on purpose")

    monkeypatch.setattr(worker_mod, "image_to_buffer", broken)
    monkeypatch.setattr(ckpt, "pack", broken)
    ref, _ = _ref(tiny_sd, "nine")
    hive = FakeHive(token="tok")
    try:
        worker = _worker(hive, tiny_sd, denoise_chunk_steps=CHUNK, checkpoint_every_chunks=1,
                         preview_every_chunks=1)
        hive.enqueue(_job("partials-fail"))
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=1), timeout=120))
        [result] = hive.results
        assert not result.get("fatal_error") and not hive.partials
        np.testing.assert_array_equal(_pixels(result), ref)
    finally:
        hive.close()


def test_upload_to_a_closed_loop_is_dropped():
    """The worker's loop may close between the shipper's check and its
    hand-off: the partial is dropped, the pass goes on."""
    worker = Worker(settings=Settings(), device="cpu",
                    registry=Registry(torch.device("cpu"), safety_checker_model=""))
    loop = asyncio.new_event_loop()
    loop.close()
    loop.is_closed = lambda: False
    worker._loop = loop
    posted = []
    worker.hive.post_partial = lambda *args: posted.append(args)
    try:
        worker._ship("preview", "gone", {"step": 3})
    finally:
        del loop.is_closed
    assert not posted and not worker._uploads


def test_checkpoint_over_the_byte_cap_is_skipped(tiny_sd):
    hive = FakeHive(token="tok")
    try:
        worker = _worker(hive, tiny_sd, denoise_chunk_steps=CHUNK, checkpoint_every_chunks=1,
                         checkpoint_max_bytes=1024)
        hive.enqueue(_job("capped", steps=6))
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=1), timeout=120))
        assert len(hive.results) == 1 and not hive.partials
    finally:
        hive.close()


# --- wire conformance with the repo's hive ---

def test_resume_through_the_repos_hive(tiny_sd, sdaas_root):
    import aiohttp

    from chiaswarm_tpu.hive_server import HiveServer
    from chiaswarm_tpu.settings import Settings as HiveSettings

    ref, _ = _ref(tiny_sd, "nine")

    async def scenario():
        settings = HiveSettings(sdaas_token="tok", hive_port=0, metrics_port=0,
                                hive_lease_deadline_s=4.0)
        async with HiveServer(settings, port=0) as hive, aiohttp.ClientSession() as session:
            headers = {"Authorization": "Bearer tok", "Content-type": "application/json"}
            async with session.post(f"{hive.api_uri}/jobs", json=_job("conf-resume"),
                                    headers=headers) as r:
                assert r.status == 200

            def worker(name: str) -> Worker:
                return Worker(settings=Settings(sdaas_token="tok", sdaas_uri=hive.api_uri,
                                                worker_name=name, max_coalesce=1,
                                                denoise_chunk_steps=CHUNK,
                                                checkpoint_every_chunks=2),
                              device="cpu", registry=_registry(tiny_sd), poll_seconds=0.05,
                              heartbeat_seconds=0.05)

            # the first worker ships its checkpoint, then dies before delivering
            first = worker("conf-w1")
            dropped = []

            async def lost(result):
                dropped.append(result["id"])

            first._submit = lost
            await first.run(max_jobs=1)
            assert dropped == ["conf-resume"]
            record = hive.queue.records["conf-resume"]
            assert record.checkpoint and record.checkpoint["step"] == 6
            # the lease lapses; the second worker gets the redelivery and its offer
            second = worker("conf-w2")
            await asyncio.wait_for(second.run(max_jobs=1), timeout=60)
            assert record.state == "done" and record.completed_by == "conf-w2"
            return record

    record = asyncio.run(asyncio.wait_for(scenario(), timeout=120))
    assert record.attempts == 2
    config = record.result["pipeline_config"]
    assert config["resumed"] == {"from_step": 6, "recomputed_steps": 3}
    # the delivered PNG is the undisturbed image's
    png = make_result(image_to_buffer(to_pil(ref), "image/png"), "image/png")
    assert record.result["artifacts"]["primary"]["sha256_hash"] == png["sha256_hash"]
