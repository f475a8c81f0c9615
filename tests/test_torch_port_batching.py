"""chiaswarm_tpu_torch's cross-job batching and embedding cache against
the JAX package, on the CPU.

- The row helpers (`pad_bucket`, `split_by_counts`, `chunk_by_rows`)
  against JAX's over a table of counts: equal.
- `coalesce_key` against JAX's over a table of raw jobs: equal wherever
  the port serves the job (flux since the Flux slice, denoise stage-jobs
  since the stage-graph slice); None wherever JAX's is None.
- `BatchScheduler`: the same sequence of `put` gives the same groups, in
  the same order and with the same flush reasons, as JAX's.
- The embedding cache: LRU under its byte cap, rows counted; a cached
  encode equals the uncached one bit for bit; bypassed for a textual
  inversion and for text-encoder LoRA stacks.
- `SDPipeline.run_batched` against JAX's, JAX's per-row noise injected, on
  the same weights (the port's written as safetensors under a model root
  that JAX reads too): within 2/255 per image, the bound of the JAX
  package's own port tests (f32 on both sides; rounding to uint8 can flip
  a level). A LoRA with 1x1-conv factors rides the port's pass, where JAX
  refuses it (`DeltaIneligibleError`); its row is held against JAX's solo
  delta on the adapter without those factors (ROADMAP §3.8).
- Row independence: one request, two sets of batchmates, the same padded
  row count: the same image bit for bit (f32).
- The worker through the fake hive: a mixed poll as one pass plus a solo
  job; a pass that raises serves every member alone; a malformed member
  gets its own fatal envelope.

Each JAX program compiles once: the JAX pipelines are shared per model by
a module-scoped fixture, and each JAX `run_batched` variant runs once.
"""

import asyncio
import base64
import copy
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import load_file, save_file

from chiaswarm_tpu import batching as jax_batching
from chiaswarm_tpu import coalesce as jax_coalesce
from chiaswarm_tpu import embed_cache as jax_embed_cache
from chiaswarm_tpu import lora_cache as jax_lora_cache
from chiaswarm_tpu import registry as jax_registry
from chiaswarm_tpu.pipelines import common as jax_common
from chiaswarm_tpu.pipelines import stable_diffusion as jax_sd
from chiaswarm_tpu.pipelines.lora_runtime import DeltaIneligibleError
from chiaswarm_tpu_torch import batching, coalesce, settings
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.embed_cache import EmbedCache
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.loras import resolve_lora
from chiaswarm_tpu_torch.pipelines import common
from chiaswarm_tpu_torch.registry import Registry

SIZE = 64
STEPS = 2
SD15 = "runwayml/stable-diffusion-v1-5"
SDXL = "stabilityai/stable-diffusion-xl-base-1.0"
MODELS = ("test/tiny-sd", "test/tiny-xl")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


smoke = _chip_smoke()


# --- row helpers ---

@pytest.mark.parametrize("counts,max_rows", [
    ([1], 8), ([1, 2, 1], 8), ([3, 3, 3], 4), ([5], 4), ([2, 8, 1, 1], 8),
    ([1] * 9, 8), ([4, 4, 4, 4], 16), ([7, 1, 1], 1), ([64, 64], 64), ([1, 2, 2], 2)])
def test_row_helpers_match_jax(counts, max_rows):
    total = sum(counts)
    assert common.pad_bucket(total) == jax_common.pad_bucket(total)
    assert common.pad_bucket(max_rows + 1) == jax_common.pad_bucket(max_rows + 1)
    items = list(range(common.pad_bucket(total)))
    assert common.split_by_counts(items, counts) == jax_common.split_by_counts(items, counts)
    assert common.chunk_by_rows(counts, max_rows) == jax_common.chunk_by_rows(counts, max_rows)


# --- the coalesce key ---

_TXT = {"workflow": "txt2img", "model_name": SDXL, "prompt": "a boat"}
_I2I = {"workflow": "img2img", "model_name": SD15, "start_image_uri": "http://h/s.png",
        "height": 512, "width": 512, "strength": 0.6}
# name -> (job, served by the port's pass)
KEY_JOBS = {
    "txt2img": (_TXT, True),
    "txt2img-dims": ({**_TXT, "height": 768, "width": 1024}, True),
    "txt2img-one-dim": ({**_TXT, "height": 768}, True),
    "txt2img-params": ({**_TXT, "parameters": {
        "num_inference_steps": 20, "guidance_scale": 5, "scheduler_type": "EulerDiscreteScheduler",
        "use_karras_sigmas": True, "num_images_per_prompt": 3, "large_model": True}}, True),
    "txt2img-default-dims": ({**_TXT, "parameters": {"default_height": 640,
                                                      "default_width": 640}}, True),
    "txt2img-with-strength": ({**_TXT, "strength": 0.5}, True),
    "txt2img-pipeline-type": ({**_TXT, "parameters": {"pipeline_type":
                                                       "StableDiffusionXLPipeline"}}, True),
    "txt2img-edit-type": ({**_TXT, "parameters": {"pipeline_type":
                                                   "StableDiffusionXLImg2ImgPipeline"}}, True),
    "img2img": (_I2I, True),
    "img2img-no-dims": ({k: v for k, v in _I2I.items() if k not in ("height", "width")}, True),
    "img2img-no-image": ({k: v for k, v in _I2I.items() if k != "start_image_uri"}, True),
    "img2img-default-strength": ({k: v for k, v in _I2I.items() if k != "strength"}, True),
    "inpaint": ({**_I2I, "workflow": "inpaint", "mask_image_uri": "http://h/m.png"}, True),
    "img2img-mask": ({**_I2I, "mask_image_uri": "http://h/m.png"}, True),
    "pix2pix": ({**_I2I, "model_name": "timbrooks/instruct-pix2pix"}, True),
    "inpaint-checkpoint-img2img": ({**_I2I, "model_name": "runwayml/stable-diffusion-inpainting"},
                                   True),
    "refiner-stage": ({**_TXT, "refiner": {"model_name": "x"}}, True),
    "refiner-model": ({**_TXT, "model_name": "stabilityai/stable-diffusion-xl-refiner-1.0"},
                      True),
    "textual-inversion": ({**_TXT, "textual_inversion": "ti.safetensors"}, True),
    "vae": ({**_TXT, "vae": "some/vae"}, True),
    "lora": ({**_TXT, "lora": "style.safetensors"}, True),
    "lora-resolved": ({**_TXT, "lora": {"lora": "/l", "weight_name": "s.safetensors",
                                        "subfolder": None}}, True),
    "lora-rank": ({**_TXT, "lora": "style.safetensors", "parameters": {"lora_rank": 12}}, True),
    "lora-rank-small": ({**_TXT, "lora": "style.safetensors", "lora_rank": 2}, True),
    "lora-xattn": ({**_TXT, "lora": "s", "parameters": {"cross_attention_kwargs":
                                                        {"scale": 0.5}}}, True),
    "controlnet": ({**_TXT, "parameters": {"controlnet": {
        "controlnet_model_name": "lllyasviel/control_v11p_sd15_canny",
        "control_image_uri": "http://h/c.png"}}}, True),
    "controlnet-bad": ({**_TXT, "parameters": {"controlnet": {"x": 1}}}, True),
    "controlnet-window-preprocessor": ({**_TXT, "parameters": {
        "pipeline_type": "StableDiffusionXLControlNetPipeline", "controlnet": {
            "control_image_uri": "http://h/c.png", "preprocessor": "canny",
            "controlnet_conditioning_scale": 0.7, "control_guidance_start": 0.25,
            "control_guidance_end": 0.75}}}, True),
    "controlnet-qr-chain": ({**_TXT, "parameters": {"controlnet": {
        "control_image_uri": "http://h/qr.png",
        "parameters": {"controlnet_prepipeline_type": "StableDiffusionPipeline"}}}}, True),
    "controlnet-qr-contents": ({**_TXT, "parameters": {"controlnet": {
        "qr_code_contents": "https://example.org"}}}, True),
    "controlnet-start-image": ({**_I2I, "parameters": {"controlnet": {
        "control_image_uri": "http://h/c.png"}}}, True),
    "controlnet-no-uri": ({**_TXT, "parameters": {"controlnet": {
        "controlnet_model_name": "x"}}}, True),
    "controlnet-img2img-pipeline": ({**_TXT, "parameters": {
        "pipeline_type": "StableDiffusionControlNetImg2ImgPipeline",
        "controlnet": {"control_image_uri": "http://h/c.png"}}}, True),
    "controlnet-lora": ({**_TXT, "lora": "style.safetensors", "parameters": {"controlnet": {
        "control_image_uri": "http://h/c.png"}}}, True),
    "flux": ({**_TXT, "model_name": "black-forest-labs/FLUX.1-schnell",
              "num_inference_steps": 4, "guidance_scale": 0.0}, True),
    "kandinsky": ({**_TXT, "model_name": "kandinsky-community/kandinsky-2-2-decoder"}, True),
    "deepfloyd": ({**_TXT, "model_name": "DeepFloyd/IF-I-XL-v1.0"}, True),
    "stage-denoise": ({**_TXT, "stage": {"name": "denoise"}}, True),
    "stage-encode": ({**_TXT, "stage": {"name": "encode"}}, True),
    "unknown-parameter": ({**_TXT, "parameters": {"scheduler_args": {}}}, True),
    "tiny-in-parameters": ({**_TXT, "parameters": {"test_tiny_model": True}}, True),
    "tiny-top-level": ({**_TXT, "test_tiny_model": True}, True),
    "interactive": ({**_TXT, "priority": "interactive"}, True),
    "echo": ({"workflow": "echo", "model_name": "none"}, True),
    "no-model": ({"workflow": "txt2img"}, True),
    "bad-steps": ({**_TXT, "num_inference_steps": "many"}, True),
}


@pytest.mark.parametrize("name", sorted(KEY_JOBS))
def test_coalesce_key_matches_jax(name, sdaas_root):
    job, served = KEY_JOBS[name]
    got = coalesce.coalesce_key(copy.deepcopy(job))
    want = jax_coalesce.coalesce_key(copy.deepcopy(job))
    if served:
        assert got == want
    else:
        # JAX batches it; the port refuses the feature, so it runs alone
        assert want is not None and got is None
    for fn in ("job_rows", "is_interactive", "adapter_ref"):
        assert getattr(coalesce, fn)(job) == getattr(jax_coalesce, fn)(job), fn


def test_coalesce_key_table_covers_both_outcomes():
    keys = {name: coalesce.coalesce_key(job) for name, (job, _) in KEY_JOBS.items()}
    assert keys["txt2img"] == (SDXL, "sdxl", None, None, 30, "DPMSolverMultistepScheduler", 7.5,
                               False, False, False, "txt2img", None, None, None, None)
    assert keys["img2img"][1:] == ("sd", 512, 512, 30, "DPMSolverMultistepScheduler", 7.5,
                                   False, False, False, "img2img", 0.6, None, None, None)
    assert keys["lora"] == keys["txt2img"]  # adapter identity rides per row
    assert keys["lora-rank"][12] == ("lora", 16)
    assert keys["interactive"] == keys["txt2img"]
    assert keys["tiny-top-level"] == keys["tiny-in-parameters"] != keys["txt2img"]
    assert coalesce.placement_model(KEY_JOBS["tiny-top-level"][0]) == "test/tiny-xl"
    # a shared ControlNet is an element of the key; its chains run alone
    assert keys["controlnet"][13] == ("lllyasviel/control_v11p_sd15_canny", "http://h/c.png",
                                      "", 1.0, 0.0, 1.0)
    assert keys["controlnet-window-preprocessor"][13][2:] == ("canny", 0.7, 0.25, 0.75)
    for name in ("controlnet-qr-chain", "controlnet-qr-contents", "controlnet-start-image",
                 "controlnet-lora"):
        assert keys[name] is None, name


# --- the scheduler ---

def _job(i, **kw):
    job = {"id": f"j{i}", "workflow": "txt2img", "model_name": SD15, "prompt": str(i),
           "height": SIZE, "width": SIZE}
    parameters = kw.pop("parameters", {})
    if "n" in kw:
        parameters["num_images_per_prompt"] = kw.pop("n")
    if parameters:
        job["parameters"] = parameters
    job.update(kw)
    return job


_INPAINT = {"workflow": "inpaint", "mask_image_uri": "http://h/m.png"}
# name -> (scheduler arguments, steps: a job to put, "sleep", "flush_all"),
# expected reasons in release order
SCENARIOS = {
    "solo-and-linger": ({}, [_job(0, **_INPAINT), _job(1), _job(2), "sleep"],
                        ["solo", "linger"]),
    "size-then-shutdown": ({"max_coalesce": 2}, [_job(0), _job(1), _job(2), "flush_all"],
                           ["size", "shutdown"]),
    "rows": ({"cap": 4}, [_job(0, n=3), _job(1, n=2), _job(2, n=2)], ["rows", "rows"]),
    "slots": ({"lora_slots": 1}, [_job(0, lora="a"), _job(1, lora="b"), _job(2, lora="b"),
                                  _job(3), "flush_all"], ["slots", "shutdown"]),
    "priority-and-preempt": ({}, [_job(0), _job(1, num_inference_steps=4),
                                  _job(2, priority="interactive"), _job(3),
                                  _job(4, priority="interactive", **_INPAINT)],
                             ["priority", "preempt", "preempt", "solo"]),
}


async def _drive(module, options, steps, linger=0.05):
    cap = options.get("cap")
    sched = module.BatchScheduler(linger_s=linger, max_coalesce=options.get("max_coalesce", 8),
                                  rows_limit=(lambda job: cap) if cap else None,
                                  lora_slots=options.get("lora_slots", 8))
    for step in steps:
        if step == "sleep":
            await asyncio.sleep(3 * linger)
        elif step == "flush_all":
            sched.flush_all()
        else:
            await sched.put(copy.deepcopy(step))
    return sched


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_groups_match_jax(name, sdaas_root, monkeypatch):
    options, steps, reasons = SCENARIOS[name]

    class Recorder:
        def __init__(self):
            self.reasons = []

        def inc(self, n=1, **labels):
            self.reasons.append(labels["reason"])

    recorder = Recorder()
    monkeypatch.setattr(jax_batching, "_FLUSHES", recorder)

    async def both():
        ref = await _drive(jax_batching, options, steps)
        port = await _drive(batching, options, steps)
        want = [[j["id"] for j in await ref.get()] for _ in recorder.reasons]
        got = []
        while port._board:
            item = await port.get_item()
            got.append(([j["id"] for j in item["jobs"]], item["reason"]))
        assert ref.pending_jobs == port.pending_jobs == 0
        return want, got

    want, got = asyncio.run(both())
    assert got == list(zip(want, recorder.reasons))
    assert recorder.reasons == reasons


def test_scheduler_admits_solo_when_coalescing_is_off():
    async def drive():
        sched = batching.BatchScheduler(max_coalesce=1)
        await sched.put(_job(0))
        await sched.put(_job(1))
        assert sched.outstanding_jobs == 2 and sched.full() is False
        items = [await sched.get_item(), await sched.get_item()]
        sched.task_done()
        return items, sched.outstanding_jobs

    items, outstanding = asyncio.run(drive())
    assert [i["reason"] for i in items] == ["solo", "solo"] and outstanding == 1


# --- models, adapters and the JAX pipelines on the same weights ---

def _save_safetensors(pipe, root):
    parts = {"unet": pipe.unet, "vae": pipe.vae}
    for i, enc in enumerate(pipe.text_encoders):
        parts["text_encoder" + ("_2" if i else "")] = enc
    for sub, module in parts.items():
        (root / sub).mkdir(parents=True)
        save_file({k: v.detach().numpy().copy() for k, v in module.state_dict().items()},
                  str(root / sub / "model.safetensors"))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The port's tiny models as safetensors under a model root, a Registry
    over it (embedding cache on), LoRAs written from seeded tensors, and the
    JAX pipelines reading the same root."""
    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline

    root = tmp_path_factory.mktemp("batching")
    models, loras = root / "models", root / "loras"
    mp = pytest.MonkeyPatch()
    mp.setenv("SDAAS_ROOT", str(root / "sdaas"))
    mp.setenv("CHIASWARM_MODEL_ROOT_DIR", str(models))
    mp.setenv("CHIASWARM_LORA_ROOT_DIR", str(loras))
    for model in MODELS:
        _save_safetensors(SDPipeline(model, device="cpu"), models / model)
    registry = Registry(torch.device("cpu"), str(models), str(loras))
    port = {m: registry.get_pipeline(m) for m in MODELS}
    xl, sd = port["test/tiny-xl"], port["test/tiny-sd"]
    smoke.write_lora(loras / "xl-a.safetensors", xl, "kohya", rank=4, alpha=2.0, te_rank=2,
                     seed=51)
    smoke.write_lora(loras / "xl-b.safetensors", xl, "peft", rank=2, seed=52)
    smoke.write_lora(loras / "sd-conv.safetensors", sd, "peft", rank=4, seed=53,
                     conv_proj=True)
    linear = {k: v for k, v in load_file(str(loras / "sd-conv.safetensors")).items()
              if v.ndim == 2}
    save_file(linear, str(loras / "sd-linear.safetensors"))
    jax_registry.clear_cache()
    jax_lora_cache.reset()
    jax_embed_cache.reset()
    reference = {m: jax_sd.SDPipeline(m) for m in MODELS}
    yield {"models": models, "loras": loras, "registry": registry, "port": port,
           "jax": reference}
    jax_registry.clear_cache()
    jax_lora_cache.reset()
    jax_embed_cache.reset()
    mp.undo()


def _lora(name, env):
    return resolve_lora(name, str(env["loras"]))


def _jax_batched_noise(seeds, counts, size=SIZE, channels=4):
    """JAX's per-row draws of a coalesced pass -> (initial latents NCHW
    [padded], noise_fn): rows of request j from split(fold_in(key(seed_j),
    i)), padding rows from key(0x9AD); the init draw normal(k_init, (lh,
    lw, C)), step noise normal(fold_in(k_step, i), ...)."""
    lh = lw = size // 2  # the tiny VAE downsamples by 2
    total = sum(counts)
    sources = [(jax.random.key(s), n) for s, n in zip(seeds, counts)]
    sources.append((jax.random.key(0x9AD), common.pad_bucket(total) - total))
    init, steps = [], []
    for base, n in sources:
        for i in range(n):
            k_init, k_step = jax.random.split(jax.random.fold_in(base, i))
            init.append(np.asarray(jax.random.normal(k_init, (lh, lw, channels), jnp.float32)))
            steps.append(k_step)

    def noise_fn(kind, i, shape):
        assert kind == "step" and shape[0] == len(steps)
        return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, i),
                                                      (lh, lw, channels), jnp.float32))
                         for k in steps]).transpose(0, 3, 1, 2)

    return np.stack(init).transpose(0, 3, 1, 2), noise_fn


def _start_image(seed, size=SIZE):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    a, b = rng.uniform(2, 8, 2)
    rgb = np.stack([0.5 + 0.5 * np.sin(a * xx + b * yy), 0.5 + 0.5 * np.cos(b * yy - a * xx),
                    xx * yy], -1)
    return Image.fromarray((255 * rgb).astype(np.uint8))


def _levels(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


# name -> (model, shared keywords, [(seed, n, per-request keywords)])
BATCHED = {
    "tiny-sd-counts-1-2-1": ("test/tiny-sd", dict(
        scheduler_type="EulerAncestralDiscreteScheduler"),
        [(11, 1, dict(prompt="a red cube")), (12, 2, dict(prompt="a blue ball",
                                                         negative_prompt="blurry")),
         (13, 1, dict(prompt="a green cone"))]),
    "tiny-xl-three-padded-to-4": ("test/tiny-xl", dict(guidance_scale=6.0), [
        (21, 1, dict(prompt="a boat")), (22, 1, dict(prompt="a ship", negative_prompt="dark")),
        (23, 1, dict(prompt="a raft"))]),
    "tiny-xl-img2img-two-start-images": ("test/tiny-xl", dict(
        strength=0.6, scheduler_type="EulerAncestralDiscreteScheduler"),
        [(31, 1, dict(prompt="a castle", image=_start_image(1))),
         (32, 1, dict(prompt="a tower", image=_start_image(2)))]),
    "tiny-xl-two-adapters-and-plain": ("test/tiny-xl", dict(
        scheduler_type="EulerAncestralDiscreteScheduler"),
        [(41, 1, dict(prompt="a cat", lora="xl-a.safetensors", lora_scale=0.8)),
         (42, 1, dict(prompt="a dog")),
         (43, 1, dict(prompt="a fox", lora="xl-b.safetensors", lora_scale=0.5))]),
}


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_run_batched_matches_jax(env, name):
    model, shared, requests = BATCHED[name]
    shared = dict(num_inference_steps=STEPS, height=SIZE, width=SIZE, **shared)
    specs = []
    for seed, n, kw in requests:
        spec = dict(kw, num_images_per_prompt=n)
        if "lora" in spec:
            spec["lora"] = _lora(spec["lora"], env)
        specs.append(spec)
    want = env["jax"][model].run_batched(
        [dict(s, rng=jax.random.key(seed)) for s, (seed, _, _) in zip(specs, requests)],
        **shared)
    counts = [n for _, n, _ in requests]
    latents, noise_fn = _jax_batched_noise([s for s, _, _ in requests], counts)
    got = env["port"][model].run_batched(
        [dict(s, seed=seed) for s, (seed, _, _) in zip(specs, requests)],
        latents=latents, noise_fn=noise_fn, **shared)
    padded = common.pad_bucket(sum(counts))
    offset = 0
    for (images, config), (want_images, want_config), spec in zip(got, want, specs):
        assert len(images) == len(want_images) == spec["num_images_per_prompt"]
        for key in ("mode", "steps", "size", "batched_with", "batch_rows", "padded_rows"):
            assert config[key] == want_config[key], key
        assert config["padded_rows"] == padded and config["batch_rows"][0] == offset
        assert config.get("lora_mode") == want_config.get("lora_mode")
        assert ("strength" in config) == ("image" in spec)
        for a, b in zip(images, want_images):
            assert _levels(a, b) <= 2
        offset += len(images)
    if "adapters" in name:
        # each adapter moved its row: the same pass without them differs
        # (the text encode uncached, as in the pass with text-encoder
        # adapters)
        pipe = env["port"][model]
        cache, pipe.embed_cache = pipe.embed_cache, None
        try:
            plain = pipe.run_batched(
                [{k: v for k, v in dict(s, seed=seed).items() if k not in ("lora", "lora_scale")}
                 for s, (seed, _, _) in zip(specs, requests)],
                latents=latents, noise_fn=noise_fn, **shared)
        finally:
            pipe.embed_cache = cache
        assert _levels(plain[0][0][0], got[0][0][0]) > 2
        assert _levels(plain[2][0][0], got[2][0][0]) > 2
        # the adapter-free row is bit for bit what a pass without hooks gives
        assert np.array_equal(plain[1][0][0], got[1][0][0])
        assert got[0][1]["lora_scale"] == 0.8 and got[2][1]["lora_scale"] == 0.5
        assert got[0][1]["operand_cache"]["hits"] + got[0][1]["operand_cache"]["misses"] == 2


def test_conv_adapter_rides_the_pass(env):
    """ROADMAP §3.8: JAX refuses a coalesced pass whose adapter has
    conv-shaped factors (DeltaIneligibleError) and serves it alone; the
    port's pass serves it, by the same delta over the matched Linear
    modules as its solo path. Its row equals JAX's solo delta on the
    adapter without those factors, JAX's solo noise injected into row 0."""
    model, seed = "test/tiny-sd", 61
    shared = dict(num_inference_steps=STEPS, height=SIZE, width=SIZE,
                  scheduler_type="EulerAncestralDiscreteScheduler")
    conv, linear = _lora("sd-conv.safetensors", env), _lora("sd-linear.safetensors", env)
    with pytest.raises(DeltaIneligibleError):
        env["jax"][model].run_batched([
            dict(prompt="a lamp", rng=jax.random.key(seed), lora=conv, job_id="conv"),
            dict(prompt="a desk", rng=jax.random.key(62), job_id="plain")], **shared)
    want, want_cfg = env["jax"][model].run(prompt="a lamp", rng=jax.random.key(seed),
                                           lora=linear, **shared)
    assert want_cfg["lora_mode"] == "delta"
    _, init_rng, step_rng = jax.random.split(jax.random.key(seed), 3)

    def nhwc(key):
        return np.asarray(jax.random.normal(key, (1, SIZE // 2, SIZE // 2, 4), jnp.float32)
                          ).transpose(0, 3, 1, 2)

    other = np.zeros((1, 4, SIZE // 2, SIZE // 2), np.float32)
    got = env["port"][model].run_batched(
        [dict(prompt="a lamp", seed=seed, lora=conv), dict(prompt="a desk", seed=62)],
        latents=np.concatenate([nhwc(init_rng), other]),
        noise_fn=lambda kind, i, shape: np.concatenate(
            [nhwc(jax.random.fold_in(step_rng, i)), other]), **shared)
    (images, config), (_, plain_config) = got
    assert config["lora_mode"] == "delta" and "lora_mode" not in plain_config
    assert config["lora_modules"]["unmatched"] > 0
    assert _levels(images[0], want[0]) <= 2


def test_run_batched_refusals(env):
    pipe = env["port"]["test/tiny-xl"]
    base = dict(num_inference_steps=1, height=SIZE, width=SIZE)
    with pytest.raises(ValueError, match="missing a start image"):
        pipe.run_batched([dict(prompt="a", image=_start_image(1)), dict(prompt="b")], **base)
    with pytest.raises(ValueError, match="mixed start-image sizes"):
        pipe.run_batched([dict(image=_start_image(1)), dict(image=_start_image(2, 128))], **base)
    with pytest.raises(ValueError, match="more than 1 distinct"):
        pipe.run_batched([dict(lora=_lora("xl-a.safetensors", env)),
                          dict(lora=_lora("xl-b.safetensors", env))], lora_slots_max=1, **base)


def test_row_is_independent_of_its_batchmates(env):
    """f32 on the CPU: the same request with two sets of batchmates at the
    same padded row count gives the same image bit for bit; its prompt
    rows come from the embedding cache in both passes."""
    pipe = env["port"]["test/tiny-sd"]
    shared = dict(num_inference_steps=STEPS, height=SIZE, width=SIZE,
                  scheduler_type="EulerAncestralDiscreteScheduler")
    me = dict(prompt="a lighthouse", negative_prompt="fog", seed=71)
    pipe.encode_prompts([me["negative_prompt"], me["prompt"]])  # cached
    first = pipe.run_batched([dict(me), dict(prompt="x", seed=1), dict(prompt="y", seed=2)],
                             **shared)
    second = pipe.run_batched([dict(prompt="z", seed=3, num_images_per_prompt=2), dict(me)],
                              **shared)
    assert first[0][1]["padded_rows"] == second[1][1]["padded_rows"] == 4
    assert np.array_equal(first[0][0][0], second[1][0][0])
    assert not np.array_equal(first[0][0][0], first[1][0][0])


# --- the embedding cache ---

def test_embed_cache_lru_and_row_counts():
    row = torch.zeros(10, dtype=torch.float32)  # 40 bytes
    cache = EmbedCache(100)
    cache.put(("m", "a"), (row, None))
    cache.put(("m", "b"), (row.clone(), row.clone()))
    assert cache.resident_bytes == 120 - 40 and len(cache) == 1  # a went
    assert cache.lookup(("m", "a")) is None and cache.lookup(("m", "b")) is not None
    cache.put(("n", "a"), (row, None))  # over the cap: b is least recent
    assert cache.lookup(("m", "b")) is None and len(cache) == 1
    cache.put(("m", "huge"), (torch.zeros(30), None))  # 120 bytes: never kept
    assert cache.lookup(("m", "huge")) is None and len(cache) == 1
    cache.note_rows(3, 1)
    cache.note_rows(2, 0)
    assert (cache.hits, cache.misses) == (5, 1)
    assert cache.drop_model("n") == 40 and len(cache) == 0 and cache.resident_bytes == 0


def test_cached_encode_equals_uncached_bit_for_bit(env):
    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline

    cached = Registry(torch.device("cpu"), str(env["models"]), str(env["loras"]),
                      embed_cache=EmbedCache(1 << 20)).get_pipeline("test/tiny-xl")
    plain = SDPipeline("test/tiny-xl", device="cpu", model_root_dir=str(env["models"]))
    texts = ["", "a red cube", "a blue ball", "a red cube"]
    want = plain.encode_prompts(texts)
    assert plain.last_encode_stats is None
    first = cached.encode_prompts(texts)
    assert cached.last_encode_stats == (1, 3)
    second = cached.encode_prompts(texts[::-1])
    assert cached.last_encode_stats == (4, 0)
    for a, b, c in zip(want, first, second):
        assert torch.equal(a, b) and torch.equal(a, c.flip(0))
    # a single miss is encoded beside a repeat of itself, never alone (a
    # batch of one takes a matrix-vector product for the pooled row)
    pair = ["a green cone", "a red cube"]
    for a, b in zip(plain.encode_prompts(pair), cached.encode_prompts(pair)):
        assert torch.equal(a, b)
    assert cached.last_encode_stats == (1, 1)
    job = dict(prompt="a red cube", negative_prompt="", num_inference_steps=1, height=SIZE,
               width=SIZE, seed=3)
    images, config = cached.run(**job)
    assert config["embed_cache"] == {"hits": 2, "misses": 0}
    assert np.array_equal(images[0], plain.run(**job)[0][0])
    assert cached.embed_cache.hits == 1 + 4 + 1 + 2 and cached.embed_cache.misses == 4


def test_embed_cache_bypassed_for_textual_inversion_and_te_lora(env):
    pipe = env["port"]["test/tiny-xl"]
    cache = pipe.embed_cache
    before = (cache.hits, cache.misses, len(cache))
    smoke.write_ti(env["loras"] / "xl-ti.safetensors", pipe, "dual", seed=81)
    job = dict(prompt="a <xl-ti> cube", num_inference_steps=1, height=SIZE, width=SIZE)
    _, config = pipe.run(textual_inversion="xl-ti.safetensors", **job)
    assert "embed_cache" not in config
    _, config = pipe.run(lora=_lora("xl-a.safetensors", env), **job)  # te stacks
    assert "embed_cache" not in config
    assert (cache.hits, cache.misses, len(cache)) == before
    # an adapter of the UNet alone leaves the encoders as they are: cached
    _, config = pipe.run(lora=_lora("xl-b.safetensors", env), **job)
    assert config["embed_cache"]["misses"] + config["embed_cache"]["hits"] == 2


# --- the worker through the fake hive ---

def _image(result):
    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def _png(image) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "PNG")
    return buf.getvalue()


def _serve(env, jobs, files=(), **overrides):
    hive = FakeHive(token="tok")
    try:
        uris = {name: hive.enqueue_file(name, data, "image/png") for name, data in files}
        for job in jobs:
            for key in ("start_image_uri", "mask_image_uri"):
                if key in job:
                    job[key] = uris.get(job[key], f"{hive.uri}/files/{job[key]}")
        worker = worker_mod.Worker(
            settings=settings.Settings(sdaas_token="tok", sdaas_uri=hive.uri,
                                       model_root_dir=str(env["models"]),
                                       lora_root_dir=str(env["loras"]), **overrides),
            device="cpu", registry=env["registry"], poll_seconds=0.01)
        hive.enqueue(*jobs)
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=len(jobs)), timeout=120))
        results = hive.wait_for_results(len(jobs), timeout=10)
    finally:
        hive.close()
    assert len(results) == len(jobs)
    return {r["id"]: r for r in results}


_COMMON = {"workflow": "txt2img", "model_name": SD15, "height": SIZE, "width": SIZE,
           "num_inference_steps": STEPS, "content_type": "image/png",
           "parameters": {"test_tiny_model": True}}


def test_worker_serves_a_mixed_poll_as_one_pass_and_one_solo(env):
    jobs = [dict(_COMMON, id=f"t{i}", prompt=f"a tree {i}", seed=100 + i) for i in range(4)]
    del jobs[2]["seed"]
    jobs[1]["parameters"] = {"test_tiny_model": True, "num_images_per_prompt": 2}
    jobs.append(dict(_COMMON, id="inp", workflow="inpaint", prompt="a door", seed=7,
                     start_image_uri="start.png", mask_image_uri="mask.png"))
    mask = Image.fromarray(np.tile((np.arange(SIZE) >= SIZE // 2).astype(np.uint8)[None] * 255,
                                   (SIZE, 1)))
    results = _serve(env, jobs, files=[("start.png", _png(_start_image(5))),
                                       ("mask.png", _png(mask))])
    seeds = set()
    for i in range(4):
        config = results[f"t{i}"]["pipeline_config"]
        assert not results[f"t{i}"].get("fatal_error"), config
        assert config["batched_with"] == 4 and config["padded_rows"] == 8
        assert config["model"] == "test/tiny-sd" and config["nsfw_checked"] is False
        assert config["batch_rows"][1] == (2 if i == 1 else 1)
        assert config["latents"]["finite"] and "embed_cache" in config
        seeds.add(config["seed"])
        if i != 2:
            assert config["seed"] == 100 + i
    assert len(seeds) == 4
    assert _image(results["t1"]).shape == (SIZE, 2 * SIZE, 3)  # a grid of two
    solo = results["inp"]["pipeline_config"]
    assert "batched_with" not in solo and solo["mode"] == "inpaint" and solo["seed"] == 7


def test_worker_serves_members_alone_when_the_pass_fails(env, monkeypatch):
    jobs = [dict(_COMMON, id=f"f{i}", prompt=f"a hill {i}", seed=200 + i) for i in range(3)]
    alone = _serve(env, copy.deepcopy(jobs), max_coalesce=1)

    def broken(*args, **kwargs):
        raise RuntimeError("injected pass failure")

    monkeypatch.setattr(worker_mod, "diffusion_batched_callback", broken)
    results = _serve(env, copy.deepcopy(jobs))
    for job in jobs:
        got, want = results[job["id"]], alone[job["id"]]
        assert "batched_with" not in got["pipeline_config"] and not got.get("fatal_error")
        assert got["pipeline_config"]["seed"] == want["pipeline_config"]["seed"]
        assert np.array_equal(_image(got), _image(want))


def test_worker_gives_a_malformed_member_its_own_fatal_envelope(env):
    jobs = [dict(_COMMON, id=f"m{i}", workflow="img2img", prompt=f"a wall {i}", seed=300 + i,
                 strength=0.5, start_image_uri="start.png") for i in range(3)]
    jobs[1]["start_image_uri"] = "missing.png"
    results = _serve(env, jobs, files=[("start.png", _png(_start_image(6)))])
    assert results["m1"]["fatal_error"] is True
    for job_id in ("m0", "m2"):
        config = results[job_id]["pipeline_config"]
        assert not results[job_id].get("fatal_error"), config
        assert config["batched_with"] == 2 and config["mode"] == "img2img"
        assert config["strength"] == 0.5
