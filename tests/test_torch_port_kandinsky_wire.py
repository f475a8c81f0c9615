"""chiaswarm_tpu_torch's Kandinsky 2.x on the wire, and the hive-client
remnants, on the CPU, held against the JAX package.

- Fault 6: the upscale stage falls back to the 2x LANCZOS resize on any
  failure to build its upscaler (a `RuntimeError("corrupt upscaler
  checkpoint")` from the registry), as JAX's stage does: the envelope's
  `upscaler: "resize-fallback"`, `upscaled: True` and the rows equal
  JAX's on the same 8x8 `pack_raw` row. Before the repair the error
  escaped.
- The registry: every Kandinsky 2.x wire name resolves to JAX's family
  and builds a KandinskyPipeline / KandinskyPriorPipeline; a Kandinsky 3
  job is still refused with the port's "not ported" error (by wire name,
  and by model name on a generic wire name).
- The advertisement: `unconverted_families` no longer names `kandinsky`
  and names Kandinsky 3's keywords, JAX's `_auto_family` words. The
  repo's HiveServer hands the worker a 2.2 job (served, test_tiny_model)
  and keeps a Kandinsky 3 job queued.
- `format_args` on Kandinsky jobs equals JAX's: the prior's
  `prior_timesteps` / `pipeline_prior_type`, split embeds, img2img, and
  the depth ControlNet's `hint` (make_hint stubbed alike on both sides).
- `resident_adapters`: the refs of the adapters whose stacks the operand
  cache holds, in JAX's format and order, and on the worker's poll.
- `HiveClient.submit_workflow` and `get_models` (the client's and the
  module function) against the repo's HiveServer, beside JAX's client.
- A tiny Kandinsky job through the worker and the port's fake hive, and
  chip_smoke.py's Kandinsky path rehearsed on the CPU with the tiny
  stand-ins (its launch holds off: no kernels on the CPU).
"""

import asyncio
import copy
import dataclasses
import importlib.util
import json
import unittest.mock as mock
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu import job_arguments as jax_job_arguments
from chiaswarm_tpu import registry as jax_registry
from chiaswarm_tpu.settings import Settings as JaxSettings
from chiaswarm_tpu_torch import hive, job_arguments
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.lora_cache import LoraCache, wire_adapter_ref
from chiaswarm_tpu_torch.pipelines.kandinsky import KandinskyPipeline, KandinskyPriorPipeline
from chiaswarm_tpu_torch.registry import (
    PIPELINE_FAMILIES,
    Registry,
    check_pipeline_type,
    job_family,
    unconverted_family_keywords,
)
from chiaswarm_tpu_torch.settings import Settings
from chiaswarm_tpu_torch.workflows import stages

REPO = Path(__file__).resolve().parents[1]
TOKEN = "tok"
K22 = "kandinsky-community/kandinsky-2-2-decoder"
K3 = "kandinsky-community/kandinsky-3"
KANDINSKY_WIRE = sorted(k for k, v in PIPELINE_FAMILIES.items() if v.startswith("kandinsky"))


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --- fault 6 ---

def test_upscale_stage_falls_back_on_any_registry_failure(monkeypatch):
    from chiaswarm_tpu.workflows import stages as jax_stages

    row = Image.fromarray(np.random.default_rng(6).integers(0, 256, (8, 8, 3), dtype=np.uint8))
    inputs = [{"artifacts": {"raw": stages.pack_raw([row])}}]

    class Broken:
        device = torch.device("cpu")

        def get_pipeline(self, *args, **kwargs):
            raise RuntimeError("corrupt upscaler checkpoint")

    def jax_get_pipeline(*args, **kwargs):
        raise RuntimeError("corrupt upscaler checkpoint")

    monkeypatch.setattr(jax_registry, "get_pipeline", jax_get_pipeline)
    ours, cfg = stages.upscale_stage_callback("cpu", "runwayml/stable-diffusion-v1-5",
                                              registry=Broken(), seed=3,
                                              stage_inputs=copy.deepcopy(inputs))
    theirs, jax_cfg = jax_stages.upscale_stage_callback("cpu", "runwayml/stable-diffusion-v1-5",
                                                        stage_inputs=copy.deepcopy(inputs))
    assert cfg["upscaler"] == jax_cfg["upscaler"] == "resize-fallback"
    assert cfg["upscaled"] is jax_cfg["upscaled"] is True
    assert ours == theirs
    (got,) = stages.unpack_raw(__import__("base64").b64decode(ours["raw"]["blob"]))
    assert got.size == (16, 16)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(row.resize(
        (16, 16), Image.Resampling.LANCZOS)))


# --- the registry and the advertisement ---

@pytest.mark.parametrize("pipeline_type", KANDINSKY_WIRE)
def test_kandinsky_wire_names_match_jax(pipeline_type):
    check_pipeline_type(pipeline_type)
    assert PIPELINE_FAMILIES[pipeline_type] == jax_registry.family_of(pipeline_type)
    assert job_family(K22, pipeline_type) == jax_registry.family_of(pipeline_type)


@pytest.mark.parametrize("pipeline_type", ["KandinskyV22Pipeline", "AutoPipelineForText2Image",
                                           "DiffusionPipeline", "KandinskyV22PriorPipeline"])
def test_registry_builds_kandinsky_pipelines(pipeline_type):
    registry = Registry(torch.device("cpu"), safety_checker_model="")
    name = ("test/tiny-kandinsky-prior" if "Prior" in pipeline_type else "test/tiny-kandinsky")
    pipe = registry.get_pipeline(name, pipeline_type=pipeline_type)
    want = KandinskyPriorPipeline if "Prior" in pipeline_type else KandinskyPipeline
    assert isinstance(pipe, want)
    assert registry.get_pipeline(name, pipeline_type=pipeline_type) is pipe


def test_unconverted_families_split_kandinsky_3_from_2():
    words = unconverted_family_keywords()
    assert "kandinsky" not in words
    # Kandinsky 3 is served too now: neither family's words are advertised
    assert not {"kandinsky-3", "kandinsky3"} & set(words)
    assert jax_registry._auto_family(K3) == "kandinsky3"
    assert jax_registry._auto_family("kandinsky-community/kandinsky3-1") == "kandinsky3"
    for name in (K22, "kandinsky-community/kandinsky-2-1",
                 "kandinsky-community/kandinsky-2-2-controlnet-depth"):
        assert not any(w in name.lower() for w in words), name


def test_each_kandinsky_bundle_has_its_geometry_and_bytes():
    """A 2.1 name takes the published 2.1 decoder (text_image) and a
    capacity row of its own, since it carries MCLIP; each row covers the
    bf16 parameters of its bundle at the published geometry."""
    from chiaswarm_tpu_torch import capacity
    from chiaswarm_tpu_torch.models import configs as cfgs
    from chiaswarm_tpu_torch.models.clip import CLIPTextEncoder
    from chiaswarm_tpu_torch.models.mclip import MCLIPTextEncoder
    from chiaswarm_tpu_torch.models.movq import MoVQ
    from chiaswarm_tpu_torch.models.prior import DiffusionPrior
    from chiaswarm_tpu_torch.models.unet_kandinsky import K22UNet
    from chiaswarm_tpu_torch.pipelines.kandinsky import decoder_configs

    k21 = "kandinsky-community/kandinsky-2-1"
    cn = "kandinsky-community/kandinsky-2-2-controlnet-depth"
    assert decoder_configs(k21)[0] == cfgs.K21_DECODER_UNET
    assert decoder_configs(K22)[0] == cfgs.K22_DECODER_UNET
    assert decoder_configs("test/tiny-kandinsky-2-1")[0] == cfgs.TINY_K22_UNET
    want = {K22: "kandinsky", cn: "kandinsky", k21: "kandinsky21",
            "kandinsky-community/kandinsky-2-2-prior": "kandinsky_prior",
            "kandinsky-community/kandinsky-2-1-prior": "kandinsky_prior"}
    assert {name: capacity._family_key(name) for name in want} == want

    def gib(*factories):
        with torch.device("meta"):
            return sum(p.numel() for f in factories for p in f().parameters()) * 2 / 2**30

    movq = lambda: MoVQ(cfgs.MoVQConfig())  # noqa: E731
    need = {"kandinsky": gib(lambda: K22UNet(cfgs.K22_DECODER_UNET), movq),
            "kandinsky21": gib(lambda: K22UNet(cfgs.K21_DECODER_UNET), movq,
                               lambda: MCLIPTextEncoder(cfgs.MCLIP_XLMR_LARGE)),
            "kandinsky_prior": gib(lambda: DiffusionPrior(cfgs.PriorConfig()),
                                   lambda: CLIPTextEncoder(cfgs.SDXL_CLIP_2))}
    assert need["kandinsky21"] > need["kandinsky"] + 0.9
    for row, n in need.items():
        assert n <= capacity.FAMILY_PARAMS_GB[row] <= n + 0.25, (row, n)


@pytest.mark.parametrize("pipeline_type", ["Kandinsky3Pipeline", "AutoPipelineForText2Image"])
def test_kandinsky_3_job_is_refused_as_not_ported(pipeline_type):
    """Kandinsky 3 is served now: a job on the production name without its
    files is refused for the missing weights (a fatal ValueError), not as a
    family that is not ported."""
    from chiaswarm_tpu_torch.weights import MissingWeightsError
    from chiaswarm_tpu_torch.workflows.diffusion import diffusion_callback

    registry = Registry(torch.device("cpu"), safety_checker_model="")
    with pytest.raises(MissingWeightsError, match="kandinsky-3"):
        diffusion_callback("cpu", K3, registry=registry, prompt="x",
                           pipeline_type=pipeline_type)


def test_the_repos_hive_hands_out_kandinsky_2_and_keeps_kandinsky_3(sdaas_root):
    import aiohttp

    from chiaswarm_tpu.hive_server import HiveServer
    from chiaswarm_tpu.settings import Settings as HiveSettings

    k22 = {"workflow": "txt2img", "model_name": K22, "prompt": "a red fox", "height": 64,
           "width": 64, "num_inference_steps": 2, "seed": 3,
           "parameters": {"pipeline_type": "KandinskyV22Pipeline", "prior_timesteps": 2,
                          "scheduler_type": "DDPMScheduler", "test_tiny_model": True}}
    # Kandinsky 3 is served now: the hive hands it out as well
    k3 = {"workflow": "txt2img", "model_name": K3, "prompt": "a red fox", "height": 64,
          "width": 64, "num_inference_steps": 2, "seed": 4,
          "parameters": {"pipeline_type": "Kandinsky3Pipeline",
                         "scheduler_type": "DDPMScheduler", "test_tiny_model": True}}

    async def post(session, url, payload):
        async with session.post(url, json=payload,
                                headers={"Authorization": f"Bearer {TOKEN}"}) as r:
            assert r.status == 200, await r.text()
            return await r.json()

    async def status(session, url):
        async with session.get(url, headers={"Authorization": f"Bearer {TOKEN}"}) as r:
            return await r.json()

    async def scenario():
        settings = HiveSettings(sdaas_token=TOKEN, hive_port=0, metrics_port=0, hive_wal_dir="")
        async with HiveServer(settings, port=0) as server, aiohttp.ClientSession() as session:
            await post(session, f"{server.api_uri}/jobs", {"id": "k3", **k3})
            await post(session, f"{server.api_uri}/jobs", {"id": "k22", **k22})
            worker = worker_mod.Worker(
                settings=Settings(sdaas_token=TOKEN, sdaas_uri=server.api_uri,
                                  worker_name="k-w", metrics_port=0),
                device="cpu", registry=Registry(torch.device("cpu"), safety_checker_model=""),
                poll_seconds=0.01)
            await asyncio.wait_for(worker.run(max_jobs=2), timeout=120)
            await asyncio.sleep(0.2)
            return (await status(session, f"{server.api_uri}/jobs/k22"),
                    await status(session, f"{server.api_uri}/jobs/k3"))

    done, held = asyncio.run(asyncio.wait_for(scenario(), timeout=180))
    assert done["status"] == "done", done
    assert held["status"] == "done", held


# --- format_args ---

class _Images:
    def __init__(self):
        self.images = {"http://h/start.png": Image.new("RGB", (640, 448), (200, 30, 40)),
                       "http://h/depth.png": Image.new("RGB", (512, 512), (90, 90, 200))}

    def fetch(self, uri, size):
        return None if uri is None or not uri.strip() else self.images[uri]


def _hint(image, *args):
    arr = np.asarray(image.convert("L").resize((48, 48)), np.float32) / 255.0
    return np.stack([arr] * 3, axis=-1)


KANDINSKY_JOBS = {
    "txt2img-prior": {"workflow": "txt2img", "model_name": K22, "prompt": "a fox",
                      "parameters": {"pipeline_type": "KandinskyV22Pipeline",
                                     "prior_timesteps": 10,
                                     "pipeline_prior_type": "KandinskyV22PriorPipeline",
                                     "scheduler_type": "DDPMScheduler"}},
    "split-embeds": {"workflow": "txt2img", "model_name": K22, "prompt": "a fox",
                     "parameters": {"pipeline_type": "KandinskyV22Pipeline",
                                    "image_embeds": [[0.1, 0.2]],
                                    "negative_image_embeds": [[0.0, 0.0]]}},
    "img2img": {"workflow": "img2img", "model_name": K22, "strength": 0.6,
                "start_image_uri": "http://h/start.png",
                "parameters": {"pipeline_type": "KandinskyV22Img2ImgPipeline"}},
    "auto-2-1": {"workflow": "txt2img", "model_name": "kandinsky-community/kandinsky-2-1",
                 "height": 512, "width": 768,
                 "parameters": {"pipeline_type": "AutoPipelineForText2Image"}},
    "depth-controlnet": {
        "workflow": "txt2img", "model_name": "kandinsky-community/kandinsky-2-2-controlnet-depth",
        "prompt": "a robot", "height": 768, "width": 768,
        "parameters": {"pipeline_type": "KandinskyV22ControlnetPipeline",
                       "controlnet": {"control_image_uri": "http://h/depth.png"}}},
    "depth-controlnet-img2img": {
        "workflow": "img2img", "model_name": "kandinsky-community/kandinsky-2-2-controlnet-depth",
        "start_image_uri": "http://h/start.png",
        "parameters": {"pipeline_type": "KandinskyV22ControlnetImg2ImgPipeline",
                       "controlnet": {"preprocessor": ""}}},
}


@pytest.mark.parametrize("name", sorted(KANDINSKY_JOBS))
def test_kandinsky_format_args_match_jax(monkeypatch, name):
    from chiaswarm_tpu.pre_processors import depth_estimator as jax_depth

    table = _Images()

    async def jax_get_image(uri, size):
        return table.fetch(uri, size)

    monkeypatch.setattr(jax_job_arguments, "get_image", jax_get_image)
    monkeypatch.setattr(job_arguments, "get_image", table.fetch)
    monkeypatch.setattr(jax_depth, "make_hint", _hint)
    monkeypatch.setattr(job_arguments, "make_hint", _hint)
    job = KANDINSKY_JOBS[name]
    jax_cb, jax_args = asyncio.run(jax_job_arguments.format_args(copy.deepcopy(job),
                                                                 JaxSettings(), "cpu"))
    cb, args = job_arguments.format_args(copy.deepcopy(job), Settings(), "cpu")
    assert cb.__name__ == jax_cb.__name__ == "diffusion_callback"
    hint, jax_hint = args.pop("hint", None), jax_args.pop("hint", None)
    assert (hint is None) == (jax_hint is None)
    if hint is not None:
        np.testing.assert_array_equal(hint, jax_hint)
    images = {k: (args.pop(k), jax_args.pop(k)) for k in ("image", "control_image")
              if k in args or k in jax_args}
    for ours, theirs in images.values():
        assert np.array_equal(np.asarray(ours), np.asarray(theirs))
    assert args == jax_args
    if name == "txt2img-prior":
        assert args["prior_timesteps"] == 10
        assert args["pipeline_prior_type"] == "KandinskyV22PriorPipeline"


# --- the hive-client remnants ---

def test_resident_adapters_match_jax(tmp_path):
    from chiaswarm_tpu import coalesce as jax_coalesce
    from chiaswarm_tpu.lora_operands import LoraOperandCache

    root = str(tmp_path / "loras")
    adapters = [{"lora": root, "weight_name": "style.safetensors", "subfolder": None},
                {"lora": "pub/repo", "weight_name": "w.safetensors", "subfolder": "sub"},
                {"lora": "pub/other", "weight_name": None, "subfolder": None},
                {"lora": root, "weight_name": "style.safetensors", "subfolder": None}]
    ours, theirs = LoraCache(), LoraOperandCache(1 << 20)
    for i, lora in enumerate(adapters):
        akey = (lora["lora"], lora["weight_name"], lora["subfolder"])
        ours.keep_stacks(f"model-{i % 2}", lora, object(), 10)
        theirs.put((f"model-{i % 2}", (akey,), "sig"), object(), 10)
        assert wire_adapter_ref(*akey) == jax_coalesce.wire_adapter_ref(*akey)
    assert ours.resident_adapter_refs() == theirs.resident_adapter_refs()
    assert ours.resident_adapter_refs() == ["style.safetensors", "pub/repo/sub/w.safetensors",
                                            "pub/other"]


def test_worker_polls_advertise_resident_adapters(tmp_path):
    registry = Registry(torch.device("cpu"), safety_checker_model="")
    registry.lora_cache.keep_stacks("m", {"lora": str(tmp_path), "weight_name": "a.safetensors"},
                                    object(), 10)
    worker = worker_mod.Worker(settings=Settings(sdaas_token=TOKEN, metrics_port=0),
                               device="cpu", registry=registry)
    caps = worker.capabilities()
    assert caps["resident_adapters"] == "a.safetensors"
    assert "kandinsky" not in caps["unconverted_families"].split(",")


def _catalog(root: Path) -> dict:
    catalog = {"models": [{"id": K22}, {"id": "test/tiny-kandinsky"}],
               "language_models": [{"id": "an-llm"}]}
    root.mkdir(parents=True, exist_ok=True)
    (root / "models.json").write_text(json.dumps(catalog))
    return catalog


def test_submit_workflow_and_get_models_match_jax(sdaas_root):
    import aiohttp

    from chiaswarm_tpu import hive as jax_hive
    from chiaswarm_tpu.hive_server import HiveServer
    from chiaswarm_tpu.settings import Settings as HiveSettings

    catalog = _catalog(sdaas_root)
    payload = {"workflow": "txt2img", "model_name": "test/tiny-sd", "prompt": "a lighthouse",
               "height": 64, "width": 64, "num_inference_steps": 2}

    async def scenario():
        settings = HiveSettings(sdaas_token=TOKEN, hive_port=0, metrics_port=0, hive_wal_dir="")
        async with HiveServer(settings, port=0) as server:
            client = hive.HiveClient(Settings(sdaas_token=TOKEN, sdaas_uri=server.uri))
            ours = await asyncio.to_thread(client.submit_workflow, {"id": "wf-port", **payload})
            jax_client = jax_hive.HiveClient(JaxSettings(sdaas_token=TOKEN), server.api_uri)
            try:
                theirs = await jax_client.submit_workflow({"id": "wf-jax", **payload})
                jax_models = await jax_client.get_models()
            finally:
                await jax_client.close()
            models = await asyncio.to_thread(client.get_models)
            module_models = await asyncio.to_thread(hive.get_models, server.uri)
            with pytest.raises(hive.HiveError):
                await asyncio.to_thread(client.submit_workflow, {"id": "bad"})
            async with aiohttp.ClientSession() as session:
                async with session.get(f"{server.api_uri}/workflows/wf-port",
                                       headers={"Authorization": f"Bearer {TOKEN}"}) as r:
                    status = await r.json()
            return ours, theirs, jax_models, models, module_models, status

    ours, theirs, jax_models, models, module_models, status = asyncio.run(
        asyncio.wait_for(scenario(), timeout=60))
    assert [s["stage"] for s in ours["stages"]] == [s["stage"] for s in theirs["stages"]]
    assert status["status"] in ("queued", "running")
    want = catalog["language_models"] + catalog["models"]
    assert models == module_models == jax_models == want
    assert json.loads((sdaas_root / "models.json").read_text()) == catalog


# --- served through the worker ---

def test_tiny_kandinsky_job_through_the_fake_hive(sdaas_root):
    fake = FakeHive(token=TOKEN)
    try:
        fake.enqueue({"id": "k-1", "workflow": "txt2img", "model_name": K22, "prompt": "a fox",
                      "height": 64, "width": 64, "num_inference_steps": 2, "seed": 4,
                      "content_type": "image/png",
                      "parameters": {"pipeline_type": "KandinskyV22Pipeline",
                                     "scheduler_type": "DDPMScheduler",
                                     "prior_timesteps": 2, "test_tiny_model": True}},
                     {"id": "k-prior", "workflow": "txt2img",
                      "model_name": "kandinsky-community/kandinsky-2-2-prior", "prompt": "x",
                      "parameters": {"pipeline_type": "KandinskyV22PriorPipeline",
                                     "test_tiny_model": True}})
        worker = worker_mod.Worker(
            settings=Settings(sdaas_token=TOKEN, sdaas_uri=fake.uri, worker_name="k",
                              metrics_port=0, max_coalesce=1),
            device="cpu", registry=Registry(torch.device("cpu"), safety_checker_model=""),
            poll_seconds=0.01)
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=2), timeout=120))
        results = {r["id"]: r for r in fake.wait_for_results(2, timeout=30)}
    finally:
        fake.close()
    ok = results["k-1"]
    cfg = ok["pipeline_config"]
    assert not ok.get("fatal_error") and cfg["model"] == "test/tiny-kandinsky"
    assert cfg["scheduler"] == "DDPMScheduler" and cfg["guidance_scale"] == 4.0
    assert {"prior_s", "denoise_s", "decode_s", "unet_step_ms"} <= set(cfg["timings"])
    assert cfg["nsfw_checked"] is False and ok["artifacts"]["primary"]["sha256_hash"]
    assert results["k-prior"]["fatal_error"]
    assert "prepipeline stage" in results["k-prior"]["pipeline_config"]["error"]


def test_chip_smoke_kandinsky_path_rehearses_on_cpu(sdaas_root):
    smoke = chip_smoke()
    paths, served = smoke.serve_kandinsky_path("cpu", device="cpu", tiny=True, hold=False,
                                               profile=False, steps=2, prior_steps=2)
    assert set(paths) == {"k22_txt2img_64", "k22_img2img", "k22_controlnet", "k21_txt2img"}
    for job in served["jobs"].values():
        assert job["latents"]["finite"]
        assert job["predicted"]["flash_attention"] > 0


@pytest.mark.parametrize("size,want", [
    (512, {((2, 1024, 12, 64), (2, 1056, 12, 64)), ((2, 256, 18, 64), (2, 288, 18, 64)),
           ((2, 64, 24, 64), (2, 96, 24, 64))}),
    (768, {((2, 2304, 12, 64), (2, 2336, 12, 64)), ((2, 576, 18, 64), (2, 608, 18, 64)),
           ((2, 144, 24, 64), (2, 176, 24, 64))})])
def test_chip_smoke_derives_the_published_shapes(size, want):
    """The shapes the smoke predicts for the published 2.2 decoder: the
    attention of a UNet call (32 image tokens ahead of the self tokens),
    MoVQ's one 512-wide head, its largest norm without SiLU at eps 1e-6."""
    from chiaswarm_tpu_torch.models import configs as cfgs

    smoke = chip_smoke()
    calls = smoke.kandinsky_calls(cfgs.K22_DECODER_UNET, cfgs.MoVQConfig(), size)
    assert {(q, k) for q, k, _ in calls["unet"]["flash_attention"]} == want
    lat = (size // 8) ** 2
    assert set(calls["decode"]["flash_attention"]) == {
        ((1, lat, 1, 512), (1, lat, 1, 512), torch.bfloat16)}
    assert ((1, size, size, 128), "bfloat16", False, 1e-6) in calls["decode"]["group_norm"]
    # layers_per_block 3, attention at the last three levels: 9 down, 1 mid
    # and 12 up; 36 resnets of two norms, 22 attention norms, the output's
    totals = {part: {k: sum(v.values()) for k, v in c.items()} for part, c in calls.items()}
    assert totals == {"unet": {"flash_attention": 22, "group_norm": 95},
                      "decode": {"flash_attention": 1, "group_norm": 30},
                      "encode": {"flash_attention": 1, "group_norm": 22}}


@contextmanager
def recorded_calls(counts: dict):
    """The Kandinsky modules' GroupNorm and attention calls recorded into
    `counts` under the wrappers' counter keys, each answered with an empty
    tensor (run the modules on the meta device inside)."""
    from chiaswarm_tpu_torch.models import layers, movq, unet_kandinsky

    def gn(x, scale, bias, *, groups=32, eps=1e-5, act=None):
        counts["group_norm"][(tuple(x.shape), str(x.dtype).replace("torch.", ""),
                              act == "silu", float(eps))] += 1
        return torch.empty_like(x)

    def fa(q, k, v, scale=None):
        counts["flash_attention"][(tuple(q.shape), tuple(k.shape), q.dtype)] += 1
        return torch.empty_like(q)

    with mock.patch.object(layers, "group_norm", gn), \
            mock.patch.object(unet_kandinsky, "group_norm", gn), \
            mock.patch.object(unet_kandinsky, "dot_product_attention", fa), \
            mock.patch.object(movq, "dot_product_attention", fa):
        yield counts


@pytest.mark.parametrize("unet_cfg,movq_cfg,size", [
    ("K22_DECODER_UNET", "MoVQConfig", 512), ("K21_DECODER_UNET", "MoVQConfig", 768),
    ("K22_CN", "MoVQConfig", 768), ("TINY_K22_UNET", "TINY_MOVQ", 64),
    ("TINY_K21_UNET", "TINY_MOVQ", 64)])
def test_chip_smoke_prediction_matches_the_modules(unet_cfg, movq_cfg, size):
    """The smoke's launch prediction, from config arithmetic alone, equals
    the wrapper calls of the modules themselves (run on the meta device),
    shape for shape, for a UNet call with two rows, a MoVQ decode and an
    encode."""
    from chiaswarm_tpu_torch.models import configs as cfgs
    from chiaswarm_tpu_torch.models.movq import MoVQ
    from chiaswarm_tpu_torch.models.unet_kandinsky import K22UNet

    smoke = chip_smoke()
    c = (dataclasses.replace(cfgs.K22_DECODER_UNET, in_channels=7) if unet_cfg == "K22_CN"
         else getattr(cfgs, unet_cfg))
    m = cfgs.MoVQConfig() if movq_cfg == "MoVQConfig" else getattr(cfgs, movq_cfg)
    dtype = torch.bfloat16
    with torch.device("meta"):
        unet, vq = K22UNet(c).to(dtype), MoVQ(m).to(dtype)
    lat = size // 2 ** (len(m.block_out_channels) - 1)

    def meta(*shape):
        return torch.empty(shape, device="meta", dtype=dtype)

    cond = ({"text_states": meta(2, 77, c.encoder_hid_dim),
             "text_embeds": meta(2, c.cross_attention_dim),
             "image_embeds": meta(2, c.image_embed_dim)}
            if c.conditioning == "text_image" else meta(2, c.encoder_hid_dim))
    recorded = {}
    with torch.no_grad():
        for part, fn in (("unet", lambda: unet(meta(2, c.in_channels, lat, lat),
                                               torch.empty((2,), device="meta"), cond)),
                         ("decode", lambda: vq.decode(meta(1, m.latent_channels, lat, lat))),
                         ("encode", lambda: vq.encode(meta(1, 3, size, size)))):
            with recorded_calls({"flash_attention": Counter(), "group_norm": Counter()}) as got:
                fn()
            recorded[part] = got
    assert smoke.kandinsky_calls(c, m, size, dtype=dtype) == recorded
