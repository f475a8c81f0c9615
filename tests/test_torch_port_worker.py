"""chiaswarm_tpu_torch's worker end to end on the CPU, its device rule, and
its import purity.

- The worker (`device="cpu"`) serves an echo job and a `test/tiny-xl`
  txt2img job against the port's local fake hive: bearer auth, the
  capability advertisement, envelopes whose artifact sha256 matches the
  b64 blob, and a clean fatal envelope for an img2img job without a
  start image.
- Entry points run on the card unless told otherwise: without CUDA and
  without `device="cpu"` they raise.
- The port imports nothing of JAX, flax or chiaswarm_tpu (this stands in
  for lint rule SW001, whose scan does not cover the port), nor OpenCV,
  which the card's machine lacks.
- The poll's `unconverted_families`, parsed by the repo's hive
  (`hive_server.dispatch.WorkerDirectory.observe`), keeps Kandinsky and
  AudioLDM jobs from the port and admits every model it serves (Flux too).
"""

import asyncio
import base64
import hashlib
import importlib.util
import io
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import chiaswarm_tpu_torch
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
from chiaswarm_tpu_torch.settings import Settings

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "chiaswarm_tpu_torch"


def _image(artifact):
    blob = base64.b64decode(artifact["blob"])
    assert hashlib.sha256(blob).hexdigest() == artifact["sha256_hash"]
    base64.b64decode(artifact["thumbnail"])
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def test_worker_serves_echo_and_tiny_txt2img(tmp_path):
    hive = FakeHive(token="tok")
    try:
        settings = Settings(sdaas_token="tok", sdaas_uri=hive.uri, worker_name="port-test",
                            model_root_dir=str(tmp_path / "models"))
        worker = worker_mod.Worker(settings=settings, device="cpu", poll_seconds=0.01)
        hive.enqueue(
            {"id": "echo-1", "workflow": "echo", "model_name": "none", "prompt": "hi"},
            {"id": "tti-1", "workflow": "txt2img",
             "model_name": "stabilityai/stable-diffusion-xl-base-1.0", "prompt": "a cat",
             "height": 64, "width": 64, "num_inference_steps": 2, "seed": 3,
             "content_type": "image/png", "parameters": {"test_tiny_model": True}},
            {"id": "i2i-1", "workflow": "img2img", "model_name": "m"},
        )
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=3), timeout=120))
        results = {r["id"]: r for r in hive.wait_for_results(3, timeout=10)}
    finally:
        hive.close()

    assert hive.auth_failures == 0
    poll = hive.polls[0]
    assert poll["worker_name"] == "port-test" and poll["worker_version"]
    for key in ("gpu", "memory", "chips", "hbm_gb"):
        assert key in poll

    echo = results["echo-1"]
    assert not echo.get("fatal_error") and echo["pipeline_config"]["echo"]
    assert _image(echo["artifacts"]["primary"]).shape == (512, 512, 3)

    tti = results["tti-1"]
    assert not tti.get("fatal_error")
    config = tti["pipeline_config"]
    assert config["model"] == "test/tiny-xl" and config["seed"] == 3
    assert config["nsfw_checked"] is False and config["latents"]["finite"]
    assert {"text_encode_s", "denoise_s", "decode_s", "job_s"} <= set(config["timings"])
    assert _image(tti["artifacts"]["primary"]).shape == (64, 64, 3)

    no_image = results["i2i-1"]
    assert no_image["fatal_error"] is True
    assert "requires an input image" in no_image["pipeline_config"]["error"]


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SDPipeline("test/tiny-xl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_mod.Worker(settings=Settings())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_mod.main([])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_phases_rehearse_on_cpu(tmp_path):
    """chip_smoke.py's serving and profiling phases at a tiny size on the
    CPU: every served-envelope check passes, and the launch-count check
    fails, as it must where no kernel runs. The resume and cancel path runs
    whole (its launches printed, not held): every bit-for-bit, checkpoint,
    preview, resume and cancel check passes."""
    from chiaswarm_tpu_torch.registry import Registry

    smoke = _chip_smoke()
    with pytest.raises(smoke.SmokeFailure, match="flash_attention was never launched"):
        smoke.serve_main_path("cpu", device="cpu", model="test/tiny-xl", size=64, steps=2)
    profile = smoke.profile_main_path(SDPipeline("test/tiny-xl", device="cpu"), size=64, steps=1)
    for call in ("unet", "vae_decode"):
        assert profile[call]["device_ms_per_call"] == 0 and profile[call]["wall_ms_per_call"] > 0
    registries = [Registry(torch.device("cpu"), str(tmp_path / "models"), safety_checker_model="")
                  for _ in range(2)]
    paths, served = smoke.serve_resume_path(
        "cpu", *registries, {"flash_attention": 0, "group_norm": 0}, device="cpu",
        sdxl="test/tiny-xl", sd15="test/tiny-sd", size_xl=64, size15=64, steps=4,
        batched_steps=3, chunk=1, group_size=2, heartbeat_seconds=0.01, hold=False)
    assert served["jobs"]["resume_resumed"]["resumed"] == {"from_step": 2, "recomputed_steps": 2}
    assert {"resume_armed", "resume_resumed", "group_one_cancelled"} <= set(paths)


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


_BLOCKED = re.compile(r"^\s*(import|from)\s+(jax|flax|chiaswarm_tpu|cv2|ml_dtypes)(\s|\.|$)",
                      re.M)


def test_port_sources_import_no_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f.relative_to(REPO)) for f in files if _BLOCKED.search(f.read_text())]
    assert not offenders


def test_every_port_module_imports_with_jax_blocked():
    modules = [m.name for m in pkgutil.walk_packages(chiaswarm_tpu_torch.__path__,
                                                     "chiaswarm_tpu_torch.")]
    assert "chiaswarm_tpu_torch.worker" in modules
    # the upscale and safety slice's modules are among those imported
    assert {"chiaswarm_tpu_torch.models.safety", "chiaswarm_tpu_torch.pipelines.safety",
            "chiaswarm_tpu_torch.models.k_upscaler",
            "chiaswarm_tpu_torch.pipelines.upscale"} <= set(modules)
    # and the preprocessors' detectors, their OpenCV stand-ins and stitch
    assert {f"chiaswarm_tpu_torch.models.{m}" for m in (
        "depth", "hed", "pose", "pidinet", "mlsd", "lineart", "zoedepth", "segmentation",
        "resize")} | {"chiaswarm_tpu_torch.pipelines.aux_models",
                      "chiaswarm_tpu_torch.pre_processors.imgproc",
                      "chiaswarm_tpu_torch.pre_processors.depth_estimator",
                      "chiaswarm_tpu_torch.workflows.stitch"} <= set(modules)
    # and the Flux slice's
    assert {"chiaswarm_tpu_torch.models.flux", "chiaswarm_tpu_torch.models.t5",
            "chiaswarm_tpu_torch.pipelines.flux"} <= set(modules)
    # and the cancel and checkpoint slice's; the blob reads bfloat16
    # through torch, so ml_dtypes (a JAX dependency) stays out of reach too
    assert {"chiaswarm_tpu_torch.cancel", "chiaswarm_tpu_torch.checkpoint"} <= set(modules)
    # and the worker plane's: telemetry, logs, faults, the outbox, the cost
    # plane, the pass ledger and the memory census
    assert {f"chiaswarm_tpu_torch.{m}" for m in (
        "telemetry", "log_setup", "faults", "outbox", "costs", "programs", "memory_census",
        "models.flops")} <= set(modules)
    # and the stage graphs' callbacks
    assert "chiaswarm_tpu_torch.workflows.stages" in modules
    # and the Kandinsky 2.x slice's: the prior, the decoder UNet, MoVQ,
    # MCLIP and their pipelines (the tokenizer.json reader is in
    # models.tokenizer)
    assert {f"chiaswarm_tpu_torch.models.{m}" for m in (
        "prior", "unet_kandinsky", "movq", "mclip", "tokenizer")} | {
        "chiaswarm_tpu_torch.pipelines.kandinsky"} <= set(modules)
    # and the Kandinsky 3 and Stable Cascade slice's, with the setup CLI
    assert {f"chiaswarm_tpu_torch.models.{m}" for m in (
        "unet_kandinsky3", "cascade_unet", "paella_vq")} | {
        f"chiaswarm_tpu_torch.pipelines.{m}" for m in ("kandinsky3", "cascade")} | {
        "chiaswarm_tpu_torch.initialize"} <= set(modules)
    script = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "for name in ('jax', 'jaxlib', 'flax', 'chiaswarm_tpu', 'cv2', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {modules + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "new = {m for m in set(sys.modules) - before if sys.modules[m] is not None}\n"
        "assert not [m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                                  'chiaswarm_tpu', 'cv2',\n"
        "                                                  'ml_dtypes')], new\n"
        "from chiaswarm_tpu_torch import checkpoint\n"
        "import torch\n"
        "leaf = torch.arange(4, dtype=torch.bfloat16)\n"
        "out = checkpoint.unpack(checkpoint.pack(1, torch.zeros(1, 4, 2, 2), [leaf], 's'))\n"
        "assert torch.equal(out['state_leaves'][0], leaf)\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]


REFUSED = ("suno/bark", "DeepFloyd/IF-I-XL-v1.0", "cvssp/audioldm-s-full-v2")
SERVED = ("runwayml/stable-diffusion-v1-5", "stabilityai/stable-diffusion-2-1",
          "stabilityai/stable-diffusion-2-1-base", "stabilityai/stable-diffusion-xl-base-1.0",
          "stabilityai/stable-diffusion-xl-refiner-1.0", "runwayml/stable-diffusion-inpainting",
          "diffusers/stable-diffusion-xl-1.0-inpainting-0.1", "timbrooks/instruct-pix2pix",
          "diffusers/sdxl-instructpix2pix-768", "stabilityai/sd-x2-latent-upscaler",
          "test/tiny-sd", "test/tiny-sd-v", "test/tiny-xl", "test/tiny-inpaint",
          "test/tiny-xl-inpaint", "test/tiny-pix2pix", "test/tiny-xl-pix2pix",
          "test/tiny-xl-refiner", "test/tiny-upscaler", "black-forest-labs/FLUX.1-schnell",
          "black-forest-labs/FLUX.1-dev", "test/tiny-flux", "test/tiny-flux-schnell",
          "kandinsky-community/kandinsky-2-2-decoder", "kandinsky-community/kandinsky-2-1",
          "kandinsky-community/kandinsky-2-2-controlnet-depth", "test/tiny-kandinsky",
          "kandinsky-community/kandinsky-3", "test/tiny-kandinsky3",
          "stabilityai/stable-cascade", "stabilityai/stable-cascade-prior",
          "test/tiny-cascade", "test/tiny-cascade-prior")


def test_unconverted_families_gate_the_hive(tmp_path):
    from chiaswarm_tpu.hive_server.dispatch import WorkerDirectory

    hive = FakeHive(token="tok")
    try:
        settings = Settings(sdaas_token="tok", sdaas_uri=hive.uri, worker_name="port-gate",
                            model_root_dir=str(tmp_path / "models"))
        worker = worker_mod.Worker(settings=settings, device="cpu", poll_seconds=0.01)
        hive.enqueue({"id": "echo-1", "workflow": "echo", "model_name": "none", "prompt": "x"})
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=1), timeout=60))
    finally:
        hive.close()
    info = WorkerDirectory(ttl_s=60).observe(hive.polls[0])
    assert info.unconverted and all(k == k.lower() for k in info.unconverted)
    for model in REFUSED:
        assert not info.can_run(model), model
    for model in SERVED:
        assert info.can_run(model), model
