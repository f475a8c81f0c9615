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
  for lint rule SW001, whose scan does not cover the port).
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


def test_chip_smoke_phases_rehearse_on_cpu():
    """chip_smoke.py's serving and profiling phases at a tiny size on the
    CPU: every served-envelope check passes, and the launch-count check
    fails, as it must where no kernel runs."""
    smoke = _chip_smoke()
    with pytest.raises(smoke.SmokeFailure, match="flash_attention was never launched"):
        smoke.serve_main_path("cpu", device="cpu", model="test/tiny-xl", size=64, steps=2)
    profile = smoke.profile_main_path(SDPipeline("test/tiny-xl", device="cpu"), size=64, steps=1)
    for call in ("unet", "vae_decode"):
        assert profile[call]["device_ms_per_call"] == 0 and profile[call]["wall_ms_per_call"] > 0


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


_BLOCKED = re.compile(r"^\s*(import|from)\s+(jax|flax|chiaswarm_tpu)(\s|\.|$)", re.M)


def test_port_sources_import_no_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f.relative_to(REPO)) for f in files if _BLOCKED.search(f.read_text())]
    assert not offenders


def test_every_port_module_imports_with_jax_blocked():
    modules = [m.name for m in pkgutil.walk_packages(chiaswarm_tpu_torch.__path__,
                                                     "chiaswarm_tpu_torch.")]
    assert "chiaswarm_tpu_torch.worker" in modules
    script = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "for name in ('jax', 'jaxlib', 'flax', 'chiaswarm_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {modules + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "new = {m for m in set(sys.modules) - before if sys.modules[m] is not None}\n"
        "assert not [m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                                  'chiaswarm_tpu')], new\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
