"""chiaswarm_tpu_torch's img2img and inpaint slice against the JAX package.

- `Downsample2D(asymmetric_pad=True)` and the tiny VAE's `encode` against
  the JAX modules (f32 on the CPU, 1e-4 absolute and relative, as
  test_torch_port_models.py: summation order in the convolutions).
- Whole jobs through `SDPipeline`, in JAX and in the port, with the same
  weights and the noise that JAX drew handed to the port: the initial
  latents, each step's ancestral noise (`fold_in(step_rng, i)`) and the
  inpaint keep noise (`fold_in(step_rng, 7919 + i)`), through `latents`
  and `noise_fn`. Jobs: tiny-xl img2img with Euler ancestral (the canvas
  taken from a start image that is resized to it), 4-channel inpaint with
  DPM++ 2M and with Heun, `test/tiny-xl-inpaint` (9 channels) with DDIM
  and `test/tiny-inpaint` (SD, 9 channels) with LCM. The JAX
  pipelines read the port's random weights from safetensors under a
  temporary model root (their own loading path), built once per module;
  the port's pipelines load what JAX holds through
  `weights.from_jax_params`. The decoded uint8 images must agree within
  2/255, as test_tiny_xl_slice_matches_jax (f32 on both sides; rounding
  to uint8 can flip a pixel by one level).
- A mask without an image is the same job error on both sides.
- The port's worker serves a tiny img2img and a tiny inpaint job whose
  start image and mask the fake hive serves.
"""

import asyncio
import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu.models import configs as jax_cfgs
from chiaswarm_tpu.models import layers as jax_layers
from chiaswarm_tpu.models.conversion import convert_vae
from chiaswarm_tpu.models.vae import AutoencoderKL as JaxVAE
from chiaswarm_tpu_torch import weights
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.models import layers
from chiaswarm_tpu_torch.models.vae import AutoencoderKL
from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
from chiaswarm_tpu_torch.settings import Settings

TOL = dict(atol=1e-4, rtol=1e-4)
SIZE = 64


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _random(module, seed=0):
    weights.random_init_(module, torch.Generator().manual_seed(seed))
    return module.eval()


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_downsample_asymmetric_pad():
    port = _random(layers.Downsample2D(8, asymmetric_pad=True))
    params = {"conv": {"kernel": port.conv.weight.detach().numpy().transpose(2, 3, 1, 0),
                       "bias": port.conv.bias.detach().numpy()}}
    x = _rand((2, 9, 10, 8), 1)  # odd and even edges
    want = jax_layers.Downsample2D(8, asymmetric_pad=True).apply({"params": params},
                                                                 jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.shape == (2, 8, 4, 5) and want.shape == (2, 4, 5, 8)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (2, 32, 24, 3)])
def test_tiny_vae_encode(shape):
    make = lambda: AutoencoderKL(cfgs.TINY_VAE)  # noqa: E731
    params = convert_vae(_numpy_sd(_random(make(), 4)))
    pixels = np.tanh(_rand(shape, 9))
    vae = JaxVAE(jax_cfgs.TINY_VAE)
    want = jax.jit(lambda p, x: vae.apply({"params": p}, x, method=vae.encode))(
        params, jnp.asarray(pixels))
    port = make().eval()
    port.load_state_dict(weights.vae_state_dict(params))
    with torch.no_grad():
        got = port.encode(_nchw(pixels))
    assert got.shape == (shape[0], 4, shape[1] // 2, shape[2] // 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


# --- whole jobs against the JAX pipeline ---

def _save_safetensors(pipe, root):
    from safetensors.numpy import save_file

    parts = {"unet": pipe.unet, "vae": pipe.vae}
    for i, enc in enumerate(pipe.text_encoders):
        parts["text_encoder" + ("_2" if i else "")] = enc
    for sub, module in parts.items():
        (root / sub).mkdir(parents=True)
        save_file({k: v.detach().numpy().copy() for k, v in module.state_dict().items()},
                  str(root / sub / "model.safetensors"))


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """{model: (JAX reference, port pipeline)} with equal weights."""
    from chiaswarm_tpu.pipelines.stable_diffusion import SDPipeline as JaxSDPipeline

    root = tmp_path_factory.mktemp("img2img")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDAAS_ROOT", str(root / "sdaas"))
        mp.setenv("CHIASWARM_MODEL_ROOT_DIR", str(root / "models"))
        for model in ("test/tiny-xl", "test/tiny-xl-inpaint", "test/tiny-inpaint"):
            _save_safetensors(SDPipeline(model, device="cpu"), root / "models" / model)
            reference = JaxSDPipeline(model)
            params = jax.tree_util.tree_map(np.asarray, reference.params)
            out[model] = (reference, SDPipeline(model, device="cpu",
                                                weights=weights.from_jax_params(params)))
    return out


def _start_image(w=96, h=80):
    """A smooth image whose size is not the canvas (96x80 -> 64x64)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 7 + yy / 11)], -1)
    return Image.fromarray((255 * rgb).astype(np.uint8))


def _mask(size=SIZE):
    """White (repaint) over a disc, black elsewhere, a soft rim between."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r = np.hypot(xx - size * 0.4, yy - size * 0.55)
    return Image.fromarray(np.clip(255 * (size * 0.35 - r) / 4, 0, 255).astype(np.uint8), "L")


def _jax_noise(seed):
    """The JAX pipeline's draws for a job seeded `seed` -> (initial latents
    NCHW, noise_fn): split(rng, 3), init_rng's NHWC normal, and step_rng
    folded with i (step noise) or 7919 + i (keep noise)."""
    _, init_rng, step_rng = jax.random.split(jax.random.key(seed), 3)

    def nhwc(key, shape):
        n, c, h, w = shape
        return np.asarray(jax.random.normal(key, (n, h, w, c), jnp.float32)).transpose(0, 3, 1, 2)

    def noise_fn(kind, i, shape):
        return nhwc(jax.random.fold_in(step_rng, i if kind == "step" else 7919 + i), shape)

    return nhwc(init_rng, (1, 4, SIZE // 2, SIZE // 2)), noise_fn


@pytest.mark.parametrize("model,mode,job", [
    ("test/tiny-xl", "img2img",
     dict(scheduler_type="EulerAncestralDiscreteScheduler", strength=0.75)),
    ("test/tiny-xl", "inpaint",
     dict(scheduler_type="DPMSolverMultistepScheduler", strength=0.75, mask=True,
          height=SIZE, width=SIZE)),
    ("test/tiny-xl-inpaint", "inpaint9",
     dict(scheduler_type="DDIMScheduler", mask=True, height=SIZE, width=SIZE)),
    # Heun's doubled index space under inpaint's re-noising of the kept
    # region; the SD (non-XL) 9-channel stand-in with an ancestral solver
    ("test/tiny-xl", "inpaint",
     dict(scheduler_type="HeunDiscreteScheduler", strength=0.5, mask=True)),
    ("test/tiny-inpaint", "inpaint9", dict(scheduler_type="LCMScheduler", mask=True)),
])
def test_slice_matches_jax(pipelines, model, mode, job):
    reference, port = pipelines[model]
    seed = 21
    job = dict(job, prompt="a red cube on a table", negative_prompt="blurry",
               num_inference_steps=4, guidance_scale=6.0, image=_start_image())
    if job.pop("mask", False):
        job["mask_image"] = _mask()
    want, want_cfg = reference.run(rng=jax.random.key(seed), **job)
    latents, noise_fn = _jax_noise(seed)
    got, config = port.run(latents=latents, noise_fn=noise_fn, **job)

    assert config["mode"] == want_cfg["mode"] == mode
    assert config["size"] == want_cfg["size"] == [SIZE, SIZE]
    assert config["latents"]["finite"] and "image_encode_s" in config["timings"]
    want = np.asarray(want[0], np.int16)
    got = np.asarray(got[0], np.int16)
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    assert np.abs(got - want).max() <= 2


def test_mask_without_image_is_a_job_error(pipelines):
    reference, port = pipelines["test/tiny-xl"]
    for pipe in (reference, port):
        with pytest.raises(ValueError, match="inpaint requires an init image"):
            pipe.run(prompt="x", num_inference_steps=2, mask_image=_mask())


# --- the worker, with inputs served by the fake hive ---

def _png(image) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "PNG")
    return buf.getvalue()


def test_worker_serves_tiny_img2img_and_inpaint(tmp_path):
    hive = FakeHive(token="tok")
    try:
        start_uri = hive.enqueue_file("start.png", _png(_start_image()), "image/png")
        mask_uri = hive.enqueue_file("mask.png", _png(_mask()), "image/png")
        settings = Settings(sdaas_token="tok", sdaas_uri=hive.uri, worker_name="port-test",
                            model_root_dir=str(tmp_path / "models"))
        worker = worker_mod.Worker(settings=settings, device="cpu", poll_seconds=0.01)
        common = {"model_name": "stabilityai/stable-diffusion-xl-base-1.0", "prompt": "a cat",
                  "num_inference_steps": 3, "seed": 5, "content_type": "image/png",
                  "start_image_uri": start_uri}
        hive.enqueue(
            {"id": "i2i", "workflow": "img2img", "strength": 0.6,
             "parameters": {"test_tiny_model": True, "scheduler_type": "HeunDiscreteScheduler",
                            "large_model": True}, **common},
            {"id": "inp", "workflow": "inpaint", "mask_image_uri": mask_uri,
             "parameters": {"test_tiny_model": True, "scheduler_type": "LCMScheduler"},
             **common},
        )
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=2), timeout=120))
        results = {r["id"]: r for r in hive.wait_for_results(2, timeout=10)}
    finally:
        hive.close()
    for job_id, mode, pipeline in (("i2i", "img2img", "StableDiffusionXLImg2ImgPipeline"),
                                   ("inp", "inpaint", "StableDiffusionInpaintPipeline")):
        result = results[job_id]
        assert not result.get("fatal_error"), result["pipeline_config"]
        config = result["pipeline_config"]
        assert config["mode"] == mode and config["pipeline"] == pipeline
        assert config["model"] == "test/tiny-xl" and config["size"] == [SIZE, SIZE]
        assert config["latents"]["finite"] and "image_encode_s" in config["timings"]
        blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
        image = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
        assert image.shape == (SIZE, SIZE, 3) and image.max() != image.min()
    assert results["i2i"]["pipeline_config"]["t_start"] == 1
    assert results["inp"]["pipeline_config"]["t_start"] == 0


def test_chip_smoke_image_phases_rehearse_on_cpu():
    """chip_smoke.py's image phases at a tiny size on the CPU: phase 4's
    image checks pass (the CPU against itself), and the served image path
    passes every envelope check, then fails its launch-count check, as it
    must where no kernel runs."""
    import importlib.util
    from pathlib import Path

    from chiaswarm_tpu_torch.registry import Registry

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    checks = smoke.tiny_image_checks(device="cpu")
    assert len(checks) == 3 + 11 and all(c["max_pixel_diff"] == 0 for c in checks.values())
    assert sum("kept_equal" in c for c in checks.values()) == 12
    with pytest.raises(smoke.SmokeFailure, match="flash_attention was never launched on the "
                                                 "image path"):
        smoke.serve_image_path("cpu", Registry(torch.device("cpu")),
                               {"flash_attention": 0, "group_norm": 0}, device="cpu",
                               model="test/tiny-xl", inpaint_model="test/tiny-xl-inpaint",
                               size=SIZE, steps=3)
