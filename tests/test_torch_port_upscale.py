"""chiaswarm_tpu_torch's SD-x2 latent upscaler (the `upscale` parameter and
standalone StableDiffusionLatentUpscalePipeline jobs) against the JAX
package.

- `KUpscalerConfig` and `TINY_K_UPSCALER` equal JAX's; the port's seeded
  K-UNet converted by the JAX package's `convert_k_upscaler` and back by
  `weights.from_jax_params` (the same tensors), and the two modules on
  those parameters, f32 on the CPU, within 1e-4 absolute and relative (as
  test_torch_port_models.py; the JAX package holds its module to a torch
  mirror within 3e-4 / 1e-3).
- The configs read off a checkpoint's shapes (`infer_k_upscaler_config`,
  `infer_vae_config`) equal what the JAX loader infers from the same
  tensors; a checkpoint in the diffusers layout loads, and serves what the
  same weights given directly serve, bit for bit.
- CLIP's state before the final LayerNorm (`apply_final_norm=False`)
  against JAX's, 1e-5; the upscaler's Euler-in-sample scheduler (its
  sigmas, init_noise_sigma, scale_model_input and step) against JAX's,
  1e-6, with and without the checkpoint's betas.
- Whole stages, the port's seeded tiny-sd and tiny-width upscaler (a
  three-level tiny VAE, to keep the 20 chained steps cheap) written
  as safetensors under a model root that both packages load (the
  upscaler under its production name, since the JAX package random-inits
  a test name's), with the noise JAX drew handed to the port
  (`normal(key, (B, 2h, 2w, C))` NHWC; in the chain `key =
  fold_in(split(key(seed), 3)[0], 0x5d2)`): the standalone `run()` (over
  `upscale()`) and a tiny SD txt2img job with `upscale: true` through
  `diffusion_callback`, both at the chain's 20 steps on a 64² image, so
  that one JAX compile serves both. The decoded uint8
  images agree within 2/255 (f32 on both sides; rounding to uint8 can
  flip a level), and the envelope's `size`, `output_size`, `upscaled` and
  `upscale_s` are JAX's.
- The latent-resize fallback (`_latent2x`) against JAX's
  `_latent2x_impl`, 2/255; a job whose upscaler has no weights is served
  through it and says `upscaler: latent-resize-fallback`.
- The registry builds the upscaler by wire name and by model name, in the
  same LRU of four; a production upscaler without files raises
  MissingWeightsError; upscale jobs stay out of coalesced passes, as in
  JAX; the worker serves a standalone upscale job through the fake hive,
  checked by the tiny safety checker.
"""

import asyncio
import base64
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu import coalesce as jax_coalesce
from chiaswarm_tpu import registry as jax_registry
from chiaswarm_tpu.models import clip as jax_clip
from chiaswarm_tpu.models import configs as jax_cfgs
from chiaswarm_tpu.models import conversion as jax_conversion
from chiaswarm_tpu.models import k_upscaler as jax_k
from chiaswarm_tpu.pipelines import stable_diffusion as jax_sd
from chiaswarm_tpu.pipelines import upscale as jax_up
from chiaswarm_tpu_torch import coalesce, weights
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.job_arguments import format_args
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.models.clip import CLIPTextEncoder
from chiaswarm_tpu_torch.models.k_upscaler import (
    TINY_K_UPSCALER,
    KUpscalerConfig,
    KUpscalerUNet,
)
from chiaswarm_tpu_torch.models.vae import AutoencoderKL
from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
from chiaswarm_tpu_torch.pipelines.upscale import (
    TINY_UPSCALER,
    UPSCALER,
    LatentUpscalePipeline,
    upscaler_name_for,
)
from chiaswarm_tpu_torch.registry import Registry, job_family
from chiaswarm_tpu_torch.settings import Settings
from chiaswarm_tpu_torch.weights import MissingWeightsError, from_jax_params
from chiaswarm_tpu_torch.workflows.diffusion import diffusion_callback

TOL = dict(atol=1e-4, rtol=1e-4)
SIZE = 64
UPSCALE_STEPS = 20  # the chain's
CPU = torch.device("cpu")
# the tiny VAE with a third level: the 2x latents of a SIZE² image are then
# SIZE/2 a side, and the tiny K-UNet's self-attention holds 256 tokens,
# not 1024, which keeps the chain's 20 steps cheap on the CPU
UPSCALER_VAE = dataclasses.replace(cfgs.TINY_VAE, block_out_channels=(32, 32, 32))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("port,ref", [(KUpscalerConfig(), jax_k.KUpscalerConfig()),
                                      (TINY_K_UPSCALER, jax_k.TINY_K_UPSCALER)])
def test_configs_match_jax(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _state(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _seeded(module, seed):
    weights.random_init_(module, torch.Generator().manual_seed(seed))
    return module.eval()


def test_k_unet_matches_jax():
    """The port's seeded K-UNet read by the JAX converter, run by the JAX
    module; its parameters back through from_jax_params are the port's."""
    port = _seeded(KUpscalerUNet(TINY_K_UPSCALER), 5)
    with torch.no_grad():
        port.time_proj.weight.normal_(0.0, 16.0, generator=torch.Generator().manual_seed(6))
    state = _state(port)
    _, params = jax_conversion.convert_k_upscaler(state, {"attention_head_dim": 8,
                                                          "resnet_group_size": 16})
    back = from_jax_params({"k_unet": params})["k_unet"]
    assert set(back) == set(state)
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), state[key], err_msg=key)
    x, ctx, cond = _rand((3, 16, 16, 8), 1), _rand((3, 7, 32), 2), _rand((3, 48), 3)
    t = np.asarray([-0.55, 0.6, 1.2], np.float32)
    want = jax.jit(jax_k.KUpscalerUNet(jax_k.TINY_K_UPSCALER).apply)(
        {"params": params}, x, t, ctx, cond)
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), torch.from_numpy(cond))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_checkpoint_configs_inferred_as_jax(tmp_path):
    from safetensors.numpy import save_file

    cj = {"attention_head_dim": 8, "resnet_group_size": 16}
    files = {}
    for name, module in (("unet", KUpscalerUNet(TINY_K_UPSCALER)),
                         ("vae", AutoencoderKL(cfgs.TINY_VAE))):
        files[name] = tmp_path / name / "model.safetensors"
        files[name].parent.mkdir()
        save_file(_state(module), str(files[name]))
    unet_cfg = weights.infer_k_upscaler_config(weights.checkpoint_shapes([files["unet"]]), cj)
    vae_cfg = weights.infer_vae_config(weights.checkpoint_shapes([files["vae"]]),
                                       {"scaling_factor": 0.18215})
    assert unet_cfg == TINY_K_UPSCALER and vae_cfg == cfgs.TINY_VAE
    want_unet = jax_conversion.infer_k_upscaler_config(
        jax_conversion.load_torch_state_dict(tmp_path, "unet"), cj)
    assert dataclasses.asdict(unet_cfg) == dataclasses.asdict(want_unet)
    want_vae = jax_conversion.infer_vae_config(
        jax_conversion.load_torch_state_dict(tmp_path, "vae"), {"scaling_factor": 0.18215})
    assert {k: v for k, v in dataclasses.asdict(vae_cfg).items() if k != "shift_factor"} == {
        k: v for k, v in dataclasses.asdict(want_vae).items() if k != "shift_factor"}


def test_clip_before_the_final_norm_matches_jax():
    cfg = dataclasses.replace(cfgs.TINY_CLIP, apply_final_norm=False)
    jax_cfg = dataclasses.replace(jax_cfgs.TINY_CLIP, apply_final_norm=False)
    ids = np.asarray(np.random.default_rng(6).integers(0, 999, (2, 77)), np.int64)
    ids[:, 9:] = 999  # EOS then padding
    port = _seeded(CLIPTextEncoder(cfg), 7)
    params = jax_conversion.convert_clip(_state(port))
    want = jax.jit(jax_clip.CLIPTextEncoder(jax_cfg).apply)({"params": params},
                                                            ids.astype(np.int32))
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
        normed = CLIPTextEncoder(cfgs.TINY_CLIP).eval()
        normed.load_state_dict(port.state_dict())
        normed = normed(torch.from_numpy(ids))["hidden_states"]
    for key in ("hidden_states", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=1e-5)
    # the option is not a no-op: the normed state differs
    assert not torch.allclose(normed, got["hidden_states"])


@pytest.mark.parametrize("scheduler_json", [
    {}, {"prediction_type": "sample", "beta_start": 0.0001, "beta_end": 0.02,
         "beta_schedule": "linear"}])
def test_upscale_scheduler_matches_jax(scheduler_json):
    pipe = LatentUpscalePipeline.__new__(LatentUpscalePipeline)
    pipe.scheduler_json = scheduler_json
    port = pipe.scheduler()
    ref_pipe = jax_up.LatentUpscalePipeline.__new__(jax_up.LatentUpscalePipeline)
    ref_pipe.scheduler_json = scheduler_json
    ref = ref_pipe._scheduler()
    assert port.config.prediction_type == ref.config.prediction_type == "sample"
    ps, rs = port.schedule(UPSCALE_STEPS), ref.schedule(UPSCALE_STEPS)
    np.testing.assert_allclose(ps.sigmas, rs.sigmas, rtol=1e-6)
    assert ps.init_noise_sigma == pytest.approx(rs.init_noise_sigma, rel=1e-6)
    x, x0 = _rand((1, 4, 8, 8), 8), _rand((1, 4, 8, 8), 9)
    for i in (0, 7, UPSCALE_STEPS - 1):
        np.testing.assert_allclose(
            port.scale_model_input(ps, torch.from_numpy(x), i).numpy(),
            np.asarray(ref.scale_model_input(rs, jnp.asarray(x), i)), rtol=1e-6)
        _, got = port.step(ps, (), i, torch.from_numpy(x), torch.from_numpy(x0))
        _, want = ref.step(rs, ref.init_state(x.shape, jnp.float32), i, jnp.asarray(x),
                           jnp.asarray(x0), None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# --- whole stages against the JAX pipelines, on JAX's weights ---

class _Registry:
    """The worker's registry over pipelines built by hand; an upscaler
    named in `missing` has no weights."""

    def __init__(self, pipelines: dict, missing=()):
        self.pipelines, self.missing = pipelines, set(missing)

    def get_pipeline(self, model_name, allow_random_init=False, pipeline_type=None):
        if model_name in self.missing:
            raise MissingWeightsError(f"no weights for {model_name}")
        return self.pipelines[model_name]

    def safety_checker(self):
        raise RuntimeError("no checker here")


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def write_upscaler(pipe, repo, scheduler=None) -> None:
    """The pipeline's weights in the diffusers layout, f32, with the
    config.json files that say its widths (chip_smoke.py's writer)."""
    _chip_smoke().write_upscaler(pipe, repo, scheduler, dtype=torch.float32)


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """(JAX tiny-sd, JAX upscaler, port tiny-sd, port upscaler, model root):
    the port's seeded tiny-sd and tiny upscaler (its VAE UPSCALER_VAE)
    written under a model root
    (the upscaler under the production name, whose folder the JAX loader
    reads), and each package's pipelines loading them."""
    from safetensors.numpy import save_file

    root = tmp_path_factory.mktemp("upscale")
    models = root / "models"
    seeded = SDPipeline("test/tiny-sd", device="cpu")
    for sub, module in (("unet", seeded.unet), ("vae", seeded.vae),
                        ("text_encoder", seeded.text_encoders[0])):
        (models / "test/tiny-sd" / sub).mkdir(parents=True)
        save_file(_state(module), str(models / "test/tiny-sd" / sub / "model.safetensors"))
    upscaler = LatentUpscalePipeline(TINY_UPSCALER, device="cpu")
    upscaler.vae = _seeded(AutoencoderKL(UPSCALER_VAE), 16)
    write_upscaler(upscaler, models / UPSCALER)
    mp = pytest.MonkeyPatch()
    mp.setenv("SDAAS_ROOT", str(root / "sdaas"))
    mp.setenv("CHIASWARM_MODEL_ROOT_DIR", str(models))
    jax_registry.clear_cache()
    ref_sd = jax_sd.SDPipeline("test/tiny-sd")
    ref_up = jax_registry.get_pipeline(UPSCALER, "StableDiffusionLatentUpscalePipeline")
    port_sd = SDPipeline("test/tiny-sd", device="cpu", model_root_dir=str(models))
    port_up = LatentUpscalePipeline(UPSCALER, device="cpu", model_root_dir=str(models))
    assert port_sd.weights_source == port_up.weights_source == "checkpoint"
    assert port_up.unet.config == TINY_K_UPSCALER
    yield ref_sd, ref_up, port_sd, port_up, models
    jax_registry.clear_cache()
    mp.undo()


def start_image(w=SIZE, h=SIZE):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 5 + yy / 9)], -1)
    return Image.fromarray((255 * rgb).astype(np.uint8))


def _upscale_noise(key, side=SIZE // 2):
    """JAX's initial draw of the fixture's upscaler on a SIZE² image (2x
    latents `side` a side), NCHW."""
    return np.asarray(jax.random.normal(key, (1, side, side, 4), jnp.float32)).transpose(
        0, 3, 1, 2)


def _close(got, want):
    got, want = np.asarray(got, np.int16), np.asarray(want, np.int16)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2


def test_standalone_run_matches_jax(stages):
    _, ref_up, _, port_up, _ = stages
    key = jax.random.key(12)
    # the chain's step count and input size: one JAX compile serves both
    job = dict(prompt="a red fox", image=start_image(), num_inference_steps=UPSCALE_STEPS)
    want, want_cfg = ref_up.run(rng=key, **job)
    got, config = port_up.run(latents=_upscale_noise(key), seed=12, **job)
    _close(got[0], want[0])
    for field in ("mode", "size", "steps", "scheduler", "pipeline"):
        assert config[field] == want_cfg[field], field
    assert config["size"] == [2 * SIZE, 2 * SIZE] and config["latents"]["finite"]
    with pytest.raises(ValueError, match="requires an input image"):
        port_up.run(prompt="x")


def _pixels(artifacts):
    blob = base64.b64decode(artifacts["primary"]["blob"])
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def test_txt2img_with_upscale_matches_jax(stages, monkeypatch):
    ref_sd, _, port_sd, port_up, _ = stages
    # JAX's tiny SD chains the tiny upscaler, random-initialised by JAX
    # alone: point its chain at the upscaler both packages read from files
    monkeypatch.setattr(jax_up, "upscaler_name_for", lambda name: UPSCALER)
    seed = 13
    job = dict(prompt="a lighthouse at dusk", negative_prompt="blurry", num_inference_steps=2,
               height=SIZE, width=SIZE, guidance_scale=6.0)
    want, want_cfg = ref_sd.run(rng=jax.random.key(seed), upscale=True, **job)
    rest, init_rng, _ = jax.random.split(jax.random.key(seed), 3)
    latents = np.asarray(jax.random.normal(init_rng, (1, SIZE // 2, SIZE // 2, 4), jnp.float32))
    registry = _Registry({"test/tiny-sd": port_sd, TINY_UPSCALER: port_up})
    artifacts, config = diffusion_callback(
        "cpu", "test/tiny-sd", registry=registry, seed=seed, upscale=True,
        content_type="image/png", latents=latents.transpose(0, 3, 1, 2),
        upscale_latents=_upscale_noise(jax.random.fold_in(rest, 0x5D2)), **job)
    _close(_pixels(artifacts), want[0])
    for field in ("size", "output_size", "upscaled", "mode"):
        assert config[field] == want_cfg[field], field
    assert config["output_size"] == [2 * SIZE, 2 * SIZE] and "upscaler" not in config
    assert "upscale_s" in config["timings"] and "upscale_s" in want_cfg["timings"]
    # the checker that raises leaves the job served, unchecked
    assert (config["nsfw"], config["nsfw_checked"]) == (False, False)


def test_qr_two_stage_with_upscale_matches_jax(stages, monkeypatch):
    """The QR two-stage chain with `upscale`: JAX hands the job's arguments
    to both stages, so the first stage's image is upscaled 2x (then resized
    to the canvas, LANCZOS) and the second's is too. Each stage's draws
    are JAX's (split(key(seed), 3)[1] to the first, [2] to the second;
    each stage's upscale from fold_in(its own rest key, 0x5d2)), the
    ControlNet nonzero, the images within 2/255 (the ControlNet file's
    QR-chain bound)."""
    ref_sd, _, port_sd, port_up, models = stages
    monkeypatch.setattr(jax_up, "upscaler_name_for", lambda name: UPSCALER)
    cn = "test/qr-controlnet"
    _chip_smoke().write_controlnet(models / cn, port_sd, seed=81)
    seed = 14
    qr = Image.fromarray(np.where(np.indices((SIZE, SIZE)).sum(0) % 16 < 8, 255, 0)
                         .astype(np.uint8)).convert("RGB")
    job = dict(prompt="a walled garden", negative_prompt="blurry", num_inference_steps=2,
               height=SIZE, width=SIZE, guidance_scale=6.0, strength=0.5, image=qr,
               controlnet_model_name=cn, controlnet_conditioning_scale=0.8,
               controlnet_prepipeline_type="StableDiffusionPipeline", upscale=True)
    want, want_cfg = ref_sd.run(rng=jax.random.key(seed), **job)
    _, k1, k2 = jax.random.split(jax.random.key(seed), 3)

    def draws(key):
        rest, init_rng, _ = jax.random.split(key, 3)
        init = np.asarray(jax.random.normal(init_rng, (1, SIZE // 2, SIZE // 2, 4), jnp.float32))
        return init.transpose(0, 3, 1, 2), _upscale_noise(jax.random.fold_in(rest, 0x5D2))

    pre_latents, pre_upscale = draws(k1)
    latents, upscale_latents = draws(k2)
    registry = _Registry({"test/tiny-sd": port_sd, TINY_UPSCALER: port_up})
    got, cfg = port_sd.run(registry=registry, seed=seed, latents=latents,
                           upscale_latents=upscale_latents, prepipeline_latents=pre_latents,
                           prepipeline_upscale_latents=pre_upscale, **job)
    assert cfg["prepipeline"] == want_cfg["prepipeline"] == "qr_two_stage"
    for field in ("size", "output_size", "upscaled", "mode"):
        assert cfg[field] == want_cfg[field], field
    assert cfg["output_size"] == [2 * SIZE, 2 * SIZE] and cfg["controlnet"] == cn
    _close(got[0], want[0])


def test_latent2x_matches_jax(stages):
    ref_sd, _, port_sd, _, _ = stages
    image = np.asarray(start_image())
    px = jnp.asarray(image, jnp.float32)[None] / 127.5 - 1.0
    want = np.asarray(ref_sd._latent2x_impl(ref_sd.params["vae"], px))[0]
    got = port_sd._latent2x(image, SIZE, SIZE, port_sd.vae)
    assert got.shape == (2 * SIZE, 2 * SIZE, 3)
    _close(got, want)


def test_upscale_without_weights_falls_back_to_latent_resize(stages):
    _, _, port_sd, _, _ = stages
    registry = _Registry({"test/tiny-sd": port_sd}, missing={TINY_UPSCALER})
    job = dict(prompt="a lighthouse", num_inference_steps=2, height=SIZE, width=SIZE, seed=14)
    images, config = port_sd.run(registry=registry, upscale=True, **job)
    base, _ = port_sd.run(**job)
    assert config["upscaler"] == "latent-resize-fallback" and config["upscaled"]
    assert config["output_size"] == [2 * SIZE, 2 * SIZE] and "upscale_s" in config["timings"]
    np.testing.assert_array_equal(images[0], port_sd._latent2x(base[0], SIZE, SIZE,
                                                               port_sd.vae))
    with pytest.raises(ValueError, match="registry"):
        port_sd.run(upscale=True, **job)


# --- residency, weights, wire ---

@pytest.mark.parametrize("name,pipeline_type", [
    ("test/tiny-upscaler", "DiffusionPipeline"),
    ("stabilityai/sd-x2-latent-upscaler", "AutoPipelineForText2Image"),
    ("test/tiny-sd", "StableDiffusionLatentUpscalePipeline"),
    ("test/tiny-upscaler", "StableDiffusionPipeline"),
    ("runwayml/stable-diffusion-v1-5", "DiffusionPipeline"),
])
def test_upscaler_family_as_jax(name, pipeline_type):
    if pipeline_type.startswith("AutoPipeline") or pipeline_type == "DiffusionPipeline":
        family = jax_registry._auto_family(name)
    else:
        family = jax_registry.family_of(pipeline_type)
    assert (job_family(name, pipeline_type) == "sd_upscale") == (family == "sd_upscale")


def test_upscaler_name_for_matches_jax():
    for name in ("test/tiny-sd", "test/tiny-xl", "runwayml/stable-diffusion-v1-5",
                 "stabilityai/stable-diffusion-xl-base-1.0"):
        assert upscaler_name_for(name) == jax_up.upscaler_name_for(name)


def test_registry_keeps_upscalers_in_its_lru(tmp_path):
    registry = Registry(CPU, str(tmp_path))
    up = registry.get_pipeline("test/tiny-upscaler")
    as_upscaler = registry.get_pipeline("test/tiny-sd",
                                        pipeline_type="StableDiffusionLatentUpscalePipeline")
    sd = registry.get_pipeline("test/tiny-sd")
    assert isinstance(up, LatentUpscalePipeline) and isinstance(as_upscaler, LatentUpscalePipeline)
    assert isinstance(sd, SDPipeline) and registry.get_pipeline("test/tiny-upscaler") is up
    for filler in ("test/tiny-xl", "test/tiny-inpaint"):
        registry.get_pipeline(filler)
    # the fifth pipeline evicted the least recently used: the upscaler of
    # test/tiny-sd's name, whose weights went with it
    assert as_upscaler.unet is None and up.unet is not None
    with pytest.raises(RuntimeError, match="evicted"):
        as_upscaler.upscale([start_image()], steps=1)


def test_production_upscaler_without_files_raises(tmp_path):
    name = "stabilityai/sd-x2-latent-upscaler"
    with pytest.raises(MissingWeightsError, match="latent upscaler"):
        LatentUpscalePipeline(name, device="cpu", model_root_dir=str(tmp_path))
    (tmp_path / name / "unet").mkdir(parents=True)
    (tmp_path / name / "unet" / "model.safetensors").write_bytes(b"")
    with pytest.raises(MissingWeightsError):
        Registry(CPU, str(tmp_path)).get_pipeline(name)


def test_upscaler_checkpoint_reads_as_in_jax(stages, tmp_path):
    """The fixture's checkpoint: the configs and the scheduler config that
    the port reads equal the JAX loader's, and the loaded pipeline serves
    what the same weights given directly serve, bit for bit."""
    _, _, _, port_up, models = stages
    ucfg, _, ccfg, _, vcfg, _, sj = jax_up.convert_upscaler_checkpoint(models / UPSCALER)
    assert dataclasses.asdict(ucfg) == dataclasses.asdict(port_up.unet.config)
    assert (ccfg.hidden_size, ccfg.num_layers, ccfg.hidden_act, ccfg.apply_final_norm) == (
        32, 2, "gelu", False)
    assert vcfg.block_out_channels == port_up.vae.config.block_out_channels
    assert sj == port_up.scheduler_json == {} and port_up.checkpoint["bytes"] > 0
    # the tiny upscaler written and read back serves what its weights
    # given directly serve
    seeded = LatentUpscalePipeline(TINY_UPSCALER, device="cpu")
    write_upscaler(seeded, tmp_path / UPSCALER)
    loaded = LatentUpscalePipeline(UPSCALER, device="cpu", model_root_dir=str(tmp_path))
    given = LatentUpscalePipeline(TINY_UPSCALER, device="cpu", weights={
        "unet": seeded.unet.state_dict(), "text": [seeded.text_encoder.state_dict()],
        "vae": seeded.vae.state_dict()})
    noise = _rand((1, 4, SIZE, SIZE), 15)
    np.testing.assert_array_equal(given.upscale([start_image()], steps=2, latents=noise)[0],
                                  loaded.upscale([start_image()], steps=2, latents=noise)[0])
    # a scheduler config with its own betas is read
    sched = {"prediction_type": "sample", "beta_start": 0.0001, "beta_end": 0.02,
             "beta_schedule": "linear"}
    write_upscaler(seeded, tmp_path / UPSCALER, sched)
    assert LatentUpscalePipeline(UPSCALER, device="cpu",
                                 model_root_dir=str(tmp_path)).scheduler_json == sched


def test_upscale_jobs_stay_solo_as_in_jax(tmp_path):
    base = {"workflow": "txt2img", "model_name": "runwayml/stable-diffusion-v1-5",
            "prompt": "x", "height": 512, "width": 512}
    for job in ({**base, "parameters": {"upscale": True}}, {**base, "upscale": True}):
        assert coalesce.coalesce_key(job) is None and jax_coalesce.coalesce_key(job) is None
    _, args = format_args({**base, "parameters": {"upscale": True}},
                          Settings(lora_root_dir=str(tmp_path)))
    assert args["upscale"] is True


# --- the worker ---

def test_worker_serves_upscale_jobs(tmp_path):
    hive = FakeHive(token="tok")
    try:
        buf = io.BytesIO()
        start_image().save(buf, "PNG")
        start_uri = hive.enqueue_file("start.png", buf.getvalue(), "image/png")
        settings = Settings(sdaas_token="tok", sdaas_uri=hive.uri, worker_name="port-test",
                            model_root_dir=str(tmp_path / "models"),
                            safety_checker_model="test/tiny-safety")
        worker = worker_mod.Worker(settings=settings, device="cpu", poll_seconds=0.01)
        common = {"prompt": "a lighthouse", "num_inference_steps": 2, "seed": 5,
                  "content_type": "image/png"}
        hive.enqueue(
            {"id": "up", "workflow": "img2img", "model_name": "stabilityai/sd-x2-latent-upscaler",
             "start_image_uri": start_uri,
             "parameters": {"test_tiny_model": True,
                            "pipeline_type": "StableDiffusionLatentUpscalePipeline"}, **common})
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=1), timeout=120))
        up = hive.wait_for_results(1, timeout=10)[0]
    finally:
        hive.close()
    config = up["pipeline_config"]
    assert not up.get("fatal_error"), config
    assert config["nsfw_checked"] is True and config["mode"] == "upscale"
    assert config["size"] == [2 * SIZE, 2 * SIZE]
    assert _pixels(up["artifacts"]).shape == (2 * SIZE, 2 * SIZE, 3)
    # the standalone job ran the upscaler built under the stand-in's name
    pipe = worker.registry.get_pipeline("test/tiny-sd",
                                        pipeline_type="StableDiffusionLatentUpscalePipeline")
    want, _ = pipe.run(prompt="a lighthouse", image=start_image(), num_inference_steps=2,
                       seed=5)
    np.testing.assert_array_equal(_pixels(up["artifacts"]), want[0])


def test_chip_smoke_upscale_path_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's upscale and safety path with tiny stand-ins on the
    CPU: the upscaler (tiny widths under the production name, which the
    tiny models' chain is pointed at: a test name's upscaler never reads
    files) and the checker written and read back, the checker called
    directly, every envelope checked (nsfw_checked, 2x images, no fallback
    but on the weightless job, which falls back after the upscaler's
    eviction); launches are printed, not held (no kernel runs here)."""
    from chiaswarm_tpu_torch.pipelines import stable_diffusion

    monkeypatch.setattr(stable_diffusion, "upscaler_name_for", lambda name: UPSCALER)
    smoke = _chip_smoke()
    paths, served = smoke.serve_upscale_path(
        "cpu", {"flash_attention": 0, "group_norm": 0}, device="cpu", sdxl="test/tiny-xl",
        sd15="test/tiny-sd", size_xl=64, size15=64, steps=2, up_steps=2, hold=False,
        seed_upscaler=TINY_UPSCALER, checker="test/tiny-safety-smoke",
        fillers=("test/tiny-inpaint", "test/tiny-pix2pix"))
    jobs = served["jobs"]
    assert set(paths) == {"up_sd15_plain", "up_sd15", "up_sdxl_plain", "up_sdxl",
                          "up_standalone", "up_fallback"}
    assert all(job["nsfw_checked"] for job in jobs.values())
    assert [job_id for job_id, job in jobs.items() if job["upscaler"]] == ["up-fallback"]
    assert {job_id: job["output"] for job_id, job in jobs.items()} == {
        "up-sd15-plain": 64, "up-sd15": 128, "up-sdxl-plain": 64, "up-sdxl": 128,
        "up-standalone": 128, "up-fallback": 128}
    assert jobs["up-sd15"]["k_unet_calls"] == smoke.UPSCALE_STEPS
    assert served["files"]["upscaler_load"]["bytes"] > 0
    assert set(served["profile"]) == {"checker", "k_unet_128", "k_unet_128", "vae_decode_64",
                                      "vae_decode_128"}
