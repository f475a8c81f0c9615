"""chiaswarm_tpu_torch's instruct-pix2pix mode and SDXL refiner chain against
the JAX package.

- `family_configs` for the edit checkpoints (8 input channels) and the
  SDXL refiner (its own UNet, OpenCLIP-bigG alone, five time ids) against
  the JAX pipeline's `_family_configs`, and the refiner at its published
  widths.
- A UNet of the refiner's structure at small widths (four levels, the
  first and last plain, four transformer layers where there are any, five
  time ids after a pooled embedding of one encoder) against the JAX
  module, f32 on the CPU, 1e-4 absolute and relative as
  test_torch_port_models.py (summation order in the convolutions).
- Whole jobs, in JAX and in the port, on the same weights: the port's
  seeded weights written as safetensors under a temporary model root,
  which the JAX pipelines read through their own loader and the port
  through `Registry` (so these jobs also load checkpoints). The noise that
  JAX drew is handed to the port: the initial latents (`split(rng, 3)`'s
  init key), each step's ancestral noise (`fold_in(step_rng, i)`), and for
  the refiner's stage the same draws from the key the base stage hands on
  (`split(rng, 3)[0]`). Jobs: tiny SD pix2pix (DPM++ 2M) and tiny SDXL
  pix2pix (Euler ancestral) at 64², 4 steps; tiny-xl with the tiny refiner
  chained (strength 0.5). The decoded uint8 images agree within 2/255 (f32
  on both sides; rounding to uint8 can flip a pixel by one level).
- A pix2pix job on a plain checkpoint runs as img2img and says so;
  ControlNet with an edit checkpoint is refused, as in JAX.
- The port's worker serves a tiny pix2pix job (strength 0.3 -> image
  guidance 1.5) and a tiny txt2img job with a refiner, their inputs served
  by the fake hive.
"""

import asyncio
import base64
import dataclasses
import io
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu import registry as jax_registry
from chiaswarm_tpu.models import configs as jax_cfgs
from chiaswarm_tpu.models.conversion import convert_unet
from chiaswarm_tpu.models.unet2d import UNet2DConditionModel as JaxUNet
from chiaswarm_tpu.pipelines import stable_diffusion as jax_sd
from chiaswarm_tpu_torch import weights
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.models.unet2d import UNet2DConditionModel
from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline, family_configs
from chiaswarm_tpu_torch.registry import Registry
from chiaswarm_tpu_torch.settings import Settings

TOL = dict(atol=1e-4, rtol=1e-4)
SIZE = 64
REFINER = "stabilityai/stable-diffusion-xl-refiner-1.0"
TINY_MODELS = ("test/tiny-pix2pix", "test/tiny-xl-pix2pix", "test/tiny-xl",
               "test/tiny-xl-refiner")


def _same_config(port_cfg, jax_cfg):
    ref = dataclasses.asdict(jax_cfg)
    for key, value in dataclasses.asdict(port_cfg).items():
        assert ref[key] == value, key


@pytest.mark.parametrize("name", ["timbrooks/instruct-pix2pix",
                                  "diffusers/sdxl-instructpix2pix-768", REFINER,
                                  "test/tiny-pix2pix", "test/tiny-xl-pix2pix",
                                  "test/tiny-xl-refiner", "someone/sd-ip2p-inpaint"])
def test_family_configs_match_jax(name, tmp_path):
    unet, clips, vae, size, pred = family_configs(name, str(tmp_path))
    j_unet, j_clips, j_vae, j_size, j_pred = jax_sd._family_configs(name)
    _same_config(unet, j_unet)
    assert len(clips) == len(j_clips)
    for port_clip, jax_clip in zip(clips, j_clips):
        _same_config(port_clip, jax_clip)
    _same_config(vae, j_vae)
    assert (size, pred) == (j_size, j_pred)
    # the edit check comes before the inpaint check
    assert unet.in_channels == (8 if "pix2pix" in name or "ip2p" in name else 4)


def test_refiner_at_published_widths(tmp_path):
    unet, clips, vae, size, pred = family_configs(REFINER, str(tmp_path))
    assert unet.block_out_channels == (384, 768, 1536, 1536)
    assert unet.transformer_layers == (0, 4, 4, 0) and unet.mid_transformer_layers == 4
    assert tuple(c // h for c, h in zip(unet.block_out_channels, unet.heads_per_block())) == (
        64, 64, 64, 64)
    assert (unet.cross_attention_dim, unet.addition_embed_dim) == (1280, 2560)
    assert [c.hidden_size for c in clips] == [1280] and clips[0].projection_dim == 1280
    assert (vae.scaling_factor, size, pred) == (0.13025, 1024, "epsilon")
    # five time ids: 2560 = 1280 pooled + 5 x 256
    pipe = SDPipeline.__new__(SDPipeline)
    pipe.n_time_ids = (unet.addition_embed_dim - 1280) // unet.addition_time_embed_dim
    assert pipe.n_time_ids == 5
    assert pipe._xl_time_ids(1024, 768, 6.5) == [1024, 768, 0, 0, 6.5]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_refiner_structured_unet():
    """The refiner's structure at small width: (0, 4, 4, 0) transformer
    layers, four in the mid block, and the addition embedding of one
    encoder's pooled output and five time ids."""
    shape = dict(block_out_channels=(32, 32, 64, 64), transformer_layers=(0, 4, 4, 0),
                 mid_transformer_layers=4, layers_per_block=2, num_attention_heads=(2, 2, 4, 4),
                 cross_attention_dim=24, addition_embed_dim=24 + 5 * 8,
                 addition_time_embed_dim=8)
    port_cfg = cfgs.SDXL_REFINER_UNET.__class__(**shape)
    jax_cfg = jax_cfgs.SDXL_REFINER_UNET.__class__(**shape)
    module = UNet2DConditionModel(port_cfg)
    weights.random_init_(module, torch.Generator().manual_seed(13))
    state = {k: v.detach().numpy() for k, v in module.eval().state_dict().items()}
    params = convert_unet(state)
    x, ctx, pooled = _rand((2, 16, 16, 4), 14), _rand((2, 77, 24), 15), _rand((2, 24), 16)
    t = np.array([981.0, 1.0], np.float32)
    ids = np.array([[64, 48, 0, 0, 6.0], [64, 48, 0, 0, 2.5]], np.float32)
    want = jax.jit(JaxUNet(jax_cfg).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        added_cond={"text_embeds": jnp.asarray(pooled), "time_ids": jnp.asarray(ids)})
    port = UNet2DConditionModel(port_cfg).eval()
    port.load_state_dict(weights.unet_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                   torch.from_numpy(t), torch.from_numpy(ctx),
                   added_cond={"text_embeds": torch.from_numpy(pooled),
                               "time_ids": torch.from_numpy(ids)})
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


# --- whole jobs against the JAX pipeline ---

def save_safetensors(pipe, root):
    """The pipeline's weights as diffusers-layout safetensors under root."""
    from safetensors.numpy import save_file

    parts = {"unet": pipe.unet, "vae": pipe.vae}
    for i, enc in enumerate(pipe.text_encoders):
        parts["text_encoder" + ("_2" if i else "")] = enc
    for sub, module in parts.items():
        (root / sub).mkdir(parents=True)
        save_file({k: v.detach().numpy().copy() for k, v in module.state_dict().items()},
                  str(root / sub / "model.safetensors"))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX reference pipelines by name, the port's Registry) over one model
    root holding the port's seeded weights; the JAX registry, which builds
    the refiner mid-job, reads the same root."""
    root = tmp_path_factory.mktemp("edit")
    mp = pytest.MonkeyPatch()
    mp.setenv("SDAAS_ROOT", str(root / "sdaas"))
    mp.setenv("CHIASWARM_MODEL_ROOT_DIR", str(root / "models"))
    for model in TINY_MODELS:
        save_safetensors(SDPipeline(model, device="cpu"), root / "models" / model)
    jax_registry.clear_cache()
    reference = {model: jax_sd.SDPipeline(model) for model in TINY_MODELS[:3]}
    yield reference, Registry(torch.device("cpu"), str(root / "models"))
    jax_registry.clear_cache()
    mp.undo()


def start_image(w=96, h=80):
    """A smooth image whose size is not the canvas (96x80 -> 64x64)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 7 + yy / 11)], -1)
    return Image.fromarray((255 * rgb).astype(np.uint8))


def jax_draws(key):
    """The JAX pipeline's draws from `key` -> (initial latents NCHW,
    noise_fn, the key it hands on to a chained stage): split(key, 3), the
    init key's NHWC normal, and the step key folded with each step."""
    rest, init_rng, step_rng = jax.random.split(key, 3)

    def nhwc(k, shape):
        n, c, h, w = shape
        return np.asarray(jax.random.normal(k, (n, h, w, c), jnp.float32)).transpose(0, 3, 1, 2)

    def noise_fn(kind, i, shape):
        return nhwc(jax.random.fold_in(step_rng, i if kind == "step" else 7919 + i), shape)

    return nhwc(init_rng, (1, 4, SIZE // 2, SIZE // 2)), noise_fn, rest


def _pixels(images):
    return np.asarray(images[0], np.int16)


@pytest.mark.parametrize("model,scheduler,image_guidance", [
    ("test/tiny-pix2pix", "DPMSolverMultistepScheduler", None),
    ("test/tiny-xl-pix2pix", "EulerAncestralDiscreteScheduler", 2.0),
])
def test_pix2pix_matches_jax(models, model, scheduler, image_guidance):
    reference, registry = models
    port = registry.get_pipeline(model)
    assert port.is_pix2pix and port.weights_source == "checkpoint"
    seed = 17
    job = dict(prompt="make it snow", negative_prompt="blurry", num_inference_steps=4,
               guidance_scale=6.0, image=start_image(), scheduler_type=scheduler,
               **({"image_guidance_scale": image_guidance} if image_guidance else {}))
    want, want_cfg = reference[model].run(rng=jax.random.key(seed), **job)
    latents, noise_fn, _ = jax_draws(jax.random.key(seed))
    got, config = port.run(latents=latents, noise_fn=noise_fn, **job)

    assert config["mode"] == want_cfg["mode"] == "pix2pix"
    assert config["image_guidance_scale"] == want_cfg["image_guidance_scale"] == (
        image_guidance or 1.5)
    assert config["size"] == want_cfg["size"] == [SIZE, SIZE]
    assert "t_start" not in config and config["latents"]["finite"]
    assert np.abs(_pixels(got) - _pixels(want)).max() <= 2


def test_refiner_chain_matches_jax(models):
    reference, registry = models
    seed = 23
    job = dict(prompt="a lighthouse", negative_prompt="blurry", num_inference_steps=4,
               guidance_scale=5.0, height=SIZE, width=SIZE,
               refiner={"model_name": "test/tiny-xl-refiner", "strength": 0.5})
    want, want_cfg = reference["test/tiny-xl"].run(rng=jax.random.key(seed), **job)
    latents, noise_fn, rest = jax_draws(jax.random.key(seed))
    refiner_latents, refiner_noise_fn, _ = jax_draws(rest)
    got, config = registry.get_pipeline("test/tiny-xl").run(
        registry=registry, latents=latents, noise_fn=noise_fn, refiner_latents=refiner_latents,
        refiner_noise_fn=refiner_noise_fn, **job)

    assert "refiner_s" in config["timings"] and "refiner_s" in want_cfg["timings"]
    assert config["mode"] == want_cfg["mode"] == "txt2img"
    assert registry.get_pipeline("test/tiny-xl-refiner").weights_source == "checkpoint"
    assert np.abs(_pixels(got) - _pixels(want)).max() <= 2
    # the chain changed the image: the base alone differs
    base, _ = registry.get_pipeline("test/tiny-xl").run(
        latents=latents, noise_fn=noise_fn, **{k: v for k, v in job.items() if k != "refiner"})
    assert np.abs(_pixels(base) - _pixels(got)).max() > 2


def test_pix2pix_on_a_plain_checkpoint_is_img2img():
    pipe = SDPipeline("test/tiny-sd", device="cpu")
    _, config = pipe.run(prompt="edit", image=start_image(), image_guidance_scale=1.8,
                         num_inference_steps=2)
    assert config["mode"] == "img2img" and config["approximated_as"] == "img2img"
    assert "image_guidance_scale" not in config


def test_controlnet_is_refused_with_pix2pix():
    pipe = SDPipeline("test/tiny-pix2pix", device="cpu")
    with pytest.raises(ValueError, match="not supported with instruct-pix2pix"):
        pipe.run(prompt="edit", image=start_image(), controlnet_model_name="test/tiny-cn",
                 num_inference_steps=2)


def test_refiner_needs_a_registry():
    pipe = SDPipeline("test/tiny-xl", device="cpu")
    with pytest.raises(ValueError, match="registry"):
        pipe.run(prompt="x", num_inference_steps=2, refiner={"model_name": "test/tiny-xl"})


@pytest.mark.parametrize("error", [torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                                           "allocate 2.00 GiB"),
                                   RuntimeError("RESOURCE_EXHAUSTED: Out of memory")])
def test_refiner_falls_back_to_one_image_at_a_time(error):
    """The JAX pipeline's fallback (stable_diffusion.py:2397-2413): the
    batched refiner call runs out of memory, and each image is refined
    alone on a generator of its own; with the refiner's draws injected,
    each image is the image of a one-image job on the same draws (within a
    level: the base stage ran two rows), and the envelope has the same
    keys, plus `refiner_one_by_one`. Any other error is raised."""
    registry = Registry(torch.device("cpu"), None)
    pipe = registry.get_pipeline("test/tiny-xl")
    refiner = registry.get_pipeline("test/tiny-xl-refiner")
    run, calls, held = refiner.run, [], []

    def flaky(*args, **kwargs):
        calls.append(len(kwargs["image"]))
        if len(calls) == 1:
            # what a batched call holds when it runs out of memory: the
            # retries must start with it freed
            activations = torch.empty(1 << 16)
            held.append(weakref.ref(activations))
            raise type(error)(*error.args)
        assert held[0]() is None, "the failed batch's tensors outlived its error"
        return run(*args, **kwargs)

    g = torch.Generator().manual_seed(3)
    lat = SIZE // 2  # the tiny VAE halves a side
    latents, refiner_latents = (torch.randn(2, 4, lat, lat, generator=g) for _ in range(2))
    job = dict(prompt="a harbour", num_inference_steps=3, height=SIZE, width=SIZE, seed=5,
               refiner={"model_name": "test/tiny-xl-refiner", "strength": 0.5},
               registry=registry)
    refiner.run = flaky
    try:
        images, config = pipe.run(num_images_per_prompt=2, latents=latents,
                                  refiner_latents=refiner_latents, **job)
    finally:
        refiner.run = run
    assert calls == [2, 1, 1] and config["timings"]["refiner_one_by_one"] == 2
    for i in range(2):
        one, one_cfg = pipe.run(num_images_per_prompt=1, latents=latents[i:i + 1],
                                refiner_latents=refiner_latents[i:i + 1], **job)
        assert np.abs(np.asarray(images[i], int) - np.asarray(one[0], int)).max() <= 1
        assert set(one_cfg) == set(config)
        assert set(config["timings"]) - set(one_cfg["timings"]) == {"refiner_one_by_one"}

    def broken(*args, **kwargs):
        raise RuntimeError("a fault of another kind")

    refiner.run = broken
    try:
        with pytest.raises(RuntimeError, match="another kind"):
            pipe.run(num_images_per_prompt=2, **job)
    finally:
        refiner.run = run


# --- the worker ---

def _png(image) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "PNG")
    return buf.getvalue()


def test_worker_serves_tiny_pix2pix_and_refiner(tmp_path):
    hive = FakeHive(token="tok")
    try:
        start_uri = hive.enqueue_file("start.png", _png(start_image()), "image/png")
        settings = Settings(sdaas_token="tok", sdaas_uri=hive.uri, worker_name="port-test",
                            model_root_dir=str(tmp_path / "models"))
        worker = worker_mod.Worker(settings=settings, device="cpu", poll_seconds=0.01)
        common = {"prompt": "make it snow", "num_inference_steps": 3, "seed": 5,
                  "content_type": "image/png"}
        hive.enqueue(
            {"id": "p2p", "workflow": "img2img", "model_name": "timbrooks/instruct-pix2pix",
             "start_image_uri": start_uri, "strength": 0.3,
             "parameters": {"test_tiny_model": True}, **common},
            {"id": "refined", "workflow": "txt2img", "height": SIZE, "width": SIZE,
             "model_name": "stabilityai/stable-diffusion-xl-base-1.0",
             "parameters": {"test_tiny_model": True,
                            "refiner": {"model_name": "test/tiny-xl-refiner"}}, **common},
        )
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=2), timeout=120))
        results = {r["id"]: r for r in hive.wait_for_results(2, timeout=10)}
    finally:
        hive.close()
    for job_id, mode, model in (("p2p", "pix2pix", "test/tiny-pix2pix"),
                                ("refined", "txt2img", "test/tiny-xl")):
        result = results[job_id]
        assert not result.get("fatal_error"), result["pipeline_config"]
        config = result["pipeline_config"]
        assert config["mode"] == mode and config["model"] == model
        assert config["size"] == [SIZE, SIZE] and config["latents"]["finite"]
        blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
        image = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
        assert image.shape == (SIZE, SIZE, 3) and image.max() != image.min()
    assert results["p2p"]["pipeline_config"]["image_guidance_scale"] == pytest.approx(1.5)
    assert "refiner_s" in results["refined"]["pipeline_config"]["timings"]
    assert worker.registry.resident_models() == ["test/tiny-pix2pix", "test/tiny-xl",
                                                 "test/tiny-xl-refiner"]


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_edit_phases_rehearse_on_cpu():
    """chip_smoke.py's edit phases at a tiny size on the CPU: phase 4's
    checks from safetensors pass (the CPU against itself), and the served
    edit path, with tiny stand-ins of its models, passes its envelope
    checks and then fails its launch-count check, as it must where no
    kernel runs."""
    smoke = _chip_smoke()
    checks = smoke.tiny_edit_checks(device="cpu", steps=2)
    assert len(checks) == 4 and all(c["max_pixel_diff"] == 0 for c in checks.values())
    cpu = torch.device("cpu")
    with pytest.raises(smoke.SmokeFailure,
                       match="flash_attention was never launched on the edit path"):
        smoke.serve_edit_path("cpu", Registry(cpu), Registry(cpu),
                              {"flash_attention": 0, "group_norm": 0}, device="cpu",
                              sd15_p2p="test/tiny-pix2pix", sdxl_p2p="test/tiny-xl-pix2pix",
                              base="test/tiny-xl", refiner="test/tiny-xl-refiner", size15=SIZE,
                              size_xl_p2p=SIZE, size_xl=SIZE, steps=2)
    # the edit calls' shapes: launches per UNet call as the served path holds them
    for model, rows, size in smoke.EDIT_CALLS:
        per_call = sum(smoke.attention_shapes(model, rows, size).values())
        assert per_call == {"sd15": 32, "sdxl": 140, "refiner": 88}[model]
        assert all(x[0] == rows for x, _, _ in smoke.unet_norms(model, rows, size))
