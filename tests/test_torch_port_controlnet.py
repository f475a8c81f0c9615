"""chiaswarm_tpu_torch's ControlNet against the JAX package, at tiny widths
(tiny-sd, tiny-xl) on the CPU.

- The branch: `ControlNetModel` residuals, with every conv nonzero (JAX's
  random init with its zero convs and the embedding's output conv drawn
  too), carried into the port by `weights.from_jax_params`; the UNet fed
  seeded residuals. f32 on both sides, within 2e-4 (the bound of the
  port's other module tests; JAX's own tests of these modules check
  shapes and the zero branch only).
- The preprocessors: canny equal to JAX's (OpenCV) pixel for pixel on three
  seeded photo-like images and a PIL-drawn shape image, shuffle within 2
  levels on 99% of pixels (measured: 1 level at most, on 0.01% of them),
  tile, crop, center crop and pix2pix equal (the names that run a model
  are held in test_torch_port_preprocessors.py).
- Job arguments of ControlNet jobs against JAX's `format_args`, each side
  fetching from the port's fake hive; the wire's pipeline types (the six
  ControlNet ones among them) against JAX's family table.
- Whole jobs on the same weights, the port's written as safetensors under a
  model root that JAX reads too (the ControlNets nonzero), JAX's noise
  injected into the port: txt2img with the canny preprocessor and the
  window 0.25-0.75, img2img with a control image, 4-channel inpaint, a
  LoRA job under Heun, the QR two-stage chain, and a coalesced pass of
  tiny-xl jobs sharing one ControlNet. Each image within 2/255 of JAX's,
  the bound of the port's other pipeline tests (f32 on both sides; the
  rounding to uint8 can flip a level). The window's branch calls counted
  against the solver's loop indices in JAX's window, for DPM++ 2M
  txt2img, an img2img start and Heun (whose doubled index space JAX does
  not rescale: ROADMAP §3).
- A zero-init branch and scale 0 give the plain image bit for bit; the
  refusals; the 9-channel inpaint checkpoint with a published-shape
  (4-channel) ControlNet fails in both packages, and a zero-init branch
  built from its config serves it.
- The worker through the fake hive: a ControlNet job, a shared-ControlNet
  pair in one pass, the QR chain, and a depth job without DPT's weights
  (a fatal envelope).

Each JAX program compiles once: every JAX job below is a distinct program
(mode, window, scheduler, adapter), and the module fixture keeps the
pipelines.
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
from PIL import Image, ImageDraw
from safetensors.numpy import save_file

from chiaswarm_tpu import embed_cache as jax_embed_cache
from chiaswarm_tpu import job_arguments as jax_job_arguments
from chiaswarm_tpu import lora_cache as jax_lora_cache
from chiaswarm_tpu import registry as jax_registry
from chiaswarm_tpu.models import configs as jax_cfgs
from chiaswarm_tpu.models.controlnet import ControlNetModel as JaxControlNet
from chiaswarm_tpu.models.unet2d import UNet2DConditionModel as JaxUNet
from chiaswarm_tpu.pipelines import stable_diffusion as jax_sd
from chiaswarm_tpu.pre_processors import controlnet as jax_pre
from chiaswarm_tpu.schedulers import get_scheduler as jax_get_scheduler
from chiaswarm_tpu.settings import Settings as JaxSettings
from chiaswarm_tpu_torch import job_arguments
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.models.controlnet import ControlNetModel
from chiaswarm_tpu_torch.models.unet2d import UNet2DConditionModel
from chiaswarm_tpu_torch.pipelines.common import pad_bucket
from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline, control_window
from chiaswarm_tpu_torch.pre_processors import controlnet as pre
from chiaswarm_tpu_torch.registry import PIPELINE_FAMILIES, Registry, check_pipeline_type
from chiaswarm_tpu_torch.settings import Settings
from chiaswarm_tpu_torch.weights import CheckpointError, MissingWeightsError, from_jax_params

SIZE = 64
STEPS = 4
SD, XL, INPAINT = "test/tiny-sd", "test/tiny-xl", "test/tiny-inpaint"
CN_SD, CN_XL, CN_ZERO = "test/tiny-cn-sd", "test/tiny-cn-xl", "test/tiny-cn-zero"


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


smoke = _chip_smoke()


# --- images ---

def _photo(seed, w=96, h=80) -> np.ndarray:
    """A photo-like image: discs of colour over stripes, with grain."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(6):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(w / 12, w / 3)
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += 40 * np.sin(xx / rng.uniform(3, 20))[..., None] * rng.uniform(0, 1, 3)
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _shapes() -> np.ndarray:
    im = Image.new("RGB", (160, 120), (30, 40, 50))
    d = ImageDraw.Draw(im)
    d.rectangle((10, 10, 70, 60), fill=(200, 50, 50))
    d.ellipse((80, 30, 150, 110), fill=(40, 200, 90))
    d.line((0, 119, 159, 0), fill=(250, 250, 0), width=3)
    d.polygon([(20, 100), (60, 70), (70, 115)], fill=(10, 10, 220))
    return np.asarray(im)


def _qr_like(size=96) -> Image.Image:
    """Black and white modules, as a QR code's (the `qrcode` package is
    absent here and on the card)."""
    cells = np.random.default_rng(9).random((12, 12)) > 0.5
    cells[:3, :3] = cells[:3, -3:] = cells[-3:, :3] = True
    arr = np.kron(cells, np.ones((size // 12, size // 12), bool))
    return Image.fromarray(np.where(arr, 0, 255).astype(np.uint8)).convert("RGB")


def _mask(size=SIZE) -> Image.Image:
    m = np.zeros((size, size), np.uint8)
    m[:, size // 2:] = 255
    return Image.fromarray(m)


def _png(image) -> bytes:
    buf = io.BytesIO()
    (image if isinstance(image, Image.Image) else Image.fromarray(image)).save(buf, "PNG")
    return buf.getvalue()


def _levels(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


# --- the branch and the UNet, module against module ---

def _random_jax_params(module, seed, *args, **kwargs):
    """A JAX module's parameter tree (its shapes by `jax.eval_shape` of its
    init, which compiles nothing) with every leaf drawn from a seeded
    normal: kernels at 1/sqrt(fan_in), norm scales about 1, biases and
    embeddings small. Nothing is zero: the zero convs and the control
    embedding's output conv are drawn too."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args, **kwargs)["params"]

    def fill(path, leaf):
        name = str(path[-1].key)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * z
        return 0.05 * z

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_inputs(cfg, factor, seed, rows=2, hw=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, hw, hw, cfg.in_channels)).astype(np.float32)
    t = np.array([500.0, 20.0][:rows], np.float32)
    ctx = rng.standard_normal((rows, 77, cfg.cross_attention_dim)).astype(np.float32)
    cond = rng.random((rows, hw * factor, hw * factor, 3)).astype(np.float32)
    added = None
    if cfg.addition_embed_dim:
        pooled = cfg.addition_embed_dim - 6 * cfg.addition_time_embed_dim
        added = {"text_embeds": rng.standard_normal((rows, pooled)).astype(np.float32),
                 "time_ids": np.tile(np.array([64, 64, 0, 0, 64, 64], np.float32), (rows, 1))}
    return x, t, ctx, cond, added


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name,jax_cfg,cfg", [("tiny-sd", jax_cfgs.TINY_UNET, cfgs.TINY_UNET),
                                              ("tiny-xl", jax_cfgs.TINY_XL_UNET,
                                               cfgs.TINY_XL_UNET)])
def test_controlnet_residuals_match_jax(name, jax_cfg, cfg):
    """Tolerance 2e-4 absolute on residuals of unit scale, f32."""
    x, t, ctx, cond, added = _jax_inputs(jax_cfg, 2, seed=3)
    branch = JaxControlNet(jax_cfg, cond_downscale=2)
    params = _random_jax_params(branch, 4, x, t, ctx, cond, added_cond=added)
    want_down, want_mid = jax.jit(branch.apply)({"params": params}, x, t, ctx, cond,
                                                conditioning_scale=0.7, added_cond=added)
    port = ControlNetModel(cfg, cond_downscale=2)
    port.load_state_dict(from_jax_params({"cn": params})["controlnet"])
    port_added = ({k: torch.from_numpy(v) for k, v in added.items()} if added else None)
    with torch.no_grad():
        down, mid = port(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), _nchw(cond),
                         0.7, port_added)
    skips = 1 + len(cfg.block_out_channels) * (cfg.layers_per_block + 1) - 1
    assert len(down) == len(want_down) == skips
    for got, want in zip([*down, mid], [*want_down, want_mid]):
        want = np.asarray(want).transpose(0, 3, 1, 2)
        assert float(np.abs(want).max()) > 0.05  # nonzero: the test proves something
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_unet_with_residuals_matches_jax():
    """Tolerance 2e-4, f32, as the port's UNet test."""
    from chiaswarm_tpu_torch.weights import unet_state_dict

    jax_cfg, cfg = jax_cfgs.TINY_UNET, cfgs.TINY_UNET
    x, t, ctx, _, _ = _jax_inputs(jax_cfg, 2, seed=5)
    unet = JaxUNet(jax_cfg)
    params = _random_jax_params(unet, 2, x, t, ctx)
    skip_shapes = [(2, 8, 8, 32), (2, 8, 8, 32), (2, 4, 4, 32), (2, 4, 4, 64)]
    rng = np.random.default_rng(6)
    down = [rng.standard_normal(s).astype(np.float32) for s in skip_shapes]
    mid = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
    want = np.asarray(jax.jit(unet.apply)({"params": params}, x, t, ctx, down_residuals=down,
                                          mid_residual=mid))
    port = UNet2DConditionModel(cfg)
    port.load_state_dict(unet_state_dict(params))
    with torch.no_grad():
        inputs = (_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
        got = port(*inputs, down_residuals=[_nchw(r) for r in down],
                   mid_residual=_nchw(mid)).numpy()
        plain = port(*inputs).numpy()
    assert np.abs(got - plain).max() > 0.1
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=2e-4, rtol=0)


# --- the preprocessors ---

IMAGES = {"photo-0": lambda: _photo(0, 200, 150), "photo-1": lambda: _photo(1, 200, 150),
          "photo-2": lambda: _photo(2, 301, 203), "shapes": _shapes}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_canny_equals_opencv(name):
    arr = IMAGES[name]()
    want = np.asarray(jax_pre.preprocess_image(Image.fromarray(arr), "canny", "cpu"))
    got = np.asarray(pre.preprocess_image(Image.fromarray(arr), "Canny"))
    assert (want > 0).sum() > 100
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_shuffle_matches_opencv(name):
    image = Image.fromarray(IMAGES[name]())
    want = np.asarray(jax_pre.preprocess_image(image, "shuffle", "cpu"), np.int16)
    got = np.asarray(pre.preprocess_image(image, "shuffle"), np.int16)
    diff = np.abs(got - want).max(-1)
    assert got.shape == want.shape
    assert (diff <= 2).mean() >= 0.99
    # what is reached: the flow fields round apart on a few pixels
    assert (diff == 0).mean() > 0.999 and diff.max() <= 1


@pytest.mark.parametrize("name", ["tile", "crop", "center crop", "pix2pix", "Center-Crop"])
def test_geometric_preprocessors_equal_jax(name):
    image = Image.fromarray(_photo(4, 150, 100))
    want = jax_pre.preprocess_image(image, name, "cpu")
    got = pre.preprocess_image(image, name)
    assert got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_unknown_preprocessor_is_refused_like_jax():
    with pytest.raises(ValueError, match="Unknown or unavailable controlnet preprocessor: x"):
        jax_pre.preprocess_image(Image.new("RGB", (8, 8)), "x", "cpu")
    with pytest.raises(ValueError, match="Unknown or unavailable controlnet preprocessor: x"):
        pre.preprocess_image(Image.new("RGB", (8, 8)), "x")


# --- the wire's pipeline types ---

@pytest.mark.parametrize("pipeline_type", sorted(PIPELINE_FAMILIES))
def test_pipeline_families_match_jax(pipeline_type):
    assert PIPELINE_FAMILIES[pipeline_type] == jax_registry.PIPELINE_FAMILIES[pipeline_type]
    check_pipeline_type(pipeline_type)


@pytest.mark.parametrize("pipeline_type", ["IFPipeline", "AudioLDMPipeline",
                                           "NoSuchPipeline"])
def test_unported_pipeline_types_are_refused(pipeline_type):
    with pytest.raises(ValueError, match="is not ported to chiaswarm_tpu_torch"):
        check_pipeline_type(pipeline_type)


# --- the module fixture ---

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
    """tiny-sd, tiny-xl and the 9-channel tiny-inpaint written as
    safetensors under a model root, with a nonzero ControlNet for each of
    tiny-sd and tiny-xl and a LoRA for tiny-sd; a Registry over the root;
    JAX's pipelines of tiny-sd and tiny-xl reading the same root; a fake
    hive serving the control, start, mask and QR images."""
    root = tmp_path_factory.mktemp("controlnet")
    models, loras = root / "models", root / "loras"
    mp = pytest.MonkeyPatch()
    mp.setenv("SDAAS_ROOT", str(root / "sdaas"))
    mp.setenv("CHIASWARM_MODEL_ROOT_DIR", str(models))
    mp.setenv("CHIASWARM_LORA_ROOT_DIR", str(loras))
    for model in (SD, XL, INPAINT):
        _save_safetensors(SDPipeline(model, device="cpu"), models / model)
    registry = Registry(torch.device("cpu"), str(models), str(loras))
    port = {m: registry.get_pipeline(m) for m in (SD, XL)}
    smoke.write_controlnet(models / CN_SD, port[SD], seed=71)
    smoke.write_controlnet(models / CN_XL, port[XL], seed=72)
    smoke.write_lora(loras / "sd-peft.safetensors", port[SD], "peft", rank=4, te_rank=2,
                     seed=73)
    hive = FakeHive(token="tok")
    uris = {name: hive.enqueue_file(f"{name}.png", _png(image), "image/png")
            for name, image in (("photo", _photo(5)), ("start", _photo(6, SIZE, SIZE)),
                                ("mask", _mask()), ("qr", _qr_like()))}
    jax_registry.clear_cache()
    jax_lora_cache.reset()
    jax_embed_cache.reset()
    reference = {m: jax_sd.SDPipeline(m) for m in (SD, XL)}
    yield {"models": models, "loras": loras, "registry": registry, "port": port,
           "jax": reference, "hive": hive, "uris": uris, "results": {}}
    hive.close()
    jax_registry.clear_cache()
    jax_lora_cache.reset()
    jax_embed_cache.reset()
    mp.undo()


def _noise(key, n=1, size=SIZE):
    """The JAX pipeline's draws for a job run with `key` -> (initial
    latents NCHW, noise_fn): split(key, 3), init_rng's NHWC normal, and
    step_rng folded with i (7919 + i for inpaint's keep noise)."""
    _, init_rng, step_rng = jax.random.split(key, 3)

    def nhwc(k, shape):
        b, c, h, w = shape
        return np.asarray(jax.random.normal(k, (b, h, w, c), jnp.float32)).transpose(0, 3, 1, 2)

    def noise_fn(kind, i, shape):
        return nhwc(jax.random.fold_in(step_rng, i if kind == "step" else 7919 + i), shape)

    return nhwc(init_rng, (n, 4, size // 2, size // 2)), noise_fn


_META = ("id", "model_name", "seed", "content_type", "outputs")


# --- job arguments ---

def _wire_jobs(uris):
    """The jobs run by both packages. Each is a JAX program of its own but
    the QR chain's second stage, which has the img2img job's shape,
    scheduler, start step and window, and so its program."""
    common = {"model_name": SD, "prompt": "a house by a lake", "negative_prompt": "blurry",
              "height": SIZE, "width": SIZE, "num_inference_steps": STEPS,
              "guidance_scale": 6.0, "content_type": "image/png"}
    window = {"controlnet_model_name": CN_SD, "control_guidance_start": 0.25,
              "control_guidance_end": 0.75}
    return {
        "txt2img-canny-window-lora": {
            **common, "id": "cn-t2i", "workflow": "txt2img", "seed": 21,
            "lora": "sd-peft.safetensors",
            "parameters": {"scheduler_type": "DPMSolverMultistepScheduler", "lora_scale": 0.8,
                           "controlnet": {**window, "control_image_uri": uris["photo"],
                                          "preprocessor": "canny"}}},
        "img2img-control-image": {
            **common, "id": "cn-i2i", "workflow": "img2img", "seed": 22,
            "start_image_uri": uris["start"], "strength": 0.5,
            "parameters": {"scheduler_type": "EulerAncestralDiscreteScheduler",
                           "controlnet": {**window, "control_image_uri": uris["photo"],
                                          "controlnet_conditioning_scale": 0.8}}},
        "inpaint-heun-window": {
            **common, "id": "cn-inp", "workflow": "inpaint", "seed": 23,
            "start_image_uri": uris["start"], "mask_image_uri": uris["mask"],
            "parameters": {"scheduler_type": "HeunDiscreteScheduler",
                           "controlnet": {**window, "control_image_uri": uris["photo"]}}},
        "qr-two-stage": {
            **common, "id": "cn-qr", "workflow": "txt2img", "seed": 24, "strength": 0.5,
            "parameters": {"scheduler_type": "EulerAncestralDiscreteScheduler",
                           "controlnet": {**window, "control_image_uri": uris["qr"],
                                          "controlnet_conditioning_scale": 0.8,
                                          "parameters": {"controlnet_prepipeline_type":
                                                         "StableDiffusionPipeline"}}}},
    }


# argument-only jobs: formatted by both packages, never run
def _arg_jobs(uris):
    base = {"model_name": "runwayml/stable-diffusion-v1-5", "prompt": "a boat"}
    sdxl = {**base, "model_name": "stabilityai/stable-diffusion-xl-base-1.0"}
    return {
        "txt2img-defaults": {**base, "workflow": "txt2img",
                             "parameters": {"controlnet": {"control_image_uri": uris["photo"]}}},
        "txt2img-xl-large": {**sdxl, "workflow": "txt2img", "height": 512, "width": 512,
                             "parameters": {"large_model": True, "controlnet": {
                                 "control_image_uri": uris["photo"], "preprocessor": "tile",
                                 "controlnet_model_name": "diffusers/controlnet-canny-sdxl-1.0",
                                 "parameters": {"controlnet_model_type": "X"}}}},
        "img2img-preprocess-start": {**base, "workflow": "img2img",
                                     "start_image_uri": uris["start"],
                                     "parameters": {"controlnet": {
                                         "control_image_uri": uris["photo"],
                                         "preprocessor": "shuffle"}}},
        "img2img-start-as-control": {**sdxl, "workflow": "img2img", "height": 768,
                                     "width": 512, "start_image_uri": uris["photo"],
                                     "parameters": {"large_model": True,
                                                    "controlnet": {}}},
        "inpaint-xl": {**sdxl, "workflow": "inpaint", "start_image_uri": uris["start"],
                       "mask_image_uri": uris["mask"],
                       "parameters": {"large_model": True, "controlnet": {
                           "control_image_uri": uris["qr"], "preprocessor": "center crop"}}},
        "pipeline-type-given": {**base, "workflow": "txt2img", "parameters": {
            "pipeline_type": "StableDiffusionControlNetImg2ImgPipeline",
            "controlnet": {"control_image_uri": uris["qr"]}}},
    }


def _settings(env):
    return (JaxSettings(lora_root_dir=str(env["loras"])),
            Settings(lora_root_dir=str(env["loras"])))


@pytest.mark.parametrize("name", ["txt2img-canny-window-lora", "img2img-control-image",
                                  "inpaint-heun-window", "qr-two-stage", "txt2img-defaults",
                                  "txt2img-xl-large", "img2img-preprocess-start",
                                  "img2img-start-as-control", "inpaint-xl",
                                  "pipeline-type-given"])
def test_job_arguments_match_jax(env, name):
    job = {**_wire_jobs(env["uris"]), **_arg_jobs(env["uris"])}[name]
    jax_settings, settings = _settings(env)
    jax_cb, jax_args = asyncio.run(jax_job_arguments.format_args(copy.deepcopy(job),
                                                                 jax_settings, "cpu"))
    cb, args = job_arguments.format_args(copy.deepcopy(job), settings)
    assert cb.__name__ == jax_cb.__name__ == "diffusion_callback"
    assert args.keys() == jax_args.keys()
    for key, value in args.items():
        if isinstance(value, Image.Image):
            assert value.size == jax_args[key].size, key
            np.testing.assert_array_equal(np.asarray(value), np.asarray(jax_args[key]))
        else:
            assert value == jax_args[key], key
    assert "controlnet_model_name" in args and ("image" in args or "control_image" in args)


@pytest.mark.parametrize("controlnet,match", [
    ({"control_image_uri": "", "preprocessor": "canny"}, "no control image provided"),
    ({"qr_code_contents": "https://example.org"}, "qrcode"),
])
def test_controlnet_argument_refusals_match_jax(env, controlnet, match):
    job = {"workflow": "txt2img", "model_name": SD, "parameters": {"controlnet": controlnet}}
    with pytest.raises(Exception, match=match):
        asyncio.run(jax_job_arguments.format_args(copy.deepcopy(job), JaxSettings(), "cpu"))
    with pytest.raises(Exception, match=match):
        job_arguments.format_args(copy.deepcopy(job), Settings())


# --- whole jobs against JAX ---

def _wire(env, name):
    """A wire job formatted by both packages -> (port kwargs, JAX kwargs,
    seed); each side fetches from the fake hive and preprocesses."""
    job = _wire_jobs(env["uris"])[name]
    jax_settings, settings = _settings(env)
    _, jax_args = asyncio.run(jax_job_arguments.format_args(copy.deepcopy(job), jax_settings,
                                                            "cpu"))
    _, args = job_arguments.format_args(copy.deepcopy(job), settings)
    for kw in (args, jax_args):
        for key in _META:
            kw.pop(key, None)
    return args, jax_args, job["seed"]


def _run_wire(env, name):
    if name not in env["results"]:
        args, jax_args, seed = _wire(env, name)
        want, want_cfg = env["jax"][SD].run(rng=jax.random.key(seed), **jax_args)
        if name == "qr-two-stage":
            # JAX splits the job's key in three: stage 1 gets the second
            # part, stage 2 the third
            _, k1, k2 = jax.random.split(jax.random.key(seed), 3)
            pre_latents, pre_noise = _noise(k1)
            latents, noise_fn = _noise(k2)
            got, cfg = env["port"][SD].run(latents=latents, noise_fn=noise_fn,
                                           prepipeline_latents=pre_latents,
                                           prepipeline_noise_fn=pre_noise, **args)
        else:
            latents, noise_fn = _noise(jax.random.key(seed))
            got, cfg = env["port"][SD].run(latents=latents, noise_fn=noise_fn, **args)
        env["results"][name] = (got, cfg, want, want_cfg, args)
    return env["results"][name]


@pytest.mark.parametrize("name,mode", [("txt2img-canny-window-lora", "txt2img"),
                                       ("img2img-control-image", "img2img"),
                                       ("inpaint-heun-window", "inpaint")])
def test_wire_job_matches_jax(env, name, mode):
    got, cfg, want, want_cfg, args = _run_wire(env, name)
    assert cfg["mode"] == want_cfg["mode"] == mode
    assert cfg["controlnet"] == want_cfg["controlnet"] == CN_SD
    assert cfg["pipeline"] == want_cfg["pipeline"] == args["pipeline_type"]
    assert _levels(got[0], want[0]) <= 2
    # the branch moved the image: the same job without it differs
    plain_args = {k: v for k, v in args.items() if not k.startswith("control")}
    if mode == "txt2img":
        plain_args.pop("image")
    latents, noise_fn = _noise(jax.random.key(_wire_jobs(env["uris"])[name]["seed"]))
    plain, _ = env["port"][SD].run(latents=latents, noise_fn=noise_fn, **plain_args)
    assert _levels(plain[0], got[0]) > 2


def test_lora_with_controlnet_matches_jax(env):
    """The delta reaches the UNet and not the branch, in both packages; the
    text encoders' delta shapes the context the branch reads."""
    got, cfg, want, want_cfg, _ = _run_wire(env, "txt2img-canny-window-lora")
    assert cfg["lora_mode"] == want_cfg["lora_mode"] == "delta"
    assert cfg["lora_scale"] == 0.8 and cfg["controlnet"] == CN_SD
    assert _levels(got[0], want[0]) <= 2
    branch = env["port"][SD].controlnet(CN_SD)
    assert not any(m._forward_hooks for m in branch.modules())


WINDOW_CASES = {"dpm-txt2img": ("txt2img-canny-window-lora", 2),
                "img2img-start": ("img2img-control-image", 1),
                "heun": ("inpaint-heun-window", 1)}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_guidance_window_matches_jax(env, case):
    """The branch runs at the solver loop indices i with lo <= i < hi, lo =
    int(0.25 x 4) = 1 and hi = ceil(0.75 x 4) = 3, counted as JAX counts
    them: DPM++ 2M txt2img at i = 1 and 2; from t_start = 2 for the img2img
    job, so at i = 2 alone; and Heun's inpaint job (t_start 1) in its
    doubled index space, which runs i = 2..6 and meets the window at i = 2
    alone, a step the job did not ask for (ROADMAP §3, as in JAX)."""
    name, calls = WINDOW_CASES[case]
    got, cfg, want, _, args = _run_wire(env, name)
    solver = jax_get_scheduler(args["scheduler_type"])
    start, end = solver.loop_bounds(solver.schedule(STEPS), STEPS, cfg.get("t_start", 0))
    lo, hi = control_window(args["control_guidance_start"], args["control_guidance_end"], STEPS)
    assert (lo, hi) == (1, 3)
    assert cfg["controlnet_calls"] == sum(lo <= i < hi for i in range(start, end)) == calls
    assert _levels(got[0], want[0]) <= 2


def test_qr_two_stage_matches_jax(env):
    got, cfg, want, want_cfg, _ = _run_wire(env, "qr-two-stage")
    assert cfg["prepipeline"] == want_cfg["prepipeline"] == "qr_two_stage"
    assert cfg["mode"] == want_cfg["mode"] == "img2img"
    assert cfg["size"] == want_cfg["size"] == [SIZE, SIZE]
    assert cfg["strength"] == 0.5 and cfg["controlnet"] == CN_SD
    assert "prepipeline_s" in cfg["timings"] and got[0].shape == (SIZE, SIZE, 3)
    assert _levels(got[0], want[0]) <= 2


def _batched_noise(seeds, counts, size=SIZE):
    """JAX's per-row draws of a coalesced pass (rows of request j from
    split(fold_in(key(seed_j), i)), padding rows from key(0x9AD))."""
    lh = size // 2
    total = sum(counts)
    sources = [(jax.random.key(s), n) for s, n in zip(seeds, counts)]
    sources.append((jax.random.key(0x9AD), pad_bucket(total) - total))
    init, steps = [], []
    for base, n in sources:
        for i in range(n):
            k_init, k_step = jax.random.split(jax.random.fold_in(base, i))
            init.append(np.asarray(jax.random.normal(k_init, (lh, lh, 4), jnp.float32)))
            steps.append(k_step)

    def noise_fn(kind, i, shape):
        return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, i), (lh, lh, 4),
                                                      jnp.float32))
                         for k in steps]).transpose(0, 3, 1, 2)

    return np.stack(init).transpose(0, 3, 1, 2), noise_fn


def test_shared_controlnet_pass_matches_jax(env):
    """tiny-xl (the branch reads SDXL's added conditioning), three requests
    of 1, 2 and 1 images padded to 4, one control image."""
    control = Image.fromarray(_photo(8))
    shared = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS, guidance_scale=6.0,
                  scheduler_type="EulerAncestralDiscreteScheduler", controlnet_model_name=CN_XL,
                  control_image=control, controlnet_conditioning_scale=0.9,
                  control_guidance_end=0.75)
    requests = [(41, 1, "a boat"), (42, 2, "a ship"), (43, 1, "a raft")]
    want = env["jax"][XL].run_batched(
        [dict(prompt=p, num_images_per_prompt=n, rng=jax.random.key(s))
         for s, n, p in requests], **shared)
    latents, noise_fn = _batched_noise([s for s, _, _ in requests], [n for _, n, _ in requests])
    got = env["port"][XL].run_batched(
        [dict(prompt=p, num_images_per_prompt=n, seed=s) for s, n, p in requests],
        latents=latents, noise_fn=noise_fn, **shared)
    for (images, cfg), (want_images, want_cfg) in zip(got, want):
        for key in ("controlnet", "mode", "batched_with", "batch_rows", "padded_rows"):
            assert cfg[key] == want_cfg[key], key
        assert cfg["controlnet_calls"] == 3
        for a, b in zip(images, want_images):
            assert _levels(a, b) <= 2


# --- exact no-ops and refusals (the port alone) ---

def test_zero_init_branch_and_scale_zero_are_bit_for_bit(env):
    pipe = env["port"][SD]
    latents, noise_fn = _noise(jax.random.key(51))
    job = dict(prompt="a house", negative_prompt="blurry", num_inference_steps=STEPS,
               height=SIZE, width=SIZE, latents=latents, noise_fn=noise_fn,
               scheduler_type="EulerAncestralDiscreteScheduler")
    plain, plain_cfg = pipe.run(**job)
    control = Image.fromarray(_photo(9))
    zero, cfg = pipe.run(controlnet_model_name=CN_ZERO, image=control, **job)
    assert cfg["controlnet"] == CN_ZERO and cfg["controlnet_calls"] == STEPS
    assert plain_cfg["controlnet"] is None and "controlnet_calls" not in plain_cfg
    assert np.array_equal(zero[0], plain[0])
    scaled, cfg = pipe.run(controlnet_model_name=CN_SD, image=control,
                           controlnet_conditioning_scale=0.0, **job)
    assert cfg["controlnet_calls"] == 0 and np.array_equal(scaled[0], plain[0])
    branch = pipe.controlnet(CN_ZERO)
    for conv in (branch.controlnet_cond_embedding.conv_out, *branch.controlnet_down_blocks,
                 branch.controlnet_mid_block):
        assert not conv.weight.any() and not conv.bias.any()
    assert branch.conv_in.weight.any()


def test_refusals(env):
    pipe = env["port"][SD]
    control = Image.fromarray(_photo(9))
    with pytest.raises(MissingWeightsError, match="ControlNet weights for "
                                                  "'lllyasviel/control_v11p_sd15_canny'"):
        pipe.run(prompt="x", num_inference_steps=2, image=control,
                 controlnet_model_name="lllyasviel/control_v11p_sd15_canny")
    with pytest.raises(ValueError, match="no control image provided"):
        pipe.run(prompt="x", num_inference_steps=2, controlnet_model_name=CN_SD)
    edit = SDPipeline("test/tiny-pix2pix", device="cpu")
    with pytest.raises(ValueError, match="not supported with instruct-pix2pix"):
        edit.run(prompt="x", num_inference_steps=2, image=control, control_image=control,
                 controlnet_model_name=CN_SD)
    with pytest.raises(ValueError, match="pipeline type 'IFPipeline'"):
        from chiaswarm_tpu_torch.workflows.diffusion import diffusion_callback

        diffusion_callback("cpu", SD, registry=env["registry"], prompt="x",
                           pipeline_type="IFPipeline")


def test_nine_channel_inpaint_with_a_controlnet(env):
    """ROADMAP §3: JAX builds the branch from the UNet's config and feeds it
    the 9-channel input, so a ControlNet of the published (4-channel)
    shape cannot serve an inpainting checkpoint in either package; a
    branch of the checkpoint's own config (a test name's zero init) serves
    it, and adds nothing."""
    start, mask = Image.fromarray(_photo(6, SIZE, SIZE)), _mask()
    job = dict(prompt="a hat", num_inference_steps=2, height=SIZE, width=SIZE, image=start,
               mask_image=mask, control_image=Image.fromarray(_photo(9)))
    reference = jax_sd.SDPipeline(INPAINT)
    with pytest.raises(Exception, match="shape"):
        reference.run(rng=jax.random.key(1), controlnet_model_name=CN_SD, **job)
    pipe = env["registry"].get_pipeline(INPAINT)
    with pytest.raises(CheckpointError, match="conv_in.weight"):
        pipe.run(controlnet_model_name=CN_SD, **job)
    latents, noise_fn = _noise(jax.random.key(2))
    plain, _ = pipe.run(latents=latents, noise_fn=noise_fn,
                        **{k: v for k, v in job.items() if k != "control_image"})
    zero, cfg = pipe.run(latents=latents, noise_fn=noise_fn, controlnet_model_name=CN_ZERO,
                         **job)
    assert cfg["mode"] == "inpaint9" and cfg["controlnet_calls"] == 2
    assert pipe.controlnet(CN_ZERO).conv_in.in_channels == 9
    assert np.array_equal(zero[0], plain[0])


def test_release_drops_the_branches(env):
    pipe = SDPipeline(SD, device="cpu", model_root_dir=str(env["models"]))
    pipe.controlnet(CN_SD)
    assert list(pipe._controlnets) == [CN_SD]
    pipe.release()
    assert not pipe._controlnets


# --- the worker ---

def _image(result):
    blob = base64.b64decode(result["artifacts"]["primary"]["blob"])
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def test_worker_serves_controlnet_jobs(env):
    hive, uris = env["hive"], env["uris"]
    common = {"workflow": "txt2img", "model_name": SD, "num_inference_steps": 2,
              "height": SIZE, "width": SIZE, "content_type": "image/png"}
    shared_cn = {"controlnet_model_name": CN_SD, "control_image_uri": uris["photo"],
                 "preprocessor": "canny"}
    jobs = [
        {**common, "id": "pair-0", "prompt": "a boat", "seed": 1,
         "parameters": {"controlnet": shared_cn}},
        {**common, "id": "pair-1", "prompt": "a ship", "seed": 2,
         "parameters": {"controlnet": shared_cn}},
        {**common, "id": "qr", "prompt": "a garden", "seed": 3, "parameters": {"controlnet": {
             "controlnet_model_name": CN_SD, "control_image_uri": uris["qr"],
             "parameters": {"controlnet_prepipeline_type": "StableDiffusionPipeline"}}}},
        {**common, "id": "depth", "prompt": "x", "workflow": "img2img",
         "start_image_uri": uris["start"],
         "parameters": {"controlnet": {"preprocessor": "depth"}}},
    ]
    settings = Settings(sdaas_token="tok", sdaas_uri=hive.uri, worker_name="port-test",
                        model_root_dir=str(env["models"]), lora_root_dir=str(env["loras"]))
    worker = worker_mod.Worker(settings=settings, device="cpu", registry=env["registry"],
                               poll_seconds=0.01)
    already = len(hive.results)
    hive.enqueue(*jobs)
    asyncio.run(asyncio.wait_for(worker.run(max_jobs=len(jobs)), timeout=300))
    results = {r["id"]: r for r in hive.wait_for_results(already + len(jobs), timeout=10)}
    for job_id in ("pair-0", "pair-1"):
        config = results[job_id]["pipeline_config"]
        assert not results[job_id].get("fatal_error"), config
        assert config["controlnet"] == CN_SD and config["batched_with"] == 2
        assert config["pipeline"] == "StableDiffusionControlNetPipeline"
        assert config["controlnet_calls"] == 2 and _image(results[job_id]).shape == (SIZE, SIZE, 3)
    qr = results["qr"]["pipeline_config"]
    assert qr["prepipeline"] == "qr_two_stage" and "batched_with" not in qr
    # the chain's default strength, 0.9
    assert qr["strength"] == 0.9 and qr["t_start"] == 0
    assert _image(results["qr"]).shape == (SIZE, SIZE, 3)
    # DPT's weights are not under the model root: the job fails, as in JAX
    assert results["depth"]["fatal_error"] is True
    assert ("depth model weights for 'Intel/dpt-large' are not present"
            in results["depth"]["pipeline_config"]["error"])
