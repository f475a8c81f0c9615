"""chiaswarm_tpu_torch's job arguments for img2img and inpaint, and its
input-fetch limits.

- `job_arguments.format_args` against the JAX package's on the same jobs,
  with `get_image` stubbed on both sides (a table of images by URI that
  records the size each fetch was bounded to): equal callbacks by name,
  equal argument dicts, equal fetches, and the same refusals. The jobs
  include the instruct-pix2pix checkpoints (strength x 5 becomes the image
  guidance scale; `diffusers/sdxl-instructpix2pix-768` gets a 768 canvas
  unless the job is a tiny-model job) and a `refiner` parameter.
- The stitch workflow against the JAX package's: both fetch the same
  result images from the fake hive; the mosaic is equal pixel for pixel,
  and the image map, rows and columns too.
- `external_resources.get_image` against the port's fake hive: a start
  image bounded to the job's size or the global edge, and the refusals of
  the JAX package's limits: a body over the 3 MiB cap (announced by HEAD,
  or only found while streaming), a content type that is not an image,
  a scheme other than http(s); a blank URI gives None.
"""

import asyncio
import copy
import io

import pytest
from PIL import Image

from chiaswarm_tpu import job_arguments as jax_job_arguments
from chiaswarm_tpu.settings import Settings as JaxSettings
from chiaswarm_tpu_torch import external_resources, job_arguments
from chiaswarm_tpu_torch.fake_hive import FakeHive

SDXL = "stabilityai/stable-diffusion-xl-base-1.0"


class _Images:
    """get_image stand-ins for both packages: images by URI, fetches recorded."""

    def __init__(self):
        self.images = {u: Image.new("RGB", (640, 448), c) for u, c in
                       (("http://h/start.png", (200, 30, 40)), ("http://h/mask.png", (255,) * 3))}
        self.calls = {"jax": [], "port": []}

    def fetch(self, side, uri, size):
        self.calls[side].append((uri, size))
        return None if uri is None or not uri.strip() else self.images[uri]


@pytest.fixture()
def images(monkeypatch):
    table = _Images()

    async def jax_get_image(uri, size):
        return table.fetch("jax", uri, size)

    monkeypatch.setattr(jax_job_arguments, "get_image", jax_get_image)
    monkeypatch.setattr(job_arguments, "get_image",
                        lambda uri, size: table.fetch("port", uri, size))
    return table


def _both(job):
    """Each side formats its own deep copy (both pop from `parameters`)."""
    jax_out = asyncio.run(jax_job_arguments.format_args(copy.deepcopy(job), JaxSettings(),
                                                        "cpu"))
    return jax_out, job_arguments.format_args(copy.deepcopy(job))


JOBS = {
    "img2img-xl-sized": {
        "workflow": "img2img", "model_name": SDXL, "prompt": "a boat", "height": 512,
        "width": 768, "strength": 0.6, "start_image_uri": "http://h/start.png",
        "parameters": {"large_model": True, "scheduler_type": "EulerAncestralDiscreteScheduler",
                       "test_tiny_model": True}},
    "img2img-unsized": {
        "workflow": "img2img", "model_name": "runwayml/stable-diffusion-v1-5",
        "start_image_uri": "http://h/start.png", "num_inference_steps": 12},
    "img2img-pinned-pipeline": {
        "workflow": "img2img", "model_name": SDXL, "height": 1024, "width": 1024,
        "start_image_uri": "http://h/start.png",
        "parameters": {"pipeline_type": "StableDiffusionXLPipeline", "default_height": 640}},
    "inpaint-xl": {
        "workflow": "inpaint", "model_name": SDXL, "prompt": "a hat", "height": 768,
        "width": 512, "start_image_uri": "http://h/start.png",
        "mask_image_uri": "http://h/mask.png",
        "parameters": {"large_model": True, "scheduler_type": "DDIMScheduler",
                       "unsupported_pipeline_arguments": ["strength"]}, "strength": 0.9},
    # the edit checkpoints: strength * 5 becomes the image guidance scale
    "img2img-pix2pix": {
        "workflow": "img2img", "model_name": "timbrooks/instruct-pix2pix", "prompt": "snow",
        "strength": 0.3, "start_image_uri": "http://h/start.png"},
    "img2img-pix2pix-unset-strength": {
        "workflow": "img2img", "model_name": "timbrooks/instruct-pix2pix",
        "start_image_uri": "http://h/start.png"},
    # the size-locked checkpoint: a 768 canvas, except for tiny-model jobs
    "img2img-pix2pix-768": {
        "workflow": "img2img", "model_name": "diffusers/sdxl-instructpix2pix-768",
        "height": 512, "width": 512, "strength": 0.5, "start_image_uri": "http://h/start.png",
        "parameters": {"large_model": True}},
    "img2img-pix2pix-768-tiny": {
        "workflow": "img2img", "model_name": "diffusers/sdxl-instructpix2pix-768",
        "start_image_uri": "http://h/start.png", "parameters": {"test_tiny_model": True}},
    "txt2img-refiner": {
        "workflow": "txt2img", "model_name": SDXL, "prompt": "a boat",
        "parameters": {"refiner": {"model_name": "stabilityai/stable-diffusion-xl-refiner-1.0",
                                   "strength": 0.3}}},
    "txt2img-with-mask": {
        "workflow": "txt2img", "model_name": "diffusers/stable-diffusion-xl-1.0-inpainting-0.1",
        "start_image_uri": "http://h/start.png", "mask_image_uri": "http://h/mask.png",
        "parameters": {"image": "not-an-image", "prompt": "ignored", "guidance_scale": 4.0}},
}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_format_args_matches_jax(images, name):
    (jax_cb, jax_args), (cb, args) = _both(JOBS[name])
    assert cb.__name__ == jax_cb.__name__ == "diffusion_callback"
    assert args == jax_args
    assert images.calls["port"] == images.calls["jax"]
    if "image" not in args:  # txt2img
        assert "start_image_uri" not in JOBS[name]
    elif name == "img2img-pix2pix-768":
        # the size-locked checkpoint's canvas: the start image cropped square
        assert args["image"].size == (768, 768) and (args["height"], args["width"]) == (768, 768)
    else:
        assert args["image"] is images.images["http://h/start.png"]


@pytest.mark.parametrize("job", [
    {"workflow": "img2img", "model_name": SDXL},
    {"workflow": "img2img", "model_name": SDXL, "start_image_uri": "  "},
    {"workflow": "inpaint", "model_name": SDXL, "mask_image_uri": "http://h/mask.png"},
])
def test_missing_start_image_is_refused_like_jax(images, job):
    with pytest.raises(ValueError, match="Workflow requires an input image. None provided"):
        asyncio.run(jax_job_arguments.format_args(copy.deepcopy(job), JaxSettings(), "cpu"))
    with pytest.raises(ValueError, match="Workflow requires an input image. None provided"):
        job_arguments.format_args(copy.deepcopy(job))


def test_pix2pix_strength_mapping(images):
    """As tests/test_job_arguments.py expects of the JAX package: strength
    0.8 becomes an image guidance scale of 4.0, and strength goes."""
    _, kwargs = job_arguments.format_args({
        "id": "j1", "workflow": "img2img", "model_name": "timbrooks/instruct-pix2pix",
        "start_image_uri": "http://h/start.png", "strength": 0.8})
    assert kwargs["image_guidance_scale"] == pytest.approx(4.0)
    assert "strength" not in kwargs


@pytest.mark.parametrize("job,match", [
    # DeepFloyd IF waits for its slice
    ({"workflow": "img2img", "model_name": "DeepFloyd/IF-I-XL-v1.0",
      "start_image_uri": "http://h/start.png", "parameters": {"controlnet": {}}},
     "DeepFloyd IF is not ported"),
    ({"workflow": "img2img", "model_name": SDXL, "height": 2048, "width": 512},
     "max image size"),
])
def test_unported_img2img_variants_are_refused(images, job, match):
    with pytest.raises(ValueError, match=match):
        job_arguments.format_args(dict(job))


def _png(size, color=(10, 120, 250)) -> bytes:
    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, "PNG")
    return buf.getvalue()


@pytest.fixture()
def hive():
    hive = FakeHive()
    yield hive
    hive.close()


def test_get_image_bounds_the_image(hive):
    uri = hive.enqueue_file("wide.png", _png((1600, 800)), "image/png")
    assert external_resources.get_image(uri, None).size == (1024, 512)
    assert external_resources.get_image(uri, (512, 512)).size == (512, 256)
    small = hive.enqueue_file("small.png", _png((300, 200)), "image/png")
    assert external_resources.get_image(small, (512, 512)).size == (300, 200)
    assert external_resources.get_image("", None) is None
    assert external_resources.get_image(None, (64, 64)) is None


def test_get_image_refusals(hive):
    rejected = external_resources.InputRejected
    big = hive.enqueue_file("big.png", b"\0" * (3 * 1024 * 1024 + 1), "image/png")
    with pytest.raises(rejected, match="oversized image input: 3145729 bytes"):
        external_resources.get_image(big, None)
    text = hive.enqueue_file("note.txt", b"hello", "text/plain")
    with pytest.raises(rejected, match="non-image input"):
        external_resources.get_image(text, None)
    with pytest.raises(rejected, match="scheme 'file'"):
        external_resources.get_image("file:///etc/hostname", None)
    # a body larger than the cap whose size no header announced
    limits = external_resources.LIMITS
    stream = io.BytesIO(b"\0" * (limits.max_bytes + 1))
    with pytest.raises(rejected, match="while streaming"):
        external_resources._read_capped(stream, limits)
    assert len(external_resources._read_capped(io.BytesIO(b"\0" * limits.max_bytes),
                                               limits)) == limits.max_bytes


def test_stitch_matches_jax(hive):
    import base64

    import numpy as np

    colors = ((200, 30, 40), (20, 180, 90), (250, 250, 10))
    sizes = ((300, 200), (128, 256), (256, 256))
    jobs = [{"id": f"job-{i}", "resultUri": hive.enqueue_file(f"r{i}.png", _png(size, c),
                                                              "image/png")}
            for i, (size, c) in enumerate(zip(sizes, colors))]
    job = {"id": "st-1", "workflow": "stitch", "model_name": "none", "jobs": jobs,
           "content_type": "image/png"}
    jax_cb, jax_args = asyncio.run(jax_job_arguments.format_args(copy.deepcopy(job),
                                                                 JaxSettings(), "cpu"))
    cb, args = job_arguments.format_args(copy.deepcopy(job))
    want, want_cfg = jax_cb("cpu", "none", **{k: v for k, v in jax_args.items()
                                               if k != "model_name"})
    got, cfg = cb("cpu", "none", **{k: v for k, v in args.items() if k != "model_name"})
    assert cfg == want_cfg and (cfg["rows"], cfg["cols"]) == (2, 2)
    assert [r["job_id"] for r in cfg["image_map"]] == ["job-0", "job-1", "job-2"]

    def pixels(artifacts):
        blob = base64.b64decode(artifacts["primary"]["blob"])
        return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))

    assert pixels(got).shape == (512, 512, 3)
    np.testing.assert_array_equal(pixels(got), pixels(want))


def test_stitch_refuses_a_local_result_uri(hive, tmp_path):
    """A stitch job's result URIs are fetched over http(s) only: a `file:`
    URI naming a readable image on the worker's disk is refused, as
    aiohttp (the JAX package's client) refuses it."""
    local = tmp_path / "secret.png"
    local.write_bytes(_png((64, 64)))
    remote = hive.enqueue_file("r0.png", _png((64, 64)), "image/png")
    jobs = [{"id": "job-0", "resultUri": remote},
            {"id": "job-1", "resultUri": local.as_uri()}]
    job = {"id": "st-2", "workflow": "stitch", "model_name": "none", "jobs": jobs}
    with pytest.raises(external_resources.InputRejected, match="scheme 'file'"):
        job_arguments.format_args(copy.deepcopy(job))
    assert len(external_resources.download_images([remote])) == 1
