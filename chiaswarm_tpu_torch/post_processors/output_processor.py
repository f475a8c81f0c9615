"""Artifact packaging: images -> hive result envelopes.

Wire-format parity with chiaswarm_tpu/post_processors/output_processor.py:
every artifact is {blob: b64, content_type, thumbnail: b64 100px jpeg,
sha256_hash}; 2-9 images are composited into a grid; an exception becomes
an image artifact with its message rendered on it; a fatal envelope tells
the hive not to resubmit. Images arrive as uint8 [H, W, 3] arrays (the
pipeline's on-device quantisation) or PIL images.
"""

from __future__ import annotations

import base64
import hashlib
import io
import itertools

import numpy as np
from PIL import Image, ImageDraw

from .. import __version__

GRID_LAYOUTS = ((1, (1, 1)), (2, (1, 2)), (4, (2, 2)), (6, (2, 3)), (9, (3, 3)))
THUMBNAIL_SIZE = (100, 100)


def to_pil(image) -> Image.Image:
    if isinstance(image, Image.Image):
        return image
    return Image.fromarray(np.asarray(image, dtype=np.uint8))


class OutputProcessor:
    """Collects pipeline outputs and renders the hive `artifacts` dict."""

    def __init__(self, output_list, main_content_type: str):
        self.outputs: list[Image.Image] = []
        self.output_list = output_list
        self.main_content_type = main_content_type

    def add_outputs(self, images) -> None:
        self.outputs.extend(to_pil(im) for im in images)

    def get_results(self) -> dict:
        results = {}
        if "primary" in self.output_list:
            composite = post_process(self.outputs)
            buffer = image_to_buffer(composite, self.main_content_type)
            results["primary"] = make_result(buffer, self.main_content_type)
        return results


def post_process(images: list[Image.Image]) -> Image.Image:
    """Composite 1-9 images into the reference's grid layouts."""
    n = len(images)
    for cap, (rows, cols) in GRID_LAYOUTS:
        if n <= cap:
            if rows == cols == 1:
                return images[0]
            w, h = images[0].size
            grid = Image.new("RGB", size=(cols * w, rows * h))
            for img, (r, c) in zip(images, itertools.product(range(rows), range(cols))):
                grid.paste(img, box=(c * w, r * h))
            return grid
    raise ValueError(f"Too many images ({n}) for post-processing. Maximum supported images: 9")


def image_to_buffer(image: Image.Image, content_type: str, quality="web_high") -> io.BytesIO:
    buffer = io.BytesIO()
    if content_type == "image/png":
        image.save(buffer, format="PNG")
    elif content_type == "image/jpeg":
        image.save(buffer, format="JPEG", quality=quality, optimize=True, progressive=True)
    else:
        raise ValueError(f"Invalid image format: {content_type}")
    buffer.seek(0)
    return buffer


def make_thumbnail(buffer: io.BytesIO) -> io.BytesIO:
    image = Image.open(io.BytesIO(buffer.getvalue())).convert("RGB")
    image.thumbnail(THUMBNAIL_SIZE, Image.Resampling.LANCZOS)
    return image_to_buffer(image, "image/jpeg", "web_low")


def image_from_text(text: str, size=(512, 512), color=0) -> Image.Image:
    image = Image.new(mode="RGB", size=size, color=color)
    ImageDraw.Draw(image).multiline_text((5, 5), text)
    return image


def make_result(buffer: io.BytesIO, content_type: str) -> dict:
    payload = buffer.getvalue()
    return {
        "blob": base64.b64encode(payload).decode("UTF-8"),
        "content_type": content_type,
        "thumbnail": base64.b64encode(make_thumbnail(buffer).getvalue()).decode("UTF-8"),
        "sha256_hash": hashlib.sha256(payload).hexdigest(),
    }


def exception_image(e: Exception, content_type: str):
    message = e.args[0] if e.args else "error generating image"
    if not str(content_type).startswith("image/"):
        content_type = "image/jpeg"
    buffer = image_to_buffer(image_from_text(str(message)), content_type)
    return {"primary": make_result(buffer, content_type)}, {"error": message}


def fatal_exception_response(e: Exception, job_id, job: dict) -> dict:
    """Result envelope for unrecoverable jobs: the hive must NOT resubmit."""
    artifacts, pipeline_config = exception_image(e, job.get("content_type", "image/jpeg"))
    return {
        "id": job_id,
        "artifacts": artifacts,
        "nsfw": False,
        "worker_version": __version__,
        "fatal_error": True,
        "pipeline_config": pipeline_config,
    }
