"""Stage-job callbacks of a workflow graph, the counterpart of
chiaswarm_tpu/workflows/stages.py (the port keeps its own copy).

A stage-graph hive (chiaswarm_tpu/hive_server/dag.py) splits a diffusion
request into encode / denoise [/ upscale] / decode stage-jobs. The chip
stages run on the device: denoise is the classic diffusion pass with the
`emit_raw` handoff flag (workflows/diffusion.py), upscale the SD-x2
upscaler of `upscale_stage_callback`. The host stages (encode, decode,
postprocess) format to the callbacks here and run on the worker's stage
lane, off the device thread, so the decode of one pass overlaps the denoise
of the next.

The raw handoff (`application/x-swarm-raw+json`) is JAX's container: JSON
of losslessly PNG-encoded rows, so that the decode stage packages the same
uint8 pixels the monolithic job would have packaged, and each package reads
the other's blob. The decode stage runs the NSFW checker through the
worker's registry (the process's checker on the worker's device, whichever
thread asks) and packages as the monolithic callback does: the final
envelope is the monolithic job's.
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import logging

import torch
from PIL import Image

from ..pipelines.safety import flag_images
from ..pipelines.stable_diffusion import UPSCALE_PIPELINE
from ..pipelines.upscale import upscaler_name_for
from ..post_processors.output_processor import OutputProcessor, to_pil
from ..telemetry import Span
from ..weights import MissingWeightsError
from .diffusion import tiny_stand_in

logger = logging.getLogger(__name__)

RAW_CONTENT_TYPE = "application/x-swarm-raw+json"

# wire workflows whose stage names the graph templates own; a stage of an
# explicit chain keeps its own workflow's dispatch
_DIFFUSION_WORKFLOWS = (None, "txt2img", "img2img")

# workflows that take a start image, for the handoff="image" seam
_IMAGE_CONSUMERS = ("img2img", "img2vid", "vid2vid", "img2txt")


def pack_raw(images) -> dict:
    """Rows (PIL images or uint8 [H, W, 3] arrays) -> one raw-handoff
    artifact: the stage's whole output as one content-addressed blob."""
    rows = []
    for image in images:
        buffer = io.BytesIO()
        to_pil(image).save(buffer, format="PNG")
        rows.append(base64.b64encode(buffer.getvalue()).decode("ascii"))
    payload = json.dumps({"format": "png", "images": rows}).encode("utf-8")
    return {
        "blob": base64.b64encode(payload).decode("ascii"),
        "content_type": RAW_CONTENT_TYPE,
        "sha256_hash": hashlib.sha256(payload).hexdigest(),
        "rows": len(rows),
    }


def unpack_raw(payload: bytes) -> list[Image.Image]:
    doc = json.loads(payload.decode("utf-8"))
    return [Image.open(io.BytesIO(base64.b64decode(row))).convert("RGB")
            for row in doc.get("images", [])]


def input_blob(inputs, key: str | None = None) -> bytes | None:
    """The newest predecessor artifact's bytes (by artifact key, when
    given) from a stage-job's inputs, which the worker hydrated: each spool
    href fetched and stamped back as `blob`."""
    for entry in reversed(list(inputs or [])):
        artifacts = entry.get("artifacts") if isinstance(entry, dict) else None
        if not isinstance(artifacts, dict):
            continue
        for name, art in artifacts.items():
            if key is not None and name != key:
                continue
            blob = art.get("blob") if isinstance(art, dict) else None
            if isinstance(blob, str) and blob:
                try:
                    return base64.b64decode(blob)
                except (ValueError, TypeError):
                    continue
    return None


def stage_images(inputs) -> list[Image.Image]:
    """The rows a consuming stage works from: the predecessor's raw
    handoff, else its packaged primary artifact."""
    payload = input_blob(inputs, key="raw")
    if payload is not None:
        return unpack_raw(payload)
    payload = input_blob(inputs, key="primary")
    if payload is not None:
        return [Image.open(io.BytesIO(payload)).convert("RGB")]
    raise ValueError("stage-job has no input artifacts to work from (predecessor handoff "
                     "missing or not yet hydrated)")


def format_stage_args(stage: dict, workflow, args: dict):
    """Route one stage-job: (callback, kwargs) for the stages this module
    owns, or None to fall through to the classic dispatch, with the graph's
    metadata (`emit_raw`, an injected start image) already in `args`."""
    name = str(stage.get("name") or "")
    inputs = stage.get("inputs") or []
    if workflow in _DIFFUSION_WORKFLOWS:
        if name == "encode":
            args.setdefault("prompt", "")
            args.setdefault("negative_prompt", "")
            return encode_callback, args
        if name in ("decode", "postprocess"):
            args["stage_inputs"] = inputs
            return decode_callback, args
        if name == "upscale":
            args["stage_inputs"] = inputs
            return upscale_stage_callback, args
        if name == "denoise" and stage.get("handoff") == "raw":
            # the classic pass, which hands its rows on unpackaged
            args["emit_raw"] = True
            return None
    if (stage.get("handoff") == "image" and inputs and workflow in _IMAGE_CONSUMERS
            and "start_image_uri" not in args and args.get("image") is None):
        payload = input_blob(inputs, key="primary")
        if payload is not None:
            args["image"] = Image.open(io.BytesIO(payload)).convert("RGB")
    return None


def encode_callback(device_identifier: str, model_name: str, **kwargs):
    """The encode stage: the prompts' fingerprints, host work that names
    the conditioning without the free text (a chip-less host serves it)."""
    prompt = str(kwargs.get("prompt", ""))
    negative = str(kwargs.get("negative_prompt", ""))
    pipeline_config = {"stage": "encode", "model": model_name, "device": device_identifier}
    with Span("encode", pipeline_config.setdefault("timings", {})):
        doc = {
            "model_name": model_name,
            "prompt": prompt,
            "negative_prompt": negative,
            "prompt_sha256": hashlib.sha256(prompt.encode("utf-8")).hexdigest(),
            "negative_sha256": hashlib.sha256(negative.encode("utf-8")).hexdigest(),
            # whitespace tokens: a size hint, not a model vocabulary
            "tokens_estimate": len(prompt.split()),
        }
        payload = json.dumps(doc, sort_keys=True).encode("utf-8")
    artifacts = {"conditioning": {
        "blob": base64.b64encode(payload).decode("ascii"),
        "content_type": "application/json",
        "sha256_hash": hashlib.sha256(payload).hexdigest(),
    }}
    return artifacts, pipeline_config


def decode_callback(device_identifier: str, model_name: str, *, registry, **kwargs):
    """The decode / postprocess stage: the monolithic callback's tail (the
    NSFW check, the grid, the encode) on the predecessor's raw rows."""
    content_type = kwargs.pop("content_type", "image/jpeg")
    outputs = kwargs.pop("outputs", ["primary"])
    images = stage_images(kwargs.pop("stage_inputs", []))
    pipeline_config = {"stage": "decode", "model": model_name, "device": device_identifier,
                       "rows": len(images)}
    with Span("decode", pipeline_config.setdefault("timings", {})):
        pipeline_config["nsfw"], pipeline_config["nsfw_checked"] = flag_images(
            images, registry.safety_checker)
        processor = OutputProcessor(outputs, content_type)
        processor.add_outputs(images)
        results = processor.get_results()
    return results, pipeline_config


def upscale_stage_callback(device_identifier: str, model_name: str, *, registry,
                           seed: int | None = None, **kwargs):
    """The upscale stage: the SD-x2 upscaler as a stage of its own (the
    monolithic job chains it inside its pass), on the denoise stage's raw
    rows, its noise drawn from the stage-job's seed; raw rows out for the
    decode stage. Without the upscaler's weights the rows are resized 2x
    (LANCZOS) and the envelope says so (`upscaler: resize-fallback`), as in
    JAX; so is any other failure to build it (a broken checkpoint, a
    registry fault): an auxiliary stage never fails the job."""
    params = kwargs.get("parameters") or {}
    tiny = bool(kwargs.pop("test_tiny_model", False)
                or (isinstance(params, dict) and params.get("test_tiny_model")))
    if tiny:
        model_name = tiny_stand_in(model_name)
    images = stage_images(kwargs.pop("stage_inputs", []))
    pipeline_config = {"stage": "upscale", "model": model_name, "rows": len(images)}
    timings = pipeline_config.setdefault("timings", {})
    try:
        upscaler = registry.get_pipeline(upscaler_name_for(model_name),
                                         pipeline_type=UPSCALE_PIPELINE)
    except Exception as e:  # missing weights or a registry fault: resize
        if not isinstance(e, MissingWeightsError):
            logger.warning("upscaler unavailable (%s); resize fallback", e)
        upscaler = None
    with Span("upscale", timings):
        if upscaler is not None:
            generator = torch.Generator(device=registry.device).manual_seed(int(seed or 0))
            images = upscaler.upscale(images, prompt=str(kwargs.get("prompt", "")),
                                      negative_prompt=str(kwargs.get("negative_prompt", "")),
                                      generator=generator)
            timings["upscale_step_ms"] = round(upscaler.last_timings["step_ms"], 4)
        else:
            images = [im.resize((im.width * 2, im.height * 2), Image.Resampling.LANCZOS)
                      for im in images]
            pipeline_config["upscaler"] = "resize-fallback"
    pipeline_config["upscaled"] = True
    return {"raw": pack_raw(images)}, pipeline_config
