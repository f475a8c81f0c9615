"""Diffusion workload callback (the SD family, Flux and Kandinsky 2.x),
the counterpart of chiaswarm_tpu/workflows/diffusion.py
`diffusion_callback`: resolve the resident pipeline (registry.job_family:
a `FluxPipeline` job, or a generic one on a Flux model name, runs on the
FluxPipeline, whose txt2img reads `max_sequence_length` and
`guidance_scale` and ignores the SD family's other arguments; a Kandinsky
wire name, or a generic one on a Kandinsky 2.x model name, on the
KandinskyPipeline, which builds its prior in the same registry), run the
job (txt2img, or img2img, pix2pix and inpaint
with the start image and mask that job_arguments fetched; a `refiner`
stage resolves its pipeline in the same registry; the job's `lora`,
`textual_inversion` and `vae` go to the pipeline, whose ValueError for an
adapter it cannot load or match the worker turns into a fatal envelope),
package the images.

`diffusion_batched_callback` is the coalesced counterpart (JAX
`diffusion_batched_callback`): a group of jobs with one coalesce key runs
as few padded passes as the device's capacity allows (usually one), and
every job gets its own envelope. A group that shares a ControlNet shares
its one control image (the txt2img ControlNet wire delivers it as
`image`, which is then no start image), and its canvas is the control
image's unless the jobs name one.

A `pipeline_type` of a family the port does not serve is refused
(registry.check_pipeline_type); `StableDiffusionLatentUpscalePipeline`
(or a generic name on an upscaler's model name) serves the job with the
SD-x2 upscaler, and an SD job's `upscale: true` chains it (the
pipeline's run).

A job whose condition image a classical stand-in made carries the
preprocessor's name in the envelope's `degraded_preprocessors`, alone or
coalesced, as in the JAX callbacks.

The decoded images of every job, and of each member of a coalesced pass,
go through the NSFW safety checker (pipelines/safety.py, resolved by the
registry), as the JAX callbacks do: the envelope's `nsfw` and
`nsfw_checked`, false and false when no checker is available; the check
never fails a job.

A denoise stage-job of a workflow graph (`emit_raw`, set by
job_arguments' stage routing) skips the checker and the packaging: its
rows leave as one raw-handoff artifact (workflows/stages.py `pack_raw`,
timed as `handoff_s`) for the stage after it, alone or coalesced with
other denoise stage-jobs (the coalesce key keeps them apart from
monolithic jobs).

A group that `chunk_by_rows` splits over several passes has its adapters
prescanned before the first pass (`SDPipeline.prescan_adapter_chunks`), as
in the JAX callback: a later pass's refusal would otherwise throw away the
passes already run.

The worker's cancel, chunk and checkpoint arguments (`job_id`,
`denoise_chunk_steps`, `checkpoint_every_chunks`, `checkpoint_cb`,
`preview_every_chunks`, `preview_cb`, `resume`) reach only a pipeline
with `supports_checkpoint` (SDPipeline), as in the JAX callback: a Flux,
Kandinsky or standalone upscale job runs untouched, neither chunked nor
cancelled mid-pass. A coalesced member whose job was cancelled during the
pass comes back as (None, pipeline_config) with `cancelled` set: no
safety check, no artifacts, and the worker delivers nothing for it.
"""

from __future__ import annotations

import time

from ..cancel import JobCancelled
from ..capacity import coalesced_fit, default_canvas
from ..models.configs import model_family
from ..pipelines.common import chunk_by_rows
from ..pipelines.safety import flag_images
from ..post_processors.output_processor import OutputProcessor
from ..registry import check_pipeline_type
from ..telemetry import Span

# the arguments of a chunked pass, for pipelines that have the chunk seam
CHUNK_KWARGS = ("job_id", "denoise_chunk_steps", "checkpoint_every_chunks", "checkpoint_cb",
                "preview_every_chunks", "preview_cb", "resume")


def tiny_stand_in(model_name: str) -> str:
    """The tiny random-weight stand-in of the requested family (the
    `test_tiny_model` job parameter), as the JAX package's `_tiny_stand_in`
    picks it. A dedicated inpaint checkpoint's stand-in is the 4-channel
    tiny model of its family, so its jobs take the latent-masking path;
    the stand-ins of families the port does not serve yet are refused
    when their pipeline is built."""
    name = model_name.lower()
    if "pix2pix" in name or "ip2p" in name:
        return "test/tiny-pix2pix"
    if "flux" in name:
        return "test/tiny-flux-schnell" if "schnell" in name else "test/tiny-flux"
    if "kandinsky-3" in name or "kandinsky3" in name:
        return "test/tiny-kandinsky3"
    if "kandinsky" in name:
        if "controlnet" in name:
            return "test/tiny-kandinsky-controlnet"
        if "prior" in name:
            return "test/tiny-kandinsky-prior"
        return "test/tiny-kandinsky"
    if "cascade" in name:
        return "test/tiny-cascade-prior" if "prior" in name else "test/tiny-cascade"
    return "test/tiny-xl" if "xl" in model_family(model_name) else "test/tiny-sd"


def diffusion_callback(device_identifier: str, model_name: str, *, registry, **kwargs):
    content_type = kwargs.pop("content_type", "image/jpeg")
    outputs = kwargs.pop("outputs", ["primary"])
    # condition images that a classical stand-in made (job_arguments)
    degraded = kwargs.pop("degraded_preprocessors", None)
    # a denoise stage-job hands its rows on raw, unchecked and unpackaged
    emit_raw = bool(kwargs.pop("emit_raw", False))
    if kwargs.pop("test_tiny_model", False):
        model_name = tiny_stand_in(model_name)
    pipeline_type = kwargs.pop("pipeline_type", "DiffusionPipeline")
    check_pipeline_type(pipeline_type)
    chunk_kwargs = {key: kwargs.pop(key) for key in CHUNK_KWARGS if key in kwargs}
    pipeline = registry.get_pipeline(model_name, pipeline_type=pipeline_type)
    if getattr(pipeline, "supports_checkpoint", False):
        kwargs.update(chunk_kwargs)
    images, pipeline_config = pipeline.run(pipeline_type=pipeline_type, registry=registry,
                                           **kwargs)
    if degraded:
        pipeline_config["degraded_preprocessors"] = degraded
    if emit_raw:
        return _handoff(images, pipeline_config)

    t0 = time.perf_counter()
    pipeline_config["nsfw"], pipeline_config["nsfw_checked"] = flag_images(
        images, registry.safety_checker)
    pipeline_config["timings"]["safety_s"] = round(time.perf_counter() - t0, 4)
    t0 = time.perf_counter()
    processor = OutputProcessor(outputs, content_type)
    processor.add_outputs(images)
    results = processor.get_results()
    pipeline_config["timings"]["encode_artifacts_s"] = round(time.perf_counter() - t0, 4)
    return results, pipeline_config


def _handoff(images, pipeline_config: dict) -> tuple[dict, dict]:
    from .stages import pack_raw

    with Span("handoff", pipeline_config.setdefault("timings", {})):
        packaged = {"raw": pack_raw(images)}
    return packaged, pipeline_config


def diffusion_batched_callback(device_identifier: str, requests: list[dict], *, registry,
                               lora_slots_max: int = 8,
                               denoise_chunk_steps: int = 0) -> list[tuple[dict | None, dict]]:
    """A coalesced group (formatted job arguments that share one coalesce
    key: model, canvas, steps, scheduler, guidance, workflow, strength) ->
    [(artifacts, pipeline_config)], one per request, in order. The shared
    arguments are the first request's; prompts, seeds, start images, image
    counts and adapters are per request. A group larger than one pass runs
    in passes of whole requests; a request larger than one pass serves the
    images that fit, and says so (`batch_capped`). Raising is fine: the
    worker then serves every member alone, which reproduces the error per
    job. Each request's `id` arms its row's cancel probe on an SDPipeline
    (at `denoise_chunk_steps` boundaries). A pass whose every member was
    cancelled flags its members `cancelled` and the group's other passes
    go on; JobCancelled, every member of the group cancelled, is the
    worker's to handle."""
    shared = requests[0]
    model_name = shared["model_name"]
    if shared.get("test_tiny_model", False):
        model_name = tiny_stand_in(model_name)
    pipeline_type = shared.get("pipeline_type", "DiffusionPipeline")
    check_pipeline_type(pipeline_type)
    # a shared ControlNet: the coalesce key holds every member to the same
    # branch and control image
    cn_name = shared.get("controlnet_model_name")
    control_image = None
    if cn_name:
        control_image = (shared.get("control_image") if shared.get("control_image") is not None
                         else shared.get("image"))
    height, width = shared.get("height"), shared.get("width")
    if (height is None or width is None) and cn_name and control_image is not None:
        est_w, est_h = control_image.size
    elif (height is None or width is None) and shared.get("image") is not None:
        # img2img formatting sized the start images to the explicit canvas
        est_w, est_h = shared["image"].size
    else:
        est_h = int(height or default_canvas(model_name))
        est_w = int(width or est_h)
    if cn_name and (height is None or width is None):
        # a ControlNet job alone takes the control image's canvas
        height, width = est_h, est_w
    strength = shared.get("strength")
    envelopes, row_specs, counts = [], [], []
    for r in requests:
        envelopes.append((r.get("content_type", "image/jpeg"), r.get("outputs", ["primary"])))
        n = max(int(r.get("num_images_per_prompt", 1) or 1), 1)
        counts.append(n)
        xattn = r.get("cross_attention_kwargs") or {}
        row_specs.append({"prompt": r.get("prompt", ""),
                          "negative_prompt": r.get("negative_prompt", ""),
                          "seed": r.get("seed"), "num_images_per_prompt": n,
                          "image": None if cn_name else r.get("image"), "lora": r.get("lora"),
                          "job_id": r.get("id"),
                          "lora_scale": float(r.get("lora_scale", xattn.get("scale", 1.0))
                                              or 0.0)})

    max_rows = coalesced_fit(registry.device, model_name, sum(counts), est_h, est_w)
    capped = {}
    for i, n in enumerate(counts):
        if n > max_rows:
            capped[i] = {"requested": n, "served": max_rows}
            counts[i] = row_specs[i]["num_images_per_prompt"] = max_rows

    pipeline = registry.get_pipeline(model_name, pipeline_type=pipeline_type)
    chunk_kwargs = ({"denoise_chunk_steps": denoise_chunk_steps}
                    if getattr(pipeline, "supports_checkpoint", False) else {})
    cn_kwargs = {}
    if cn_name:
        cn_kwargs = {"controlnet_model_name": cn_name, "control_image": control_image,
                     "controlnet_conditioning_scale": float(
                         shared.get("controlnet_conditioning_scale", 1.0)),
                     "control_guidance_start": float(shared.get("control_guidance_start", 0.0)),
                     "control_guidance_end": float(shared.get("control_guidance_end", 1.0))}
    results = []
    chunks = chunk_by_rows(counts, max_rows)
    if len(chunks) > 1:
        # every pass's adapter refusal surfaces before the first pass runs
        prescan = getattr(pipeline, "prescan_adapter_chunks", None)
        if prescan is not None:
            prescan([row_specs[s:e] for s, e in chunks], lora_slots_max)
    for start, end in chunks:
        try:
            results.extend(pipeline.run_batched(
                row_specs[start:end], height=height, width=width,
                num_inference_steps=int(shared.get("num_inference_steps", 30)),
                guidance_scale=float(shared.get("guidance_scale", 7.5)),
                scheduler_type=shared.get("scheduler_type", "DPMSolverMultistepScheduler"),
                use_karras_sigmas=bool(shared.get("use_karras_sigmas", False)),
                pipeline_type=pipeline_type,
                strength=0.75 if strength is None else float(strength),
                lora_slots_max=lora_slots_max, **cn_kwargs, **chunk_kwargs))
        except JobCancelled:
            # every member of this pass was cancelled; the other passes'
            # members are served all the same
            results.extend((None, {"cancelled": True, "timings": {}})
                           for _ in range(start, end))
    if all(config.get("cancelled") for _, config in results):
        raise JobCancelled([r.get("id") for r in requests])

    out = []
    for i, ((images, pipeline_config), (content_type, outputs)) in enumerate(
            zip(results, envelopes)):
        if pipeline_config.get("cancelled"):
            # cancelled by the hive mid-pass: nothing is checked or packaged
            out.append((None, pipeline_config))
            continue
        if requests[i].get("emit_raw"):
            pipeline_config["batched_with"] = len(requests)
            if requests[i].get("degraded_preprocessors"):
                pipeline_config["degraded_preprocessors"] = requests[i]["degraded_preprocessors"]
            if i in capped:
                pipeline_config["batch_capped"] = capped[i]
            out.append(_handoff(images, pipeline_config))
            continue
        t0 = time.perf_counter()
        pipeline_config["nsfw"], pipeline_config["nsfw_checked"] = flag_images(
            images, registry.safety_checker)
        pipeline_config["timings"]["safety_s"] = round(time.perf_counter() - t0, 4)
        t0 = time.perf_counter()
        pipeline_config["batched_with"] = len(requests)
        if requests[i].get("degraded_preprocessors"):
            pipeline_config["degraded_preprocessors"] = requests[i]["degraded_preprocessors"]
        if i in capped:
            pipeline_config["batch_capped"] = capped[i]
        processor = OutputProcessor(outputs, content_type)
        processor.add_outputs(images)
        packaged = processor.get_results()
        pipeline_config["timings"]["encode_artifacts_s"] = round(time.perf_counter() - t0, 4)
        out.append((packaged, pipeline_config))
    return out
