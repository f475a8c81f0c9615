"""Coalesce compatibility: which raw hive jobs may share one padded
denoise + decode pass. The counterpart of chiaswarm_tpu/coalesce.py, of
which it keeps a copy (the port imports nothing of the JAX package).

`coalesce_key(job)` is the bucket: two jobs with equal keys give the same
images alone or coalesced, up to the rounding of other batch shapes.
Everything the pass shares (model, canvas, steps, scheduler, guidance,
workflow, img2img strength) is in the key; everything per row (prompt,
negative, seed, start image, image count, adapter and its scale) rides
outside it. None means the job runs alone.

For the families and features the port serves the key is the JAX
package's, element for element, the shared ControlNet element among them
(jobs with one ControlNet branch and one control image coalesce; a
ControlNet job with a start image, a QR chain or QR contents runs
alone). It is None wherever the JAX key is None, and also for the job
keys job_arguments refuses. Its last element is the stage, as in JAX: a
denoise stage-job of a workflow graph coalesces with other denoise
stage-jobs, never with a monolithic job (its envelope hands off raw rows),
and every other stage-job runs alone. Flux coalesces as in JAX: txt2img only, no
ControlNet, no adapter, a Flux wire name, explicit steps and guidance.
The port has one adapter route, the runtime delta
(pipelines/lora_runtime.py), so adapter jobs always coalesce, as in the
JAX package with `lora_runtime_delta` at its default.
"""

from __future__ import annotations

from .job_arguments import _UNPORTED_KEYS
from .models.configs import auto_family

# wire pipeline_type strings whose txt2img semantics the pass reproduces
_BATCHABLE_PIPELINE_TYPES = {
    None,
    "DiffusionPipeline",
    "StableDiffusionPipeline",
    "StableDiffusionXLPipeline",
    "AutoPipelineForText2Image",
}

# img2img wire names the pass serves (per-row start-image latents)
_BATCHABLE_I2I_PIPELINE_TYPES = {
    None,
    "DiffusionPipeline",
    "StableDiffusionImg2ImgPipeline",
    "StableDiffusionXLImg2ImgPipeline",
    "AutoPipelineForImage2Image",
}

# txt2img wire names the coalesced Flux pass reproduces (no CFG rows)
_BATCHABLE_FLUX_PIPELINE_TYPES = {
    None,
    "DiffusionPipeline",
    "FluxPipeline",
    "AutoPipelineForText2Image",
}

# txt2img ControlNet wire names whose batched semantics the shared
# ControlNet pass reproduces (one control image conditions every row)
_BATCHABLE_CN_PIPELINE_TYPES = {
    None,
    "StableDiffusionControlNetPipeline",
    "StableDiffusionXLControlNetPipeline",
}

# job keys that mean per-job structure the padded pass cannot carry
_UNBATCHABLE_JOB_KEYS = ("mask_image_uri", "refiner", "upscale", "textual_inversion", "vae")

# the only `parameters` keys a batchable job may carry
_SAFE_PARAMETER_KEYS = frozenset({
    "test_tiny_model",
    "pipeline_type",
    "scheduler_type",
    "num_inference_steps",
    "guidance_scale",
    "num_images_per_prompt",
    "large_model",
    "use_karras_sigmas",
    "default_height",
    "default_width",
    "controlnet",
    "cross_attention_kwargs",
    "lora_rank",
})

# the stage names of a workflow graph, as the JAX package spells them on
# both sides of the wire: chip stages run on the device, the host stages
# on the worker's stage lane
CHIP_STAGES = frozenset({
    "denoise", "upscale", "svd", "i2vgen", "txt2vid", "vid2vid", "audio",
})
CPU_STAGES = frozenset({
    "encode", "decode", "postprocess", "stitch", "caption",
})

DEFAULT_STEPS = 30
DEFAULT_GUIDANCE = 7.5
DEFAULT_SCHEDULER = "DPMSolverMultistepScheduler"
DEFAULT_STRENGTH = 0.75

# the smallest padded factor rank of the JAX package's batched program:
# declared ranks below it share one bucket
LORA_MIN_RANK = 4


def stage_of(job: dict) -> str | None:
    """The stage name a stage-job carries (the `stage` dict a hive's
    workflow expander stamps), or None for a monolithic job."""
    stage = job.get("stage")
    if isinstance(stage, dict):
        name = stage.get("name")
        if isinstance(name, str) and name:
            return name
    return None


def is_interactive(job: dict) -> bool:
    """The latency-sensitive marker: `priority: "interactive"` (or the
    legacy `sdaas_priority`) must not sit in a linger window."""
    return "interactive" in (str(job.get("priority", "")).lower(),
                             str(job.get("sdaas_priority", "")).lower())


def job_rows(job: dict) -> int:
    """Images this job contributes to a coalesced pass."""
    params = job.get("parameters") or {}
    try:
        n = int(params.get("num_images_per_prompt", job.get("num_images_per_prompt", 1)) or 1)
    except (TypeError, ValueError):
        return 1
    return max(n, 1)


def placement_model(job: dict) -> str | None:
    """The model name the registry knows this job by (the tiny stand-in
    when `test_tiny_model` is set)."""
    model = job.get("model_name")
    if not isinstance(model, str) or not model:
        return None
    params = job.get("parameters")
    tiny = bool(job.get("test_tiny_model"))
    if isinstance(params, dict):
        tiny = tiny or bool(params.get("test_tiny_model"))
    if tiny:
        from .workflows.diffusion import tiny_stand_in

        return tiny_stand_in(model)
    return model


def adapter_ref(job: dict) -> str | None:
    """One spelling of the adapter a job carries (the raw wire string or
    the resolved {lora, weight_name, subfolder}), or None: the scheduler
    caps the distinct adapters of a group with it."""
    lora = job.get("lora")
    if lora is None or lora == "":
        return None
    if isinstance(lora, dict):
        return "|".join(str(lora.get(k) or "") for k in ("lora", "weight_name", "subfolder"))
    return str(lora)


def _pow2_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _adapter_component(job: dict, params: dict) -> tuple | None:
    """The key's adapter element: adapter jobs coalesce with each other and
    with adapter-free jobs (identity rides per row); only a declared
    `lora_rank` splits, by power-of-two rank bucket, as in the JAX
    package."""
    if adapter_ref(job) is None:
        return None
    try:
        rank = int(params.get("lora_rank", job.get("lora_rank", 0)) or 0)
    except (TypeError, ValueError):
        rank = 0
    if rank <= 0:
        return None
    return ("lora", _pow2_bucket(max(rank, LORA_MIN_RANK)))


def _controlnet_component(job: dict, params: dict, workflow: str) -> tuple | None | bool:
    """The key's shared-ControlNet element, as in the JAX package: jobs
    conditioned by one ControlNet branch and one control image coalesce.
    False = ControlNet structure a pass cannot share (a start image, a QR
    chain, QR contents): the job runs alone; None = no ControlNet."""
    cn = params.get("controlnet")
    if cn is None:
        return None
    if not isinstance(cn, dict) or workflow != "txt2img":
        return False
    cn_params = cn.get("parameters") or {}
    if not isinstance(cn_params, dict):
        return False
    if cn_params.get("controlnet_prepipeline_type"):
        return False  # the QR two-stage chain runs per job
    if cn.get("qr_code_contents"):
        return False  # a generated control image is the job's own
    uri = cn.get("control_image_uri")
    if not uri:
        return False
    if params.get("pipeline_type") not in _BATCHABLE_CN_PIPELINE_TYPES:
        return False
    return (str(cn.get("controlnet_model_name", "lllyasviel/control_v11p_sd15_canny")),
            str(uri),
            str(cn.get("preprocessor") or ""),
            round(float(cn.get("controlnet_conditioning_scale", 1.0)), 4),
            round(float(cn.get("control_guidance_start", 0.0)), 4),
            round(float(cn.get("control_guidance_end", 1.0)), 4))


def _family(model: str) -> str | None:
    """The model's family (configs.auto_family) where it has a coalesced
    pass ("sd", "sdxl", "flux"); None for every other family."""
    family = auto_family(model)
    return family if family in ("sd", "sdxl", "flux") else None


def coalesce_key(job: dict) -> tuple | None:
    """The compatibility bucket of one raw hive job; None = not batchable."""
    try:
        workflow = job.get("workflow")
        if workflow not in ("txt2img", "img2img"):
            return None
        # only the denoise stage is a pass; the stage is a key dimension
        stage = stage_of(job)
        if stage is not None and stage != "denoise":
            return None
        model = job.get("model_name")
        if not isinstance(model, str) or not model:
            return None
        if any(k in job for k in _UNBATCHABLE_JOB_KEYS) or any(job.get(k) for k in _UNPORTED_KEYS):
            return None
        params = job.get("parameters") or {}
        if not isinstance(params, dict):
            return None
        if not set(params) <= _SAFE_PARAMETER_KEYS:
            return None
        adapter = _adapter_component(job, params)
        cn = _controlnet_component(job, params, workflow)
        if cn is False:
            return None
        if cn is not None and adapter_ref(job) is not None:
            # each coalesces alone; the two together run alone, as in JAX
            return None
        family = _family(model)
        if family is None:
            return None
        if family == "flux":
            # flow-matching txt2img only, and explicit steps and guidance:
            # the solo defaults depend on the variant (schnell's 4 steps)
            if workflow != "txt2img" or cn is not None or adapter_ref(job) is not None:
                return None
            if params.get("pipeline_type") not in _BATCHABLE_FLUX_PIPELINE_TYPES:
                return None
            if any(params.get(k, job.get(k)) is None
                   for k in ("num_inference_steps", "guidance_scale")):
                return None

        # canvas: explicit dims, else the model-pinned default; jobs on the
        # family default share the None bucket
        height = job.get("height", params.get("default_height"))
        width = job.get("width", params.get("default_width"))
        if (height is None) != (width is None):
            return None
        if height is not None:
            height, width = int(height), int(width)

        strength = None
        if workflow == "txt2img":
            if "start_image_uri" in job or "strength" in job:
                return None
            # the ControlNet element and the Flux branch checked their own
            # pipeline types
            if cn is None and family != "flux" and (
                    params.get("pipeline_type") not in _BATCHABLE_PIPELINE_TYPES):
                return None
        else:
            # per-request start images at a shared explicit canvas
            if not job.get("start_image_uri") or height is None:
                return None
            if params.get("pipeline_type") not in _BATCHABLE_I2I_PIPELINE_TYPES:
                return None
            if any(s in model.lower() for s in ("pix2pix", "ip2p", "inpaint")):
                return None
            strength = round(float(job.get("strength", DEFAULT_STRENGTH)), 4)

        steps = int(params.get("num_inference_steps",
                               job.get("num_inference_steps", DEFAULT_STEPS)))
        guidance = round(float(params.get("guidance_scale",
                                          job.get("guidance_scale", DEFAULT_GUIDANCE))), 4)
        scheduler = str(params.get("scheduler_type", DEFAULT_SCHEDULER))
        karras = bool(params.get("use_karras_sigmas", False))
        # the tiny flag at either level splits the bucket
        tiny = bool(params.get("test_tiny_model", False)) or bool(job.get("test_tiny_model", False))
        large = bool(params.get("large_model", False))
        return (model, family, height, width, steps, scheduler, guidance, karras, tiny, large,
                workflow, strength, adapter, cn, stage)
    except (TypeError, ValueError):
        # values that do not parse: the solo path gives its fatal envelope
        return None
