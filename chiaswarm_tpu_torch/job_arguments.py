"""Job JSON -> (workload callback, normalized kwargs), for the workflows
the port serves: `echo`, `stitch` (the images of earlier jobs' results,
fetched here, into one mosaic) and the SD family's `txt2img`, `img2img`
and `inpaint`.

Same defaults and precedence as chiaswarm_tpu/job_arguments.py (30 steps,
DPMSolverMultistepScheduler, the 1024 canvas cap, the img2img and inpaint
pipeline types chosen by `large_model`, the job's size threaded into the
image fetches, `parameters` passed through with the identity keys
protected), and the same special cases of img2img: the instruct-pix2pix
checkpoints take `strength * 5` as their image guidance scale, and the
size-locked checkpoints get a 768 canvas. A job's `lora` resolves against
the settings' `lora_root_dir` (loras.py); `textual_inversion`, `vae`,
`lora_scale` and `cross_attention_kwargs` pass through from `parameters`,
as does `upscale` (the SD-x2 stage the pipeline chains). A Flux job's
wire arguments (`pipeline_type: FluxPipeline`, `max_sequence_length`,
`guidance_scale`) pass through from `parameters` as well, as do a
Kandinsky job's `prior_timesteps` and `pipeline_prior_type` (taken out of
`parameters` first, as JAX does) and its split-embeds `image_embeds` /
`negative_image_embeds`.

A `parameters.controlnet` dict gives the ControlNet arguments, as in the
JAX package's `format_controlnet_args`: the control image is the
fetched `control_image_uri`, a QR code of `qr_code_contents` (which
overrides it), or the start image; a `preprocessor` turns the start image
(else the control image) into the condition image, its detector running
on the worker's device under the settings' model root; a preprocessor
whose learned detector has no weights there, so that a classical
stand-in answered, is listed in `degraded_preprocessors`, which the
envelope carries. The txt2img ControlNet pipelines take the control
image as `image`, the others as `control_image`, and an img2img start
image is cropped to the control image's size. The ControlNet pipeline
types are chosen by `large_model`. The Kandinsky 2.2 depth ControlNet
takes a depth `hint` instead (the port's DPT on the control image,
pre_processors/depth_estimator.make_hint), as in JAX.

A stage-job of a workflow graph (a `stage` dict, as a stage-graph hive
stamps it) routes first, as in the JAX package: the host stages (encode,
decode / postprocess) and the upscale stage to their callbacks
(workflows/stages.py), a denoise stage with the raw handoff to the classic
diffusion dispatch with `emit_raw` set.

A workflow or feature that is not ported yet raises ValueError naming it,
which the worker turns into a fatal envelope. Input images are fetched,
and preprocessed, here (`get_image` blocks: the worker formats a job on
its executor thread).
"""

from __future__ import annotations

from .external_resources import LIMITS, download_images, get_image, get_qrcode_image, is_blank
from .loras import resolve_lora
from .pipelines.aux_models import Detectors
from .pre_processors.controlnet import is_degraded_preprocessor, preprocess_image
from .pre_processors.depth_estimator import make_hint
from .pre_processors.image_utils import center_crop_resize, resize_square
from .settings import Settings, load_settings
from .workflows.diffusion import diffusion_callback
from .workflows.echo import echo_callback
from .workflows.stages import format_stage_args
from .workflows.stitch import stitch_callback

DEFAULT_SCHEDULER = "DPMSolverMultistepScheduler"
MAX_SIZE = LIMITS.max_edge

# job keys of workflows and features this slice does not serve
_UNPORTED_KEYS = ("video_uri",)
# the JAX package's special cases of img2img
_PIX2PIX_MODELS = {"timbrooks/instruct-pix2pix", "diffusers/sdxl-instructpix2pix-768"}
_SIZE_LOCKED_MODELS = {"diffusers/sdxl-instructpix2pix-768",
                       "kandinsky-community/kandinsky-2-2-controlnet-depth"}

# identity / payload keys a hive-controlled parameters dict may fill but
# never rewrite
_PROTECTED_ARGS = frozenset({"model_name", "prompt", "negative_prompt", "image", "mask_image",
                             "workflow", "id"})


def format_args(job: dict, settings: Settings | None = None, device=None):
    """-> (callback, kwargs). `settings` (read from disk when not given)
    supplies the root a bare LoRA name resolves under and the model root
    of the preprocessors' detectors, which run on `device` (the card when
    None)."""
    args = dict(job)
    settings = settings or load_settings()
    if "lora" in args:
        args["lora"] = resolve_lora(args["lora"], settings.lora_root_dir)
    stage = args.pop("stage", None)
    workflow = args.pop("workflow", None)
    if isinstance(stage, dict) and stage.get("name"):
        routed = format_stage_args(stage, workflow, args)
        if routed is not None:
            return routed
    if workflow == "echo":
        return echo_callback, args
    if workflow == "stitch":
        args["images"] = download_images([j["resultUri"] for j in args["jobs"]])
        return stitch_callback, args
    if workflow not in (None, "txt2img", "img2img", "inpaint"):
        raise ValueError(f"workflow {workflow!r} is not ported to chiaswarm_tpu_torch yet")
    for key in _UNPORTED_KEYS:
        if args.get(key):
            raise ValueError(f"job key {key!r} is not ported to chiaswarm_tpu_torch yet")
    model_name = args.get("model_name", "")
    if model_name.startswith("DeepFloyd/"):
        raise ValueError("DeepFloyd IF is not ported to chiaswarm_tpu_torch yet")
    detectors = Detectors.from_settings(settings, "cuda" if device is None else device)
    return diffusion_callback, format_stable_diffusion_args(args, workflow, detectors)


def format_stable_diffusion_args(args: dict, workflow: str | None,
                                 detectors: Detectors) -> dict:
    size = None
    if "height" in args and "width" in args:
        if args["height"] > MAX_SIZE or args["width"] > MAX_SIZE:
            raise ValueError(f"The max image size is ({MAX_SIZE}, {MAX_SIZE}); "
                             f"got ({args['height']}, {args['width']}).")
        size = (args["width"], args["height"])  # PIL (width, height)
    args.setdefault("prompt", "")
    parameters = dict(args.pop("parameters", {}) or {})

    if workflow == "img2img":
        format_img2img_args(args, parameters, size, detectors)
    elif workflow == "inpaint" or "mask_image_uri" in args:
        format_inpaint_args(args, parameters, size, detectors)
    elif workflow == "txt2img":
        format_txt2img_args(args, parameters, size, detectors)

    args.setdefault("num_inference_steps", 30)
    for key in ("pipeline_prior_type", "prior_timesteps"):
        if key in parameters:
            args[key] = parameters.pop(key)
    args["pipeline_type"] = parameters.pop("pipeline_type", "DiffusionPipeline")
    args["scheduler_type"] = parameters.pop("scheduler_type", DEFAULT_SCHEDULER)
    # model-specified default canvas
    default_height = parameters.pop("default_height", None)
    default_width = parameters.pop("default_width", None)
    if default_height is not None and "height" not in args:
        args["height"] = default_height
    if default_width is not None and "width" not in args:
        args["width"] = default_width
    for arg in parameters.pop("unsupported_pipeline_arguments", []):
        args.pop(arg, None)
    for k, v in parameters.items():
        if k in _PROTECTED_ARGS and args.get(k) not in (None, ""):
            continue
        args[k] = v
    return args


def format_txt2img_args(args: dict, parameters: dict, size, detectors: Detectors) -> None:
    if "controlnet" in parameters:
        parameters.setdefault(
            "pipeline_type",
            "StableDiffusionXLControlNetPipeline" if parameters.get("large_model", False)
            else "StableDiffusionControlNetPipeline")
        format_controlnet_args(args, parameters, None, size, detectors)


def format_inpaint_args(args: dict, parameters: dict, size, detectors: Detectors) -> None:
    # the inpaint pipeline type is chosen before img2img's setup, whose
    # own default would otherwise claim the slot
    large = parameters.get("large_model", False)
    if "controlnet" in parameters:
        parameters.setdefault(
            "pipeline_type",
            "StableDiffusionXLControlNetInpaintPipeline" if large
            else "StableDiffusionControlNetInpaintPipeline")
    else:
        parameters.setdefault(
            "pipeline_type",
            "StableDiffusionXLInpaintPipeline" if large else "StableDiffusionInpaintPipeline")
    # inpaint inherits img2img's setup, since it has a start image
    format_img2img_args(args, parameters, size, detectors)
    args["mask_image"] = get_image(args.pop("mask_image_uri"), size)
    args.pop("height", None)
    args.pop("width", None)
    if "controlnet" in parameters:
        format_controlnet_args(args, parameters, None, size, detectors)


def format_img2img_args(args: dict, parameters: dict, size, detectors: Detectors) -> None:
    start_image = get_image(args.pop("start_image_uri", None), size)
    if size is None and start_image is not None:
        size = start_image.size
    if "controlnet" in parameters:
        format_controlnet_args(args, parameters, start_image, size, detectors)
        parameters.setdefault(
            "pipeline_type",
            "StableDiffusionXLControlNetImg2ImgPipeline" if parameters.get("large_model", False)
            else "StableDiffusionControlNetImg2ImgPipeline")
    elif "pipeline_type" not in parameters:
        parameters["pipeline_type"] = (
            "StableDiffusionXLImg2ImgPipeline" if parameters.get("large_model", False)
            else "StableDiffusionImg2ImgPipeline")
        # the canvas comes from the start image
        args.pop("height", None)
        args.pop("width", None)
    if args["model_name"] in _PIX2PIX_MODELS:
        # the edit checkpoints take an image guidance scale (1-5), not a
        # strength (0-1)
        args["image_guidance_scale"] = args.pop("strength", 0.6) * 5
    if start_image is None and args.get("control_image") is not None:
        start_image = args["control_image"]
    if start_image is None:
        raise ValueError("Workflow requires an input image. None provided")
    if args["model_name"] in _SIZE_LOCKED_MODELS and not parameters.get("test_tiny_model"):
        # these checkpoints are trained at 768 only; tiny-model test jobs
        # keep their small canvas
        start_image = resize_square(start_image).resize((768, 768))
        args["height"] = start_image.height
        args["width"] = start_image.width
    if "control_image" in args:
        start_image = center_crop_resize(start_image, args["control_image"].size)
    args["image"] = start_image


def _preprocess(args: dict, image, preprocessor: str, detectors: Detectors) -> object:
    """The condition image, and the preprocessor listed in
    `degraded_preprocessors` when a stand-in made it."""
    control_image = preprocess_image(image, preprocessor, detectors=detectors)
    if is_degraded_preprocessor(preprocessor, detectors):
        args.setdefault("degraded_preprocessors", []).append(preprocessor)
    return control_image


def format_controlnet_args(args: dict, parameters: dict, start_image, size,
                           detectors: Detectors) -> None:
    controlnet = parameters.pop("controlnet")
    control_image = get_image(controlnet.get("control_image_uri"), size)
    args["save_preprocessed_input"] = True
    # the JAX package runs a preprocessor on an executor so that its event
    # loop keeps turning; the port formats a job on the worker's executor
    # thread already, so it calls the preprocessor in place
    if not is_blank(controlnet.get("qr_code_contents")):
        # a QR code overrides any control image given
        control_image = get_qrcode_image(controlnet["qr_code_contents"], size)
        if start_image is None:
            start_image = control_image
    elif start_image is not None and not is_blank(controlnet.get("preprocessor")):
        control_image = _preprocess(args, start_image, controlnet["preprocessor"], detectors)
    elif control_image is not None and not is_blank(controlnet.get("preprocessor")):
        control_image = _preprocess(args, control_image, controlnet["preprocessor"], detectors)
    elif control_image is None:
        control_image = start_image
    if control_image is None:
        raise ValueError("Controlnet specified but no control image provided")

    controlnet_parameters = controlnet.get("parameters", {})
    args["controlnet_model_type"] = controlnet_parameters.get("controlnet_model_type",
                                                              "ControlNetModel")
    if "controlnet_prepipeline_type" in controlnet_parameters:
        args["controlnet_prepipeline_type"] = controlnet_parameters[
            "controlnet_prepipeline_type"]
    args["controlnet_model_name"] = controlnet.get("controlnet_model_name",
                                                   "lllyasviel/control_v11p_sd15_canny")
    args["controlnet_conditioning_scale"] = float(
        controlnet.get("controlnet_conditioning_scale", 1.0))
    args["control_guidance_start"] = float(controlnet.get("control_guidance_start", 0.0))
    args["control_guidance_end"] = float(controlnet.get("control_guidance_end", 1.0))
    if args["model_name"] == "kandinsky-community/kandinsky-2-2-controlnet-depth":
        # the Kandinsky ControlNet takes a depth hint instead of an image
        args["hint"] = make_hint(control_image, detectors)
    elif parameters.get("pipeline_type") in ("StableDiffusionControlNetPipeline",
                                           "StableDiffusionXLControlNetPipeline"):
        # the txt2img ControlNet pipelines take the control image as `image`
        args["image"] = control_image
    else:
        args["control_image"] = control_image
