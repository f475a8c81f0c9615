"""Job JSON -> (workload callback, normalized kwargs), for the workflows
the port serves: `echo` and the SD family's `txt2img`, `img2img` and
`inpaint`.

Same defaults and precedence as chiaswarm_tpu/job_arguments.py (30 steps,
DPMSolverMultistepScheduler, the 1024 canvas cap, the img2img and inpaint
pipeline types chosen by `large_model`, the job's size threaded into the
image fetches, `parameters` passed through with the identity keys
protected). A workflow or feature that is not ported yet raises
ValueError naming it, which the worker turns into a fatal envelope; so
do ControlNet, the instruct-pix2pix checkpoints and the size-locked 768
models, by name. Input images are fetched here (`get_image` blocks: the
worker formats a job on its executor thread).
"""

from __future__ import annotations

from .external_resources import LIMITS, get_image
from .workflows.diffusion import diffusion_callback
from .workflows.echo import echo_callback

DEFAULT_SCHEDULER = "DPMSolverMultistepScheduler"
MAX_SIZE = LIMITS.max_edge

# job keys of workflows and features this slice does not serve
_UNPORTED_KEYS = ("lora", "video_uri")
_UNPORTED_PARAMETERS = ("controlnet", "refiner", "upscale", "textual_inversion", "vae")
# the JAX package's special cases of img2img, refused by name here
_PIX2PIX_MODELS = {"timbrooks/instruct-pix2pix", "diffusers/sdxl-instructpix2pix-768"}
_SIZE_LOCKED_MODELS = {"diffusers/sdxl-instructpix2pix-768",
                       "kandinsky-community/kandinsky-2-2-controlnet-depth"}

# identity / payload keys a hive-controlled parameters dict may fill but
# never rewrite
_PROTECTED_ARGS = frozenset({"model_name", "prompt", "negative_prompt", "image", "mask_image",
                             "workflow", "id"})


def format_args(job: dict):
    args = dict(job)
    workflow = args.pop("workflow", None)
    if workflow == "echo":
        return echo_callback, args
    if workflow not in (None, "txt2img", "img2img", "inpaint"):
        raise ValueError(f"workflow {workflow!r} is not ported to chiaswarm_tpu_torch yet")
    for key in _UNPORTED_KEYS:
        if args.get(key):
            raise ValueError(f"job key {key!r} is not ported to chiaswarm_tpu_torch yet")
    model_name = args.get("model_name", "")
    if model_name.startswith("DeepFloyd/"):
        raise ValueError("DeepFloyd IF is not ported to chiaswarm_tpu_torch yet")
    if model_name in _PIX2PIX_MODELS | _SIZE_LOCKED_MODELS:
        raise ValueError(f"{model_name} is not ported to chiaswarm_tpu_torch yet")
    return diffusion_callback, format_stable_diffusion_args(args, workflow)


def format_stable_diffusion_args(args: dict, workflow: str | None) -> dict:
    size = None
    if "height" in args and "width" in args:
        if args["height"] > MAX_SIZE or args["width"] > MAX_SIZE:
            raise ValueError(f"The max image size is ({MAX_SIZE}, {MAX_SIZE}); "
                             f"got ({args['height']}, {args['width']}).")
        size = (args["width"], args["height"])  # PIL (width, height)
    args.setdefault("prompt", "")
    parameters = dict(args.pop("parameters", {}) or {})
    for key in _UNPORTED_PARAMETERS:
        if parameters.get(key):
            raise ValueError(f"parameter {key!r} is not ported to chiaswarm_tpu_torch yet")

    if workflow == "img2img":
        format_img2img_args(args, parameters, size)
    elif workflow == "inpaint" or "mask_image_uri" in args:
        format_inpaint_args(args, parameters, size)

    args.setdefault("num_inference_steps", 30)
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


def format_inpaint_args(args: dict, parameters: dict, size) -> None:
    # the inpaint pipeline type is chosen before img2img's setup, whose
    # own default would otherwise claim the slot
    parameters.setdefault(
        "pipeline_type",
        "StableDiffusionXLInpaintPipeline" if parameters.get("large_model", False)
        else "StableDiffusionInpaintPipeline")
    # inpaint inherits img2img's setup, since it has a start image
    format_img2img_args(args, parameters, size)
    args["mask_image"] = get_image(args.pop("mask_image_uri"), size)
    args.pop("height", None)
    args.pop("width", None)


def format_img2img_args(args: dict, parameters: dict, size) -> None:
    start_image = get_image(args.pop("start_image_uri", None), size)
    if "pipeline_type" not in parameters:
        parameters["pipeline_type"] = (
            "StableDiffusionXLImg2ImgPipeline" if parameters.get("large_model", False)
            else "StableDiffusionImg2ImgPipeline")
        # the canvas comes from the start image
        args.pop("height", None)
        args.pop("width", None)
    if start_image is None:
        raise ValueError("Workflow requires an input image. None provided")
    args["image"] = start_image
