"""Job JSON -> (workload callback, normalized kwargs), for the workflows
the port serves: `echo` and SD-family `txt2img`.

Same defaults and precedence as chiaswarm_tpu/job_arguments.py (30 steps,
DPMSolverMultistepScheduler, the 1024 canvas cap, `parameters` passed
through with the identity keys protected). A workflow or feature that is
not ported yet raises ValueError naming it, which the worker turns into a
fatal envelope.
"""

from __future__ import annotations

from .workflows.diffusion import diffusion_callback
from .workflows.echo import echo_callback

DEFAULT_SCHEDULER = "DPMSolverMultistepScheduler"
MAX_SIZE = 1024

# job keys of workflows and features this slice does not serve
_UNPORTED_KEYS = ("start_image_uri", "mask_image_uri", "lora", "video_uri")
_UNPORTED_PARAMETERS = ("controlnet", "refiner", "upscale", "textual_inversion", "vae")

# identity / payload keys a hive-controlled parameters dict may fill but
# never rewrite
_PROTECTED_ARGS = frozenset({"model_name", "prompt", "negative_prompt", "workflow", "id"})


def format_args(job: dict):
    args = dict(job)
    workflow = args.pop("workflow", None)
    if workflow == "echo":
        return echo_callback, args
    if workflow not in (None, "txt2img"):
        raise ValueError(f"workflow {workflow!r} is not ported to chiaswarm_tpu_torch yet")
    for key in _UNPORTED_KEYS:
        if args.get(key):
            raise ValueError(f"job key {key!r} is not ported to chiaswarm_tpu_torch yet")
    if args.get("model_name", "").startswith("DeepFloyd/"):
        raise ValueError("DeepFloyd IF is not ported to chiaswarm_tpu_torch yet")
    return diffusion_callback, format_txt2img_args(args)


def format_txt2img_args(args: dict) -> dict:
    if "height" in args and "width" in args:
        if args["height"] > MAX_SIZE or args["width"] > MAX_SIZE:
            raise ValueError(f"The max image size is ({MAX_SIZE}, {MAX_SIZE}); "
                             f"got ({args['height']}, {args['width']}).")
    args.setdefault("prompt", "")
    parameters = dict(args.pop("parameters", {}) or {})
    for key in _UNPORTED_PARAMETERS:
        if parameters.get(key):
            raise ValueError(f"parameter {key!r} is not ported to chiaswarm_tpu_torch yet")
    args.setdefault("num_inference_steps", 30)
    args["pipeline_type"] = parameters.pop("pipeline_type", "DiffusionPipeline")
    args["scheduler_type"] = parameters.pop("scheduler_type", DEFAULT_SCHEDULER)
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
