"""Echo workload: renders the prompt as an image artifact. A hermetic
diagnostic and liveness probe with no model (as chiaswarm_tpu's)."""

from __future__ import annotations

from ..post_processors.output_processor import OutputProcessor, image_from_text


def echo_callback(device_identifier: str, model_name: str, **kwargs):
    prompt = kwargs.get("prompt", "")
    size = (kwargs.get("width", 512), kwargs.get("height", 512))
    processor = OutputProcessor(kwargs.get("outputs", ["primary"]),
                                kwargs.get("content_type", "image/jpeg"))
    processor.add_outputs([image_from_text(f"echo: {prompt}", size)])
    pipeline_config = {"echo": True, "device": device_identifier, "model": model_name}
    return processor.get_results(), pipeline_config
