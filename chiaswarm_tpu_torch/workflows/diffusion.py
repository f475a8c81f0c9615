"""Stable-diffusion-family workload callback, the counterpart of
chiaswarm_tpu/workflows/diffusion.py `diffusion_callback`: resolve the
resident pipeline, run the job (txt2img, or img2img, pix2pix and inpaint
with the start image and mask that job_arguments fetched; a `refiner`
stage resolves its pipeline in the same registry; the job's `lora`,
`textual_inversion` and `vae` go to the pipeline, whose ValueError for an
adapter it cannot load or match the worker turns into a fatal envelope),
package the images.

The safety checker is a model of its own that the port does not have
yet: envelopes say `nsfw_checked: false`, as the JAX package's
`flag_images` does when no checker is available.
"""

from __future__ import annotations

import time

from ..models.configs import model_family
from ..post_processors.output_processor import OutputProcessor


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
    if kwargs.pop("test_tiny_model", False):
        model_name = tiny_stand_in(model_name)
    pipeline_type = kwargs.pop("pipeline_type", "DiffusionPipeline")
    pipeline = registry.get_pipeline(model_name)
    images, pipeline_config = pipeline.run(pipeline_type=pipeline_type, registry=registry,
                                           **kwargs)

    t0 = time.perf_counter()
    pipeline_config["nsfw"] = False
    pipeline_config["nsfw_checked"] = False
    processor = OutputProcessor(outputs, content_type)
    processor.add_outputs(images)
    results = processor.get_results()
    pipeline_config["timings"]["encode_artifacts_s"] = round(time.perf_counter() - t0, 4)
    return results, pipeline_config
