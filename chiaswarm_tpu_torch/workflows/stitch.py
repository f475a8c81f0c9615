"""The stitch workflow, the counterpart of chiaswarm_tpu/workflows/stitch.py:
earlier jobs' images laid out in a near-square grid of 256-pixel tiles,
each thumbnail centred in its cell, returned as the primary artifact with
an image map locating each source job's tile (its id and result URI), so
the hive's page can make the regions clickable."""

from __future__ import annotations

import math

from PIL import Image

from ..post_processors.output_processor import OutputProcessor

TILE = 256


def stitch_callback(device_identifier: str, model_name: str, **kwargs):
    images: list[Image.Image] = kwargs["images"]
    jobs: list[dict] = kwargs.get("jobs", [])
    content_type = kwargs.get("content_type", "image/jpeg")
    if not images:
        raise ValueError("stitch requires at least one input image")
    cols = math.ceil(math.sqrt(len(images)))
    rows = math.ceil(len(images) / cols)
    mosaic = Image.new("RGB", (cols * TILE, rows * TILE))
    image_map = []
    for i, image in enumerate(images):
        tile = image.convert("RGB").copy()
        tile.thumbnail((TILE, TILE), Image.Resampling.LANCZOS)
        x, y = (i % cols) * TILE, (i // cols) * TILE
        mosaic.paste(tile, (x + (TILE - tile.width) // 2, y + (TILE - tile.height) // 2))
        region = {"coords": [x, y, x + TILE, y + TILE], "shape": "rect"}
        if i < len(jobs):
            region["job_id"] = jobs[i].get("id")
            region["href"] = jobs[i].get("resultUri")
        image_map.append(region)
    processor = OutputProcessor(kwargs.get("outputs", ["primary"]), content_type)
    processor.add_outputs([mosaic])
    return processor.get_results(), {"image_map": image_map, "rows": rows, "cols": cols}
