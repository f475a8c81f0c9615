"""PIL geometry helpers of job inputs; a copy of
chiaswarm_tpu/pre_processors/image_utils.py (the port imports nothing of
the JAX package)."""

from __future__ import annotations

from PIL import Image


def resize_square(image: Image.Image) -> Image.Image:
    """Center-crop a PIL image to its shorter side."""
    side = min(image.width, image.height)
    left = (image.width - side) // 2
    top = (image.height - side) // 2
    return image.crop((left, top, left + side, top + side))


def center_crop_resize(image: Image.Image,
                       output_size: tuple[int, int] = (512, 512)) -> Image.Image:
    """Center-crop to a square, then resize to `output_size` (PIL width,
    height)."""
    return resize_square(image).resize(output_size)


def resize_for_condition_image(image: Image.Image, resolution: int = 1024) -> Image.Image:
    """Scale the shorter side to `resolution`, each side rounded to a
    multiple of 64."""
    image = image.convert("RGB")
    w, h = image.size
    k = float(resolution) / min(h, w)
    w = int(round(w * k / 64.0)) * 64
    h = int(round(h * k / 64.0)) * 64
    return image.resize((w, h), resample=Image.Resampling.LANCZOS)
