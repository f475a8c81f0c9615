"""Fetching and validating a job's input images (start image, mask,
control image), and the QR control image of QR-monster jobs.

A trimmed copy of chiaswarm_tpu/external_resources.py (the port imports
nothing of the JAX package), over stdlib `urllib` instead of aiohttp:
the port formats a job's arguments on the worker's executor thread, as
its hive client does. The limits are the JAX package's: one policy
object, a HEAD probe that rejects a wrong content type or an announced
size over the cap before any body moves, then a GET whose body is capped
on the bytes actually read (a Content-Length that lies or is absent
cannot smuggle an oversized body past the check), and a decode that
turns the image upright (EXIF) and bounds it to the job's canvas or the
global edge cap. Sizes are PIL (width, height) throughout.
"""

from __future__ import annotations

import dataclasses
import urllib.parse
import urllib.request
from io import BytesIO

from PIL import Image, ImageOps

from .hive import USER_AGENT


@dataclasses.dataclass(frozen=True)
class FetchLimits:
    max_bytes: int = 3 * 1024 * 1024  # the reference's 3 MiB input cap
    max_edge: int = 1024  # global canvas cap (swarm job schema)
    timeout_s: float = 10.0


LIMITS = FetchLimits()
# earlier jobs' results, which may be larger than an input: a 2048² PNG
# (the largest output, an upscaled 1024² job) holds at most 12 MiB of pixels
RESULT_LIMITS = FetchLimits(max_bytes=32 * 1024 * 1024)


def is_blank(s) -> bool:
    return not (s and s.strip())


class InputRejected(Exception):
    """A job input failed validation (scheme, type or size). Raised while
    the job's arguments are formatted, so the worker returns a fatal
    envelope (no hive resubmit)."""


def _check_headers(content_type: str, content_length: int, limits: FetchLimits) -> None:
    if not content_type.startswith("image"):
        raise InputRejected(f"Refusing non-image input (content-type '{content_type}').")
    if content_length > limits.max_bytes:
        raise InputRejected(
            f"Refusing oversized image input: {content_length} bytes "
            f"(limit {limits.max_bytes}).")


def _read_capped(response, limits: FetchLimits) -> bytes:
    """Read a body (any object with `read(n)`) enforcing the cap on the
    bytes actually read, not on headers."""
    chunks: list[bytes] = []
    total = 0
    while chunk := response.read(64 * 1024):
        total += len(chunk)
        if total > limits.max_bytes:
            raise InputRejected(
                f"Refusing oversized image input: body exceeded "
                f"{limits.max_bytes} bytes while streaming.")
        chunks.append(chunk)
    return b"".join(chunks)


def _decode_image(raw: bytes, size: tuple[int, int] | None,
                  limits: FetchLimits) -> Image.Image:
    """bytes -> RGB PIL, EXIF-upright, bounded to `size` or the global cap."""
    image = ImageOps.exif_transpose(Image.open(BytesIO(raw))).convert("RGB")
    if size is not None and (image.width > size[0] or image.height > size[1]):
        bound = size
    elif max(image.size) > limits.max_edge:
        bound = (limits.max_edge, limits.max_edge)
    else:
        bound = None
    if bound is not None:
        image.thumbnail(bound, Image.Resampling.LANCZOS)
    return image


def _check_scheme(uri: str) -> None:
    scheme = urllib.parse.urlsplit(uri).scheme
    if scheme not in ("http", "https"):
        # urllib would also open file: and ftp: URIs, which aiohttp (the
        # JAX package's client) refuses
        raise InputRejected(f"Refusing input URI with scheme '{scheme}'.")


def _open(uri: str, method: str, timeout: float):
    request = urllib.request.Request(uri, method=method, headers={"user-agent": USER_AGENT})
    return urllib.request.urlopen(request, timeout=timeout)


def get_image(uri: str | None, size: tuple[int, int] | None,
              limits: FetchLimits = LIMITS) -> Image.Image | None:
    """Fetch one remote job-input image; None for a blank URI. Blocks:
    call it off the event loop."""
    if is_blank(uri):
        return None
    _check_scheme(uri)
    # probe first so obviously bad inputs are rejected without a body
    # transfer; the streaming cap below is the authoritative guard
    with _open(uri, "HEAD", limits.timeout_s) as probe:
        _check_headers(probe.headers.get("Content-Type", ""),
                       int(probe.headers.get("Content-Length") or 0), limits)
    with _open(uri, "GET", limits.timeout_s) as response:
        raw = _read_capped(response, limits)
    return _decode_image(raw, size, limits)


def download_images(image_urls: list[str]) -> list[Image.Image]:
    """The images of earlier jobs' results (the stitch workflow's inputs,
    which the hive names), in order, each body capped at
    `RESULT_LIMITS.max_bytes`. Blocks."""
    images = []
    for url in image_urls:
        _check_scheme(url)
        with _open(url, "GET", RESULT_LIMITS.timeout_s) as response:
            images.append(Image.open(BytesIO(_read_capped(response, RESULT_LIMITS))))
    return images


def get_qrcode_image(qr_code_contents: str, size: tuple[int, int] | None) -> Image.Image:
    """A QR control image for the QR-monster jobs, at the job's longer
    edge (768 unsized). Needs the `qrcode` package; without it the job
    fails, as in the JAX package."""
    try:
        import qrcode
    except ImportError as e:
        raise Exception("QR-code workflows require the 'qrcode' package, which is not "
                        "installed on this worker.") from e
    from .pre_processors.image_utils import resize_for_condition_image

    edge = max(size) if size is not None else 768
    qr = qrcode.QRCode(version=None, error_correction=qrcode.constants.ERROR_CORRECT_H,
                       box_size=10, border=4)
    qr.add_data(qr_code_contents)
    qr.make(fit=True)
    return resize_for_condition_image(qr.make_image(fill_color="black", back_color="white"),
                                      edge)
