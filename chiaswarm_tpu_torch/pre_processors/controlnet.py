"""ControlNet condition-image preprocessors that need no learned model; the
counterpart of chiaswarm_tpu/pre_processors/controlnet.py.

`canny`, `tile`, `crop`, `center crop`, `shuffle` and `pix2pix` run here
on the host, in numpy and scipy: the JAX package calls OpenCV for canny
and shuffle, and the port does not depend on it. `canny` follows
OpenCV's `Canny(image, 100, 200)` on an RGB array (3x3 Sobel with
replicated borders per channel; at each pixel the channel of largest L1
magnitude; non-maximum suppression in OpenCV's fixed-point direction
sectors; hysteresis over 8-connected pixels). `shuffle` follows its
`resize` (bilinear, half-pixel centres) and `remap` (bilinear, rounded to
the nearest level, reflected borders).

The preprocessors that run a model (depth, HED, pose, ...) are refused by
name with a ValueError, which the worker turns into a fatal envelope.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from .image_utils import center_crop_resize, resize_for_condition_image

_PREPROCESSORS = {}

# the JAX package's model-backed preprocessors, which wait for their models
MODEL_BACKED = ("depth", "scribble", "softedge", "soft edge", "mlsd", "lineart", "normal bae",
                "zoe depth", "zoe", "segmentation", "openpose", "depth estimator")


def _norm(name: str) -> str:
    """Canonical key: lowercase, spaces, dashes and underscores dropped."""
    return name.lower().strip().replace(" ", "").replace("-", "").replace("_", "")


def register(name):
    def deco(fn):
        _PREPROCESSORS[_norm(name)] = fn
        return fn

    return deco


def preprocess_image(image: Image.Image, preprocessor: str, device_identifier: str = ""):
    """The condition image `preprocessor` makes of `image`; ValueError for
    a name that is unknown or needs a model the port lacks."""
    fn = _PREPROCESSORS.get(_norm(preprocessor))
    if fn is None:
        if _norm(preprocessor) in {_norm(n) for n in MODEL_BACKED}:
            raise ValueError(f"controlnet preprocessor {preprocessor!r} runs a model that "
                             "chiaswarm_tpu_torch does not port yet")
        raise ValueError(f"Unknown or unavailable controlnet preprocessor: {preprocessor}")
    return fn(image)


# --- canny ---

_TG22 = 13573  # tan(22.5 degrees) * 2^15, OpenCV's CANNY_SHIFT fixed point


def _sobel(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """3x3 Sobel derivatives of [H, W, C] int32 with replicated borders."""
    p = np.pad(a, ((1, 1), (1, 1), (0, 0)), mode="edge")
    left = p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2]
    right = p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
    top = p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:]
    bottom = p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]
    return right - left, bottom - top


def canny_edges(arr: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> uint8 [H, W] edge map (255 on edges)."""
    from scipy import ndimage

    a = np.asarray(arr, np.int32)
    if a.ndim == 2:
        a = a[..., None]
    dx, dy = _sobel(a)
    mag = np.abs(dx) + np.abs(dy)
    # the channel of largest magnitude, the first of equals
    pick = np.argmax(mag, axis=-1)[..., None]
    dx = np.take_along_axis(dx, pick, -1)[..., 0].astype(np.int64)
    dy = np.take_along_axis(dy, pick, -1)[..., 0].astype(np.int64)
    m = np.take_along_axis(mag, pick, -1)[..., 0].astype(np.int64)
    h, w = m.shape
    pm = np.pad(m, 1)  # magnitudes outside the image are 0

    def at(di, dj):
        return pm[1 + di:1 + di + h, 1 + dj:1 + dj + w]

    x = np.abs(dx)
    y = np.abs(dy) << 15
    tg22x = x * _TG22
    tg67x = tg22x + (x << 16)
    horizontal = y < tg22x
    vertical = ~horizontal & (y > tg67x)
    diagonal = ~horizontal & ~vertical
    s = np.where((dx ^ dy) < 0, -1, 1)
    # the diagonal neighbours: (i-1, j-s) and (i+1, j+s)
    up_left, up_right = at(-1, -1), at(-1, 1)
    down_left, down_right = at(1, -1), at(1, 1)
    prev_diag = np.where(s < 0, up_right, up_left)
    next_diag = np.where(s < 0, down_left, down_right)
    maximum = ((horizontal & (m > at(0, -1)) & (m >= at(0, 1)))
               | (vertical & (m > at(-1, 0)) & (m >= at(1, 0)))
               | (diagonal & (m > prev_diag) & (m > next_diag)))
    candidate = maximum & (m > low)
    strong = candidate & (m > high)
    labels, n = ndimage.label(candidate, structure=np.ones((3, 3), bool))
    keep = np.zeros(n + 1, bool)
    keep[np.unique(labels[strong])] = True
    keep[0] = False
    return np.where(keep[labels], 255, 0).astype(np.uint8)


@register("canny")
def canny(image: Image.Image) -> Image.Image:
    edges = canny_edges(np.array(image))
    return Image.fromarray(np.stack([edges] * 3, axis=-1))


@register("tile")
def tile(image: Image.Image) -> Image.Image:
    return resize_for_condition_image(image, 1024)


@register("crop")
def crop(image: Image.Image) -> Image.Image:
    return center_crop_resize(image, (512, 512))


# --- shuffle ---

def resize_linear(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """float32 [h, w] -> [height, width], bilinear with half-pixel centres
    and clamped edges (OpenCV's INTER_LINEAR on float input)."""

    def taps(n_out, n_in):
        src = ((np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
               ).astype(np.float32)
        i0 = np.floor(src).astype(np.int64)
        f = (src - i0).astype(np.float32)
        f = np.where(i0 < 0, np.float32(0), f)
        i0 = np.clip(i0, 0, n_in - 1)
        f = np.where(i0 >= n_in - 1, np.float32(0), f)
        return i0, np.minimum(i0 + 1, n_in - 1), f

    x0, x1, fx = taps(width, a.shape[1])
    y0, y1, fy = taps(height, a.shape[0])
    rows = a[:, x0] * (1 - fx) + a[:, x1] * fx
    return (rows[y0] * (1 - fy)[:, None] + rows[y1] * fy[:, None]).astype(np.float32)


def _reflect(p: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's BORDER_REFLECT index (fedcba|abcdef|fedcba), any distance."""
    if n == 1:
        return np.zeros_like(p)
    r = np.mod(p, 2 * n)
    return np.where(r < n, r, 2 * n - 1 - r)


def remap_linear(arr: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] sampled at float32 maps, as OpenCV's remap with
    INTER_LINEAR and BORDER_REFLECT: bilinear weights of the exact
    coordinates, rounded to the nearest level."""
    h, w = arr.shape[:2]
    x, y = map_x.astype(np.float32), map_y.astype(np.float32)
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    xs0, xs1 = _reflect(x0, w), _reflect(x0 + 1, w)
    ys0, ys1 = _reflect(y0, h), _reflect(y0 + 1, h)
    src = arr.astype(np.float32)
    top = src[ys0, xs0] * (1 - fx) + src[ys0, xs1] * fx
    bottom = src[ys1, xs0] * (1 - fx) + src[ys1, xs1] * fx
    return np.clip(np.rint(top * (1 - fy) + bottom * fy), 0, 255).astype(np.uint8)


@register("shuffle")
def shuffle(image: Image.Image) -> Image.Image:
    """Content shuffle: a smooth random flow warps the image, keeping its
    palette and texture and losing its composition; seeded by the image's
    content, so equal jobs give equal condition images."""
    arr = np.asarray(image.convert("RGB"))
    h, w = arr.shape[:2]
    seed = int(np.uint32(np.sum(arr[::16, ::16], dtype=np.uint64) & 0xFFFFFFFF))
    rng = np.random.default_rng(seed)
    grid_h, grid_w = max(h // 64, 2), max(w // 64, 2)
    fx = resize_linear(rng.standard_normal((grid_h, grid_w)).astype(np.float32), w, h) * (w / 4)
    fy = resize_linear(rng.standard_normal((grid_h, grid_w)).astype(np.float32), w, h) * (h / 4)
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    return Image.fromarray(remap_linear(arr, (xx + fx).astype(np.float32),
                                        (yy + fy).astype(np.float32)))


@register("pix2pix")
def pix2pix(image: Image.Image) -> Image.Image:
    """Identity: the edit model conditions on the image itself."""
    return image


@register("center crop")
def center_crop(image: Image.Image) -> Image.Image:
    return crop(image)
