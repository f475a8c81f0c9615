"""ControlNet condition-image preprocessors, the counterpart of
chiaswarm_tpu/pre_processors/controlnet.py.

`canny`, `tile`, `crop`, `center crop`, `shuffle` and `pix2pix` run on the
host, in numpy and scipy: the JAX package calls OpenCV, and the port does
not depend on it. `canny` follows OpenCV's `Canny(image, 100, 200)` on an
RGB array (3x3 Sobel with replicated borders per channel; at each pixel
the channel of largest L1 magnitude; non-maximum suppression in OpenCV's
fixed-point direction sectors; hysteresis over 8-connected pixels).
`shuffle` follows its `resize` (bilinear, half-pixel centres) and `remap`
(bilinear, rounded to the nearest level, reflected borders).

The rest run a learned detector (pipelines/aux_models.py) on the worker's
device, resolved through a `Detectors`: `depth`, `normal bae` and `depth
estimator` (DPT), `scribble` (HED, then directional non-maximum
suppression), `soft edge` (PiDiNet, else HED), `openpose` (the body
network, drawn as the stick figure), `mlsd`, `lineart`, `zoe depth` and
`segmentation`. Where a detector's weights are absent, the JAX
package's classical stand-ins answer, with its other OpenCV calls in
numpy (imgproc.py): the Laplacian for HED (logged, not flagged), Hough
segments for M-LSD, a difference of Gaussians for LineArt, DPT for
ZoeDepth and k-means for segmentation; `is_degraded_preprocessor` tells
the envelope which of those answered. DPT and openpose without weights
raise MissingWeightsError (a fatal envelope).
"""

from __future__ import annotations

import colorsys
import logging

import numpy as np
from PIL import Image

from ..pipelines.aux_models import Detectors
from . import imgproc
from .depth_estimator import make_hint
from .image_utils import center_crop_resize, resize_for_condition_image

logger = logging.getLogger(__name__)

_PREPROCESSORS = {}


def _norm(name: str) -> str:
    """Canonical key: lowercase, spaces, dashes and underscores dropped."""
    return name.lower().strip().replace(" ", "").replace("-", "").replace("_", "")


def register(name):
    def deco(fn):
        _PREPROCESSORS[_norm(name)] = fn
        return fn

    return deco


def preprocess_image(image: Image.Image, preprocessor: str, device_identifier: str = "",
                     detectors: Detectors | None = None):
    """The condition image `preprocessor` makes of `image`, its detector
    (if any) from `detectors` (default: the card, no model root);
    ValueError for an unknown name."""
    fn = _PREPROCESSORS.get(_norm(preprocessor))
    if fn is None:
        raise ValueError(f"Unknown or unavailable controlnet preprocessor: {preprocessor}")
    return fn(image, detectors or Detectors())


def is_degraded_preprocessor(name: str, det: Detectors) -> bool:
    """True when `name`'s learned detector has no weights under `det`'s
    model root and a classical or DPT stand-in answered instead
    (segmentation, mlsd, lineart, zoe)."""
    key = _norm(name)
    if key == "segmentation":
        return det.segmenter() is None
    if key == "mlsd":
        return det.mlsd() is None
    if key == "lineart":
        return det.lineart() is None
    if key in (_norm("zoe depth"), _norm("zoe")):
        return det.zoe() is None
    return False


def _rgb(gray: np.ndarray) -> Image.Image:
    return Image.fromarray(np.stack([gray] * 3, axis=-1))


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
def canny(image: Image.Image, det=None) -> Image.Image:
    return _rgb(canny_edges(np.array(image)))


@register("tile")
def tile(image: Image.Image, det=None) -> Image.Image:
    return resize_for_condition_image(image, 1024)


@register("crop")
def crop(image: Image.Image, det=None) -> Image.Image:
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
def shuffle(image: Image.Image, det=None) -> Image.Image:
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
def pix2pix(image: Image.Image, det=None) -> Image.Image:
    """Identity: the edit model conditions on the image itself."""
    return image


@register("center crop")
def center_crop(image: Image.Image, det=None) -> Image.Image:
    return crop(image)


# --- depth ---

@register("depth")
def depth(image: Image.Image, det: Detectors) -> Image.Image:
    """DPT inverse depth as a grey image."""
    return _rgb((det.depth()(image) * 255).astype(np.uint8))


@register("normal bae")
def normal_bae(image: Image.Image, det: Detectors) -> Image.Image:
    """Surface normals from the DPT depth: the blurred depth's gradients as
    normal vectors, RGB-encoded (x, y, z -> r, g, b)."""
    d = imgproc.gaussian_blur(det.depth()(image).astype(np.float32), 5, 0)
    gy, gx = np.gradient(d)
    h, w = d.shape
    nx, ny = -gx * w / 4.0, -gy * h / 4.0
    nz = np.ones_like(d)
    norm = np.sqrt(nx * nx + ny * ny + nz * nz)
    n = np.stack([nx / norm, ny / norm, nz / norm], axis=-1)
    return Image.fromarray(((n * 0.5 + 0.5) * 255).astype(np.uint8))


@register("depth estimator")
def depth_estimator(image: Image.Image, det: Detectors) -> Image.Image:
    return Image.fromarray((make_hint(image, det) * 255).astype(np.uint8))


@register("zoe depth")
@register("zoe")
def zoe_depth(image: Image.Image, det: Detectors) -> Image.Image:
    """Metric depth, near = white (reversed grey); DPT's inverse depth
    answers when ZoeDepth's weights are absent."""
    zoe = det.zoe()
    if zoe is not None:
        d = zoe(image)
        lo, hi = float(d.min()), float(d.max())
        norm = (d - lo) / (hi - lo) if hi > lo else np.zeros_like(d)
        return _rgb(((1.0 - norm) * 255).astype(np.uint8))
    return _rgb((det.depth()(image) * 255).astype(np.uint8))


# --- edges ---

def _laplacian_edges(image: Image.Image) -> Image.Image:
    """The classical stand-in when no HED weights are on this worker."""
    gray = imgproc.gray(np.asarray(image.convert("RGB")))
    return _rgb(imgproc.laplacian5(imgproc.gaussian_blur(gray, 5, 0)))


_NMS_LINES = (np.array([[0, 0, 0], [1, 1, 1], [0, 0, 0]], bool),
              np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0]], bool),
              np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], bool),
              np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], bool))


def edge_nms(edge: np.ndarray, thr: float, sigma: float) -> np.ndarray:
    """Directional non-maximum suppression of a soft edge map (scribble's
    post-processing): keep the pixels that are maxima under any of four
    line-shaped dilations, then threshold to 0/255."""
    x = imgproc.gaussian_blur(edge.astype(np.float32), 0, sigma)
    y = np.zeros_like(x)
    for fp in _NMS_LINES:
        np.putmask(y, imgproc.dilate(x, fp) == x, x)
    z = np.zeros_like(y, dtype=np.uint8)
    z[y > thr] = 255
    return z


_HED_WARNED = False


def _warn_no_hed() -> None:
    global _HED_WARNED
    if not _HED_WARNED:
        _HED_WARNED = True
        logger.warning("no HED weights under the model root; scribble/softedge degrade to "
                       "the classical Laplacian heuristic")


def _hed_edges(image: Image.Image, det: Detectors):
    hed = det.hed()
    return hed(image) if hed is not None else None


@register("scribble")
def scribble(image: Image.Image, det: Detectors) -> Image.Image:
    """HED edges, thinned and binarised; the Laplacian without HED."""
    edge = _hed_edges(image, det)
    if edge is None:
        _warn_no_hed()
        return _laplacian_edges(image)
    return _rgb(edge_nms(edge * 255.0, 127.0, 3.0))


@register("softedge")
@register("soft edge")
def soft_edge(image: Image.Image, det: Detectors) -> Image.Image:
    """PiDiNet's soft edges; HED's without PiDiNet; the Laplacian without
    either."""
    pidi = det.pidinet()
    edge = pidi(image) if pidi is not None else _hed_edges(image, det)
    if edge is None:
        _warn_no_hed()
        return _laplacian_edges(image)
    return _rgb((edge * 255.0).clip(0, 255).astype(np.uint8))


# --- lines ---

@register("mlsd")
def mlsd(image: Image.Image, det: Detectors) -> Image.Image:
    """White line segments on black: M-LSD's, else probabilistic Hough
    segments over Canny edges (flagged degraded)."""
    arr = np.asarray(image.convert("RGB"))
    h, w = arr.shape[:2]
    out = np.zeros((h, w, 3), np.uint8)
    detector = det.mlsd()
    if detector is not None:
        for x1, y1, x2, y2 in detector(image):
            imgproc.draw_line(out, (int(round(x1)), int(round(y1))),
                              (int(round(x2)), int(round(y2))), (255, 255, 255))
        return Image.fromarray(out)
    edges = canny_edges(imgproc.gray(arr), 60, 180)
    for x1, y1, x2, y2 in hough_stand_in(edges):
        imgproc.draw_line(out, (x1, y1), (x2, y2), (255, 255, 255))
    return Image.fromarray(out)


def hough_stand_in(edges: np.ndarray) -> np.ndarray:
    """The segments of mlsd's stand-in: threshold 40, a minimum length of a
    sixteenth of the shorter side (at least 8), gaps up to 4."""
    h, w = edges.shape
    return imgproc.hough_segments(edges, 40, max(min(h, w) // 16, 8), 4)


@register("lineart")
def lineart(image: Image.Image, det: Detectors) -> Image.Image:
    """White strokes on black: the LineArt generator's, else a difference
    of Gaussians (flagged degraded)."""
    detector = det.lineart()
    if detector is not None:
        return _rgb((detector(image) * 255).astype(np.uint8))
    gray = imgproc.gray(np.asarray(image.convert("RGB"))).astype(np.float32)
    dog = imgproc.gaussian_blur(gray, 0, 1.0) - imgproc.gaussian_blur(gray, 0, 3.0)
    lines = np.clip(-dog * 4.0, 0, 255).astype(np.uint8)
    return _rgb(imgproc.close2x2(lines))


# --- segmentation ---

def _segmentation_palette(n: int = 150) -> np.ndarray:
    """The JAX package's label palette: n colours from a golden-ratio hue walk."""
    colors = []
    for i in range(n):
        hue = (i * 0.61803398875) % 1.0
        sat = 0.55 + 0.45 * ((i * 7) % 3) / 2.0
        val = 0.6 + 0.4 * ((i * 5) % 4) / 3.0
        colors.append(tuple(int(c * 255) for c in colorsys.hsv_to_rgb(hue, sat, val)))
    return np.asarray(colors, np.uint8)


ADE_STYLE_PALETTE = _segmentation_palette()
KMEANS_CLUSTERS = 12


@register("segmentation")
def segmentation(image: Image.Image, det: Detectors) -> Image.Image:
    """UperNet's ADE labels painted with the palette; else k-means over
    colour and position at most 256 a side (flagged degraded)."""
    segmenter = det.segmenter()
    if segmenter is not None:
        labels = segmenter(image)
        return Image.fromarray(ADE_STYLE_PALETTE[labels % len(ADE_STYLE_PALETTE)])
    arr = np.asarray(image.convert("RGB").resize(
        (min(image.width, 256), min(image.height, 256)), Image.BILINEAR), np.float32)
    h, w = arr.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    feats = np.concatenate([arr.reshape(-1, 3), (xx * 255 / w).reshape(-1, 1),
                            (yy * 255 / h).reshape(-1, 1)], axis=1).astype(np.float32)
    labels = imgproc.kmeans(feats, KMEANS_CLUSTERS)
    seg = ADE_STYLE_PALETTE[labels.reshape(h, w) % len(ADE_STYLE_PALETTE)]
    return Image.fromarray(seg).resize(image.size, Image.NEAREST)


# --- openpose ---

def limb_colors(n: int) -> list[tuple[int, int, int]]:
    """The openpose visualiser's limb colours (a hue wheel)."""
    return [tuple(int(c * 255) for c in colorsys.hsv_to_rgb(i / n, 1.0, 1.0))
            for i in range(n)]


def draw_pose(people: np.ndarray, w: int, h: int) -> Image.Image:
    """COCO-18 keypoints [P, 18, 3] as the openpose stick figure on black."""
    from ..models.pose import LIMBS

    out = np.zeros((h, w, 3), np.uint8)
    colors = limb_colors(len(LIMBS))
    thick = max(min(h, w) // 128, 2)
    floor = 0.05
    for kps in people:
        for (a, b), color in zip(LIMBS, colors):
            if kps[a, 2] > floor and kps[b, 2] > floor:
                imgproc.draw_line(out, (int(kps[a, 0]), int(kps[a, 1])),
                                  (int(kps[b, 0]), int(kps[b, 1])), color, thick)
        for x, y, c in kps:
            if c > floor:
                imgproc.fill_circle(out, (int(x), int(y)), thick + 1, (255, 255, 255))
    return Image.fromarray(out)


@register("openpose")
def openpose(image: Image.Image, det: Detectors) -> Image.Image:
    w, h = image.size
    return draw_pose(det.pose()(image), w, h)
