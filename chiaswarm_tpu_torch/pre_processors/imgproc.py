"""The OpenCV calls of the JAX package's preprocessors, in numpy and scipy
(the card's machine has no OpenCV):

- `gray`: `cvtColor(RGB2GRAY)`, uint8 in OpenCV 5's 15-bit fixed point;
- `gaussian_blur`: `GaussianBlur` with its default border (reflect-101),
  its kernel-size and sigma rules and its fixed 5-tap table, rounded to
  the nearest level for uint8;
- `laplacian5`: `Laplacian(src, CV_8U, ksize=5)` (the 5x5 aperture,
  saturated to uint8);
- `dilate`: `dilate` with a 0/1 footprint (outside pixels ignored);
- `close2x2`: `morphologyEx(MORPH_CLOSE, ones((2, 2)))`, anchor (1, 1);
- `draw_line`: `line`, 8-connected, pixel for pixel: thickness 1 is its
  clipped Bresenham walk, a thicker line its `ThickLine` (a convex polygon
  filled in 16-bit fixed point, and a disc at each end);
- `fill_circle`: `circle(..., -1)`, the pixels within the radius;
- `hough_segments` and `kmeans`: deterministic counterparts of
  `HoughLinesP` and `kmeans` (OpenCV's are randomised: ROADMAP §3).
"""

from __future__ import annotations

import math

import numpy as np

# OpenCV's fixed 5-tap Gaussian (ksize 5, sigma <= 0)
_SMALL_GAUSSIAN_5 = np.asarray([1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16])


def gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] RGB -> uint8 [H, W] luma (R .299, G .587, B .114 in
    15-bit fixed point summing to 1, rounded)."""
    a = rgb.astype(np.int32)
    return ((a[..., 0] * 9798 + a[..., 1] * 19235 + a[..., 2] * 3735 + (1 << 14)) >> 15).astype(
        np.uint8)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """getGaussianKernel: the fixed table for ksize 5 and sigma <= 0, else a
    sampled Gaussian (sigma from ksize when not positive), normalised."""
    if ksize == 5 and sigma <= 0:
        return _SMALL_GAUSSIAN_5
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return k / k.sum()


def _reflect101(a: np.ndarray, pad: int) -> np.ndarray:
    return np.pad(a, pad, mode="reflect")


def _sep_filter(a: np.ndarray, kx: np.ndarray, ky: np.ndarray) -> np.ndarray:
    """Separable correlation of [H, W] float64 with reflect-101 borders."""
    r = len(kx) // 2
    p = _reflect101(a, r)
    h, w = a.shape
    rows = sum(kx[i] * p[:, i:i + w] for i in range(len(kx)))
    return sum(ky[i] * rows[i:i + h, :] for i in range(len(ky)))


def gaussian_blur(img: np.ndarray, ksize: int = 0, sigma: float = 0.0) -> np.ndarray:
    """GaussianBlur(img, (ksize, ksize), sigma): ksize 0 takes
    round(sigma * 8 + 1) | 1 taps (float input). uint8 rounds half up."""
    if ksize <= 0:
        ksize = int(round(sigma * 4 * 2 + 1)) | 1
    k = gaussian_kernel(ksize, sigma)
    out = _sep_filter(img.astype(np.float64), k, k)
    if img.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def laplacian5(img: np.ndarray) -> np.ndarray:
    """Laplacian(img uint8, CV_8U, ksize=5): d2/dx2 + d2/dy2 of the 5x5
    aperture ([1, 0, -2, 0, 1] x [1, 4, 6, 4, 1]), saturated."""
    d2 = np.asarray([1, 0, -2, 0, 1], np.float64)
    smooth = np.asarray([1, 4, 6, 4, 1], np.float64)
    a = img.astype(np.float64)
    out = _sep_filter(a, d2, smooth) + _sep_filter(a, smooth, d2)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def dilate(img: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Max over the footprint centred on each pixel (anchor at the centre),
    pixels outside the image ignored."""
    fh, fw = footprint.shape
    ay, ax = fh // 2, fw // 2
    low = -np.inf if img.dtype.kind == "f" else np.iinfo(img.dtype).min
    p = np.pad(img, ((ay, fh - 1 - ay), (ax, fw - 1 - ax)), constant_values=low)
    h, w = img.shape
    out = np.full_like(img, low)
    for i, j in zip(*np.nonzero(footprint)):
        out = np.maximum(out, p[i:i + h, j:j + w])
    return out


def _erode(img: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    fh, fw = footprint.shape
    ay, ax = fh // 2, fw // 2
    high = np.iinfo(img.dtype).max
    p = np.pad(img, ((ay, fh - 1 - ay), (ax, fw - 1 - ax)), constant_values=high)
    h, w = img.shape
    out = np.full_like(img, high)
    for i, j in zip(*np.nonzero(footprint)):
        out = np.minimum(out, p[i:i + h, j:j + w])
    return out


def close2x2(img: np.ndarray) -> np.ndarray:
    """morphologyEx(img uint8, MORPH_CLOSE, ones((2, 2)))."""
    fp = np.ones((2, 2), bool)
    return _erode(dilate(img, fp), fp)


# --- drawing ---

def _bresenham(x0: int, y0: int, x1: int, y1: int):
    """The pixels OpenCV's 8-connected LineIterator visits (left to right)."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    x, y = x0, y0
    xs, ys = [], []
    for _ in range(dx + 1):
        xs.append(x)
        ys.append(y)
        move = err < 0
        err += minus_delta + (plus_delta if move else 0)
        # the minor axis moves where err went negative, the major always
        if steep:
            y += sy
            x += 1 if move else 0
        else:
            x += 1
            y += sy if move else 0
    return np.asarray(xs), np.asarray(ys)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine: the segment cut to the image, or None outside it."""
    right, bottom = w - 1, h - 1

    def code(x, y, full=True):
        c = (x < 0) + (x > right) * 2
        return c + ((y < 0) * 4 + (y > bottom) * 8 if full else 0)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """cv2.line(img, p0, p1, color, thickness) in place, 8-connected."""
    h, w = img.shape[:2]
    (x0, y0), (x1, y1) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if thickness <= 1:
        clipped = _clip_line(w, h, x0, y0, x1, y1)
        if clipped is None:
            return
        xs, ys = _bresenham(*clipped)
        keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        img[ys[keep], xs[keep]] = color
        return
    _thick_line(img, (x0, y0), (x1, y1), color, thickness)


# OpenCV's fixed point for drawing
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncated toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's `Line2`: a line between points in 16-bit fixed point."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        count = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    points = [((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)]
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(count + 1):
            points.append((x1, y1 >> XY_SHIFT))
            x1, y1 = x1 + 1, y1 + y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(count + 1):
            points.append((x1 >> XY_SHIFT, y1))
            x1, y1 = x1 + x_step, y1 + 1
    for x, y in points:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def _fill_convex_poly(img: np.ndarray, v: list, color) -> None:
    """OpenCV's `FillConvexPoly` (8-connected, points in 16-bit fixed
    point): the outline by `_line2`, then the scanlines between the two
    edges walked from the top vertex."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
             {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    left_to_walk = npts
    y = ymin
    while True:
        for e in edges:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % npts
            while True:
                left_to_walk -= 1
                if left_to_walk < 0:
                    break
                ty = (v[idx][1] + delta) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e.update(ye=ty, dx=_cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)), x=xs,
                             idx=idx)
                    break
                idx0, idx = idx, (idx + e["di"]) % npts
        if left_to_walk < 0:
            break
        if y >= 0:
            a, b = (edges[1], edges[0]) if edges[0]["x"] > edges[1]["x"] else edges
            x1, x2 = (a["x"] + delta) >> XY_SHIFT, (b["x"] + delta) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        for e in edges:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int) -> None:
    """OpenCV's `ThickLine` (8-connected): the rectangle of half-width
    t/2 (plus a half for odd t) filled as a convex polygon, and a disc of
    radius round(t/2) at each end."""
    x0, y0 = p0[0] << XY_SHIFT, p0[1] << XY_SHIFT
    x1, y1 = p1[0] << XY_SHIFT, p1[1] << XY_SHIFT
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(img, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                                (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)], color)
    radius = (half + (XY_ONE >> 1)) >> XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        fill_circle(img, ((x + (XY_ONE >> 1)) >> XY_SHIFT, (y + (XY_ONE >> 1)) >> XY_SHIFT),
                    radius, color)


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """cv2.circle(img, center, radius, color, -1) in place."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    lo_x, hi_x = max(cx - radius, 0), min(cx + radius, w - 1)
    lo_y, hi_y = max(cy - radius, 0), min(cy + radius, h - 1)
    if lo_x > hi_x or lo_y > hi_y:
        return
    yy, xx = np.mgrid[lo_y:hi_y + 1, lo_x:hi_x + 1]
    mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= radius * radius
    img[lo_y:hi_y + 1, lo_x:hi_x + 1][mask] = color


# --- the stand-ins of the randomised OpenCV calls ---

def hough_segments(edges: np.ndarray, threshold: int, min_length: int, max_gap: int,
                   n_theta: int = 180) -> np.ndarray:
    """Line segments [N, 4] (x1, y1, x2, y2) of a binary edge map: OpenCV's
    progressive probabilistic Hough transform (`HoughLinesP(edges, 1,
    pi/180, threshold, minLineLength, maxLineGap)`), step for step, except
    that the edge pixels are taken in raster order instead of a random
    one. A pixel votes; once a line's votes reach `threshold`, the line is
    walked both ways from the pixel in 16-bit fixed point across gaps of
    up to `max_gap`; the walked pixels leave the map, and when the run
    spans at least `min_length` along either axis it is a segment and its
    pixels take their votes back."""
    h, w = edges.shape
    thetas = np.arange(n_theta, dtype=np.float64) * (math.pi / n_theta)
    cos_t, sin_t = np.cos(thetas).astype(np.float32), np.sin(thetas).astype(np.float32)
    n_rho = int(round((w + h) * 2 + 1))
    offset = (n_rho - 1) // 2
    acc = np.zeros((n_theta, n_rho), np.int32)
    rows = np.arange(n_theta)
    mask = edges > 0
    shift = 16

    def bins(x, y):
        return np.rint(np.float32(x) * cos_t + np.float32(y) * sin_t).astype(np.int64) + offset

    def walk(x0, y0, dx, dy, xflag):
        while True:
            yield (x0, y0 >> shift) if xflag else (x0 >> shift, y0)
            x0 += dx
            y0 += dy

    out = []
    for y, x in zip(*np.nonzero(mask)):
        if not mask[y, x]:
            continue
        r = bins(x, y)
        acc[rows, r] += 1
        votes = acc[rows, r]
        best = int(np.argmax(votes))
        if votes[best] < threshold:
            continue
        a, b = -float(sin_t[best]), float(cos_t[best])
        if abs(a) > abs(b):
            xflag, dx0, dy0 = True, (1 if a > 0 else -1), int(round(b * (1 << shift) / abs(a)))
            x0, y0 = int(x), (int(y) << shift) + (1 << (shift - 1))
        else:
            xflag, dy0, dx0 = False, (1 if b > 0 else -1), int(round(a * (1 << shift) / abs(b)))
            x0, y0 = (int(x) << shift) + (1 << (shift - 1)), int(y)
        ends = []
        for sign in (1, -1):
            gap, end = 0, (int(x), int(y))
            for j1, i1 in walk(x0, y0, sign * dx0, sign * dy0, xflag):
                if j1 < 0 or j1 >= w or i1 < 0 or i1 >= h:
                    break
                if mask[i1, j1]:
                    gap, end = 0, (j1, i1)
                else:
                    gap += 1
                    if gap > max_gap:
                        break
            ends.append(end)
        (ax, ay), (bx, by) = ends
        good = abs(bx - ax) >= min_length or abs(by - ay) >= min_length
        for sign, end in zip((1, -1), ends):
            for j1, i1 in walk(x0, y0, sign * dx0, sign * dy0, xflag):
                if mask[i1, j1]:
                    if good:
                        acc[rows, bins(j1, i1)] -= 1
                    mask[i1, j1] = False
                if (j1, i1) == end:
                    break
        if good:
            out.append((ax, ay, bx, by))
    return np.asarray(out, np.int32).reshape(-1, 4)


def kmeans(feats: np.ndarray, k: int, iters: int = 8, eps: float = 1.0, attempts: int = 2,
           seed: int = 0) -> np.ndarray:
    """Labels [N] of `k` clusters of float32 [N, D] rows: k-means++ seeding
    from a fixed generator, at most `iters` Lloyd steps (fewer once no
    centre moves more than `eps`), the most compact of `attempts` runs.
    Deterministic: equal inputs give equal labels."""
    rng = np.random.default_rng(seed)
    x = feats.astype(np.float64)
    n = len(x)
    sq = (x * x).sum(1)
    best, best_labels = np.inf, None
    for _ in range(attempts):
        centers = [x[rng.integers(n)]]
        d2 = ((x - centers[0]) ** 2).sum(1)
        for _ in range(1, k):
            total = d2.sum()
            idx = int(rng.choice(n, p=d2 / total)) if total > 0 else int(rng.integers(n))
            centers.append(x[idx])
            d2 = np.minimum(d2, ((x - x[idx]) ** 2).sum(1))
        c = np.stack(centers)
        for _ in range(iters):
            dist = sq[:, None] - 2 * x @ c.T + (c * c).sum(1)[None]
            labels = dist.argmin(1)
            new = np.stack([x[labels == j].mean(0) if np.any(labels == j) else c[j]
                            for j in range(k)])
            shift = np.sqrt(((new - c) ** 2).sum(1)).max()
            c = new
            if shift <= eps:
                break
        dist = sq[:, None] - 2 * x @ c.T + (c * c).sum(1)[None]
        labels = dist.argmin(1)
        compact = float(dist[np.arange(n), labels].sum())
        if compact < best:
            best, best_labels = compact, labels
    return best_labels.astype(np.int32)
