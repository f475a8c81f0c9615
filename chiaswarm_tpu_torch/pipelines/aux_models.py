"""The learned detectors of the ControlNet preprocessors, the counterpart of
chiaswarm_tpu/pipelines/aux_models.py: DPT depth, openpose, HED, UperNet
segmentation, M-LSD, LineArt, PiDiNet and ZoeDepth.

Each detector is resident per process, keyed by (name, model root,
device), outside the pipeline registry's LRU (as the JAX package's module
caches and the port's safety checker). It runs on its device in the
serving dtype (bf16 on the card, f32 on the CPU); the host does the
resizes, normalisation and decoding, in numpy and PIL, as the JAX
detectors do.

Weights are the published files under `<model_root_dir>/<name>/`, in
their upstream key layout, read with the JAX loaders' globs:
safetensors (with config.json for ZoeDepth and UperNet) for the
transformers models; `*HED*.pth`, `*body_pose*.pth`, `*pidinet*.pth`,
`*mlsd*.pth` and `sk_model*.pth` pickles (read with `weights_only=True`)
for lllyasviel's annotators. The policy is the JAX package's:

- DPT (`depth`, `normal bae`, `depth estimator`, ZoeDepth's stand-in) and
  openpose raise MissingWeightsError for a production name without files,
  which the worker turns into a fatal envelope; `test/*` and `*tiny*`
  names random-initialise (TINY_DPT, the tiny PoseNet) unless files are
  there;
- HED answers None when absent (`scribble` and `soft edge` fall back to the
  Laplacian, logged and not flagged);
- segmentation, M-LSD, LineArt, PiDiNet and ZoeDepth answer None when
  absent, and their preprocessors serve a classical stand-in that the
  envelope flags as degraded; that None is cached only while the model
  directory's mtime is unchanged (`cached_detector`), so weights that
  arrive later are picked up by the next job.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..device import resolve_device, serving_dtype, synchronize
from ..models import depth as depth_mod
from ..models import lineart as lineart_mod
from ..models import mlsd as mlsd_mod
from ..models import pidinet as pidinet_mod
from ..models import pose as pose_mod
from ..models import segmentation as seg_mod
from ..models import zoedepth as zoe_mod
from ..models.hed import HEDConfig, HEDNet
from ..weights import (
    CheckpointError,
    MissingWeightsError,
    is_test_model,
    load_detector_state_,
    model_seed,
    random_init_,
    require_weights_present,
)

logger = logging.getLogger(__name__)

DEFAULT_DEPTH_MODEL = "Intel/dpt-large"
DEFAULT_POSE_MODEL = "lllyasviel/ControlNet-openpose"
DEFAULT_ANNOTATORS = "lllyasviel/Annotators"  # HED, M-LSD, LineArt, PiDiNet
DEFAULT_ZOE_MODEL = "Intel/zoedepth-nyu"
DEFAULT_SEGMENTATION_MODEL = "openmmlab/upernet-convnext-small"

# ImageNet normalisation (the DPT and UperNet image processors)
_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
# fixed processing canvases of the fully convolutional detectors
POSE_CANVAS = 368
HED_SIZE = 512
SEG_SIZE = 512
MLSD_SIZE = 512
LINEART_SIZE = 512
PIDI_SIZE = 512

_CACHE: dict[tuple, tuple] = {}
_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Detectors:
    """Where the detectors of one worker live: its device, its model root
    and the DPT and pose model names (its settings' `depth_model` and
    `pose_model`). Each getter gives the process's resident detector."""

    device: str = "cuda"
    model_root_dir: str | None = None
    depth_model: str = DEFAULT_DEPTH_MODEL
    pose_model: str = DEFAULT_POSE_MODEL

    @classmethod
    def from_settings(cls, settings, device) -> "Detectors":
        return cls(str(device), settings.model_root_dir, settings.depth_model or
                   DEFAULT_DEPTH_MODEL, settings.pose_model or DEFAULT_POSE_MODEL)

    def model_dir(self, name: str) -> Path | None:
        if not self.model_root_dir:
            return None
        return Path(self.model_root_dir).expanduser() / name

    def depth(self) -> "DepthEstimator":
        return resident(self, "depth", self.depth_model, DepthEstimator)

    def pose(self) -> "PoseEstimator":
        return resident(self, "pose", self.pose_model, PoseEstimator)

    def hed(self):
        """The HED detector, or None without its weights."""
        try:
            return resident(self, "hed", DEFAULT_ANNOTATORS, HEDDetector)
        except MissingWeightsError:
            return None

    def segmenter(self):
        return cached_detector(self, "segmentation", DEFAULT_SEGMENTATION_MODEL, Segmenter)

    def mlsd(self):
        return cached_detector(self, "mlsd", DEFAULT_ANNOTATORS, MLSDDetector)

    def lineart(self):
        return cached_detector(self, "lineart", DEFAULT_ANNOTATORS, LineartDetector)

    def pidinet(self):
        return cached_detector(self, "pidinet", DEFAULT_ANNOTATORS, PidinetDetector)

    def zoe(self):
        return cached_detector(self, "zoe", DEFAULT_ZOE_MODEL, ZoeEstimator)


def _key(where: Detectors, kind: str, name: str) -> tuple:
    return kind, name, where.model_root_dir, str(resolve_device(where.device))


def resident(where: Detectors, kind: str, name: str, build):
    """Build-or-fetch; a build that raises is not cached (the next job
    probes the files again). Built under the lock, so a cold start loads
    a checkpoint once."""
    key = _key(where, kind, name)
    with _LOCK:
        hit = _CACHE.get(key)
        if hit is None:
            hit = (build(name, where), 0.0)
            _CACHE[key] = hit
        return hit[0]


def model_dir_stamp(where: Detectors, name: str) -> float:
    """mtime of the model directory (-1 when absent)."""
    d = where.model_dir(name)
    try:
        return d.stat().st_mtime if d is not None else -1.0
    except OSError:
        return -1.0


def cached_detector(where: Detectors, kind: str, name: str, build):
    """Build-or-fetch with an mtime-aware negative cache: a detector whose
    weights are missing or broken is cached as None only while its
    directory's mtime is unchanged (the JAX package's `_cached_detector`)."""
    key = _key(where, kind, name)
    with _LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            det, stamp = hit
            if det is not None or stamp == model_dir_stamp(where, name):
                return det
            logger.info("%s checkpoint dir changed; re-probing weights", kind)
        # stamped before the build: a download that completes in between
        # must not freeze the negative cache against the complete directory
        stamp = model_dir_stamp(where, name)
        try:
            det = build(name, where)
        except (MissingWeightsError, CheckpointError, FileNotFoundError, OSError, KeyError,
                ValueError) as e:
            logger.info("no %s weights (%s)", kind, e)
            _CACHE[key] = (None, stamp)
            return None
        _CACHE[key] = (det, 0.0)
        return det


def clear() -> None:
    """Drop every resident detector (tests; a worker keeps them)."""
    with _LOCK:
        _CACHE.clear()


# --- loading ---

def _pth_state(path: Path) -> dict:
    return torch.load(str(path), map_location="cpu", weights_only=True)


def _safetensors_state(model_dir: Path) -> dict:
    from safetensors import SafetensorError, safe_open

    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors under {model_dir}")
    state = {}
    for path in files:
        try:
            with safe_open(str(path), framework="pt") as f:
                for key in f.keys():
                    state[key] = f.get_tensor(key)
        except (SafetensorError, OSError) as e:
            raise CheckpointError(f"{path}: unreadable safetensors file ({e})") from e
    return state


def _glob_state(model_dir: Path | None, pattern: str) -> tuple[dict, Path]:
    """The first file matching `pattern` in sorted order."""
    if model_dir is None or not model_dir.is_dir():
        raise FileNotFoundError(f"no checkpoint directory {model_dir}")
    for path in sorted(model_dir.glob(pattern)):
        return _pth_state(path), path
    raise FileNotFoundError(f"no {pattern} under {model_dir}")


def _annotator_state(model_dir: Path | None, marker: str, pattern: str):
    """An annotator's state from the shared folder -> (state, source,
    ignore): its safetensors when they hold `marker` (other annotators'
    tensors in the folder's files are then ignored), else the first
    `pattern` pickle, loaded strictly."""
    try:
        state = _safetensors_state(model_dir) if model_dir is not None else {}
    except FileNotFoundError:
        state = {}
    if any(k.removeprefix("module.") == marker for k in state):
        return state, str(model_dir), True
    state, path = _glob_state(model_dir, pattern)
    return state, str(path), None


def _config_json(model_dir: Path) -> dict | None:
    p = model_dir / "config.json"
    return json.loads(p.read_text()) if p.is_file() else None


class _Detector:
    """A network on its device in the serving dtype, with its load record
    (`source`, `weights_source`, `param_bytes`). `prepare(image)` is the
    network's input on the host, HWC f32; `run` the network on it."""

    def _place(self, factory, where: Detectors, state: dict | None, source: str,
               ignore=None, seed_name: str | None = None) -> None:
        """Build `factory()` on the device without initialising it, then
        load `state` (or random-initialise from `seed_name`'s seed). On the
        meta device (the setup CLI's `--check`) the load holds the state's
        keys and shapes to the module and copies nothing."""
        self.device = (torch.device("meta") if str(where.device) == "meta"
                       else resolve_device(where.device))
        self.dtype = serving_dtype(self.device)
        self.source = source
        with torch.device("meta"):
            module = factory()
        module = module.to_empty(device=self.device).eval().requires_grad_(False)
        if state is not None:
            load_detector_state_(module, state, source, ignore)
            self.weights_source = "checkpoint"
        else:
            random_init_(module, torch.Generator(device=self.device).manual_seed(
                model_seed(seed_name)))
            self.weights_source = "random"
        self.model = module.to(self.dtype)
        self.param_bytes = sum(p.numel() * p.element_size() for p in self.model.parameters())
        synchronize(self.device)

    def pixels(self, arr: np.ndarray) -> torch.Tensor:
        """HWC float32 -> [1, C, H, W] on the device in the serving dtype."""
        return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1))[None]).to(
            self.device, self.dtype)

    @torch.inference_mode()
    def run(self, arr: np.ndarray):
        return self.model(self.pixels(arr))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


# --- DPT depth ---

class DepthEstimator(_Detector):
    """PIL -> inverse depth [H, W] f32 in [0, 1] at the image's size."""

    def __init__(self, model_name: str, where: Detectors, allow_random_init: bool = False):
        self.model_name = model_name
        self.config = depth_mod.TINY_DPT if is_test_model(model_name) else depth_mod.DPTConfig()
        model_dir = where.model_dir(model_name)
        state = None
        if model_dir is not None and model_dir.is_dir():
            try:
                state = _safetensors_state(model_dir)
            except FileNotFoundError:
                state = None
        if state is None:
            require_weights_present(
                model_name, model_dir if model_dir is not None and model_dir.is_dir() else None,
                allow_random_init, component="depth model",
                hint="Put transformers' DPT safetensors under <model_root_dir>/<name>/.")
        self._place(lambda: depth_mod.DPTDepthModel(self.config), where, state, str(model_dir),
                    depth_mod.UNUSED_KEYS, model_name)

    def prepare(self, image) -> np.ndarray:
        size = self.config.image_size
        rgb = image.convert("RGB").resize((size, size), Image.BICUBIC)
        return (np.asarray(rgb, np.float32) / 255.0 - _MEAN) / _STD

    def __call__(self, image) -> np.ndarray:
        size = self.config.image_size
        original = image.size
        depth = _numpy(self.run(self.prepare(image)))[0]
        lo, hi = float(depth.min()), float(depth.max())
        depth = (depth - lo) / (hi - lo) if hi > lo else np.zeros_like(depth)
        if original != (size, size):
            # in float (mode "F"): a uint8 detour would band the gradients
            depth = np.asarray(Image.fromarray(depth.astype(np.float32), mode="F").resize(
                original, Image.BICUBIC), np.float32)
        return np.clip(depth, 0.0, 1.0).astype(np.float32)


# --- openpose ---

def decode_openpose(paf: np.ndarray, heat: np.ndarray, out_w: int, out_h: int,
                    peak_thresh: float = 0.1, paf_thresh: float = 0.05) -> np.ndarray:
    """Openpose's PAF grouping: (paf [h, w, 38], heat [h, w, 19]) -> people
    [P, 18, 3] (x, y, confidence) scaled to (out_w, out_h): peaks of the
    smoothed heatmaps, limbs scored by line integrals over the affinity
    fields, a greedy assignment per limb, then people assembled from limbs
    and pruned (fewer than 4 keypoints or a mean score under 0.2)."""
    from scipy.ndimage import gaussian_filter

    h, w = heat.shape[:2]
    sx, sy = out_w / w, out_h / h
    all_peaks: list[list[tuple]] = []
    peak_id = 0
    for k in range(18):
        m = gaussian_filter(heat[:, :, k], sigma=2)
        peaks = ((m > np.roll(m, 1, 0)) & (m > np.roll(m, -1, 0))
                 & (m > np.roll(m, 1, 1)) & (m > np.roll(m, -1, 1)) & (m > peak_thresh))
        ys, xs = np.nonzero(peaks)
        rows = []
        for x, y in zip(xs, ys):
            rows.append((float(x), float(y), float(heat[y, x, k]), peak_id))
            peak_id += 1
        all_peaks.append(rows)

    connections: list[list[tuple]] = []
    for (a, b), (c1, c2) in zip(pose_mod.LIMB_SEQ, pose_mod.PAF_IDX):
        cand_a, cand_b = all_peaks[a], all_peaks[b]
        scored = []
        for i, pa in enumerate(cand_a):
            for j, pb in enumerate(cand_b):
                vec = np.array([pb[0] - pa[0], pb[1] - pa[1]], np.float32)
                norm = float(np.linalg.norm(vec))
                if norm < 1e-4:
                    continue
                u = vec / norm
                xs = np.linspace(pa[0], pb[0], 10)
                ys = np.linspace(pa[1], pb[1], 10)
                px = paf[np.clip(np.round(ys).astype(int), 0, h - 1),
                         np.clip(np.round(xs).astype(int), 0, w - 1)]
                scores = px[:, c1] * u[0] + px[:, c2] * u[1]
                prior = min(0.5 * h / norm - 1.0, 0.0)
                mean = float(scores.mean()) + prior
                if (scores > paf_thresh).sum() > 0.8 * len(scores) and mean > 0:
                    scored.append((i, j, mean))
        scored.sort(key=lambda t: -t[2])
        used_a, used_b, conn = set(), set(), []
        for i, j, s in scored:
            if i not in used_a and j not in used_b:
                used_a.add(i)
                used_b.add(j)
                conn.append((cand_a[i][3], cand_b[j][3], s, i, j))
        connections.append(conn)

    flat_peaks = [p for rows in all_peaks for p in rows]
    subsets: list[dict] = []
    for (a, b), conn in zip(pose_mod.LIMB_SEQ, connections):
        for pid_a, pid_b, score, _, _ in conn:
            for s in subsets:
                if s.get(a) == pid_a or s.get(b) == pid_b:
                    s[a] = pid_a
                    s[b] = pid_b
                    s["score"] += score
                    break
            else:
                subsets.append({a: pid_a, b: pid_b, "score": score})

    people = []
    for s in subsets:
        kps = [k for k in s if isinstance(k, int)]
        if len(kps) < 4 or s["score"] / max(len(kps), 1) < 0.2:
            continue
        row = np.zeros((18, 3), np.float32)
        for k in kps:
            x, y, conf, _ = flat_peaks[s[k]]
            row[k] = ((x + 0.5) * sx, (y + 0.5) * sy, conf)
        people.append(row)
    if not people:
        return np.zeros((0, 18, 3), np.float32)
    return np.stack(people)


class PoseEstimator(_Detector):
    """PIL -> [P, 18, 3] (x, y, confidence) per person in the image's pixels.
    A production name runs the CMU body network (`*body_pose*.pth`, or
    safetensors) at a 368 canvas and decodes with `decode_openpose`; a test
    name runs the tiny PoseNet (its safetensors when present, else random)
    and reads one person off the heatmaps' maxima."""

    def __init__(self, model_name: str, where: Detectors, allow_random_init: bool = False):
        self.model_name = model_name
        self.real = not is_test_model(model_name)
        model_dir = where.model_dir(model_name)
        state, source = None, str(model_dir)
        if model_dir is not None and model_dir.is_dir():
            try:
                state = _safetensors_state(model_dir)
            except FileNotFoundError:
                if self.real:
                    try:
                        state, path = _glob_state(model_dir, "*body_pose*.pth")
                        source = str(path)
                    except FileNotFoundError:
                        state = None
        if self.real:
            if state is None:
                require_weights_present(model_name, None, allow_random_init,
                                        component="pose model",
                                        hint="Put body_pose_model.pth under "
                                             "<model_root_dir>/<name>/.")
            else:
                state = pose_mod.prefixed(state)
            factory = pose_mod.OpenposeBody
        else:
            self.config = pose_mod.TINY_POSE
            factory = lambda: pose_mod.PoseNet(self.config)  # noqa: E731
        self._place(factory, where, state, source, seed_name=model_name)

    def prepare(self, image) -> np.ndarray:
        if self.real:  # pytorch-openpose's normalisation
            rgb = image.convert("RGB").resize((POSE_CANVAS, POSE_CANVAS), Image.BICUBIC)
            return np.asarray(rgb, np.float32) / 256.0 - 0.5
        size = self.config.image_size
        rgb = image.convert("RGB").resize((size, size), Image.BICUBIC)
        return np.asarray(rgb, np.float32) / 127.5 - 1.0

    def __call__(self, image) -> np.ndarray:
        w, h = image.size
        if self.real:
            paf, heat = self.run(self.prepare(image))
            return decode_openpose(_numpy(paf)[0].transpose(1, 2, 0),
                                   _numpy(heat)[0].transpose(1, 2, 0), w, h)
        heat = _numpy(self.run(self.prepare(image)))[0].transpose(1, 2, 0)
        hs, ws, k = heat.shape
        flat = heat.reshape(hs * ws, k)
        idx = flat.argmax(axis=0)
        conf = flat[idx, np.arange(k)]
        ys, xs = np.divmod(idx, ws)
        out = np.stack([(xs + 0.5) / ws * w, (ys + 0.5) / hs * h, conf], axis=-1)
        return out.astype(np.float32)[None]


# --- HED ---

def hed_config(state: dict) -> HEDConfig:
    """The stage widths and depths of a ControlNetHED checkpoint."""
    channels, layers = [], []
    i = 1
    while f"block{i}.projection.weight" in state:
        n = sum(1 for k in state if k.startswith(f"block{i}.convs.") and k.endswith(".weight"))
        channels.append(int(state[f"block{i}.convs.0.weight"].shape[0]))
        layers.append(n)
        i += 1
    return HEDConfig(channels=tuple(channels), layers=tuple(layers))


class HEDDetector(_Detector):
    """PIL -> soft edge probabilities [H, W] in [0, 1] at the image's size.
    The widths are read off the checkpoint (`*HED*.pth`, or safetensors)."""

    def __init__(self, model_name: str, where: Detectors, allow_random_init: bool = False):
        self.model_name = model_name
        model_dir = where.model_dir(model_name)
        state, source = None, str(model_dir)
        if model_dir is not None and model_dir.is_dir():
            try:
                state = _safetensors_state(model_dir)
            except FileNotFoundError:
                try:
                    state, path = _glob_state(model_dir, "*HED*.pth")
                    source = str(path)
                except FileNotFoundError:
                    state = None
        if state is None:
            require_weights_present(model_name, None, allow_random_init,
                                    component="HED edge model")
            self.config = HEDConfig()
        else:
            self.config = hed_config(state)
        self._place(lambda: HEDNet(self.config), where, state, source, seed_name=model_name)

    def prepare(self, image) -> np.ndarray:
        rgb = image.convert("RGB").resize((HED_SIZE, HED_SIZE), Image.BICUBIC)
        return np.asarray(rgb, np.float32)

    def __call__(self, image) -> np.ndarray:
        original = image.size
        maps = [np.asarray(Image.fromarray(_numpy(m)[0, 0]).resize(original, Image.BILINEAR),
                           np.float32)
                for m in self.run(self.prepare(image))]
        return (1.0 / (1.0 + np.exp(-np.mean(np.stack(maps), axis=0)))).astype(np.float32)


# --- UperNet segmentation ---

class Segmenter(_Detector):
    """PIL -> ADE label map [H, W] int32 at the image's size. Converted
    weights only (safetensors and config.json): absent, the preprocessor
    serves its stand-in."""

    def __init__(self, model_name: str, where: Detectors):
        model_dir = where.model_dir(model_name)
        if model_dir is None or not model_dir.is_dir():
            raise MissingWeightsError(f"segmentation weights for '{model_name}' are not present")
        self.config = seg_mod.config_from_json(_config_json(model_dir))
        state = seg_mod.fold_batchnorms(_safetensors_state(model_dir))
        self._place(lambda: seg_mod.UperNetSegmenter(self.config), where, state, str(model_dir))

    def prepare(self, image) -> np.ndarray:
        rgb = image.convert("RGB").resize((SEG_SIZE, SEG_SIZE), Image.BILINEAR)
        return (np.asarray(rgb, np.float32) / 255.0 - _MEAN) / _STD

    def __call__(self, image) -> np.ndarray:
        w, h = image.size
        with torch.inference_mode():
            labels = self.model(self.pixels(self.prepare(image))).argmax(dim=1)[0]
            labels = labels.to(torch.int32).cpu().numpy()
        return np.asarray(Image.fromarray(labels.astype(np.uint8)).resize((w, h), Image.NEAREST),
                          np.int32)


# --- M-LSD ---

class MLSDDetector(_Detector):
    """PIL -> segments [N, 4] (x1, y1, x2, y2) in the image's pixels."""

    def __init__(self, model_name: str, where: Detectors):
        state, source, ignore = _annotator_state(where.model_dir(model_name),
                                                 "backbone.features.0.0.weight", "*mlsd*.pth")
        self._place(mlsd_mod.MLSDNet, where, mlsd_mod.fold_batchnorms(state), source, ignore)

    def prepare(self, image) -> np.ndarray:
        """RGB and a constant alpha plane, in [-1, 1]."""
        rgb = image.convert("RGB").resize((MLSD_SIZE, MLSD_SIZE), Image.BILINEAR)
        return np.concatenate([np.asarray(rgb, np.float32),
                               np.ones((MLSD_SIZE, MLSD_SIZE, 1), np.float32)],
                              axis=-1) / 127.5 - 1.0

    def __call__(self, image, score_thr: float = 0.1, dist_thr: float = 0.1) -> np.ndarray:
        from scipy.ndimage import maximum_filter

        w, h = image.size
        tp = _numpy(self.run(self.prepare(image)))[0].transpose(1, 2, 0)
        center, disp = tp[:, :, 0], tp[:, :, 1:5]
        heat = 1.0 / (1.0 + np.exp(-center))
        # a 5x5 window, upstream's max-pool NMS
        hmax = maximum_filter(heat, size=5, mode="nearest")
        heat = np.where(heat >= hmax, heat, 0.0)
        top = np.argsort(heat.ravel())[::-1][:200]
        ys, xs = np.unravel_index(top, heat.shape)
        lines = []
        for y, x in zip(ys, xs):
            if heat[y, x] <= score_thr:
                break
            x1, y1 = x + disp[y, x, 0], y + disp[y, x, 1]
            x2, y2 = x + disp[y, x, 2], y + disp[y, x, 3]
            if np.hypot(x2 - x1, y2 - y1) > dist_thr:
                lines.append((x1, y1, x2, y2))
        if not lines:
            return np.zeros((0, 4), np.float32)
        # the TP map is at canvas/2: 2x to the canvas, then to the image
        seg = np.asarray(lines, np.float32) * 2.0
        seg[:, 0::2] *= w / MLSD_SIZE
        seg[:, 1::2] *= h / MLSD_SIZE
        return seg


# --- LineArt ---

class LineartDetector(_Detector):
    """PIL -> stroke intensity [H, W] in [0, 1], white lines on black."""

    def __init__(self, model_name: str, where: Detectors):
        state, source, ignore = _annotator_state(where.model_dir(model_name), "model0.1.weight",
                                                 "sk_model*.pth")
        self.config = lineart_mod.config_from_state(state)
        self._place(lambda: lineart_mod.LineartGenerator(self.config), where, state, source,
                    ignore)

    def prepare(self, image) -> np.ndarray:
        rgb = image.convert("RGB").resize((LINEART_SIZE, LINEART_SIZE), Image.BILINEAR)
        return np.asarray(rgb, np.float32) / 255.0

    def __call__(self, image) -> np.ndarray:
        original = image.size
        sketch = _numpy(self.run(self.prepare(image)))[0, 0]
        inverted = 1.0 - sketch
        return np.asarray(Image.fromarray((inverted * 255).astype(np.uint8)).resize(
            original, Image.BILINEAR), np.float32) / 255.0


# --- PiDiNet ---

class PidinetDetector(_Detector):
    """PIL -> soft edge probabilities [H, W] in [0, 1]."""

    def __init__(self, model_name: str, where: Detectors):
        state, source, ignore = _annotator_state(where.model_dir(model_name),
                                                 "init_block.weight", "*pidinet*.pth")
        self._place(pidinet_mod.PiDiNet, where, pidinet_mod.reparameterize(state), source,
                    ignore)

    def prepare(self, image) -> np.ndarray:
        rgb = image.convert("RGB").resize((PIDI_SIZE, PIDI_SIZE), Image.BILINEAR)
        return np.asarray(rgb, np.float32) / 255.0

    def __call__(self, image) -> np.ndarray:
        original = image.size
        edge = _numpy(self.run(self.prepare(image)))[0, 0]
        return np.asarray(Image.fromarray((edge * 255).astype(np.uint8)).resize(
            original, Image.BILINEAR), np.float32) / 255.0


# --- ZoeDepth ---

class ZoeEstimator(_Detector):
    """PIL -> metric depth [H, W] f32 (metres) at the image's size, on a
    fixed canvas equal to the trained window."""

    def __init__(self, model_name: str, where: Detectors):
        model_dir = where.model_dir(model_name)
        if model_dir is None or not model_dir.is_dir():
            raise FileNotFoundError(f"no checkpoint directory {model_dir}")
        self.config = zoe_mod.config_from_json(_config_json(model_dir))
        self._place(lambda: zoe_mod.ZoeDepthModel(self.config), where,
                    _safetensors_state(model_dir), str(model_dir))

    def prepare(self, image) -> np.ndarray:
        size = self.config.image_size
        rgb = image.convert("RGB").resize((size, size), Image.BICUBIC)
        return (np.asarray(rgb, np.float32) / 255.0 - 0.5) / 0.5

    def __call__(self, image) -> np.ndarray:
        original = image.size
        depth = _numpy(self.run(self.prepare(image)))[0]
        return np.asarray(Image.fromarray(depth, mode="F").resize(original, Image.BICUBIC),
                          np.float32)
