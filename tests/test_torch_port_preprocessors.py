"""chiaswarm_tpu_torch's model-backed ControlNet preprocessors against the
JAX package, on the CPU.

- Each detector network at its tiny config (TINY_DPT, TINY_HED, the tiny
  PoseNet, TINY_LINEART, TINY_ZOE, TINY_UPERNET; M-LSD, PiDiNet and the
  openpose body network, which have one width, at a 64² input): the port's
  seeded state in its upstream layout goes into JAX through the JAX
  package's `convert_*`, the two modules run on the same input in f32,
  within 1e-4 absolute and relative (the upscaler tests' TOL), and
  `weights.from_jax_params` gives back the state the port runs (the
  folded BatchNorms and re-parameterised kernels where JAX folds them).
- Decoded outputs: openpose's PAF grouping on synthetic maps (keypoints
  within 0.5 px, confidences within 1e-4), M-LSD's segments equal after
  rounding, UperNet's labels equal on at least 99.9% of pixels.
- The condition image of every preprocessor name the port used to refuse,
  aliases included, against JAX's on one photo-like image, both packages
  reading the same files under one model root (JAX's HED and pose
  detectors at the test names' tiny configs): grey maps and normals
  within 1 level on at least 99.9% of pixels, drawings (scribble, mlsd,
  openpose: OpenCV's line, polygon and circle rasterisation ported pixel
  for pixel) equal on at least 99.9%, segmentation labels on 99.9%.
  Measured: depth, scribble, soft edge, mlsd, openpose and depth
  estimator equal everywhere; lineart, the normals and zoe within 1
  level everywhere; segmentation labels equal on 99.905%.
- Without weights: the Laplacian (scribble), the difference of Gaussians
  (lineart) and DPT (zoe) within 1 level of JAX's OpenCV on 99.9% of
  pixels; the Hough and k-means stand-ins by their properties (each
  segment on the edge map and long enough; at most 12 labels, all from
  the palette; equal inputs, equal maps); `degraded_preprocessors` of
  both packages' job arguments equal in the four absent-weights cases;
  DPT and openpose without weights raise MissingWeightsError in both; the
  negative cache re-probes once weights arrive.
- The worker serves a tiny ControlNet job with a preprocessor, and one
  with a stand-in, whose envelope says so.

Each JAX detector compiles once: the module fixture keeps JAX's condition
images and the detectors live in both packages' process caches.
"""

import asyncio
import copy
import io
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw
from safetensors.torch import save_file

from chiaswarm_tpu import job_arguments as jax_job_arguments
from chiaswarm_tpu.models import conversion as jax_conversion
from chiaswarm_tpu.pipelines import aux_models as jax_aux
from chiaswarm_tpu.pre_processors import controlnet as jax_pre
from chiaswarm_tpu.settings import Settings as JaxSettings
from chiaswarm_tpu_torch import job_arguments
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.models import depth, hed, lineart, mlsd, pidinet, pose
from chiaswarm_tpu_torch.models import segmentation as seg
from chiaswarm_tpu_torch.models import zoedepth as zoe
from chiaswarm_tpu_torch.pipelines import aux_models as aux
from chiaswarm_tpu_torch.pre_processors import controlnet as pre
from chiaswarm_tpu_torch.pre_processors import imgproc
from chiaswarm_tpu_torch.settings import Settings
from chiaswarm_tpu_torch.weights import MissingWeightsError, from_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
DPT_NAME = "test/tiny-dpt"
POSE_NAME = "test/tiny-pose"
HED_NAME = "test/tiny-hed"
# the 12 names the port refused, and an alias
SERVED = ("depth", "scribble", "softedge", "soft edge", "mlsd", "lineart", "normal bae",
          "zoe depth", "zoe", "segmentation", "openpose", "depth estimator", "Normal-BAE")


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _chip_smoke()


def photo(w: int = 120, h: int = 96) -> Image.Image:
    """Smooth shading with hard shapes and straight edges."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([90 + 60 * np.sin(xx / 13), 80 + 50 * np.cos(yy / 11),
                    120 + 40 * np.sin((xx + yy) / 17)], -1)
    image = Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(image)
    draw.rectangle((14, 12, 58, 50), fill=(230, 220, 40))
    draw.ellipse((64, 30, 108, 84), fill=(30, 40, 200))
    draw.line((5, 90, 115, 60), fill=(250, 250, 250), width=3)
    draw.polygon(((20, 80), (45, 58), (60, 88)), fill=(200, 30, 30))
    return image


def _clear_jax():
    for cache in (jax_aux._DEPTH, jax_aux._POSE, jax_aux._HED, jax_aux._SEG, jax_aux._MLSD,
                  jax_aux._LINEART, jax_aux._PIDI, jax_aux._ZOE):
        cache.clear()


def _jax_env(mp, models):
    mp.setenv("CHIASWARM_MODEL_ROOT_DIR", str(models))
    mp.setenv("CHIASWARM_DEPTH_MODEL", DPT_NAME)
    mp.setenv("CHIASWARM_POSE_MODEL", POSE_NAME)
    _clear_jax()
    # JAX serves HED at its full widths under the annotators' name; the
    # test name's detector reads the same tiny file
    jax_aux._HED[aux.DEFAULT_ANNOTATORS] = jax_aux.HEDDetector(HED_NAME)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Every detector written under one model root (tiny where a config
    is), the tiny pose network JAX random-initialises written for the port
    from JAX's parameters, and a degraded root with M-LSD, LineArt,
    ZoeDepth and UperNet absent."""
    root = tmp_path_factory.mktemp("preprocessors")
    models, degraded = root / "models", root / "degraded"
    mp = pytest.MonkeyPatch()
    mp.setenv("SDAAS_ROOT", str(root / "sdaas"))
    smoke.write_detectors(models, 11, tiny=True, depth_model=DPT_NAME, pose_model=POSE_NAME)
    (models / HED_NAME).mkdir(parents=True)
    shutil.copy(models / aux.DEFAULT_ANNOTATORS / smoke.HED_FILE, models / HED_NAME)
    _jax_env(mp, models)
    pose_params = jax_aux.get_pose_estimator().params
    (models / POSE_NAME).mkdir(parents=True)
    save_file(from_jax_params({"pose_net": jax.tree_util.tree_map(np.asarray, pose_params)})[
        "pose_net"], str(models / POSE_NAME / "model.safetensors"))
    smoke.write_detectors(degraded, 11, tiny=True, depth_model=DPT_NAME, pose_model=POSE_NAME,
                          skip=("mlsd", "lineart", "zoe", "upernet", "hed"))
    aux.clear()
    yield {"models": models, "degraded": degraded, "mp": mp, "jax": {},
           "det": aux.Detectors("cpu", str(models), DPT_NAME, POSE_NAME),
           "image": photo()}
    aux.clear()
    _clear_jax()
    mp.undo()


def _eager_zoe():
    """JAX's ZoeEstimator with its network run eagerly: its jitted program
    gives NaN everywhere (XLA folds the log-binomial's constants, and
    log(n - k + eps) goes negative at the last bin; ROADMAP §3)."""
    est = jax_aux.get_zoe_estimator()
    if est is not None:
        est._program = lambda p, px: est.model.apply({"params": p}, px)
    return est


def _jax_image(env, name):
    """JAX's condition image for `name` (cached: one compile per detector)."""
    if name not in env["jax"]:
        _eager_zoe()
        env["jax"][name] = np.asarray(jax_pre.preprocess_image(env["image"], name, "cpu"))
    return env["jax"][name]


# --- the networks ---

def _seeded(factory, seed):
    return smoke._cpu_state(smoke.seeded_detector(factory, seed))


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def _case_dpt():
    from chiaswarm_tpu.models.depth import TINY_DPT, DPTDepthModel

    state = _seeded(lambda: depth.DPTDepthModel(depth.TINY_DPT), 1)
    return (depth.DPTDepthModel(depth.TINY_DPT), state, state, DPTDepthModel(TINY_DPT),
            jax_conversion.convert_dpt(state), "dpt", (1, 3, 64, 64))


def _case_hed():
    from chiaswarm_tpu.models.hed import TINY_HED, HEDNet

    state = _seeded(lambda: hed.HEDNet(hed.TINY_HED), 2)
    return (hed.HEDNet(hed.TINY_HED), state, state, HEDNet(TINY_HED),
            jax_conversion.convert_hed(state), "hed", (1, 3, 40, 48))


def _case_openpose_body():
    from chiaswarm_tpu.models.pose import OpenposeBody

    state = _seeded(pose.OpenposeBody, 3)
    flat = {k.split(".", 1)[1]: v for k, v in state.items()}  # the published keys
    return (pose.OpenposeBody(), pose.prefixed(flat), state, OpenposeBody(),
            jax_conversion.convert_openpose_body(flat), "openpose_body", (1, 3, 64, 64))


def _case_pose_net():
    from chiaswarm_tpu.models.pose import TINY_POSE, PoseNet

    module = PoseNet(TINY_POSE)
    tree = jax.tree_util.tree_map(np.asarray, module.init(jax.random.key(4),
                                                         jnp.zeros((1, 64, 64, 3)))["params"])
    state = from_jax_params({"pose_net": tree})["pose_net"]
    return pose.PoseNet(pose.TINY_POSE), state, state, module, tree, "pose_net", (1, 3, 64, 64)


def _case_pidinet():
    from chiaswarm_tpu.models.pidinet import PiDiNet

    published = smoke.published_pidinet(_seeded(pidinet.PiDiNet, 5), 5)
    state = pidinet.reparameterize(published)
    tree = jax_conversion.convert_pidinet({k: v.numpy() for k, v in
                                           published["state_dict"].items()})
    return pidinet.PiDiNet(), state, state, PiDiNet(), tree, "pidinet", (1, 3, 64, 64)


def _case_mlsd():
    from chiaswarm_tpu.models.mlsd import MLSDNet

    published = smoke.published_mlsd(_seeded(mlsd.MLSDNet, 6), 6)
    state = mlsd.fold_batchnorms(published)
    tree = jax_conversion.convert_mlsd({k: v.numpy() for k, v in published.items()})
    return mlsd.MLSDNet(), state, state, MLSDNet(), tree, "mlsd", (1, 4, 64, 64)


def _case_lineart():
    from chiaswarm_tpu.models.lineart import LineartGenerator

    state = _seeded(lambda: lineart.LineartGenerator(lineart.TINY_LINEART), 7)
    cfg, tree = jax_conversion.convert_lineart(state)
    return (lineart.LineartGenerator(lineart.config_from_state(state)), state, state,
            LineartGenerator(cfg), tree, "lineart", (1, 3, 32, 40))


def _case_zoedepth():
    from chiaswarm_tpu.models.zoedepth import ZoeDepthModel

    state = _seeded(lambda: zoe.ZoeDepthModel(zoe.TINY_ZOE), 8)
    cfg, tree = jax_conversion.convert_zoedepth(state, zoe.config_json(zoe.TINY_ZOE))
    return (zoe.ZoeDepthModel(zoe.config_from_json(zoe.config_json(zoe.TINY_ZOE))), state,
            state, ZoeDepthModel(cfg), tree, "zoedepth", (1, 3, 64, 64))


def _case_upernet():
    from chiaswarm_tpu.models.segmentation import TINY_UPERNET, UperNetSegmenter

    published = smoke.published_upernet(_seeded(lambda: seg.UperNetSegmenter(seg.TINY_UPERNET),
                                                 9), 9)
    state = seg.fold_batchnorms(published)
    tree = jax_conversion.convert_upernet({k: v.numpy() for k, v in published.items()})
    return (seg.UperNetSegmenter(seg.TINY_UPERNET), state, state,
            UperNetSegmenter(TINY_UPERNET), tree, "upernet", (1, 3, 64, 64))


NETWORKS = {"dpt": _case_dpt, "hed": _case_hed, "openpose_body": _case_openpose_body,
            "pose_net": _case_pose_net, "pidinet": _case_pidinet, "mlsd": _case_mlsd,
            "lineart": _case_lineart, "zoedepth": _case_zoedepth, "upernet": _case_upernet}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_matches_jax(name):
    module, load, state, jax_module, tree, key, shape = NETWORKS[name]()
    module.load_state_dict(load)
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    if name == "hed":
        x = x * 60 + 127.5
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x))
    apply = lambda p, px: jax_module.apply({"params": p}, px)  # noqa: E731
    # ZoeDepth runs eagerly: jitted, XLA folds its log-binomial's constants
    # into a NaN at the last bin (ROADMAP §3)
    want = (apply if name == "zoedepth" else jax.jit(apply))(tree, _nhwc(x))
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        w = w.transpose(0, 3, 1, 2) if w.ndim == 4 else w
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    back = from_jax_params({key: tree})[key]
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_allclose(back[k].numpy(), v.numpy(), atol=1e-6, err_msg=k)


# --- decoded outputs ---

def _synthetic_pose(h=46, w=46):
    """Heatmaps with a blob per keypoint of two people, and part-affinity
    fields along each limb."""
    rng = np.random.RandomState(3)
    people = [rng.uniform(4, 42, (18, 2)) for _ in range(2)]
    heat = np.zeros((h, w, 19), np.float32)
    paf = np.zeros((h, w, 38), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for kps in people:
        for k, (x, y) in enumerate(kps):
            heat[:, :, k] += np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 4.0) * 0.9
        for (a, b), (c1, c2) in zip(pose.LIMB_SEQ, pose.PAF_IDX):
            (xa, ya), (xb, yb) = kps[a], kps[b]
            v = np.array([xb - xa, yb - ya])
            n = np.linalg.norm(v) + 1e-6
            u = v / n
            t = np.clip(((xx - xa) * u[0] + (yy - ya) * u[1]) / n, 0, 1)
            d = np.hypot(xx - xa - t * v[0], yy - ya - t * v[1])
            on = d < 1.5
            paf[:, :, c1] += on * u[0]
            paf[:, :, c2] += on * u[1]
    return paf, heat


def test_decode_openpose_matches_jax():
    paf, heat = _synthetic_pose()
    got = aux.decode_openpose(paf, heat, 368, 300)
    want = jax_aux.decode_openpose(paf, heat, 368, 300)
    assert got.shape == want.shape and got.shape[0] >= 1
    np.testing.assert_allclose(got[..., :2], want[..., :2], atol=0.5)
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=1e-4)


def test_mlsd_segments_match_jax(env):
    got = env["det"].mlsd()(env["image"])
    want = jax_aux.get_mlsd_detector()(env["image"])
    assert len(got) > 10
    assert sorted(map(tuple, np.rint(got).astype(int))) == \
        sorted(map(tuple, np.rint(want).astype(int)))


def test_segmentation_labels_match_jax(env):
    got = env["det"].segmenter()(env["image"])
    want = jax_aux.get_segmenter()(env["image"])
    assert got.shape == want.shape == (96, 120)
    assert len(np.unique(want)) > 1
    assert (got == want).mean() >= 0.999


# --- condition images ---

GREY = {"depth", "depth estimator", "softedge", "soft edge", "lineart", "zoe depth", "zoe",
        "normal bae", "Normal-BAE"}
DRAWN = {"scribble", "mlsd", "openpose"}


@pytest.mark.parametrize("name", SERVED)
def test_model_backed_preprocessors_are_served(env, name):
    """Each name the port used to refuse is served, and matches JAX's."""
    got = np.asarray(pre.preprocess_image(env["image"], name, detectors=env["det"]), np.int16)
    want = _jax_image(env, name).astype(np.int16)
    assert got.shape == want.shape == (96, 120, 3)
    assert len(np.unique(want)) > 1
    diff = np.abs(got - want).max(-1)
    if name in GREY:
        assert (diff <= 1).mean() >= 0.999
    elif name in DRAWN:
        assert (diff == 0).mean() >= 0.999
    else:  # segmentation: the palette colours of equal labels
        assert (diff == 0).mean() >= 0.999
    assert not pre.is_degraded_preprocessor(name, env["det"])


# --- without weights ---

@pytest.fixture()
def degraded(env, monkeypatch):
    """The degraded root for both packages, their caches empty."""
    monkeypatch.setenv("CHIASWARM_MODEL_ROOT_DIR", str(env["degraded"]))
    _clear_jax()
    aux.clear()
    yield aux.Detectors("cpu", str(env["degraded"]), DPT_NAME, POSE_NAME)
    aux.clear()
    _jax_env(monkeypatch, env["models"])
    env["mp"].setenv("CHIASWARM_MODEL_ROOT_DIR", str(env["models"]))


@pytest.mark.parametrize("name", ["scribble", "lineart", "zoe depth"])
def test_deterministic_stand_ins_match_jax(degraded, env, name):
    """The Laplacian (scribble without HED), the difference of Gaussians
    (lineart) and DPT's depth (zoe): JAX's OpenCV within 1 level."""
    got = np.asarray(pre.preprocess_image(env["image"], name, detectors=degraded), np.int16)
    want = np.asarray(jax_pre.preprocess_image(env["image"], name, "cpu"), np.int16)
    assert got.shape == want.shape and len(np.unique(want)) > 1
    assert (np.abs(got - want).max(-1) <= 1).mean() >= 0.999
    assert pre.is_degraded_preprocessor(name, degraded) == (name != "scribble")


def test_hough_stand_in_properties(degraded, env):
    image = env["image"]
    arr = np.asarray(image.convert("RGB"))
    edges = pre.canny_edges(imgproc.gray(arr), 60, 180)
    segments = pre.hough_stand_in(edges)
    h, w = edges.shape
    min_length = max(min(h, w) // 16, 8)
    assert len(segments) >= 3
    for x1, y1, x2, y2 in segments:
        assert edges[y1, x1] and edges[y2, x2]
        assert max(abs(x2 - x1), abs(y2 - y1)) >= min_length
        # the segment's pixels run along edge pixels, gaps of at most 4
        n = max(abs(x2 - x1), abs(y2 - y1)) + 1
        xs = np.rint(np.linspace(x1, x2, n)).astype(int)
        ys = np.rint(np.linspace(y1, y2, n)).astype(int)
        near = np.array([edges[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2].any()
                         for x, y in zip(xs, ys)])
        gaps = np.diff(np.flatnonzero(np.r_[True, near, True])) - 1
        assert gaps.max() <= 4
    drawn = np.asarray(pre.preprocess_image(image, "mlsd", detectors=degraded))
    again = np.asarray(pre.preprocess_image(image, "mlsd", detectors=degraded))
    np.testing.assert_array_equal(drawn, again)
    assert (drawn > 0).any() and pre.is_degraded_preprocessor("mlsd", degraded)


def test_kmeans_stand_in_properties(degraded, env):
    seg_map = np.asarray(pre.preprocess_image(env["image"], "segmentation", detectors=degraded))
    again = np.asarray(pre.preprocess_image(env["image"], "segmentation", detectors=degraded))
    np.testing.assert_array_equal(seg_map, again)
    colors = np.unique(seg_map.reshape(-1, 3), axis=0)
    palette = {tuple(c) for c in pre.ADE_STYLE_PALETTE}
    assert 2 <= len(colors) <= pre.KMEANS_CLUSTERS
    assert all(tuple(c) in palette for c in colors)
    assert np.array_equal(pre.ADE_STYLE_PALETTE, jax_pre.ADE_STYLE_PALETTE)
    assert pre.is_degraded_preprocessor("segmentation", degraded)


def _controlnet_job(name, uri):
    return {"id": f"cn-{name}", "workflow": "txt2img", "model_name": "test/tiny-sd",
            "prompt": "a house", "height": 64, "width": 64, "num_inference_steps": 2,
            "parameters": {"test_tiny_model": True, "controlnet": {
                "controlnet_model_name": "test/tiny-cn", "control_image_uri": uri,
                "preprocessor": name}}}


@pytest.fixture()
def photo_hive(env):
    hive = FakeHive(token="tok")
    buf = io.BytesIO()
    env["image"].save(buf, "PNG")
    yield hive, hive.enqueue_file("photo.png", buf.getvalue(), "image/png")
    hive.close()


@pytest.mark.parametrize("name", ["mlsd", "lineart", "zoe depth", "segmentation"])
def test_degraded_preprocessors_match_jax(degraded, env, photo_hive, name):
    _, uri = photo_hive
    job = _controlnet_job(name, uri)
    _, want = asyncio.run(jax_job_arguments.format_args(copy.deepcopy(job), JaxSettings(),
                                                        "cpu"))
    settings = Settings(model_root_dir=str(env["degraded"]), depth_model=DPT_NAME,
                        pose_model=POSE_NAME)
    _, got = job_arguments.format_args(copy.deepcopy(job), settings, "cpu")
    assert got["degraded_preprocessors"] == want["degraded_preprocessors"] == [name]


def test_missing_dpt_and_pose_raise_as_in_jax(env, tmp_path, monkeypatch):
    empty = aux.Detectors("cpu", str(tmp_path), aux.DEFAULT_DEPTH_MODEL, aux.DEFAULT_POSE_MODEL)
    monkeypatch.setenv("CHIASWARM_MODEL_ROOT_DIR", str(tmp_path))
    monkeypatch.setenv("CHIASWARM_DEPTH_MODEL", aux.DEFAULT_DEPTH_MODEL)
    monkeypatch.setenv("CHIASWARM_POSE_MODEL", aux.DEFAULT_POSE_MODEL)
    saved = dict(jax_aux._DEPTH), dict(jax_aux._POSE)
    jax_aux._DEPTH.clear()
    jax_aux._POSE.clear()
    try:
        for name, component in (("depth", "depth model"), ("openpose", "pose model")):
            with pytest.raises(jax_aux.MissingWeightsError if hasattr(jax_aux, "MissingWeightsError")
                               else ValueError, match=component):
                jax_pre.preprocess_image(env["image"], name, "cpu")
            with pytest.raises(MissingWeightsError, match=component):
                pre.preprocess_image(env["image"], name, detectors=empty)
    finally:
        jax_aux._DEPTH.update(saved[0])
        jax_aux._POSE.update(saved[1])


def test_negative_cache_picks_up_weights(env, tmp_path):
    """A stand-in answers while M-LSD's file is absent; once it arrives
    (the folder's mtime changes), the next call loads the detector."""
    root = tmp_path / "models"
    det = aux.Detectors("cpu", str(root), DPT_NAME, POSE_NAME)
    assert det.mlsd() is None and det.mlsd() is None
    folder = root / aux.DEFAULT_ANNOTATORS
    folder.mkdir(parents=True)
    shutil.copy(env["models"] / aux.DEFAULT_ANNOTATORS / smoke.MLSD_FILE, folder)
    detector = det.mlsd()
    assert detector is not None and detector.weights_source == "checkpoint"
    assert det.mlsd() is detector


def test_detector_missing_a_tensor_degrades(env, tmp_path):
    """A DPT state with one tensor deleted is a CheckpointError naming the
    missing parameter, which the negative cache turns into a degraded
    (None) detector, as JAX's `_cached_detector` does."""
    from chiaswarm_tpu_torch.weights import CheckpointError

    state = aux._safetensors_state(env["models"] / DPT_NAME)
    dropped = sorted(state)[len(state) // 2]
    del state[dropped]
    (tmp_path / DPT_NAME).mkdir(parents=True)
    save_file(state, str(tmp_path / DPT_NAME / "model.safetensors"))
    where = aux.Detectors("cpu", str(tmp_path), DPT_NAME, POSE_NAME)
    with pytest.raises(CheckpointError, match="parameters in no file"):
        aux.DepthEstimator(DPT_NAME, where)
    assert aux.cached_detector(where, "depth", DPT_NAME, aux.DepthEstimator) is None


def test_detectors_load_published_and_folded_forms(env, tmp_path):
    """M-LSD, UperNet and PiDiNet from the published files and from the
    folded state `from_jax_params` gives: the same parameters."""
    published = env["det"]
    folded_root = tmp_path / "folded"
    models = env["models"]
    for name, file, folder in (("mlsd", smoke.MLSD_FILE, aux.DEFAULT_ANNOTATORS),
                               ("pidinet", smoke.PIDINET_FILE, aux.DEFAULT_ANNOTATORS)):
        state = getattr(published, name)().model.state_dict()
        (folded_root / folder).mkdir(parents=True, exist_ok=True)
        save_file({k: v.contiguous() for k, v in state.items()},
                  str(folded_root / folder / f"{name}.safetensors"))
    shutil.copytree(models / aux.DEFAULT_SEGMENTATION_MODEL,
                    folded_root / aux.DEFAULT_SEGMENTATION_MODEL)
    seg_state = published.segmenter().model.state_dict()
    save_file({k: v.contiguous() for k, v in seg_state.items()},
              str(folded_root / aux.DEFAULT_SEGMENTATION_MODEL / "model.safetensors"))
    folded = aux.Detectors("cpu", str(folded_root), DPT_NAME, POSE_NAME)
    for name in ("mlsd", "pidinet", "segmenter"):
        a = getattr(published, name)().model.state_dict()
        b = getattr(folded, name)().model.state_dict()
        assert set(a) == set(b)
        for k in a:
            torch.testing.assert_close(a[k], b[k], msg=k)


def test_detectors_run_on_the_card_by_default(env):
    card = aux.Detectors(model_root_dir=str(env["models"]), depth_model=DPT_NAME)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        card.depth()


def test_worker_serves_preprocessor_jobs(env, photo_hive):
    hive, uri = photo_hive
    settings = Settings(sdaas_token="tok", sdaas_uri=hive.uri, worker_name="pre",
                        model_root_dir=str(env["degraded"]), depth_model=DPT_NAME,
                        pose_model=POSE_NAME, max_coalesce=1)
    worker = worker_mod.Worker(settings=settings, device="cpu", poll_seconds=0.01)
    hive.enqueue(_controlnet_job("depth", uri), _controlnet_job("lineart", uri))
    asyncio.run(asyncio.wait_for(worker.run(max_jobs=2), timeout=300))
    results = {r["id"]: r for r in hive.wait_for_results(2, timeout=10)}
    for name in ("depth", "lineart"):
        envelope = results[f"cn-{name}"]
        assert not envelope.get("fatal_error"), envelope["pipeline_config"].get("error")
        config = envelope["pipeline_config"]
        assert config["controlnet"] == "test/tiny-cn"
        assert set(envelope["artifacts"]) >= {"primary"}
    assert "degraded_preprocessors" not in results["cn-depth"]["pipeline_config"]
    assert results["cn-lineart"]["pipeline_config"]["degraded_preprocessors"] == ["lineart"]


def test_chip_smoke_preprocessor_path_rehearses_on_cpu():
    """chip_smoke.py's preprocessor path with tiny stand-ins on the CPU:
    every detector from its written files, every envelope, the stitch job
    and the degraded root's flags, the fatal envelope without DPT and the
    negative cache; the launches are printed, not held (no kernels here)."""
    paths, served = smoke.serve_preprocessor_path(
        "cpu", {"flash_attention": 0, "group_norm": 0}, device="cpu", sdxl="test/tiny-xl",
        sd15="test/tiny-sd", size15=64, size_xl=64, steps=2, tiny=True, hold=False)
    assert served["degraded"] == {"scribble": None, "mlsd": ["mlsd"], "lineart": ["lineart"],
                                  "segmentation": ["segmentation"], "zoe depth": ["zoe depth"],
                                  "mlsd-back": None}
    assert {f"pre_{n.replace(' ', '_')}" for n in smoke.PREPROCESSORS} <= set(paths)
    assert set(served["detectors"]) == {"depth", "hed", "pose", "pidinet", "mlsd", "lineart",
                                        "zoe", "segmenter"}
    assert served["stitch"]["rows"] == 2
