"""Worker setup CLI: `python -m chiaswarm_tpu_torch.initialize`, the
counterpart of chiaswarm_tpu/initialize.py.

The settings prompt (hive token, URI, worker name) into
$SDAAS_ROOT/settings.json (`--silent` keeps what is there, `--reset`
deletes the file); `--download` fetches each model's safetensors tree from
the hub into the model root; `--check` holds each model directory against
the modules the worker would load. Both work over `--models` or, unset,
the hive's catalog (`hive.get_models`) plus the auxiliary models serving
depends on (`aux_model_names`); a failure of an auxiliary model the
catalog did not name is a warning, not a failed run (the preprocessors and
the checker degrade, flagged), while anything named in `--models` fails
the run (exit 1).

`verify_local_model` dispatches by name as the JAX package's does, over
the families the port serves: SD and SDXL, Flux, Kandinsky 2.x and 3,
Stable Cascade, the SD-x2 latent upscaler, the safety checker, DPT,
ZoeDepth, the Annotators repo (HED, M-LSD, LineArt, PiDiNet), openpose and
UperNet. Each check reads the directory through the recipe its pipeline
loads with (the same configs, the same folders, the same key fix-ups),
builds the modules on the meta device (no device memory is touched, none
is needed) and holds every tensor's key and shape to them, from the
safetensors headers; a mismatch raises naming every missing, unexpected
and misshaped key. -> {component: parameters}. A family in
`registry.unconverted_family_keywords()`, or one the port does not serve,
is skipped (None), as JAX skips its unconverted families.

The port serves no `zero_image_embed.npy` precompute (JAX's runs
transformers' CLIP vision tower, which the card's machine lacks) and no
BLIP special-token table (BLIP is not ported).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

import torch

from .log_setup import setup_stream
from .settings import Settings, load_settings, save_settings, settings_path

logger = logging.getLogger(__name__)

# repo files worth fetching for serving: weights, configs, tokenizers
_DOWNLOAD_PATTERNS = ["*.safetensors", "*.json", "tokenizer/*", "tokenizer_2/*",
                      "text_encoder/*", "text_encoder_2/*", "unet/*", "vae/*", "scheduler/*",
                      "*.txt"]
# annotator repos ship torch pickles: only the files the detector loaders glob
_PTH_PATTERNS_BY_KEYWORD = {
    "annotators": ["*HED*.pth", "*mlsd*.pth", "sk_model*.pth", "*pidinet*.pth"],
    "openpose": ["*body_pose*.pth"],
}
# the auxiliary models of the JAX package's list that no setting names
HED_MODEL = MLSD_MODEL = LINEART_MODEL = PIDINET_MODEL = "lllyasviel/Annotators"
POSE_MODEL = "lllyasviel/ControlNet-openpose"
SEGMENTATION_MODEL = "openmmlab/upernet-convnext-small"
ZOE_MODEL = "Intel/zoedepth-nyu"
MOTION_ADAPTER = "guoyww/animatediff-motion-adapter-v1-5-2"


def prompt_for_settings(existing: Settings) -> Settings:
    print("chiaswarm-tpu-torch worker setup")
    token = input(f"hive token [{existing.sdaas_token or 'unset'}]: ").strip()
    uri = input(f"hive uri [{existing.sdaas_uri}]: ").strip()
    name = input(f"worker name [{existing.worker_name}]: ").strip()
    if token:
        existing.sdaas_token = token
    if uri:
        existing.sdaas_uri = uri
    if name:
        existing.worker_name = name
    return existing


def model_root() -> Path:
    return Path(load_settings().model_root_dir).expanduser()


def download_model(model_id: str, root: Path) -> bool:
    """Fetch one model's tree from the hub into the model root. False (and
    a log line) when `huggingface_hub` is absent or the fetch fails: the
    caller goes on, and serving later fails loudly if the weights are still
    missing."""
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        logger.error("huggingface_hub not installed; cannot download %s", model_id)
        return False
    patterns = list(_DOWNLOAD_PATTERNS)
    for keyword, extra in _PTH_PATTERNS_BY_KEYWORD.items():
        if keyword in model_id.lower():
            patterns += extra
    try:
        snapshot_download(repo_id=model_id, local_dir=str(root / model_id),
                          allow_patterns=patterns)
        return True
    except Exception as e:  # noqa: BLE001 — any hub failure is this model's
        logger.error("download failed for %s: %s", model_id, e)
        return False


# --- the checks, one per family ---

def _dir(root: Path, model_name: str) -> Path:
    model_dir = root / model_name
    if not model_dir.is_dir():
        raise FileNotFoundError(f"no checkpoint directory {model_dir}")
    return model_dir


def _check(modules: dict, model_dir: Path, folders: dict,
           text_layers: dict | None = None) -> dict:
    """{component: parameters} of meta `modules` held to the safetensors of
    their `folders` {component: folder}."""
    from .weights import check_checkpoint, checkpoint_files

    files = checkpoint_files(model_dir, dict.fromkeys(folders.values()))
    return {name: check_checkpoint(module, files[folders[name]], folders[name],
                                   text_layers=(text_layers or {}).get(name))
            for name, module in modules.items()}


def _verify_sd(model_name: str, root: Path) -> dict:
    from .models.clip import CLIPTextEncoder
    from .models.unet2d import UNet2DConditionModel
    from .models.vae import AutoencoderKL
    from .pipelines.stable_diffusion import family_configs
    from .weights import TEXT_ENCODER_FOLDERS

    model_dir = _dir(root, model_name)
    unet_cfg, clip_cfgs, vae_cfg, _, _ = family_configs(model_name, str(root))
    folders = ("unet", "vae", *TEXT_ENCODER_FOLDERS[:len(clip_cfgs)])
    with torch.device("meta"):
        modules = {"unet": UNet2DConditionModel(unet_cfg), "vae": AutoencoderKL(vae_cfg)}
        for folder, c in zip(TEXT_ENCODER_FOLDERS, clip_cfgs):
            modules[folder] = CLIPTextEncoder(c)
    layers = {f: c.num_layers for f, c in zip(TEXT_ENCODER_FOLDERS, clip_cfgs)}
    return _check(modules, model_dir, {f: f for f in folders}, layers)


def _verify_flux(model_name: str, root: Path) -> dict:
    from .models.clip import CLIPTextEncoder
    from .models.flux import FluxTransformer
    from .models.t5 import T5Encoder
    from .models.vae import AutoencoderKL
    from .pipelines.flux import flux_configs

    model_dir = _dir(root, model_name)
    flux_cfg, t5_cfg, clip_cfg, vae_cfg, *_ = flux_configs(model_name)
    with torch.device("meta"):
        modules = {"flux": FluxTransformer(flux_cfg), "t5": T5Encoder(t5_cfg),
                   "clip": CLIPTextEncoder(clip_cfg), "vae": AutoencoderKL(vae_cfg)}
    folders = {"flux": "transformer", "t5": "text_encoder_2", "clip": "text_encoder",
               "vae": "vae"}
    return _check(modules, model_dir, folders, {"clip": clip_cfg.num_layers})


def _verify_kandinsky(model_name: str, root: Path) -> dict:
    from .pipelines.kandinsky import verify_kandinsky

    return verify_kandinsky(model_name, _dir(root, model_name))


def _verify_kandinsky3(model_name: str, root: Path) -> dict:
    from .pipelines.kandinsky3 import verify_k3

    return verify_k3(_dir(root, model_name))


def _verify_cascade(model_name: str, root: Path) -> dict:
    from .pipelines.cascade import verify_cascade

    return verify_cascade(model_name, _dir(root, model_name))


def _verify_upscaler(model_name: str, root: Path) -> dict:
    """The SD-x2 latent upscaler (K-UNet, CLIP ViT-L, SD VAE), its configs
    read off the checkpoint as pipelines/upscale.py reads them."""
    from .models.clip import CLIPTextEncoder
    from .models.k_upscaler import KUpscalerUNet
    from .models.vae import AutoencoderKL
    from .pipelines.upscale import FOLDERS, upscaler_configs
    from .weights import checkpoint_files

    model_dir = _dir(root, model_name)
    unet_cfg, clip_cfg, vae_cfg = upscaler_configs(model_dir, checkpoint_files(model_dir, FOLDERS))
    with torch.device("meta"):
        modules = {"unet": KUpscalerUNet(unet_cfg), "text_encoder": CLIPTextEncoder(clip_cfg),
                   "vae": AutoencoderKL(vae_cfg)}
    return _check(modules, model_dir, {f: f for f in FOLDERS},
                  {"text_encoder": clip_cfg.num_layers})


def _verify_safety(model_name: str, root: Path) -> dict:
    from .models.safety import TINY_SAFETY, SafetyChecker, SafetyConfig
    from .weights import check_checkpoint, is_test_model

    model_dir = _dir(root, model_name)
    files = sorted(model_dir.glob("*.safetensors"))
    with torch.device("meta"):
        model = SafetyChecker(TINY_SAFETY if is_test_model(model_name) else SafetyConfig())
    return {"safety": check_checkpoint(model, files, "safety_checker")}


def _detector_count(detector) -> int:
    return sum(p.numel() for p in detector.model.parameters())


def _meta_where(root: Path, **names):
    from .pipelines.aux_models import Detectors

    return Detectors("meta", str(root), **names)


def _verify_dpt(model_name: str, root: Path) -> dict:
    from .pipelines.aux_models import DepthEstimator

    _dir(root, model_name)
    return {"dpt": _detector_count(DepthEstimator(model_name,
                                                  _meta_where(root, depth_model=model_name)))}


def _verify_zoedepth(model_name: str, root: Path) -> dict:
    from .pipelines.aux_models import ZoeEstimator

    _dir(root, model_name)
    return {"zoedepth": _detector_count(ZoeEstimator(model_name, _meta_where(root)))}


def _verify_annotators(model_name: str, root: Path) -> dict:
    """The shared Annotators repo: whichever of HED, M-LSD, LineArt and
    PiDiNet it holds, each through its serving loader; none is a failure."""
    from .pipelines.aux_models import (
        HEDDetector,
        LineartDetector,
        MLSDDetector,
        PidinetDetector,
    )
    from .weights import MissingWeightsError

    model_dir = _dir(root, model_name)
    where, report = _meta_where(root), {}
    for name, cls in (("hed", HEDDetector), ("mlsd", MLSDDetector),
                      ("lineart", LineartDetector), ("pidinet", PidinetDetector)):
        try:
            report[name] = _detector_count(cls(model_name, where))
        except (FileNotFoundError, KeyError, MissingWeightsError):
            continue
    if not report:
        raise FileNotFoundError(f"no convertible detector checkpoints under {model_dir}")
    return report


def _verify_openpose(model_name: str, root: Path) -> dict:
    from .pipelines.aux_models import PoseEstimator

    _dir(root, model_name)
    pose = PoseEstimator(model_name, _meta_where(root, pose_model=model_name))
    if pose.weights_source != "checkpoint":
        raise FileNotFoundError(f"no body_pose_model weights under {root / model_name}")
    return {"openpose_body": _detector_count(pose)}


def _verify_upernet(model_name: str, root: Path) -> dict:
    from .pipelines.aux_models import Segmenter

    _dir(root, model_name)
    return {"upernet": _detector_count(Segmenter(model_name, _meta_where(root)))}


# the JAX package's dispatch by name, in its order: (keywords, family);
# families the port does not serve are checked by nobody (skipped)
_DISPATCH = (
    (("blip",), None), (("zoedepth",), _verify_zoedepth), (("annotators",), _verify_annotators),
    (("dpt", "midas"), _verify_dpt), (("safety",), _verify_safety), (("flux",), _verify_flux),
    (("kandinsky-3", "kandinsky3"), _verify_kandinsky3),
    (("latent-upscaler", "tiny-upscaler"), _verify_upscaler),
    (("kandinsky",), _verify_kandinsky), (("audioldm", "bark"), None), (("deepfloyd/",), None),
    (("animatediff", "motion-adapter"), None), (("openpose",), _verify_openpose),
    (("upernet",), _verify_upernet), (("zeroscope", "text-to-video", "damo"), None),
    (("cascade",), _verify_cascade), (("stable-video", "svd"), None), (("i2vgen",), None),
)


def verify_local_model(model_name: str, root: Path | None = None) -> dict | None:
    """The model directory held against the modules the worker would load
    -> {component: parameters}; None for a family the port does not serve
    (skipped, not failed); raises on a mismatch or missing files."""
    from .registry import unconverted_family_keywords

    name = model_name.lower()
    if any(k in name for k in unconverted_family_keywords()):
        return None
    root = root or model_root()
    for keywords, verify in _DISPATCH:
        if any(k in name for k in keywords):
            return None if verify is None else verify(model_name, root)
    return _verify_sd(model_name, root)


def aux_model_names(settings: Settings) -> list[str]:
    """Models the hive does not list but serving depends on: the detectors
    of the preprocessors (one Annotators repo holds four), the NSFW checker
    and the AnimateDiff motion adapter, as the JAX package lists them."""
    out = []
    for aux in (settings.depth_model, settings.safety_checker_model, HED_MODEL, MLSD_MODEL,
                LINEART_MODEL, PIDINET_MODEL, POSE_MODEL, SEGMENTATION_MODEL, ZOE_MODEL,
                MOTION_ADAPTER):
        if aux and aux not in out:
            out.append(aux)
    return out


def fetch_hive_model_list(settings: Settings) -> list[str]:
    from .hive import get_models

    names = []
    for m in get_models(f"{settings.sdaas_uri.rstrip('/')}/api"):
        name = m.get("id") or m.get("model_name") or m.get("name")
        if name:
            names.append(name)
    return names


def _report_line(report: dict) -> str:
    total = sum(int(v) for v in report.values())
    return f"ok ({total / 1e6:.1f}M params, {json.dumps(report, sort_keys=True)})"


def init(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="chiaswarm-tpu-torch-init",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--reset", action="store_true", help="delete settings and exit")
    parser.add_argument("--silent", action="store_true",
                        help="no interactive prompt; keep existing settings")
    parser.add_argument("--download", action="store_true",
                        help="prefetch every hive-known model into the model root")
    parser.add_argument("--check", action="store_true",
                        help="hold locally present models against the port's modules")
    parser.add_argument("--models", nargs="*", default=None,
                        help="explicit model ids (default: ask the hive)")
    args = parser.parse_args(argv)

    if args.reset:
        path = settings_path()
        if path.is_file():
            path.unlink()
            print(f"removed {path}")
        return 0

    settings = load_settings()
    if not args.silent and (not settings_path().is_file() or not settings.sdaas_token):
        settings = prompt_for_settings(settings)
    save_settings(settings)
    setup_stream("WARNING", settings.log_format)

    rc = 0
    if args.download or args.check:
        names = args.models
        if names is None:
            try:
                names = fetch_hive_model_list(settings)
            except Exception as e:  # noqa: BLE001 — reported, the run fails
                print(f"failed to fetch hive model list: {e}; pass --models explicitly")
                return 1
            if not names:
                print("hive returned no model list; pass --models explicitly")
                return 1
            names += [aux for aux in aux_model_names(settings) if aux not in names]
        # an auxiliary model the catalog did not name degrades at serving
        # time; one named in --models fails the run
        soft_fail = set() if args.models is not None else set(aux_model_names(settings))
        root = model_root()
        root.mkdir(parents=True, exist_ok=True)
        for name in names:
            if args.download:
                if download_model(name, root):
                    print(f"download {name}: ok")
                elif name in soft_fail:
                    print(f"download {name}: FAILED (aux model; serving will flag degraded "
                          "fallbacks)")
                else:
                    print(f"download {name}: FAILED")
                    rc |= 1
            if args.check:
                try:
                    report = verify_local_model(name, root)
                    if report is None:
                        print(f"check {name}: skipped (family not served by this worker)")
                    else:
                        print(f"check {name}: {_report_line(report)}")
                except Exception as e:  # noqa: BLE001 — each model's verdict is printed
                    if name in soft_fail:
                        print(f"check {name}: FAILED: {e} (aux model; serving will flag "
                              "degraded fallbacks)")
                    else:
                        print(f"check {name}: FAILED: {e}")
                        rc |= 1
    return rc


def main() -> None:
    sys.exit(init())


if __name__ == "__main__":
    main()
