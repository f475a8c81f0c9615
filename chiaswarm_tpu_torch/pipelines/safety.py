"""The resident NSFW safety checker that feeds the envelope's `nsfw` flag,
the counterpart of chiaswarm_tpu/pipelines/safety.py, with its policy:

- the checker is auxiliary: a production name whose folder under the
  model root holds no safetensors disables it, and the job still serves
  with `nsfw: false, nsfw_checked: false`;
- `test/*` and `*tiny*` names without files random-initialise from
  crc32(name) (TINY_SAFETY);
- the setting `""` disables it;
- a checkpoint that fails to load is cached as disabled, so it is not
  parsed again for every job;
- `flag_images` never fails the job.

The checkpoint is `<model_root_dir>/<name>/*.safetensors` in the
published layout (models/safety.py). Images are resized to the tower's
canvas on the host (bicubic) and CLIP-normalised there; the tower runs on
the device in the serving dtype. One checker is kept per process, as in
the JAX package, outside the registry's LRU.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..device import resolve_device, serving_dtype, synchronize
from ..models.safety import TINY_SAFETY, SafetyChecker, SafetyConfig
from ..weights import (
    MissingWeightsError,
    is_test_model,
    load_checkpoint_,
    model_seed,
    random_init_,
)

logger = logging.getLogger(__name__)

DEFAULT_SAFETY_MODEL = "CompVis/stable-diffusion-safety-checker"
# CLIP image normalisation
_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)

_CHECKER = None
_CHECKER_KEY = None
_LOCK = threading.Lock()


class NSFWChecker:
    available = True

    def __init__(self, model_name: str, device, model_root_dir: str | None):
        """Loads `<model_root_dir>/<model_name>/*.safetensors`; a test name
        without files is random-initialised; any other name without files
        raises MissingWeightsError."""
        self.model_name = model_name
        self.device = resolve_device(device)
        self.dtype = serving_dtype(self.device)
        self.config = TINY_SAFETY if is_test_model(model_name) else SafetyConfig()
        files = []
        if model_root_dir:
            model_dir = Path(model_root_dir).expanduser() / model_name
            files = sorted(model_dir.glob("*.safetensors")) if model_dir.is_dir() else []
        if not files and not is_test_model(model_name):
            raise MissingWeightsError(f"safety checker {model_name} not present under "
                                      f"{model_root_dir}")
        with torch.device("meta"):
            model = SafetyChecker(self.config)
        model = model.to_empty(device=self.device).to(self.dtype).eval().requires_grad_(False)
        if files:
            load_checkpoint_(model, files, "safety_checker")
            self.weights_source = "checkpoint"
        else:
            init_random_(model, torch.Generator(device=self.device).manual_seed(
                model_seed(model_name)))
            self.weights_source = "random"
        self.model = model
        synchronize(self.device)

    def pixels(self, images) -> torch.Tensor:
        """PIL images or uint8 [H, W, 3] arrays -> the tower's input [B, 3,
        S, S] on the device: bicubic to S on the host, CLIP-normalised."""
        size = self.config.image_size
        batch = np.stack([
            (np.asarray(_pil(im).convert("RGB").resize((size, size), Image.BICUBIC),
                        np.float32) / 255.0 - _MEAN) / _STD
            for im in images])
        return torch.from_numpy(batch.transpose(0, 3, 1, 2).copy()).to(self.device, self.dtype)

    @torch.inference_mode()
    def scores(self, images) -> tuple[np.ndarray, list[bool]]:
        """-> (concept scores [B, K] f32, per-image flags)."""
        concept, flags = self.model(self.pixels(images))
        return concept.cpu().numpy(), [bool(f) for f in flags.cpu()]

    def check(self, images) -> list[bool]:
        """Per-image NSFW booleans."""
        return self.scores(images)[1]


def _pil(image) -> Image.Image:
    return image if isinstance(image, Image.Image) else Image.fromarray(np.asarray(image))


@torch.no_grad()
def init_random_(model: SafetyChecker, generator: torch.Generator) -> None:
    """Seeded init as the reference initialises the checker: the tower as
    any module (weights.random_init_), the concept and special-care
    embeddings N(0, 1) and every threshold 0.5, so random images seldom
    score past one."""
    random_init_(model, generator)
    for p in (model.concept_embeds, model.special_care_embeds):
        p.normal_(0.0, 1.0, generator=generator)
    model.concept_embeds_weights.fill_(0.5)
    model.special_care_embeds_weights.fill_(0.5)


class _DisabledChecker:
    """The checker of a disabled setting, of a missing checkpoint and of
    one that failed to load: its images are not checked."""

    available = False

    def check(self, images):
        return None


def get_checker(model_name: str, model_root_dir: str | None, device):
    """The process's checker for (name, model root, device), built on first
    use. "" disables it; a checker whose files are missing or fail to load
    is kept as disabled."""
    global _CHECKER, _CHECKER_KEY
    if not model_name:
        return _DisabledChecker()
    key = (model_name, model_root_dir, str(device))
    with _LOCK:
        if _CHECKER is not None and _CHECKER_KEY == key:
            return _CHECKER
        try:
            checker = NSFWChecker(model_name, device, model_root_dir)
        except Exception as e:  # noqa: BLE001 — missing files, a broken checkpoint, no device
            logger.warning("safety checker %s unavailable (%s); NSFW flag disabled",
                           model_name, e)
            checker = _DisabledChecker()
        _CHECKER, _CHECKER_KEY = checker, key
        return checker


def flag_images(images, resolve) -> tuple[bool, bool]:
    """-> (any image flagged, checked). `resolve()` gives the checker.
    Never raises: the checker must not fail the job."""
    try:
        flags = resolve().check(images)
    except Exception as e:  # noqa: BLE001 — auxiliary: never fails the job
        logger.warning("safety check failed: %s", e)
        return False, False
    if flags is None:
        return False, False
    return any(flags), True
