"""Kandinsky's depth hint, the counterpart of
chiaswarm_tpu/pre_processors/depth_estimator.py: the DPT depth as an HWC
f32 array of three equal channels in [0, 1], which the `depth estimator`
preprocessor renders as an image."""

from __future__ import annotations

import numpy as np
from PIL import Image

from ..pipelines.aux_models import Detectors


def make_hint(image: Image.Image, detectors: Detectors) -> np.ndarray:
    depth = detectors.depth()(image)
    return np.stack([depth] * 3, axis=-1).astype(np.float32)
