"""Pipeline residency: model name -> resident pipeline on one device.

The counterpart of chiaswarm_tpu/registry.py for the one family the port
serves (SD: SDXL and the tiny test models). A `Registry` is an object
that the worker owns, not process-global state: the worker builds it for
its device, and a caller may pre-build a pipeline into it (chip_smoke.py
does, for a model that runs on random weights).
"""

from __future__ import annotations

import threading

from .pipelines.stable_diffusion import SDPipeline


class Registry:
    def __init__(self, device, model_root_dir: str | None = None):
        self.device = device
        self.model_root_dir = model_root_dir
        self._pipelines: dict[str, SDPipeline] = {}
        self._lock = threading.Lock()

    def get_pipeline(self, model_name: str, allow_random_init: bool = False) -> SDPipeline:
        """The resident pipeline for `model_name`, built on first use."""
        with self._lock:
            pipe = self._pipelines.get(model_name)
            if pipe is None:
                pipe = SDPipeline(model_name, device=self.device,
                                  allow_random_init=allow_random_init,
                                  model_root_dir=self.model_root_dir)
                self._pipelines[model_name] = pipe
            return pipe

    def resident_models(self) -> list[str]:
        with self._lock:
            return sorted(self._pipelines)
