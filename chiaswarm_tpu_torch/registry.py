"""Pipeline residency: model name -> resident pipeline on one device.

The counterpart of chiaswarm_tpu/registry.py for the families the port
serves (SD: SD 1.x, SD 2.x, SDXL base and refiner, the edit checkpoints
and the tiny test models; the SD-x2 upscaler; Flux; Kandinsky 2.x and 3;
Stable Cascade). A
`Registry` is an object that the worker owns, not process-global state:
the worker builds it for its device, and a caller may pre-build a
pipeline into it (chip_smoke.py does, for a
model that runs on random weights). Its pipelines load their weights and
read each checkpoint's scheduler config (the prediction type) under
`model_root_dir`.

At most MAX_RESIDENT_PIPELINES stay resident, as in the JAX package: a
build past the limit evicts the least recently used pipeline (a fetch
refreshes its recency). On the card a build first evicts least recently
used pipelines until the new model's footprint and one image fit in the
free device memory (capacity.resident_bytes), so a Flux bundle (31.4
GiB) can join a worker that serves SDXL too. An eviction releases the
pipeline's adapter stacks, textual-inversion tables and custom VAEs and
drops the registry's reference; a job that still runs on the evicted
pipeline keeps it (and what the job itself holds) alive until it ends,
and its device memory returns when the last reference goes.

The registry owns the caches its pipelines share (the adapter caches of
lora_cache.py, the encoded-prompt cache of embed_cache.py) and the roots a
job's adapters and ControlNets resolve under.

`PIPELINE_FAMILIES` is the JAX package's table of wire `pipeline_type`
names for the families the port serves: "sd" and "sdxl" (one resident
`SDPipeline` serves every name of its model), "sd_upscale" (the SD-x2
`LatentUpscalePipeline`), "flux" (`FluxPipeline`), "kandinsky" (the
Kandinsky 2.x decoder, `KandinskyPipeline`), "kandinsky_prior" (its
prior, `KandinskyPriorPipeline`, which a decoder's job builds here as its
prepipeline), "kandinsky3" (`Kandinsky3Pipeline`), "cascade" (Stable
Cascade's decoder, `CascadePipeline`, the combined name too) and
"cascade_prior" (`CascadePriorPipeline`). The generic names
(`DiffusionPipeline`, `AutoPipeline*`) resolve by model name, as the JAX
registry's `_auto_family` (configs.auto_family; `job_family`). A pipeline
is kept under (model name, its family's key kind, "sd" for the SD family),
in the same LRU. A build never evicts the pipelines its caller names in
`keep`: the Kandinsky 2.x decoder whose job builds its prior is one, and
so is a Cascade prior building its decoder, or a decoder its prior.
`check_pipeline_type` refuses the names of other families and names that
no table holds.

The NSFW safety checker is a process singleton outside the LRU
(pipelines/safety.py); `safety_checker()` gives it for the registry's
device, model root and `safety_checker_model`.
"""

from __future__ import annotations

import gc
import logging
import threading
from collections import OrderedDict

import torch

from .capacity import free_bytes, resident_bytes
from .embed_cache import EmbedCache
from .lora_cache import LoraCache
from .models.configs import auto_family
from .pipelines.cascade import CascadePipeline, CascadePriorPipeline
from .pipelines.flux import FluxPipeline
from .pipelines.kandinsky import KandinskyPipeline, KandinskyPriorPipeline
from .pipelines.kandinsky3 import Kandinsky3Pipeline
from .pipelines.safety import DEFAULT_SAFETY_MODEL, get_checker
from .pipelines.stable_diffusion import SDPipeline
from .pipelines.upscale import LatentUpscalePipeline

logger = logging.getLogger(__name__)

MAX_RESIDENT_PIPELINES = 4

# wire name -> family, the SD, SDXL and Flux rows of the JAX package's table
PIPELINE_FAMILIES: dict[str, str] = {
    "DiffusionPipeline": "sd",
    "StableDiffusionPipeline": "sd",
    "StableDiffusionImg2ImgPipeline": "sd",
    "StableDiffusionInpaintPipeline": "sd",
    "StableDiffusionControlNetPipeline": "sd",
    "StableDiffusionControlNetImg2ImgPipeline": "sd",
    "StableDiffusionControlNetInpaintPipeline": "sd",
    "StableDiffusionXLPipeline": "sdxl",
    "StableDiffusionXLImg2ImgPipeline": "sdxl",
    "StableDiffusionXLInpaintPipeline": "sdxl",
    "StableDiffusionXLControlNetPipeline": "sdxl",
    "StableDiffusionXLControlNetImg2ImgPipeline": "sdxl",
    "StableDiffusionXLControlNetInpaintPipeline": "sdxl",
    "StableDiffusionInstructPix2PixPipeline": "sd",
    "StableDiffusionXLInstructPix2PixPipeline": "sdxl",
    "StableDiffusionLatentUpscalePipeline": "sd_upscale",
    "KandinskyPipeline": "kandinsky",
    "KandinskyImg2ImgPipeline": "kandinsky",
    "KandinskyV22Pipeline": "kandinsky",
    "KandinskyV22Img2ImgPipeline": "kandinsky",
    "KandinskyV22ControlnetPipeline": "kandinsky",
    "KandinskyV22ControlnetImg2ImgPipeline": "kandinsky",
    "KandinskyV22PriorPipeline": "kandinsky_prior",
    "KandinskyV22PriorEmb2EmbPipeline": "kandinsky_prior",
    "Kandinsky3Pipeline": "kandinsky3",
    "Kandinsky3Img2ImgPipeline": "kandinsky3",
    "AutoPipelineForText2Image": "sd",
    "StableCascadeDecoderPipeline": "cascade",
    "StableCascadePriorPipeline": "cascade_prior",
    "StableCascadeCombinedPipeline": "cascade",
    "FluxPipeline": "flux",
}

# the families whose pipelines are not SDPipelines, and their registry keys
_OWN_PIPELINES = {"flux": FluxPipeline, "sd_upscale": LatentUpscalePipeline,
                  "kandinsky": KandinskyPipeline, "kandinsky_prior": KandinskyPriorPipeline,
                  "kandinsky3": Kandinsky3Pipeline, "cascade": CascadePipeline,
                  "cascade_prior": CascadePriorPipeline}
_KEY_KINDS = {"flux": "flux", "sd_upscale": "upscaler", "kandinsky": "kandinsky",
              "kandinsky_prior": "kandinsky_prior", "kandinsky3": "kandinsky3",
              "cascade": "cascade", "cascade_prior": "cascade_prior"}


# model-name keywords (substrings of a lowercased model name) of each family
# of the JAX package's table (its family dispatch by model name, and the
# audio, video and captioning models it serves), for the families that
# PIPELINE_FAMILIES does not hold yet.
FAMILY_KEYWORDS: dict[str, tuple[str, ...]] = {
    "sd": (), "sdxl": (), "sd_upscale": (),
    "kandinsky": ("kandinsky",), "kandinsky_prior": ("kandinsky",),
    "kandinsky3": ("kandinsky-3", "kandinsky3"), "cascade": ("cascade",),
    "cascade_prior": ("cascade",),
    "flux": ("flux",), "deepfloyd_if": ("deepfloyd",),
    "audioldm": ("audioldm",), "audioldm2": ("audioldm",), "bark": ("suno/bark",),
    "animatediff": ("animatediff", "text-to-video"), "i2vgenxl": ("i2vgen",),
    "svd": ("stable-video-diffusion",), "blip": ("blip",),
}


def unconverted_family_keywords() -> list[str]:
    """The keywords of every family the port does not serve, sorted, for
    the worker's `unconverted_families` advertisement; a family that lands
    in PIPELINE_FAMILIES drops out."""
    served = set(PIPELINE_FAMILIES.values())
    return sorted({kw for family, kws in FAMILY_KEYWORDS.items() if family not in served
                   for kw in kws})


def check_pipeline_type(pipeline_type: str) -> None:
    """ValueError for a wire pipeline type the port does not serve. The
    generic `AutoPipeline*` names resolve by model name, as in the JAX
    package, where the pipeline is built."""
    if pipeline_type not in PIPELINE_FAMILIES and not pipeline_type.startswith("AutoPipeline"):
        raise ValueError(f"pipeline type {pipeline_type!r} is not ported to "
                         "chiaswarm_tpu_torch yet")


def job_family(model_name: str, pipeline_type: str | None = None) -> str:
    """"flux", "sd_upscale", "kandinsky", "kandinsky_prior", "kandinsky3",
    "cascade", "cascade_prior" or "sd" (SD, SDXL, and the families not
    ported yet, which SDPipeline refuses) for a
    job: by its wire name, or, for the generic names (and none), by the
    model's (configs.auto_family, as the JAX registry's `_auto_family`)."""
    if pipeline_type in PIPELINE_FAMILIES and pipeline_type not in (
            "DiffusionPipeline", "AutoPipelineForText2Image"):
        family = PIPELINE_FAMILIES[pipeline_type]
    else:
        family = auto_family(model_name)
    return family if family in _OWN_PIPELINES else "sd"


class Registry:
    def __init__(self, device, model_root_dir: str | None = None,
                 lora_root_dir: str | None = None, lora_cache: LoraCache | None = None,
                 embed_cache: EmbedCache | None | bool = True,
                 safety_checker_model: str = DEFAULT_SAFETY_MODEL):
        """`embed_cache` True gives a cache of the default 64 MiB; None or
        False turns it off. `safety_checker_model` "" turns the checker
        off."""
        self.device = device
        self.model_root_dir = model_root_dir
        self.lora_root_dir = lora_root_dir
        self.safety_checker_model = safety_checker_model
        self.lora_cache = lora_cache or LoraCache()
        if embed_cache is True:
            embed_cache = EmbedCache(64 << 20)
        self.embed_cache = embed_cache if isinstance(embed_cache, EmbedCache) else None
        self._pipelines: OrderedDict[tuple, object] = OrderedDict()
        self._lock = threading.Lock()

    def get_pipeline(self, model_name: str, allow_random_init: bool = False,
                     pipeline_type: str | None = None, keep=()):
        """The resident pipeline for `model_name` (a FluxPipeline, the
        upscaler, a Kandinsky or Cascade pipeline where `job_family` says
        so, else an SDPipeline), built on first use. The pipelines in `keep`
        are not evicted to make room for it."""
        family = job_family(model_name, pipeline_type)
        key = (model_name, _KEY_KINDS.get(family, "sd"))
        with self._lock:
            pipe = self._pipelines.get(key)
            if pipe is not None:
                self._pipelines.move_to_end(key)
                return pipe
            evicted = self._make_room(model_name, keep)
            if family in _OWN_PIPELINES:
                pipe = _OWN_PIPELINES[family](model_name, device=self.device,
                                              allow_random_init=allow_random_init,
                                              model_root_dir=self.model_root_dir)
            else:
                pipe = SDPipeline(model_name, device=self.device,
                                  allow_random_init=allow_random_init,
                                  model_root_dir=self.model_root_dir,
                                  lora_root_dir=self.lora_root_dir, lora_cache=self.lora_cache,
                                  embed_cache=self.embed_cache)
            self._pipelines[key] = pipe
            while len(self._pipelines) > MAX_RESIDENT_PIPELINES:
                old_key = self._evict((*keep, pipe))
                if old_key is None:
                    break
                evicted.append(old_key)
            if evicted:
                logger.info("evicted resident pipelines %s", evicted)
                if torch.device(self.device).type == "cuda":
                    torch.cuda.empty_cache()
            return pipe

    def _evict(self, keep=()) -> tuple | None:
        """Release the least recently used pipeline that is not in `keep`
        and drop the registry's reference -> its key (None: every resident
        pipeline is kept)."""
        for key, old in self._pipelines.items():
            if not any(old is k for k in keep):
                del self._pipelines[key]
                old.release()
                return key
        return None

    def _make_room(self, model_name: str, keep=()) -> list[tuple]:
        """Evict least recently used pipelines, those in `keep` excepted,
        until `model_name`'s resident footprint and one image
        (capacity.resident_bytes: nothing off the card) fit in the device's
        free memory -> the evicted keys."""
        need = resident_bytes(self.device, model_name)
        evicted = []
        while need and free_bytes(self.device) < need:
            key = self._evict(keep)
            if key is None:
                break
            evicted.append(key)
            gc.collect()
        return evicted

    def resident_models(self) -> list[str]:
        """The resident models' names, read without the lock, which a build
        holds for seconds: the worker's event loop reads them (its polls,
        /healthz, the watchdog's deadline). `tuple()` copies the keys in one
        step under the interpreter lock."""
        return sorted({name for name, _ in tuple(self._pipelines)})

    def safety_checker(self):
        """The process's safety checker for this registry's device, model
        root and checker name (pipelines/safety.py `get_checker`)."""
        return get_checker(self.safety_checker_model, self.model_root_dir, self.device)
