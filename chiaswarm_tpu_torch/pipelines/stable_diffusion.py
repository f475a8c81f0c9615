"""Resident Stable-Diffusion pipeline (SD 1.x, SD 2.x, SDXL base and
refiner, the instruct-pix2pix edit checkpoints and the tiny test models):
txt2img, img2img, pix2pix, 4-channel inpaint and dedicated (9-channel)
inpaint, and the SDXL refiner and the SD-x2 upscaler (pipelines/upscale.py)
chained after any of them; the counterpart of
chiaswarm_tpu/pipelines/stable_diffusion.py.

Weights load once (from the model directory's safetensors, see
weights.py) and stay on the device. A job runs the CLIP encoders over
[negatives | prompts] in one batch; encodes the start image (masked first
for a 9-channel inpaint checkpoint) with the VAE encoder; runs the
classifier-free-guidance denoise loop (the UNet sees [uncond | cond] rows
stacked, as the JAX program does; pix2pix [uncond | image | image+text])
with any ported solver; then the VAE decode with the uint8 quantisation
on the device. PyTorch runs eagerly, so the loop is a Python loop over
steps.

Modes, as in the JAX pipeline: `inpaint9` for a 9-channel UNet given a
mask (the mask and the masked image's latents ride on the UNet's channel
axis), else `inpaint` for a mask (latent masking: the kept region follows
the original's noise trajectory), else `pix2pix` for an image on an
8-channel edit UNet (the image's unscaled latents ride on the channel
axis, dual guidance), else `img2img` for an image, else `txt2img`.
img2img and inpaint start from the image's latents noised to
`t_start = int(steps * (1 - strength))`; pix2pix, like txt2img, from pure
noise over every step.

Noise: the initial latents, each step's ancestral noise and inpaint's
keep noise come from one `torch.Generator` per job on the device, seeded
with the job's seed (a chained refiner continues the job's generator, as
the JAX pipeline refines with the job's own key). A caller may inject
them instead (`latents`, NCHW, and `noise_fn(kind, i, shape)` for kind
"step" and "keep"; `refiner_latents` and `refiner_noise_fn` for the
refiner's stage), which is how the tests hand the port the noise that
the JAX pipeline drew.

Per-job adapters, as in the JAX pipeline: a `lora` (resolved by
job_arguments) applies as a runtime low-rank delta on the one resident
base model (lora_runtime.py) over the UNet's and the text encoders'
matched Linear modules, every CFG row and every text row, at `lora_scale`
(else `cross_attention_kwargs.scale`); a `textual_inversion` adds its
vectors to the encoders whose widths they match (placeholder ids past the
vocabulary); a `vae` names a model directory whose VAE encodes and decodes
the job. A chained refiner gets none of them. An adapter that cannot be
loaded or matches nothing raises ValueError, a fatal job error.

A ControlNet (`controlnet_model_name`, a resident branch of this UNet's
config, `controlnet`) adds its residuals to the UNet's skips and mid block
on the steps of its guidance window, on txt2img, img2img and inpaint, and
on every row of a coalesced pass; `controlnet_prepipeline_type` runs the
QR two-stage chain, as in the JAX pipeline.

Chunked denoise, as the JAX pipeline's chunked runner
(`denoise_chunk_steps` N > 0): every N steps of a pass, counted from its
first step, is a chunk boundary. Where the worker hands the pass its job
id(s), the host synchronises the device there and probes the cancel
registry (cancel.py), also before the first step and after the last; a
cancelled solo raises `JobCancelled`, a cancelled member of a coalesced
pass comes back flagged. A solo pass's boundaries also checkpoint
(`checkpoint_every_chunks`, `checkpoint_cb`: latents, scheduler leaves,
the program signature and the generator's state, on the host) and
preview (`preview_every_chunks`, `preview_cb`: the live latents decoded),
and a pass given a `resume` (checkpoint.unpack's dict) under its own
signature restarts at the checkpoint's step. Chunking without callbacks,
and a resumed pass, give the undisturbed pass's image bit for bit.

The cost plane, stamped where the JAX pipeline stamps it: every envelope
carries `unet_tflops` (the analytic UNet FLOPs of the pass's denoise,
models/flops.py, for the job's own images), `cost` (costs.job_cost: the
job's integer FLOPs, a resumed job billed the recomputed fraction, beside
the pass's achieved TFLOP/s and MFU over `denoise_s + decode_s`) and
`geometry` ({"data": 1, "tensor": 1, "seq": 1}, one device). Each pass key
is a row of the pass ledger (programs.py), whose first UNet call is
counted against the analytic figure.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from collections import OrderedDict
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from .. import cancel as cancel_registry
from .. import checkpoint, costs, programs
from ..cancel import JobCancelled
from ..device import device_label, resolve_device, serving_dtype, synchronize
from ..embed_cache import EmbedCache
from ..lora_cache import LoraCache, adapter_key
from ..models import configs as cfgs
from ..models.clip import CLIPTextEncoder
from ..models.controlnet import ControlNetModel
from ..models.flops import denoise_flops, unet_call_flops
from ..models.lora import linear_index, match_factors
from ..models.tokenizer import PlaceholderTokenizer, load_tokenizer
from ..models.unet2d import UNet2DConditionModel
from ..models.vae import AutoencoderKL
from ..schedulers import SchedulerConfig, get_scheduler
from ..weights import (
    TEXT_ENCODER_FOLDERS,
    MissingWeightsError,
    checkpoint_folders,
    find_checkpoint,
    load_checkpoint_,
    model_seed,
    random_init_,
    require_weights_present,
)
from . import lora_runtime
from .common import pad_bucket, split_by_counts
from .upscale import upscaler_name_for

# the wire name the upscale stage resolves its pipeline by
UPSCALE_PIPELINE = "StableDiffusionLatentUpscalePipeline"

logger = logging.getLogger(__name__)

# per-job add-ons a pipeline keeps resident, least recently used first out
MAX_RESIDENT_TI = 4
MAX_RESIDENT_VAES = 2


def config_prediction_type(model_name: str, model_root_dir: str | None) -> str | None:
    """`prediction_type` from the checkpoint's scheduler config
    (<model_root_dir>/<model_name>/scheduler/scheduler_config.json), as
    the JAX package's `_config_prediction_type` reads it: authoritative
    over any name heuristic (a v-prediction fine-tune named without '768'
    would otherwise get epsilon). None when the file is absent or
    unreadable."""
    if not model_root_dir:
        return None
    path = (Path(model_root_dir).expanduser() / model_name / "scheduler"
            / "scheduler_config.json")
    if not path.is_file():
        return None
    try:
        pred = json.loads(path.read_text()).get("prediction_type")
    except (OSError, ValueError):
        return None
    return str(pred) if pred else None


def family_configs(model_name: str, model_root_dir: str | None = None):
    """(unet_cfg, [clip_cfgs], vae_cfg, default_size, prediction_type), name
    for name as the JAX package's `_family_configs`: SD 1.x (the default
    family) at 512 and epsilon; SD 2.x at 768, v-prediction when the name
    holds `768` or ends in `2-1`; SDXL at 1024. The checkpoint's scheduler
    config under `model_root_dir`, where there is one, overrides the
    prediction type for every family.

    The SDXL refiner (`xl` and `refiner` in the name) has its own UNet
    and OpenCLIP-bigG alone. A name containing `pix2pix` or `ip2p` is an
    edit checkpoint: its UNet takes 8 channels (latents, start-image
    latents). Else a name containing `inpaint` is a dedicated inpaint
    checkpoint: its UNet takes 9 channels (latents, mask, masked-image
    latents)."""
    name = model_name.lower()
    family = cfgs.auto_family(model_name)
    if family == "flux":
        raise ValueError(f"{model_name}: a Flux model, which FluxPipeline (pipelines/flux.py) "
                         "serves, not SDPipeline")
    if family in ("kandinsky", "kandinsky_prior"):
        raise ValueError(f"{model_name}: a Kandinsky 2.x model, which KandinskyPipeline / "
                         "KandinskyPriorPipeline (pipelines/kandinsky.py) serve, not SDPipeline")
    if family not in ("sd", "sdxl"):
        raise ValueError(f"{model_name}: this family is not ported to "
                         "chiaswarm_tpu_torch yet")
    if "tiny" in name:
        if "xl" in name:
            out = (cfgs.TINY_XL_UNET, [cfgs.TINY_CLIP, cfgs.TINY_CLIP_2],
                   cfgs.TINY_VAE, 64, "epsilon")
        else:
            out = cfgs.TINY_UNET, [cfgs.TINY_CLIP], cfgs.TINY_VAE, 64, "epsilon"
    elif (family := cfgs.model_family(model_name)) == "sdxl":
        out = (cfgs.SDXL_UNET, [cfgs.SDXL_CLIP_1, cfgs.SDXL_CLIP_2],
               cfgs.SDXL_VAE, 1024, "epsilon")
    elif family == "sdxl_refiner":
        out = cfgs.SDXL_REFINER_UNET, [cfgs.SDXL_CLIP_2], cfgs.SDXL_VAE, 1024, "epsilon"
    elif family == "sd21":
        pred = "v_prediction" if "768" in name or name.endswith("2-1") else "epsilon"
        out = cfgs.SD21_UNET, [cfgs.SD21_CLIP], cfgs.SD_VAE, 768, pred
    else:
        out = cfgs.SD15_UNET, [cfgs.SD15_CLIP], cfgs.SD_VAE, 512, "epsilon"
    unet_cfg, clip_cfgs, vae_cfg, size, pred = out
    pred = config_prediction_type(model_name, model_root_dir) or pred
    if "pix2pix" in name or "ip2p" in name:
        unet_cfg = dataclasses.replace(unet_cfg, in_channels=2 * vae_cfg.latent_channels)
    elif "inpaint" in name:
        unet_cfg = dataclasses.replace(unet_cfg,
                                       in_channels=2 * vae_cfg.latent_channels + 1)
    return unet_cfg, clip_cfgs, vae_cfg, size, pred


def load_learned_embeddings(ref, model_root_dir: str | None,
                            lora_root_dir: str | None) -> list[dict]:
    """A textual-inversion file -> [{"tokens": [alias, ...], "vectors":
    [[k, D] float32, ...]}] groups (the aliases of a group share one run of
    ids; a group's several vectors are one per encoder width).

    `ref` is a file or directory, tried as a path, under `model_root_dir`
    and under `lora_root_dir`. Formats: diffusers (one key per placeholder
    token), kohya `emb_params`, and SDXL's dual-encoder `clip_l` / `clip_g`;
    the two named by their file register both its stem and `<stem>`."""
    from safetensors import safe_open

    candidates: list[Path] = []
    for base in (Path(str(ref)).expanduser(),
                 *(Path(root).expanduser() / str(ref)
                   for root in (model_root_dir, lora_root_dir) if root)):
        if base.is_file():
            candidates.append(base)
        elif base.is_dir():
            candidates.extend(sorted(base.glob("*.safetensors")))
    for f in candidates:
        try:
            with safe_open(str(f), framework="np") as sf:
                state = {k: sf.get_tensor(k) for k in sf.keys()}
        except Exception:  # noqa: BLE001 — an unreadable candidate: try the next
            continue
        if not state:
            continue
        stem = [f.stem, f"<{f.stem}>"]
        if set(state) == {"emb_params"}:
            return [{"tokens": stem, "vectors": [_as2d(state["emb_params"])]}]
        if set(state) <= {"clip_l", "clip_g"}:
            return [{"tokens": stem, "vectors": [_as2d(v) for v in state.values()]}]
        return [{"tokens": [token], "vectors": [_as2d(v)]} for token, v in state.items()]
    raise ValueError(
        f"Could not load textual inversion {ref}: no embedding safetensors found (looked at "
        f"{[str(c) for c in candidates] or 'no candidates'})")


def _as2d(v) -> np.ndarray:
    return np.atleast_2d(np.asarray(v, np.float32))


def _pil_to_array(image: Image.Image, width: int, height: int) -> np.ndarray:
    """PIL -> float32 [H, W, 3] in [-1, 1], resized to the job canvas."""
    image = image.convert("RGB")
    if image.size != (width, height):
        image = image.resize((width, height), Image.LANCZOS)
    return np.asarray(image, np.float32) / 127.5 - 1.0


def control_window(start, end, steps: int) -> tuple[int, int]:
    """A ControlNet's guidance window [lo, hi) in the solver's loop index,
    as the JAX pipeline reckons it: lo = int(start x steps), hi =
    ceil(end x steps), one step at least. The bounds are in user steps
    while the loop runs over the solver's own index (from t_start for
    img2img, doubled for Heun), as in JAX."""
    lo = int(float(start) * steps)
    return lo, max(int(np.ceil(float(end) * steps)), lo + 1)


def _control_residuals(branch, scale: float, window, i: int, model_in, t_vec, context,
                       control, added) -> dict:
    """The UNet's ControlNet keywords at loop index i: the branch's
    residuals inside the window, none outside it or at scale 0. The JAX
    program runs the branch there too, at scale 0; a residual scaled by 0
    adds exact zeros, so skipping it changes no bit of the image."""
    if branch is None or scale == 0.0 or not window[0] <= i < window[1]:
        return {}
    down, mid = branch(model_in, t_vec, context, control, scale, added)
    return {"down_residuals": down, "mid_residual": mid}


def _mask_to_latent_array(mask: Image.Image, width: int, height: int,
                          factor: int) -> np.ndarray:
    """Mask PIL -> float32 [H/f, W/f, 1]; 1 = repaint, 0 = keep."""
    mask = mask.convert("L").resize((width // factor, height // factor), Image.NEAREST)
    return (np.asarray(mask, np.float32)[..., None] / 255.0 > 0.5).astype(np.float32)


def is_out_of_memory(e: BaseException) -> bool:
    """torch's out-of-memory error, or an error whose text says memory ran
    out (the JAX pipeline matches "emory")."""
    return isinstance(e, torch.OutOfMemoryError) or "emory" in str(e)


def fold_seed(seed: int | None, index: int) -> int:
    """A seed of its own for row `index` of a job seeded with `seed`."""
    return (int(seed or 0) * 0x9E3779B1 + 0x632BE5AB * (index + 1)) % (1 << 63)


def _row_noise(noise_fn, index: int, rows: int):
    """Injected noise for one row of `rows`: `noise_fn`'s draw for the
    whole batch, row `index` of it."""
    if noise_fn is None:
        return None

    def one(kind, i, shape):
        return noise_fn(kind, i, (rows, *shape[1:]))[index:index + 1]

    return one


def _solo_probe(job_id):
    """The cancel probe of a solo pass: raises JobCancelled once the hive
    has cancelled `job_id`; None without a job id (direct calls)."""
    if not job_id:
        return None

    def probe():
        if cancel_registry.cancelled(job_id):
            raise JobCancelled([job_id])

    return probe


# the mesh view of every pass: one device, nothing sharded
GEOMETRY = {"data": 1, "tensor": 1, "seq": 1}
GEOMETRY_LABEL = "replicated"


def _unet_call(ledger, unet, *args, **kwargs):
    """One UNet call; the first of a pass key is counted for the ledger."""
    if ledger.counting:
        return ledger.count_call(unet, *args, **kwargs)
    return unet(*args, **kwargs)


def _at_boundary(i: int, first: int, chunk: int) -> bool:
    """Step `i` of a pass that started at `first` opens a new chunk: every
    `chunk` steps from the start, never at the start itself."""
    return chunk > 0 and i != first and (i - first) % chunk == 0


class _Timer:
    """Wall time of a stage that ends with the device idle."""

    def __init__(self, device, timings: dict, key: str):
        self.device, self.timings, self.key = device, timings, key

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        synchronize(self.device)
        self.timings[self.key] = time.perf_counter() - self.t0


class SDPipeline:
    """One SD-family model resident on one device; serves txt2img, img2img,
    pix2pix (an 8-channel UNet) and inpaint (4- or 9-channel, by the UNet's
    input channels)."""

    # the chunk boundary is the cancel, checkpoint and preview seam; the
    # workflows forward those arguments only to pipelines that have it
    supports_checkpoint = True

    def __init__(self, model_name: str, device=None, dtype=None,
                 allow_random_init: bool = False, weights: dict | None = None,
                 model_root_dir: str | None = None, lora_root_dir: str | None = None,
                 lora_cache: LoraCache | None = None, embed_cache: EmbedCache | None = None):
        """`weights`: {"unet": sd, "text": [sd, ...], "vae": sd} state dicts
        in the port's key layout (weights.from_jax_params gives them);
        without it the model loads from `<model_root_dir>/<model_name>/`, or
        is random-initialised from a seed, as the policy in weights.py
        says. Adapters resolve under `model_root_dir` and `lora_root_dir`
        through `lora_cache` (the registry's; a pipeline of its own
        otherwise). Encoded prompt rows are kept in `embed_cache` (the
        registry's; none otherwise)."""
        self.model_name = model_name
        self.allow_random_init = allow_random_init
        self.embed_cache = embed_cache
        # the last encode's (hits, misses) of the cache, None when it was
        # bypassed
        self.last_encode_stats = None
        self.model_root_dir = model_root_dir
        self.lora_root_dir = lora_root_dir
        self.lora_cache = lora_cache or LoraCache()
        self._ti_cache: OrderedDict[str, tuple] = OrderedDict()
        self._vae_cache: OrderedDict[str, AutoencoderKL] = OrderedDict()
        # resident ControlNet branches by name, as in the JAX pipeline
        self._controlnets: dict[str, ControlNetModel] = {}
        self.device = resolve_device(device)
        self.dtype = dtype or serving_dtype(self.device)
        unet_cfg, clip_cfgs, vae_cfg, self.default_size, self.prediction_type = (
            family_configs(model_name, model_root_dir))
        self.is_xl = unet_cfg.addition_embed_dim > 0
        self.latent_factor = 2 ** (len(vae_cfg.block_out_channels) - 1)
        self.latent_channels = vae_cfg.latent_channels
        # dedicated inpaint and edit checkpoints, told by their architecture
        # as in JAX
        self.is_inpaint_unet = unet_cfg.in_channels == 2 * vae_cfg.latent_channels + 1
        self.is_pix2pix = unet_cfg.in_channels == 2 * vae_cfg.latent_channels
        # SDXL's micro-conditioning ids: what the addition embedding holds
        # beyond the last encoder's pooled output (6 for the base, 5 for the
        # refiner)
        pooled_dim = clip_cfgs[-1].projection_dim or clip_cfgs[-1].hidden_size
        self.n_time_ids = ((unet_cfg.addition_embed_dim - pooled_dim)
                           // unet_cfg.addition_time_embed_dim if self.is_xl else 0)

        model_dir = None
        if model_root_dir:
            candidate = Path(model_root_dir).expanduser() / model_name
            model_dir = candidate if candidate.is_dir() else None
        # the policy first: a production model without weights costs no
        # device memory
        files = None if weights is not None else find_checkpoint(
            model_name, model_dir, checkpoint_folders(len(clip_cfgs)), allow_random_init)
        # what was read from the model directory: {"dir", "bytes", "load_s"}
        self.checkpoint = None

        t0 = time.perf_counter()
        with torch.device("meta"):
            unet = UNet2DConditionModel(unet_cfg)
            encoders = [CLIPTextEncoder(c) for c in clip_cfgs]
            vae = AutoencoderKL(vae_cfg)
        self.unet, self.vae = self._materialise(unet), self._materialise(vae)
        self.text_encoders = [self._materialise(e) for e in encoders]

        if weights is not None:
            self.unet.load_state_dict(weights["unet"])
            for enc, sd in zip(self.text_encoders, weights["text"], strict=True):
                enc.load_state_dict(sd)
            self.vae.load_state_dict(weights["vae"])
            self.weights_source = "given"
        elif files is not None:
            t_load = time.perf_counter()
            nbytes = load_checkpoint_(self.unet, files["unet"], "unet")
            nbytes += load_checkpoint_(self.vae, files["vae"], "vae")
            for folder, enc, c in zip(TEXT_ENCODER_FOLDERS, self.text_encoders, clip_cfgs):
                nbytes += load_checkpoint_(enc, files[folder], folder, text_layers=c.num_layers)
            synchronize(self.device)
            self.checkpoint = {"dir": str(model_dir), "bytes": nbytes,
                               "load_s": time.perf_counter() - t_load}
            self.weights_source = "checkpoint"
        else:
            gen = torch.Generator(device=self.device).manual_seed(model_seed(model_name))
            for module in (self.unet, *self.text_encoders, self.vae):
                random_init_(module, gen)
            self.weights_source = "random"
        for module in (self.unet, self.vae):
            module.to(memory_format=torch.channels_last)
        self.tokenizers = [load_tokenizer(model_dir, vocab_size=c.vocab_size)
                           for c in clip_cfgs]
        # the Linear modules an adapter's factors are matched on, by key
        self.unet_index = linear_index(self.unet)
        self.text_indexes = [linear_index(e, f"te{i}:") for i, e in enumerate(self.text_encoders)]
        synchronize(self.device)
        logger.info("%s resident on %s in %.1fs (dtype=%s, weights=%s%s)", model_name,
                    device_label(self.device), time.perf_counter() - t0, self.dtype,
                    self.weights_source,
                    f" from {model_dir}, {self.checkpoint['bytes']} bytes"
                    if self.checkpoint else "")

    def _materialise(self, module):
        module = module.to_empty(device=self.device).to(self.dtype)
        module.eval().requires_grad_(False)
        return module

    def release(self) -> int:
        """Drop the per-job state this pipeline keeps resident (its adapter
        stacks and prompt rows in the shared caches, textual-inversion
        tables, custom VAEs, ControlNet branches), as the registry evicts
        it. -> the adapter stacks' bytes freed."""
        self._ti_cache.clear()
        self._vae_cache.clear()
        self._controlnets.clear()
        if self.embed_cache is not None:
            self.embed_cache.drop_model(self.model_name)
        return self.lora_cache.drop_model(self.model_name)

    # --- per-job adapters ---

    def adapter_stacks(self, lora: dict) -> tuple[dict, dict]:
        """A resolved `lora` reference -> (its device stacks over the
        modules it matched, {"matched", "unmatched", "bytes", "factor_hit",
        "operand_hit"}). The factors come through the cache; the stacks are
        built once per (model, adapter). An adapter that matches no module
        raises ValueError."""
        factors, factor_hit = self.lora_cache.resolve(lora, self.model_name,
                                                      self.model_root_dir)
        entry = self.lora_cache.stacks(self.model_name, lora)
        operand_hit = entry is not None
        if entry is None:
            index = dict(self.unet_index)
            for te in self.text_indexes:
                index.update(te)
            matched, unmatched = match_factors(factors, index)
            if not matched:
                raise ValueError(f"Could not load lora {lora}: no modules matched "
                                 f"{self.model_name}'s parameter tree")
            if unmatched:
                # conv / LoCon factors, or a base of other shapes: skipped,
                # as by the JAX package's delta path
                logger.info("adapter %s: %d module(s) match no Linear of %s and are skipped",
                            lora.get("lora"), unmatched, self.model_name)
            stacks, nbytes = lora_runtime.build_stacks(matched, self.dtype, self.device)
            entry = (stacks, {"matched": len(matched), "unmatched": unmatched, "bytes": nbytes})
            self.lora_cache.keep_stacks(self.model_name, lora, entry, nbytes)
        stacks, stats = entry
        return stacks, {**stats, "factor_hit": factor_hit, "operand_hit": operand_hit}

    def ti_apply(self, ti_ref) -> tuple[list, list]:
        """A textual inversion -> (per encoder: its extra embedding table on
        the device or None, its tokenizer with the placeholders). Vectors go
        to the encoder whose hidden width they match; one that matches no
        encoder raises ValueError. The resident weights are untouched."""
        key = str(ti_ref)
        if key in self._ti_cache:
            self._ti_cache.move_to_end(key)
            return self._ti_cache[key]
        groups = load_learned_embeddings(ti_ref, self.model_root_dir, self.lora_root_dir)
        extras, tokenizers = [], []
        for enc, tok in zip(self.text_encoders, self.tokenizers):
            dim, next_id = enc.config.hidden_size, enc.config.vocab_size
            placeholders, rows = {}, []
            for group in groups:
                vec = next((v for v in group["vectors"] if v.shape[-1] == dim), None)
                if vec is None:
                    continue
                ids = list(range(next_id, next_id + vec.shape[0]))
                for alias in group["tokens"]:
                    placeholders[alias] = ids
                rows.append(vec)
                next_id += vec.shape[0]
            if not rows:
                extras.append(None)
                tokenizers.append(tok)
                continue
            extras.append(torch.from_numpy(np.concatenate(rows)).to(self.device, self.dtype))
            tokenizers.append(PlaceholderTokenizer(tok, placeholders))
        if all(extra is None for extra in extras):
            dims = sorted({v.shape[-1] for g in groups for v in g["vectors"]})
            raise ValueError(f"Textual inversion {ti_ref} is incompatible with "
                             f"{self.model_name}: embedding widths {dims} match no text encoder")
        self._ti_cache[key] = (extras, tokenizers)
        while len(self._ti_cache) > MAX_RESIDENT_TI:
            self._ti_cache.popitem(last=False)
        return extras, tokenizers

    def custom_vae(self, name: str) -> AutoencoderKL:
        """The VAE of `<model_root_dir>/<name>` (its safetensors at the top
        or under vae/), in this pipeline's VAE config, dtype and device.
        Missing files raise ValueError."""
        if name in self._vae_cache:
            self._vae_cache.move_to_end(name)
            return self._vae_cache[name]
        root = Path(self.model_root_dir or "").expanduser() / name
        files = self.model_root_dir and next(
            (found for sub in ("", "vae") if (found := sorted((root / sub).glob("*.safetensors")))),
            None)
        if not files:
            raise ValueError(f"Could not load custom VAE {name}: no safetensors under {root}")
        with torch.device("meta"):
            vae = AutoencoderKL(self.vae.config)
        vae = self._materialise(vae)
        load_checkpoint_(vae, files, "vae")
        vae.to(memory_format=torch.channels_last)
        self._vae_cache[name] = vae
        while len(self._vae_cache) > MAX_RESIDENT_VAES:
            self._vae_cache.popitem(last=False)
        return vae

    def controlnet(self, name: str) -> ControlNetModel:
        """The resident ControlNet branch `name`, built on first use from
        this UNet's config: its weights from `<model_root_dir>/<name>/*.safetensors`
        (the folder itself, diffusers layout, as the JAX pipeline reads
        it). Without files a production name raises MissingWeightsError (a
        branch of zeros would ignore the control image without a word); a
        test name, or a pipeline built with `allow_random_init`, gets
        seeded weights whose residual convs are zero, so the branch is an
        exact no-op, as JAX's random init of it is."""
        branch = self._controlnets.get(name)
        if branch is not None:
            return branch
        root = Path(self.model_root_dir).expanduser() / name if self.model_root_dir else None
        files = sorted(root.glob("*.safetensors")) if root is not None and root.is_dir() else []
        with torch.device("meta"):
            branch = ControlNetModel(self.unet.config, cond_downscale=self.latent_factor)
        branch = self._materialise(branch)
        if files:
            load_checkpoint_(branch, files, "controlnet")
        else:
            require_weights_present(
                name, root, self.allow_random_init, component="ControlNet",
                hint="Put its diffusers-layout safetensors under <model_root_dir>/<name>/, "
                     "or serve a test/tiny ControlNet name.")
            logger.warning("no safetensors under %s; zero-init ControlNet %s", root, name)
            random_init_(branch, torch.Generator(device=self.device).manual_seed(
                model_seed(name)))
            branch.zero_residual_convs_()
        branch.to(memory_format=torch.channels_last)
        self._controlnets[name] = branch
        return branch

    # --- stages ---

    def _xl_time_ids(self, height: int, width: int, aesthetic_score: float = 6.0) -> list:
        """SDXL micro-conditioning ids for this canvas: original size, crop
        top-left, then the target size (the base's six ids) or the
        aesthetic score (the refiner's five)."""
        if self.n_time_ids == 5:
            return [height, width, 0, 0, float(aesthetic_score)]
        return [height, width, 0, 0, height, width][:self.n_time_ids]

    def encode_prompts(self, prompts: list[str], tokenizers=None, extras=None,
                       stacks=None, gain: float = 1.0, slot_stacks=None, slot_gains=None):
        """-> (context [B, 77, D], pooled [B, P] or None), all encoders in
        one batch; SDXL concatenates both encoders' hidden states. A job's
        textual inversion gives `tokenizers` and `extras` (per encoder), its
        adapter the `stacks` whose "te{i}:" modules carry the delta at
        `gain` on every row; a coalesced pass gives per-row adapters as
        `slot_stacks` and `slot_gains` (lora_runtime.applied_rows).

        Rows come from the embedding cache, as in the JAX package, unless
        something of the job changes the encoders: a textual inversion, or
        an adapter with text-encoder modules. Only the texts the cache
        misses run the encoders, padded to a power of two (two at least) by
        repeating the last miss, so the encode batch takes few shapes."""
        self.last_encode_stats = None
        te_delta = any(":" in key for group in ([stacks or {}] + list(slot_stacks or []))
                       for key in group)
        cache = self.embed_cache
        if cache is None or tokenizers is not None or extras is not None or te_delta:
            return self._encode(prompts, tokenizers, extras, stacks, gain, slot_stacks,
                                slot_gains)
        found: dict[str, tuple | None] = {}
        hits = misses = 0
        for text in prompts:
            if text in found:
                # a repeat within the batch skips its encoder forward too
                hits += 1
                continue
            found[text] = cache.lookup((self.model_name, text))
            hits += found[text] is not None
            misses += found[text] is None
        cache.note_rows(hits, misses)
        self.last_encode_stats = (hits, misses)
        missing = [t for t, v in found.items() if v is None]
        if missing:
            # never a batch of one: its pooled projection would be a
            # matrix-vector product, which rounds otherwise than the matrix
            # product of every other batch (a job's own encode has two rows
            # at least), and a cached row must be the row a job would get
            padded = missing + [missing[-1]] * (max(pad_bucket(len(missing)), 2) - len(missing))
            context, pooled = self._encode(padded)
            for i, text in enumerate(missing):
                # a copy of its own: a view would keep the encode batch alive
                found[text] = (context[i].clone(),
                               pooled[i].clone() if pooled is not None else None)
                cache.put((self.model_name, text), found[text])
        context = torch.stack([found[t][0] for t in prompts])
        pooled = torch.stack([found[t][1] for t in prompts]) if self.is_xl else None
        return context, pooled

    def _encode(self, prompts: list[str], tokenizers=None, extras=None, stacks=None,
                gain: float = 1.0, slot_stacks=None, slot_gains=None):
        hiddens, pooled = [], None
        for i, enc in enumerate(self.text_encoders):
            tok = (tokenizers or self.tokenizers)[i]
            ids = torch.from_numpy(tok(prompts).astype(np.int64)).to(self.device)
            hooks = (lora_runtime.applied_rows(self.text_indexes[i], slot_stacks, slot_gains)
                     if slot_stacks else
                     lora_runtime.applied(self.text_indexes[i], stacks, gain, len(prompts)))
            with hooks:
                out = enc(ids, extras[i] if extras else None)
            hiddens.append(out["hidden_states"])
            pooled = out["pooled"]
        context = torch.cat(hiddens, dim=-1) if len(hiddens) > 1 else hiddens[0]
        return context, (pooled if self.is_xl else None)

    def encode_image(self, pixels: np.ndarray, vae=None):
        """float32 [B, H, W, 3] in [-1, 1] -> scaled latents [B, C, h, w]
        f32 (the latent distribution's mean), by `vae` (the resident one
        unset)."""
        x = torch.from_numpy(np.ascontiguousarray(pixels.transpose(0, 3, 1, 2)))
        x = x.to(self.device, self.dtype).contiguous(memory_format=torch.channels_last)
        return (vae or self.vae).encode(x).float()

    def decode(self, latents, vae=None):
        """scaled latents [B, C, h, w] -> uint8 [B, H, W, 3] on the host,
        quantised on the device as the JAX program does."""
        latents = latents.to(self.dtype).contiguous(memory_format=torch.channels_last)
        pixels = (vae or self.vae).decode(latents).float()
        pixels = ((pixels + 1.0) * 127.5).clamp(0.0, 255.0).round().to(torch.uint8)
        return pixels.permute(0, 2, 3, 1).cpu().numpy()

    def _control_rows(self, control_image: Image.Image, width: int, height: int,
                      rows: int) -> torch.Tensor:
        """The control image at the canvas, in [0, 1] (a ControlNet's
        conditioning range), as [rows, 3, H, W] on the device: every CFG
        row of every image sees the same one."""
        cond = (_pil_to_array(control_image, width, height) + 1.0) / 2.0
        cond = torch.from_numpy(np.ascontiguousarray(cond.transpose(2, 0, 1)[None]))
        return cond.to(self.device, self.dtype).expand(rows, -1, -1, -1).contiguous(
            memory_format=torch.channels_last)

    def _latents(self, value, shape) -> torch.Tensor:
        """An injected latent-shaped array (numpy or tensor, NCHW) as f32 on
        the device."""
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value, dtype=np.float32))
        value = value.to(self.device, torch.float32)
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"latents {tuple(value.shape)} != {tuple(shape)}")
        return value

    # --- public job API ---

    @torch.inference_mode()
    def run(self, prompt: str = "", negative_prompt: str = "",
            pipeline_type: str = "DiffusionPipeline", *,
            num_inference_steps: int = 30, guidance_scale: float = 7.5,
            height: int | None = None, width: int | None = None,
            num_images_per_prompt: int = 1,
            scheduler_type: str = "DPMSolverMultistepScheduler",
            seed: int | None = None, image=None,
            mask_image: Image.Image | None = None, strength: float | None = None,
            image_guidance_scale: float | None = None, aesthetic_score: float = 6.0,
            refiner: dict | None = None, registry=None, generator=None,
            latents=None, noise_fn=None, refiner_latents=None, refiner_noise_fn=None,
            prepipeline_latents=None, prepipeline_noise_fn=None, upscale: bool = False,
            upscale_latents=None, job_id: str | None = None, denoise_chunk_steps: int = 0,
            checkpoint_every_chunks: int = 0, checkpoint_cb=None,
            preview_every_chunks: int = 0, preview_cb=None, resume: dict | None = None,
            **kwargs):
        """One job -> (list of uint8 [H, W, 3] arrays, pipeline_config).

        `image` (one PIL image, or a list of them, one per output image)
        starts img2img (`strength` 0.75 unset), or pix2pix on an edit
        checkpoint (guided by `image_guidance_scale`, 1.5 unset); with
        `mask_image` inpaint (white repaints). `aesthetic_score` is the
        refiner's fifth time id.
        `controlnet_model_name` adds that ControlNet branch (`controlnet`)
        to every UNet call of the guidance window: `control_image`, or
        `image` when no control image is given (the txt2img ControlNet
        convention: the job is then txt2img), conditions it at
        `controlnet_conditioning_scale` (1.0) from step
        int(`control_guidance_start` x steps) (0.0) up to
        ceil(`control_guidance_end` x steps) (1.0, one step at least),
        counted in the solver's loop index. Outside the window the branch
        is not run: the JAX program runs it at scale 0 there, and a
        residual scaled by 0 adds exact zeros, so the image is the same bit
        for bit; likewise at scale 0. With `controlnet_prepipeline_type`
        the job is the QR two-stage chain (`_run_qr_two_stage`), whose
        first stage takes `prepipeline_latents` and `prepipeline_noise_fn`.
        `lora` {lora, weight_name, subfolder} (at `lora_scale`, else
        `cross_attention_kwargs["scale"]`, else 1.0), `textual_inversion`
        and `vae` are the job's adapters.
        `refiner` {"model_name", "strength" (0.3)} re-enters the output into
        that model's pipeline, which `registry` resolves, as img2img with the
        job's prompts, steps, guidance and scheduler; where that batched call
        runs out of memory, each image is refined alone on a generator of its
        own (`fold_seed`), as the JAX pipeline falls back. `upscale` then chains
        the SD-x2 upscaler (`upscaler_name_for` the model, resolved in
        `registry` before the denoise, so that missing weights cost no
        denoise): 20 unguided steps on the job's prompt and generator (or
        `upscale_latents`, its initial draw), twice the canvas out. Where
        the upscaler's weights are missing, the job is served all the same
        by the latent-resize fallback (`_latent2x`), and says so, as the JAX
        pipeline does.
        `generator` replaces the job's seeded generator; `latents` [N, C,
        H/8, W/8] the initial draw, and `noise_fn(kind, i, shape)` the draws
        of each step's ancestral noise ("step") and of inpaint's keep noise
        ("keep"); `refiner_latents` and `refiner_noise_fn` the same for the
        refiner's stage.
        `job_id` arms the cancel probe (the module docstring), at the chunk
        boundaries of `denoise_chunk_steps`, and before the first and after
        the last step; a chained refiner and both stages of the QR chain
        probe too. With chunking on, every `checkpoint_every_chunks`-th
        boundary calls `checkpoint_cb(step, latents, leaves, signature,
        rng)` (host arrays: latents, the scheduler's `state_leaves`, the
        program signature, the generator's state), every
        `preview_every_chunks`-th `preview_cb(step, pixels)` (uint8 [n, H,
        W, 3]); `resume` (checkpoint.unpack's dict) restarts the pass at its
        step when its signature, step and arrays fit this pass, else the
        full pass runs and a warning is logged. A resumed pass stamps
        `resumed` {from_step, recomputed_steps}. With chunking on,
        `timings["boundary_s"]` is the host's time at the boundaries (the
        probes, checkpoints and previews), which `unet_step_ms` leaves
        out. Neither the QR chain nor
        the refiner checkpoints or resumes, as in the JAX pipeline."""
        if self.is_pix2pix and image is not None and kwargs.get("controlnet_model_name"):
            raise ValueError("ControlNet is not supported with instruct-pix2pix models")
        if (kwargs.get("controlnet_prepipeline_type") and kwargs.get("controlnet_model_name")
                and mask_image is None):
            # the txt2img ControlNet wire puts the QR image in `image`, so
            # the chain sorts control and start image out itself
            return self._run_qr_two_stage(
                prompt, negative_prompt, pipeline_type, height=height, width=width,
                strength=strength, image=image, seed=seed, generator=generator,
                latents=latents, noise_fn=noise_fn, prepipeline_latents=prepipeline_latents,
                prepipeline_noise_fn=prepipeline_noise_fn,
                num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                num_images_per_prompt=num_images_per_prompt, scheduler_type=scheduler_type,
                image_guidance_scale=image_guidance_scale, aesthetic_score=aesthetic_score,
                refiner=refiner, registry=registry, refiner_latents=refiner_latents,
                refiner_noise_fn=refiner_noise_fn, upscale=upscale,
                upscale_latents=upscale_latents, job_id=job_id,
                denoise_chunk_steps=denoise_chunk_steps, **kwargs)
        strength = 0.75 if strength is None else float(strength)
        controlnet_name = kwargs.get("controlnet_model_name")
        control_image = kwargs.get("control_image")
        if controlnet_name and control_image is None:
            # the txt2img ControlNet convention: `image` is the control image
            control_image, image = image, None
        if controlnet_name and control_image is None:
            raise ValueError("Controlnet specified but no control image provided")
        cn_scale = float(kwargs.get("controlnet_conditioning_scale", 1.0))
        timings: dict[str, float] = {}
        upscaler = None
        upscale_fallback = False
        if upscale:
            if registry is None:
                raise ValueError("an upscale stage needs the worker's pipeline registry")
            try:
                upscaler = registry.get_pipeline(upscaler_name_for(self.model_name),
                                                 pipeline_type=UPSCALE_PIPELINE)
            except MissingWeightsError:
                logger.warning("sd-x2 upscaler weights missing; falling back to latent-resize "
                               "2x for this job")
                upscale_fallback = True
        # the adapters resolve before any work, so a bad one fails the job
        # at once
        t_adapters = time.perf_counter()
        lora = kwargs.get("lora")
        lora_scale = float(kwargs.get("lora_scale", (kwargs.get("cross_attention_kwargs")
                                                     or {}).get("scale", 1.0)))
        stacks = lora_stats = None
        if lora is not None:
            stacks, lora_stats = self.adapter_stacks(lora)
        ti_ref = kwargs.get("textual_inversion")
        extras, tokenizers = self.ti_apply(ti_ref) if ti_ref else (None, None)
        vae = self.custom_vae(str(kwargs["vae"])) if kwargs.get("vae") else self.vae
        if lora is not None or ti_ref or vae is not self.vae:
            synchronize(self.device)
            timings["adapters_s"] = time.perf_counter() - t_adapters
        branch = self.controlnet(controlnet_name) if controlnet_name else None
        steps = int(num_inference_steps)
        n = int(num_images_per_prompt)
        starts = None
        if isinstance(image, (list, tuple)):
            # distinct start images, one per output image
            starts, n = list(image), len(image)
            image = starts[0]
        guidance_scale = float(guidance_scale)
        if height is None and image is not None:
            width, height = image.size
        if height is None and control_image is not None:
            width, height = control_image.size
        height = int(height or self.default_size)
        width = int(width or self.default_size)
        height, width = (max(64, (d // 64) * 64) for d in (height, width))
        lh, lw = height // self.latent_factor, width // self.latent_factor
        if mask_image is not None:
            if image is None:
                raise ValueError("inpaint requires an init image. None provided")
            mode = "inpaint9" if self.is_inpaint_unet else "inpaint"
        elif image is not None and self.is_pix2pix:
            mode = "pix2pix"
            if image_guidance_scale is None:
                image_guidance_scale = 1.5  # the edit checkpoints' default
        else:
            mode = "txt2img" if image is None else "img2img"
        # pix2pix guides over [uncond | image only | image and text]
        cfg_rows = 3 if mode == "pix2pix" else 2
        t_start = 0
        if mode in ("img2img", "inpaint"):
            t_start = min(max(int(steps * (1.0 - strength)), 0), steps - 1)
        scheduler = get_scheduler(scheduler_type, **vars(SchedulerConfig(
            prediction_type=self.prediction_type,
            use_karras_sigmas=bool(kwargs.get("use_karras_sigmas", False)))))
        t_job = time.perf_counter()

        with _Timer(self.device, timings, "text_encode_s"):
            context, pooled = self.encode_prompts([negative_prompt] * n + [prompt] * n,
                                                  tokenizers, extras, stacks, lora_scale)
            if cfg_rows == 3:
                context = torch.cat([context[:n], context])
            added = None
            if self.is_xl:
                ids = self._xl_time_ids(height, width, aesthetic_score)
                added = {
                    "text_embeds": torch.cat([pooled[:n]] * (cfg_rows - 1) + [pooled[n:]]),
                    "time_ids": torch.tensor([ids] * (cfg_rows * n), dtype=torch.float32,
                                             device=self.device),
                }

        shape = (n, self.latent_channels, lh, lw)
        gen = generator or torch.Generator(device=self.device).manual_seed(int(seed or 0))

        def draw(kind: str, i: int):
            if noise_fn is None:
                return torch.randn(shape, generator=gen, device=self.device,
                                   dtype=torch.float32)
            return self._latents(noise_fn(kind, i, shape), shape)

        latents = (torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
                   if latents is None else self._latents(latents, shape))

        image_latents = mask = None
        if image is not None:
            with _Timer(self.device, timings, "image_encode_s"):
                pixels = np.stack([_pil_to_array(im, width, height) for im in starts or [image]])
                if mode == "inpaint9":
                    # the 9-channel checkpoint conditions on the masked
                    # image: the repaint region is blanked before encoding
                    mask_px = np.asarray(mask_image.convert("L").resize(
                        (width, height), Image.NEAREST), np.float32)[None, ..., None] / 255.0
                    pixels = pixels * (mask_px <= 0.5).astype(np.float32)
                # one start image for the whole batch: encoded once
                image_latents = self.encode_image(pixels, vae).expand(shape)
                if mode == "pix2pix":
                    # the edit checkpoint conditions on the latent
                    # distribution's unscaled mean
                    image_latents = image_latents / vae.config.scaling_factor
        if mask_image is not None:
            m = _mask_to_latent_array(mask_image, width, height, self.latent_factor)
            mask = torch.from_numpy(m.transpose(2, 0, 1)[None]).to(self.device).expand(
                n, 1, lh, lw)
        control = window = None
        if branch is not None:
            control = self._control_rows(control_image, width, height, cfg_rows * n)
            window = control_window(kwargs.get("control_guidance_start", 0.0),
                                    kwargs.get("control_guidance_end", 1.0), steps)

        schedule = scheduler.schedule(steps)
        start, end = scheduler.loop_bounds(schedule, steps, t_start)
        # the analytic UNet FLOPs of this pass: the cost stamp's numerator,
        # and the ledger's figure for its key
        pass_flops_raw = denoise_flops(self.unet.config, lh, lw, n, steps - t_start,
                                       cfg_rows=cfg_rows)
        ledger = programs.note_pass(
            self.model_name, mode,
            (mode, lh, lw, n, steps, scheduler_type, bool(kwargs.get("use_karras_sigmas", False)),
             t_start, controlnet_name),
            call_flops=unet_call_flops(self.unet.config, lh, lw, cfg_rows * n),
            pass_flops=pass_flops_raw)
        chunk = max(int(denoise_chunk_steps or 0), 0)
        probe = _solo_probe(job_id)
        ckpt_every = int(checkpoint_every_chunks or 0)
        preview_every = int(preview_every_chunks or 0)
        arm_ckpt = chunk > 0 and checkpoint_cb is not None and ckpt_every > 0
        arm_preview = chunk > 0 and preview_cb is not None and preview_every > 0
        signature = None
        if chunk > 0 and (resume is not None or arm_ckpt):
            # what fixes the meaning of "step K" for this pass
            key = (self.model_name, mode, self.unet.config.in_channels, scheduler_type,
                   bool(kwargs.get("use_karras_sigmas", False)), steps, t_start,
                   (height, width), cfg_rows, controlnet_name)
            signature = checkpoint.program_signature(self.model_name, key, self.dtype)
        if resume is not None and str(resume.get("signature", "")) != signature:
            if chunk > 0:
                logger.warning("resume offer signature %s does not match this pass's %s; "
                               "running the full pass", resume.get("signature"), signature)
            resume = None
        branch_calls = boundaries = 0
        # the host's time at the boundaries (probe, checkpoint copy and
        # pack, preview decode and encode), which is not step time
        boundary_s = 0.0
        if probe is not None:
            probe()
        with (_Timer(self.device, timings, "denoise_s"),
              lora_runtime.applied(self.unet_index, stacks, lora_scale, cfg_rows * n)):
            if mode in ("img2img", "inpaint"):
                latents = scheduler.add_noise(schedule, image_latents, latents, start)
            else:
                latents = latents * float(schedule.init_noise_sigma)
            state = scheduler.init_state(latents)
            first = start
            if resume is not None:
                try:
                    first, latents, state = self._rehydrate(resume, scheduler, latents, state,
                                                            gen, start, end)
                except (ValueError, KeyError, TypeError, RuntimeError) as e:
                    # resume is an optimisation, never a gate
                    logger.warning("checkpoint rehydration failed (%s); running the full pass",
                                   e)
            if mode == "inpaint9":
                cond9 = torch.cat([mask, image_latents], dim=1)
            elif mode == "pix2pix":
                # zeros on the uncond row: image guidance pulls away from a
                # true no-image baseline
                cond_rows = torch.cat([torch.zeros_like(image_latents), image_latents,
                                       image_latents])
            for i in range(first, end):
                if _at_boundary(i, first, chunk) and (probe or arm_ckpt or arm_preview):
                    # the host waits for the chunk before it probes: it would
                    # otherwise run ahead of the queued launches, and every
                    # probe would fire before the first chunk computed
                    synchronize(self.device)
                    t_boundary = time.perf_counter()
                    if probe is not None:
                        probe()
                    boundaries += 1
                    if arm_ckpt and boundaries % ckpt_every == 0:
                        checkpoint_cb(i, latents.cpu().numpy(),
                                      [leaf.cpu().numpy()
                                       for leaf in scheduler.state_leaves(state, latents)],
                                      signature, gen.get_state().numpy())
                    if arm_preview and boundaries % preview_every == 0:
                        # the decode comes back on the host: nothing of it
                        # stays queued behind the next step
                        preview_cb(i, self.decode(latents, vae))
                    boundary_s += time.perf_counter() - t_boundary
                inp = scheduler.scale_model_input(schedule, latents, i)
                if mode == "inpaint9":
                    inp = torch.cat([inp, cond9], dim=1)
                model_in = torch.cat([inp] * cfg_rows)
                if mode == "pix2pix":
                    model_in = torch.cat([model_in, cond_rows], dim=1)
                model_in = model_in.to(self.dtype).contiguous(memory_format=torch.channels_last)
                t_vec = torch.full((cfg_rows * n,), float(schedule.timesteps[i]),
                                   device=self.device)
                residuals = _control_residuals(branch, cn_scale, window, i, model_in, t_vec,
                                               context, control, added)
                branch_calls += bool(residuals)
                out = _unet_call(ledger, self.unet, model_in, t_vec, context, added_cond=added,
                                 **residuals).float()
                if mode == "pix2pix":
                    # dual guidance (InstructPix2Pix eq. 3)
                    out_u, out_i, out_c = out.chunk(3)
                    guided = (out_u + guidance_scale * (out_c - out_i)
                              + float(image_guidance_scale) * (out_i - out_u))
                else:
                    out_u, out_c = out.chunk(2)
                    guided = out_u + guidance_scale * (out_c - out_u)
                noise = draw("step", i) if scheduler.uses_ancestral_noise else None
                state, latents = scheduler.step(schedule, state, i, latents, guided, noise)
                if mode == "inpaint":
                    # the kept region stays on the original's trajectory,
                    # and is the clean latents after the last step
                    keep = (image_latents if i == end - 1 else scheduler.add_noise(
                        schedule, image_latents, draw("keep", i), min(i + 1, end - 1)))
                    latents = mask * latents + (1.0 - mask) * keep
            if probe is not None:
                synchronize(self.device)
                probe()

        with _Timer(self.device, timings, "decode_s"):
            pixels = self.decode(latents, vae)
        finite = bool(torch.isfinite(latents).all())
        absmax = float(latents.abs().max())
        # the steps this pass ran: a resumed pass ran from its checkpoint
        if chunk > 0:
            timings["boundary_s"] = boundary_s
        timings["unet_step_ms"] = (1000.0 * (timings["denoise_s"] - boundary_s)
                                   / max(end - first, 1))
        # the JAX package's denoise_decode_s span
        span = round(timings["denoise_s"] + timings["decode_s"], 4)
        ledger.finish(span)
        # a resumed pass bills the fraction it recomputed, not the full pass
        # the first delivery already ran
        billed_flops = pass_flops_raw
        if first != start and steps > t_start:
            billed_flops = int(round(pass_flops_raw * (end - first) / (steps - t_start)))
        lora_runtime.LORA_ROWS.inc(n, mode="none" if lora is None else "delta")
        # a solo pass is its own job: the job's flops are the pass's
        cost = costs.job_cost(costs.pass_cost(
            model=self.model_name, pass_flops=billed_flops, denoise_s=span, chips=1,
            device=self.device, geometry=GEOMETRY_LABEL), billed_flops)

        if refiner is not None:
            # the SDXL refiner stage: the output re-enters a second resident
            # pipeline as img2img, on the job's generator
            if registry is None:
                raise ValueError("a refiner stage needs the worker's pipeline registry")
            t0 = time.perf_counter()
            refiner_pipe = registry.get_pipeline(refiner["model_name"])
            refiner_kw = dict(prompt=prompt, negative_prompt=negative_prompt,
                              strength=float(refiner.get("strength", 0.3)),
                              num_inference_steps=steps, guidance_scale=guidance_scale,
                              scheduler_type=scheduler_type, job_id=job_id,
                              denoise_chunk_steps=denoise_chunk_steps)
            refined = None
            try:
                refined, _ = refiner_pipe.run(
                    image=[Image.fromarray(px) for px in pixels], generator=gen,
                    latents=refiner_latents, noise_fn=refiner_noise_fn, **refiner_kw)
            except Exception as e:  # noqa: BLE001 — only an out-of-memory error falls back
                if not is_out_of_memory(e):
                    raise
                # the message as text: a log record kept by a handler would
                # otherwise keep the error, and with it the failed batch
                logger.warning("batched refiner out of memory (%s); refining image by image",
                               str(e))
            if refined is None:
                # the JAX pipeline's fallback: one image at a time, each on
                # a generator of its own (the job's seed folded with its
                # index). It runs after the handler, whose error's traceback
                # held the failed batch's frames and with them its tensors.
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                refined = []
                for idx, px in enumerate(pixels):
                    out, _ = refiner_pipe.run(
                        image=[Image.fromarray(px)],
                        generator=torch.Generator(device=self.device).manual_seed(
                            fold_seed(seed, idx)),
                        latents=None if refiner_latents is None else refiner_latents[idx:idx + 1],
                        noise_fn=_row_noise(refiner_noise_fn, idx, len(pixels)), **refiner_kw)
                    refined.extend(out)
                timings["refiner_one_by_one"] = len(pixels)
            pixels = np.stack(refined)
            timings["refiner_s"] = time.perf_counter() - t0
        if upscaler is not None:
            # the learned SD-x2 stage, on the job's generator
            t0 = time.perf_counter()
            pixels = np.stack(upscaler.upscale(
                [Image.fromarray(px) for px in pixels], prompt=prompt,
                negative_prompt=negative_prompt, generator=gen, latents=upscale_latents))
            timings["upscale_s"] = time.perf_counter() - t0
            timings["upscale_step_ms"] = upscaler.last_timings["step_ms"]
        elif upscale_fallback:
            t0 = time.perf_counter()
            pixels = np.stack([self._latent2x(px, width, height, vae) for px in pixels])
            timings["upscale_s"] = time.perf_counter() - t0
        timings["pipeline_s"] = time.perf_counter() - t_job

        pipeline_config = {
            "model": self.model_name,
            "pipeline": pipeline_type,
            "scheduler": scheduler_type,
            "controlnet": controlnet_name,
            **({"controlnet_calls": branch_calls} if branch is not None else {}),
            "mode": mode,
            "steps": steps,
            "size": [width, height],
            "guidance_scale": guidance_scale,
            **({"strength": strength, "t_start": t_start}
               if mode in ("img2img", "inpaint") else {}),
            **({"image_guidance_scale": float(image_guidance_scale)}
               if mode == "pix2pix" else {}),
            # `size` stays the canvas asked for, as in JAX; the upscale
            # stage doubles what comes out
            **({"output_size": [2 * width, 2 * height], "upscaled": True} if upscale else {}),
            **({"upscaler": "latent-resize-fallback"} if upscale_fallback else {}),
            # a pix2pix job on a checkpoint that is not an edit checkpoint
            # runs as plain img2img, and says so
            **({"approximated_as": "img2img"}
               if image_guidance_scale is not None and mode == "img2img" else {}),
            # the analytic UNet FLOPs of the denoise, and the cost stamp
            "unet_tflops": round(pass_flops_raw / 1e12, 4),
            "cost": cost,
            "geometry": dict(GEOMETRY),
            "backend": f"torch-{self.device.type}",
            "device": device_label(self.device),
            "dtype": str(self.dtype).replace("torch.", ""),
            "weights": self.weights_source,
            # the adapter's route: the runtime delta, whatever its modules
            # (the JAX package says "merged" where some of them are conv)
            **({"lora_mode": "delta", "lora_scale": lora_scale,
                "lora_modules": {k: lora_stats[k] for k in ("matched", "unmatched")},
                "operand_cache": {"hits": int(lora_stats["operand_hit"]),
                                  "misses": int(not lora_stats["operand_hit"]),
                                  "bytes_saved": lora_stats["bytes"] * lora_stats["operand_hit"]}}
               if lora is not None else {}),
            **self._embed_cache_stamp(),
            # a pass resumed from a checkpoint ran only the steps after it
            **({"resumed": {"from_step": first, "recomputed_steps": end - first}}
               if first != start else {}),
            "latents": {"finite": finite, "absmax": absmax},
            "timings": {k: round(v, 4) for k, v in timings.items()},
        }
        return list(pixels), pipeline_config

    def _rehydrate(self, resume: dict, scheduler, latents, state, gen, lo: int, hi: int):
        """A freshly prepared pass's (latents, scheduler state) swapped for a
        checkpoint's, and its generator set to the checkpoint's state ->
        (step, latents, state). The step must lie strictly inside the pass
        (lo, hi); the latents, every scheduler leaf and the generator state
        must have this pass's shapes and dtypes. Anything else raises
        ValueError, and nothing is changed."""
        at = int(resume.get("step", lo))
        if not lo < at < hi:
            raise ValueError(f"resume step {at} outside the denoise span ({lo}, {hi})")
        ck = resume["latents"]
        ck = ck if isinstance(ck, torch.Tensor) else torch.from_numpy(np.array(ck))
        if tuple(ck.shape) != tuple(latents.shape) or ck.dtype != latents.dtype:
            raise ValueError(f"checkpoint latents {ck.dtype}{tuple(ck.shape)} do not match this "
                             f"pass's {latents.dtype}{tuple(latents.shape)}")
        state = scheduler.state_from_leaves(state, list(resume.get("state_leaves") or []),
                                            latents)
        if resume.get("rng") is None:
            raise ValueError("checkpoint carries no generator state")
        rng = torch.from_numpy(np.array(resume["rng"], dtype=np.uint8).reshape(-1))
        if rng.numel() != gen.get_state().numel():
            raise ValueError(f"generator state of {rng.numel()} bytes, this pass's generator "
                             f"has {gen.get_state().numel()}")
        gen.set_state(rng)
        return at, ck.to(self.device), state

    def _latent2x(self, image: np.ndarray, width: int, height: int, vae) -> np.ndarray:
        """The fallback of `upscale` where the SD-x2 upscaler has no
        weights, as the JAX pipeline's `_latent2x_impl`: one image encoded,
        its latents resized 2x bilinearly (half-pixel centres, edges
        clamped), decoded -> uint8 [2H, 2W, 3]."""
        z = self.encode_image(_pil_to_array(Image.fromarray(image), width, height)[None], vae)
        return self.decode(F.interpolate(z, scale_factor=2.0, mode="bilinear",
                                         align_corners=False), vae)[0]

    def _run_qr_two_stage(self, prompt, negative_prompt, pipeline_type, *, height, width,
                          strength, image, seed, generator, latents, noise_fn,
                          prepipeline_latents, prepipeline_noise_fn, **kwargs):
        """The QR-monster chain, as in the JAX pipeline: a plain txt2img
        stage composes one image at half the canvas (64 at least), which is
        upscaled (LANCZOS) and re-enters as the start image of the
        ControlNet img2img stage at `strength` (0.9 unset), conditioned by
        the QR image (`control_image`, else `image`). Both stages draw from
        the job's generator in turn, or take injected noise: the first
        `prepipeline_latents` / `prepipeline_noise_fn`, the second
        `latents` / `noise_fn` (JAX splits the job's key in three and hands
        the second and third to the stages). An `upscale` runs after each
        stage, as in JAX (the first stage's 2x output is then the start
        image's canvas); `upscale_latents` are the second stage's,
        `prepipeline_upscale_latents` the first's."""
        kwargs.pop("controlnet_prepipeline_type", None)
        upscale_latents = kwargs.pop("upscale_latents", None)
        stage1_upscale_latents = kwargs.pop("prepipeline_upscale_latents", None)
        height = int(height or self.default_size)
        width = int(width or self.default_size)
        strength = 0.9 if strength is None else float(strength)
        cn_kwargs = {k: kwargs.pop(k) for k in (
            "controlnet_model_name", "control_image", "controlnet_conditioning_scale",
            "control_guidance_start", "control_guidance_end") if k in kwargs}
        if cn_kwargs.get("control_image") is None and image is not None:
            cn_kwargs["control_image"] = image
        if cn_kwargs.get("control_image") is None:
            raise ValueError("Controlnet specified but no control image provided")
        gen = generator or torch.Generator(device=self.device).manual_seed(int(seed or 0))
        t0 = time.perf_counter()
        # one composition image is all the second stage reads
        stage1, _ = self.run(prompt, negative_prompt, pipeline_type, generator=gen,
                             height=max(height // 2, 64), width=max(width // 2, 64),
                             latents=prepipeline_latents, noise_fn=prepipeline_noise_fn,
                             upscale_latents=stage1_upscale_latents,
                             **{**kwargs, "num_images_per_prompt": 1})
        prepipeline_s = round(time.perf_counter() - t0, 3)
        base = Image.fromarray(stage1[0]).resize((width, height), Image.LANCZOS)
        images, config = self.run(prompt, negative_prompt, pipeline_type, generator=gen,
                                  image=base, strength=strength, height=height, width=width,
                                  latents=latents, noise_fn=noise_fn,
                                  upscale_latents=upscale_latents, **cn_kwargs, **kwargs)
        config["prepipeline"] = "qr_two_stage"
        config["timings"]["prepipeline_s"] = prepipeline_s
        return images, config

    def _embed_cache_stamp(self) -> dict:
        """The envelope's `embed_cache` {hits, misses} of the job's (or the
        pass's) encode; nothing when the cache was off or bypassed."""
        if self.last_encode_stats is None:
            return {}
        hits, misses = self.last_encode_stats
        return {"embed_cache": {"hits": hits, "misses": misses}}

    @staticmethod
    def _check_adapter_slots(requests: list[dict], lora_slots_max: int) -> None:
        """One pass's adapter scan: ValueError when its requests carry more
        distinct adapters than `lora_slots_max`. The one rule of
        `run_batched` and `prescan_adapter_chunks`."""
        distinct = {adapter_key(r["lora"]) for r in requests if r.get("lora")}
        if len(distinct) > lora_slots_max:
            raise ValueError(f"group carries more than {lora_slots_max} distinct adapters in "
                             "one pass; serving members individually")

    def prescan_adapter_chunks(self, chunks: list[list[dict]], lora_slots_max: int = 8) -> None:
        """Raise every adapter refusal `run_batched` would meet in any pass
        of a group split over several, before the first pass runs (a later
        pass's refusal would throw away the passes already run). The port
        has one adapter route, the runtime delta, and no switch that turns
        it off, so the slots cap is the one refusal."""
        for chunk in chunks:
            self._check_adapter_slots(chunk, lora_slots_max)

    @torch.inference_mode()
    def run_batched(self, requests: list[dict], *, height: int | None = None,
                    width: int | None = None, num_inference_steps: int = 30,
                    guidance_scale: float = 7.5,
                    scheduler_type: str = "DPMSolverMultistepScheduler",
                    use_karras_sigmas: bool = False, pipeline_type: str = "DiffusionPipeline",
                    strength: float = 0.75, lora_slots_max: int = 8,
                    aesthetic_score: float = 6.0, controlnet_model_name: str | None = None,
                    control_image=None, controlnet_conditioning_scale: float = 1.0,
                    control_guidance_start: float = 0.0, control_guidance_end: float = 1.0,
                    latents=None, noise_fn=None, denoise_chunk_steps: int = 0):
        """A coalesced txt2img or img2img group in one padded pass, the
        counterpart of the JAX pipeline's `run_batched` -> [(images,
        pipeline_config)], one per request, in order.

        `requests`: [{"prompt", "negative_prompt", "seed",
        "num_images_per_prompt", "image"?, "lora"?, "lora_scale"?}]; what
        the group shares (model, canvas, steps, scheduler, guidance,
        strength) comes as keywords, as `coalesce_key` guarantees. Either
        every request has a start image (img2img; one size for all) or none
        has; else ValueError. The rows are counted per request and padded to
        `pad_bucket(total)`; padding rows carry the empty prompt, slot 0 and
        zero start latents, and are discarded before the decode.

        Each request's noise comes from its own generator, seeded with its
        `seed`: its initial latents [n, C, h, w], then its ancestral noise
        at each step, in the order the solo `run` draws them, so a row does
        not depend on its batchmates. Padding rows draw from a generator of
        their own. `latents` [padded, C, h, w] and `noise_fn(kind, i,
        shape)` (kind "step", shape the padded batch) inject all of it
        instead.

        Adapters ride per row (lora_runtime.applied_rows): each distinct
        adapter is a slot, at most `lora_slots_max` per pass (past that,
        ValueError, and the members run alone). Conv-shaped factors and
        any rank are served, as by the solo path's delta over the matched
        Linear modules.

        A shared ControlNet (`controlnet_model_name`, one `control_image`
        for the group, scale and window as in `run`) conditions every row
        of the pass, padding rows too, as the JAX pass does: the branch
        runs once a step over all of them.

        A request's `job_id` arms its row's cancel probe, before the first
        step, at every `denoise_chunk_steps` boundary and after the last:
        a cancelled member's row keeps computing (the padded shapes are
        fixed) and its result comes back with `cancelled` true; when every
        member is cancelled the pass raises JobCancelled. A coalesced pass
        never checkpoints or resumes, as in the JAX package."""
        timings: dict[str, float] = {}
        start_images = [r.get("image") for r in requests]
        i2i = any(im is not None for im in start_images)
        if i2i and not all(im is not None for im in start_images):
            raise ValueError("coalesced img2img group missing a start image")
        if i2i and len({im.size for im in start_images}) > 1:
            raise ValueError("coalesced img2img group has mixed start-image sizes; "
                             "serving members individually")
        if self.is_pix2pix or self.is_inpaint_unet:
            raise ValueError(f"{self.model_name} conditions on the channel axis; its jobs "
                             "run alone")
        if height is None and i2i:
            width, height = start_images[0].size
        height = int(height or self.default_size)
        width = int(width or height)
        height, width = (max(64, (d // 64) * 64) for d in (height, width))
        lh, lw = height // self.latent_factor, width // self.latent_factor
        steps = int(num_inference_steps)
        strength = min(max(float(strength), 0.0), 1.0)
        t_start = min(max(int(steps * (1.0 - strength)), 0), steps - 1) if i2i else 0
        counts = [max(int(r.get("num_images_per_prompt", 1) or 1), 1) for r in requests]
        total = sum(counts)
        padded = pad_bucket(total)
        pad_rows = padded - total

        # per-row adapters: one slot per distinct adapter, slot 0 for none;
        # the cap refuses before any adapter loads
        self._check_adapter_slots(requests, lora_slots_max)
        t_adapters = time.perf_counter()
        slot_of: dict[tuple, int] = {}
        slot_stacks, slot_stats, row_slots, row_gains, request_slots = [], [], [], [], []
        for r, n in zip(requests, counts):
            slot, gain = 0, 0.0
            if r.get("lora"):
                key = adapter_key(r["lora"])
                slot = slot_of.get(key, 0)
                if not slot:
                    stacks, stats = self.adapter_stacks(r["lora"])
                    slot_stacks.append(stacks)
                    slot_stats.append(stats)
                    slot = slot_of[key] = len(slot_stacks)
                gain = float(r.get("lora_scale", 1.0) or 0.0)
            request_slots.append(slot)
            row_slots += [slot] * n
            row_gains += [gain] * n
        row_slots += [0] * pad_rows
        row_gains += [0.0] * pad_rows
        gains = None
        if slot_stacks:
            # [slot, row]: a row's gain in its own slot's line; the UNet's
            # CFG rows and the text encode are [uncond x padded | cond x
            # padded], so the row vector is written twice
            per_row = torch.tensor([[g if s == k else 0.0 for s, g in zip(row_slots, row_gains)]
                                    for k in range(1, len(slot_stacks) + 1)])
            gains = torch.cat([per_row, per_row], dim=1).to(self.device, self.dtype)
            synchronize(self.device)
            timings["adapters_s"] = time.perf_counter() - t_adapters
        t_job = time.perf_counter()

        with _Timer(self.device, timings, "text_encode_s"):
            negs, prompts = [], []
            for r, n in zip(requests, counts):
                negs += [r.get("negative_prompt") or ""] * n
                prompts += [r.get("prompt") or ""] * n
            context, pooled = self.encode_prompts(
                negs + [""] * pad_rows + prompts + [""] * pad_rows,
                slot_stacks=slot_stacks or None, slot_gains=gains)
            added = None
            if self.is_xl:
                ids = self._xl_time_ids(height, width, aesthetic_score)
                added = {"text_embeds": pooled,
                         "time_ids": torch.tensor([ids] * (2 * padded), dtype=torch.float32,
                                                  device=self.device)}

        shape = (padded, self.latent_channels, lh, lw)
        sources = [(torch.Generator(device=self.device).manual_seed(int(r.get("seed") or 0)), n)
                   for r, n in zip(requests, counts)]
        if pad_rows:
            sources.append((torch.Generator(device=self.device).manual_seed(0x9AD), pad_rows))

        def fresh():
            return torch.cat([torch.randn((n, *shape[1:]), generator=gen, device=self.device,
                                          dtype=torch.float32) for gen, n in sources])

        def draw(kind: str, i: int):
            return fresh() if noise_fn is None else self._latents(noise_fn(kind, i, shape), shape)

        latents = fresh() if latents is None else self._latents(latents, shape)

        image_latents = None
        if i2i:
            with _Timer(self.device, timings, "image_encode_s"):
                # one encode per request, gathered into the row layout
                rows = [self.encode_image(_pil_to_array(im, width, height)[None]).expand(
                    n, -1, -1, -1) for im, n in zip(start_images, counts)]
                if pad_rows:
                    rows.append(torch.zeros((pad_rows, *shape[1:]), device=self.device))
                image_latents = torch.cat(rows)

        branch = control = window = None
        cn_scale = float(controlnet_conditioning_scale)
        if controlnet_model_name:
            if control_image is None:
                raise ValueError("Controlnet specified but no control image provided")
            branch = self.controlnet(controlnet_model_name)
            control = self._control_rows(control_image, width, height, 2 * padded)
            window = control_window(control_guidance_start, control_guidance_end, steps)

        scheduler = get_scheduler(scheduler_type, **vars(SchedulerConfig(
            prediction_type=self.prediction_type, use_karras_sigmas=bool(use_karras_sigmas))))
        schedule = scheduler.schedule(steps)
        start, end = scheduler.loop_bounds(schedule, steps, t_start)
        # the analytic UNet FLOPs of the whole padded pass (padding rows
        # take device time too); each envelope counts its own rows
        pass_flops_raw = denoise_flops(self.unet.config, lh, lw, padded, steps - t_start,
                                       cfg_rows=2)
        kind = "batched_i2i" if i2i else "batched"
        ledger = programs.note_pass(
            self.model_name, kind,
            (kind, lh, lw, padded, steps, scheduler_type, bool(use_karras_sigmas), t_start,
             controlnet_model_name),
            call_flops=unet_call_flops(self.unet.config, lh, lw, 2 * padded),
            pass_flops=pass_flops_raw)
        branch_calls = 0
        chunk = max(int(denoise_chunk_steps or 0), 0)
        row_ids = [r.get("job_id") for r in requests]
        cancelled_rows: set[int] = set()
        probe = None
        if any(row_ids):
            def probe():
                for idx, jid in enumerate(row_ids):
                    if jid and idx not in cancelled_rows and cancel_registry.cancelled(jid):
                        cancelled_rows.add(idx)
                        logger.warning("coalesced row for job %s cancelled; its batchmates "
                                       "go on", jid)
                if len(cancelled_rows) == len(requests):
                    raise JobCancelled(row_ids)

            probe()
        hooks = (lora_runtime.applied_rows(self.unet_index, slot_stacks, gains)
                 if slot_stacks else nullcontext())
        with _Timer(self.device, timings, "denoise_s"), hooks:
            if i2i:
                latents = scheduler.add_noise(schedule, image_latents, latents, start)
            else:
                latents = latents * float(schedule.init_noise_sigma)
            state = scheduler.init_state(latents)
            for i in range(start, end):
                if probe is not None and _at_boundary(i, start, chunk):
                    synchronize(self.device)
                    probe()
                inp = scheduler.scale_model_input(schedule, latents, i)
                model_in = torch.cat([inp, inp]).to(self.dtype).contiguous(
                    memory_format=torch.channels_last)
                t_vec = torch.full((2 * padded,), float(schedule.timesteps[i]),
                                   device=self.device)
                residuals = _control_residuals(branch, cn_scale, window, i, model_in, t_vec,
                                               context, control, added)
                branch_calls += bool(residuals)
                out_u, out_c = _unet_call(ledger, self.unet, model_in, t_vec, context,
                                          added_cond=added, **residuals).float().chunk(2)
                guided = out_u + float(guidance_scale) * (out_c - out_u)
                noise = draw("step", i) if scheduler.uses_ancestral_noise else None
                state, latents = scheduler.step(schedule, state, i, latents, guided, noise)
            if probe is not None:
                synchronize(self.device)
                probe()

        real = latents[:total]
        with _Timer(self.device, timings, "decode_s"):
            if lh * lw >= 9216:
                # one image at a time from 768² up: the VAE's activations
                # stay those of one image, as the JAX program's big decode
                pixels = np.concatenate([self.decode(real[k:k + 1]) for k in range(total)])
            else:
                pixels = self.decode(real)
        timings["unet_step_ms"] = 1000.0 * timings["denoise_s"] / max(end - start, 1)
        timings["pipeline_s"] = time.perf_counter() - t_job
        span = round(timings["denoise_s"] + timings["decode_s"], 4)
        ledger.finish(span)
        for n, slot in zip(counts, request_slots):
            lora_runtime.LORA_ROWS.inc(n, mode="delta" if slot else "none")
        # the pass's cost figures, counted once for the coalesced pass
        pass_figures = costs.pass_cost(
            model=self.model_name, pass_flops=pass_flops_raw, denoise_s=span, chips=1,
            device=self.device, geometry=GEOMETRY_LABEL)

        operand_hits = sum(st["operand_hit"] for st in slot_stats)
        shared = {
            "model": self.model_name,
            "pipeline": pipeline_type,
            "scheduler": scheduler_type,
            "controlnet": controlnet_model_name,
            **({"controlnet_calls": branch_calls} if branch is not None else {}),
            "mode": "img2img" if i2i else "txt2img",
            "steps": steps,
            "size": [width, height],
            "guidance_scale": float(guidance_scale),
            **({"strength": strength, "t_start": t_start} if i2i else {}),
            "backend": f"torch-{self.device.type}",
            "device": device_label(self.device),
            "dtype": str(self.dtype).replace("torch.", ""),
            "weights": self.weights_source,
            "batched_with": len(requests),
            "padded_rows": padded,
            "geometry": dict(GEOMETRY),
            **self._embed_cache_stamp(),
            # per adapter of the pass: were its device stacks resident
            **({"operand_cache": {
                "hits": operand_hits, "misses": len(slot_stats) - operand_hits,
                "bytes_saved": sum(st["bytes"] * st["operand_hit"] for st in slot_stats)}}
               if slot_stats else {}),
        }
        results, offset = [], 0
        for r, n, slot, images, rows in zip(requests, counts, request_slots,
                                            split_by_counts(list(pixels), counts),
                                            real.split(counts)):
            job_flops = denoise_flops(self.unet.config, lh, lw, n, steps - t_start, cfg_rows=2)
            config = {**shared, "batch_rows": [offset, n],
                      # this job's own rows, then the shared pass figures
                      "unet_tflops": round(job_flops / 1e12, 4),
                      "cost": costs.job_cost(pass_figures, job_flops),
                      # a cancelled member's envelope is never built
                      **({"cancelled": True} if len(results) in cancelled_rows else {}),
                      "latents": {"finite": bool(torch.isfinite(rows).all()),
                                  "absmax": float(rows.abs().max())},
                      "timings": {k: round(v, 4) for k, v in timings.items()}}
            if slot:
                stats = slot_stats[slot - 1]
                config.update({"lora_mode": "delta",
                               "lora_scale": float(r.get("lora_scale", 1.0) or 0.0),
                               "lora_modules": {k: stats[k] for k in ("matched", "unmatched")}})
            results.append((images, config))
            offset += n
        return results
