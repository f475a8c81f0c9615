"""Kandinsky 2.x: the diffusion prior and the image-embed decoder, the
counterpart of chiaswarm_tpu/pipelines/kandinsky.py.

`KandinskyPriorPipeline` turns a prompt into CLIP image embeddings: the
CLIP text tower (bigG's penultimate states and pooled projection for 2.2,
ViT-L with quick_gelu for 2.1), then `DiffusionPrior` under DDPM with
`prediction_type="sample"` (25 steps unset), the two CFG rows [negative
| prompt] in one batch, the causal + first-EOS keep-mask, and the
un-whitening through the checkpoint's `clip_mean` / `clip_std`. The
negative embedding is the checkpoint's `zero_image_embed.npy` (the CLIP
vision embedding of a zero image, precomputed), else an unguided prior
run on the empty prompt. A prior-typed job is refused: the prior runs
inside the decoder's job.

`KandinskyPipeline` serves the decoder wire names: the prior as its
prepipeline, fetched from the worker's registry (which never evicts the
decoder that asked for it), unless the job brings `image_embeds` (and
`negative_image_embeds`: the split-embeds mode); then the CFG loop over
`K22UNet` (30 steps, guidance 4.0, DDPMScheduler unset), whose
learned-variance output is cut to its first latent channels before a
fixed-variance step, as the JAX program does (not diffusers'
learned-range variance); then `MoVQ.decode` and the uint8 quantisation on
the device. img2img encodes its start image through `MoVQ.encode` first
and noises it to the strength's step; the depth ControlNet checkpoint
concatenates the job's depth `hint` (HWC in [0, 1], resized to the
latents by antialiased bilinear, as `jax.image.resize` shrinks) onto the
latent input. A 2.1 checkpoint (`conditioning == "text_image"`, read off
the UNet's keys) conditions on MCLIP's states and pooled projection of
the prompt beside the image embedding; its tokenizer is the model's
`tokenizer/tokenizer.json` (models/tokenizer.py `load_fast_tokenizer`),
and a repo without one raises MissingWeightsError, as JAX does.

The canvas floors to a multiple of 64, at least 64 (512 unset, 64 for
the tiny stand-ins); a start image sets it. Errors are JAX's: a hint on
a checkpoint without hint channels, a ControlNet job without one.

Noise: the port draws from the job's generator (seed), in this order:
the prior's start latents and its step noise, the negative run's, then
the decoder's start latents and its step noise. A test hands each stage
what JAX drew (`prior_latents`, `prior_noise_fn`, `prior_negative_*`,
`latents`, `noise_fn`), as ROADMAP's "Inject the reference's noise" says.
Timings: `prior_s` (the whole prior stage, its CLIP included),
`text_encode_s` (the CLIP and MCLIP encodes), `denoise_s`, `decode_s`
and `unet_step_ms`. Neither family member is coalesced, chunked or
checkpointed, as in JAX.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from ..device import device_label, resolve_device, serving_dtype, synchronize
from ..models import configs as cfgs
from ..models.clip import CLIPTextEncoder
from ..models.mclip import MCLIPTextEncoder
from ..models.movq import MoVQ
from ..models.prior import DiffusionPrior
from ..models.tokenizer import load_fast_tokenizer, load_tokenizer
from ..models.unet_kandinsky import K22UNet
from ..schedulers import get_scheduler
from ..weights import (
    KANDINSKY_DECODER_FOLDERS,
    KANDINSKY_PRIOR_FOLDERS,
    PRIOR_STATS,
    MissingWeightsError,
    check_checkpoint,
    checkpoint_files,
    checkpoint_shapes,
    find_checkpoint,
    infer_k22_unet_config,
    is_test_model,
    load_checkpoint_,
    load_movq_,
    model_seed,
    movq_optional,
    random_init_,
    read_tensors,
)
from .stable_diffusion import _pil_to_array, _Timer

logger = logging.getLogger(__name__)

PRIOR_PIPELINE = "KandinskyV22PriorPipeline"
DEFAULT_SCHEDULER = "DDPMScheduler"
DEFAULT_STEPS = 30
DEFAULT_PRIOR_STEPS = 25
DEFAULT_GUIDANCE = 4.0
MCLIP_MAX_LENGTH = 77


def _is_21(model_name: str) -> bool:
    return "2-1" in model_name or "2_1" in model_name


def prior_configs(model_name: str):
    """(prior_cfg, clip_cfg) by name, as the JAX package's `_prior_configs`:
    the tiny stand-ins for `test/*` and `*tiny*`, 2.1's ViT-L tower and
    768-wide prior, else 2.2's bigG tower (SDXL's second encoder) and
    1280-wide prior."""
    if is_test_model(model_name):
        return cfgs.TINY_PRIOR, cfgs.TINY_CLIP_2
    if _is_21(model_name):
        return cfgs.K21_PRIOR, cfgs.K21_CLIP
    return cfgs.PriorConfig(), cfgs.SDXL_CLIP_2


def decoder_configs(model_name: str):
    """(unet_cfg, movq_cfg, default_size) by name, before a checkpoint's
    own geometry replaces them: the tiny stand-ins at 64^2, else the
    published 2.1 or 2.2 decoder at 512^2; a ControlNet name takes 3 more
    input channels (the depth hint)."""
    if is_test_model(model_name):
        unet, movq, size = cfgs.TINY_K22_UNET, cfgs.TINY_MOVQ, 64
    else:
        unet = cfgs.K21_DECODER_UNET if _is_21(model_name) else cfgs.K22_DECODER_UNET
        movq, size = cfgs.MoVQConfig(), 512
    if "controlnet" in model_name.lower():
        unet = dataclasses.replace(unet, in_channels=unet.in_channels + 3)
    return unet, movq, size


def prior_name_for(decoder_name: str) -> str:
    """The prior a decoder's job runs, as the JAX package names it."""
    if is_test_model(decoder_name):
        return "test/tiny-kandinsky-prior"
    if "decoder" in decoder_name:
        return decoder_name.replace("decoder", "prior")
    if _is_21(decoder_name):
        return "kandinsky-community/kandinsky-2-1-prior"
    return "kandinsky-community/kandinsky-2-2-prior"


def _model_dir(model_name: str, model_root_dir: str | None) -> Path | None:
    if not model_root_dir:
        return None
    candidate = Path(model_root_dir).expanduser() / model_name
    return candidate if candidate.is_dir() else None


def _config_json(path: Path) -> dict:
    return json.loads(path.read_text()) if path.is_file() else {}


def mclip_config_from_json(cj: dict | None) -> cfgs.MCLIPConfig:
    """MCLIP's geometry from text_encoder/config.json (MCLIPConfig nests
    the trunk's width as `transformerDimensions` and the projection as
    `numDims`; plain XLM-R keys otherwise), as the JAX pipeline reads it."""
    cj = cj or {}
    base = cfgs.MCLIP_XLMR_LARGE
    return cfgs.MCLIPConfig(
        vocab_size=int(cj.get("vocab_size", base.vocab_size)),
        hidden_size=int(cj.get("transformerDimensions", cj.get("hidden_size",
                                                                base.hidden_size))),
        num_layers=int(cj.get("num_hidden_layers", base.num_layers)),
        num_heads=int(cj.get("num_attention_heads", base.num_heads)),
        intermediate_size=int(cj.get("intermediate_size", base.intermediate_size)),
        max_positions=int(cj.get("max_position_embeddings", base.max_positions)),
        projection_dim=int(cj.get("numDims", base.projection_dim)),
        layer_norm_eps=float(cj.get("layer_norm_eps", base.layer_norm_eps)))


def mclip_files(model_name: str, model_dir: Path | None):
    """2.1's MCLIP: (its safetensors, its tokenizer, its config); a repo
    without either raises MissingWeightsError, as JAX's does."""
    files = sorted((model_dir / "text_encoder").glob("*.safetensors")) if model_dir else []
    if not files:
        raise MissingWeightsError(f"{model_name}: text_image checkpoints need the "
                                  "MCLIP text tower on disk (text_encoder/)")
    tok_dir = model_dir / "tokenizer"
    try:
        tokenizer = load_fast_tokenizer(tok_dir)
    except Exception as e:
        raise MissingWeightsError(
            f"{model_name}: MCLIP tokenizer failed to load from {tok_dir} ({e}); "
            "XLM-R needs tokenizer/tokenizer.json (a fast tokenizer)") from e
    cfg = mclip_config_from_json(_config_json(model_dir / "text_encoder" / "config.json"))
    return files, tokenizer, cfg


def prior_checkpoint(model_name: str, model_dir: Path, files: dict | None = None) -> dict:
    """The one reading of a 2.x prior directory, for serving and `--check`:
    {"files": {folder: safetensors}, "prior_cfg" (the name's, with
    prior/config.json over it), "clip_cfg"}; a folder without safetensors
    raises FileNotFoundError."""
    cfg, clip_cfg = prior_configs(model_name)
    return {"files": files or checkpoint_files(model_dir, KANDINSKY_PRIOR_FOLDERS),
            "prior_cfg": cfgs.prior_config_with_overrides(
                cfg, _config_json(model_dir / "prior" / "config.json")),
            "clip_cfg": clip_cfg}


def decoder_checkpoint(model_name: str, model_dir: Path, files: dict | None = None) -> dict:
    """The one reading of a 2.x decoder directory, for serving and
    `--check`: {"files": {"unet", "movq"[, "text_encoder"]: safetensors},
    "unet_cfg" (off the UNet's checkpoint), "movq_cfg" (movq/config.json,
    else the name's), "mclip_cfg" and "tokenizer" (2.1's MCLIP, else
    None)}; a folder without safetensors raises FileNotFoundError, a 2.1
    repo without MCLIP MissingWeightsError."""
    files = dict(files or checkpoint_files(model_dir, KANDINSKY_DECODER_FOLDERS))
    movq_cfg = decoder_configs(model_name)[1]
    if (model_dir / "movq" / "config.json").is_file():
        movq_cfg = cfgs.movq_config_from_json(_config_json(model_dir / "movq" / "config.json"))
    out = {"files": files, "movq_cfg": movq_cfg, "mclip_cfg": None, "tokenizer": None,
           "unet_cfg": infer_k22_unet_config(checkpoint_shapes(files["unet"]),
                                             _config_json(model_dir / "unet" / "config.json"))}
    if out["unet_cfg"].conditioning == "text_image":
        files["text_encoder"], out["tokenizer"], out["mclip_cfg"] = mclip_files(model_name,
                                                                               model_dir)
    return out


def decoder_modules(unet_cfg, movq_cfg, mclip_cfg=None) -> dict:
    """{folder: module} of a 2.x decoder (2.1's MCLIP where `mclip_cfg` is
    given), on the current default device."""
    modules = {"unet": K22UNet(unet_cfg), "movq": MoVQ(movq_cfg)}
    if mclip_cfg is not None:
        modules["text_encoder"] = MCLIPTextEncoder(mclip_cfg)
    return modules


def verify_kandinsky(model_name: str, model_dir: Path) -> dict:
    """`--check` of a 2.x prior repo (the prior, its CLIP tower, whether
    the whitening stats are there) or decoder repo (UNet, MoVQ, 2.1's
    MCLIP) against the modules the worker would load, built on the meta
    device -> {component: parameters}."""
    if "prior" in model_name.lower():
        found = prior_checkpoint(model_name, model_dir)
        files, clip_cfg = found["files"], found["clip_cfg"]
        with torch.device("meta"):
            prior, text = DiffusionPrior(found["prior_cfg"]), CLIPTextEncoder(clip_cfg)
        return {"prior": check_checkpoint(prior, files["prior"], "prior"),
                "text": check_checkpoint(text, files["text_encoder"], "text_encoder",
                                         text_layers=clip_cfg.num_layers),
                "clip_stats": set(PRIOR_STATS) <= set(checkpoint_shapes(files["prior"]))}
    found = decoder_checkpoint(model_name, model_dir)
    with torch.device("meta"):
        modules = decoder_modules(found["unet_cfg"], found["movq_cfg"], found["mclip_cfg"])
    names = {"unet": "unet", "movq": "movq", "text_encoder": "text"}
    return {names[folder]: check_checkpoint(module, found["files"][folder], folder,
                                            optional=movq_optional if folder == "movq" else None)
            for folder, module in modules.items()}


def _as_f32(value, device) -> torch.Tensor:
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value, dtype=np.float32))
    return value.to(device, torch.float32)


def _injected(value, shape, device) -> torch.Tensor:
    value = _as_f32(value, device)
    if tuple(value.shape) != tuple(shape):
        raise ValueError(f"injected array {tuple(value.shape)} != {tuple(shape)}")
    return value


class _Module:
    """Shared construction: modules on the meta device, cast to the serving
    dtype there, then given memory on the device."""

    def _materialise(self, module):
        module = module.to(self.dtype).to_empty(device=self.device)
        return module.eval().requires_grad_(False)

    def release(self) -> int:
        """Nothing per job stays resident beside the modules. -> 0 bytes."""
        return 0


class KandinskyPriorPipeline(_Module):
    """The resident prior stage: a prompt -> (image_embeds,
    negative_image_embeds). Not an image job of its own."""

    def __init__(self, model_name: str, device=None, dtype=None,
                 allow_random_init: bool = False, model_root_dir: str | None = None,
                 weights: dict | None = None):
        """The prior loads from `<model_root_dir>/<model_name>/` {prior,
        text_encoder}, with prior/config.json's geometry, or from `weights`
        {"prior": state dict, "text": state dict, "clip_stats": {"mean",
        "std"} or None, "zero_embed": array or None}, or is
        random-initialised from a seed."""
        self.model_name = model_name
        self.device = resolve_device(device)
        self.dtype = dtype or serving_dtype(self.device)
        self.config, clip_cfg = prior_configs(model_name)
        model_dir = _model_dir(model_name, model_root_dir)
        files = None if weights is not None else find_checkpoint(
            model_name, model_dir, KANDINSKY_PRIOR_FOLDERS, allow_random_init)
        if files is not None:
            self.config = prior_checkpoint(model_name, model_dir, files)["prior_cfg"]
        t0 = time.perf_counter()
        with torch.device("meta"):
            prior, text = DiffusionPrior(self.config), CLIPTextEncoder(clip_cfg)
        self.prior, self.text_encoder = self._materialise(prior), self._materialise(text)
        stats, zero = None, None
        self.checkpoint = None
        if weights is not None:
            self.prior.load_state_dict(weights["prior"])
            self.text_encoder.load_state_dict(weights["text"])
            stats, zero = weights.get("clip_stats"), weights.get("zero_embed")
            self.weights_source = "given"
        elif files is not None:
            t_load = time.perf_counter()
            nbytes = load_checkpoint_(self.prior, files["prior"], "prior")
            nbytes += load_checkpoint_(self.text_encoder, files["text_encoder"], "text_encoder",
                                       text_layers=clip_cfg.num_layers)
            found = read_tensors(files["prior"], PRIOR_STATS)
            if len(found) == len(PRIOR_STATS):
                stats = {"mean": found["clip_mean"], "std": found["clip_std"]}
            if (model_dir / "zero_image_embed.npy").is_file():
                zero = np.load(model_dir / "zero_image_embed.npy")
            synchronize(self.device)
            self.checkpoint = {"dir": str(model_dir), "bytes": nbytes,
                               "load_s": time.perf_counter() - t_load}
            self.weights_source = "checkpoint"
        else:
            gen = torch.Generator(device=self.device).manual_seed(model_seed(model_name))
            for module in (self.prior, self.text_encoder):
                random_init_(module, gen)
            self.weights_source = "random"
        # the whitened embedding space's stats [E] (None: identity)
        self.clip_stats = None if stats is None else {
            k: _as_f32(v, self.device).reshape(-1) for k, v in stats.items()}
        self.zero_embed = None if zero is None else _as_f32(zero, self.device).reshape(-1)
        self.tokenizer = load_tokenizer(model_dir, vocab_size=clip_cfg.vocab_size)
        synchronize(self.device)
        logger.info("%s resident on %s in %.1fs (dtype=%s, weights=%s)", model_name,
                    device_label(self.device), time.perf_counter() - t0, self.dtype,
                    self.weights_source)

    def run(self, *args, **kwargs):
        """A prior-typed job is no image job: refused, as in JAX."""
        raise ValueError(
            f"{self.model_name} is a prior prepipeline stage; schedule the Kandinsky "
            "decoder model instead (the prior runs automatically).")

    def text_mask(self, ids: np.ndarray) -> np.ndarray:
        """Keep-mask over the padded tokens: positions up to and including
        the first EOS after BOS (both tokenizers pad with EOS)."""
        eos = getattr(self.tokenizer, "eos", None)
        if eos is None:
            return np.ones_like(ids, np.float32)
        first_eos = np.argmax(ids[:, 1:] == eos, axis=1) + 1
        return (np.arange(ids.shape[1])[None] <= first_eos[:, None]).astype(np.float32)

    def encode(self, texts: list[str]):
        """-> (hidden states, pooled projection, keep-mask) of the CLIP tower."""
        ids = self.tokenizer(texts)
        out = self.text_encoder(torch.from_numpy(ids.astype(np.int64)).to(self.device))
        mask = torch.from_numpy(self.text_mask(ids)).to(self.device)
        return out["hidden_states"], out["pooled"], mask

    def denoise(self, hiddens, pooled, mask, steps: int, guidance: float, rows: int,
                latents, draw):
        """The DDPM sample-prediction loop over [B, E] f32 embeddings; with
        `rows` 2 the batch holds the CFG rows [negative | prompt]."""
        scheduler = get_scheduler("DDPMScheduler", prediction_type="sample")
        schedule = scheduler.schedule(steps)
        latents = latents * float(schedule.init_noise_sigma)
        state = scheduler.init_state(latents)
        b = latents.shape[0]
        for i in range(steps):
            t = torch.full((rows * b,), float(schedule.timesteps[i]), device=self.device)
            model_in = torch.cat([latents] * rows) if rows > 1 else latents
            pred = self.prior(model_in.to(self.dtype), t, hiddens, pooled,
                              attention_mask=mask).float()
            if rows > 1:
                pred_u, pred_c = pred.chunk(2)
                pred = pred_u + guidance * (pred_c - pred_u)
            state, latents = scheduler.step(schedule, state, i, latents, pred, draw(i))
        return latents

    def unwhiten(self, embeds):
        """PriorTransformer.post_process_latents: the decoder consumes raw
        CLIP space."""
        if self.clip_stats is None:
            return embeds
        return embeds * self.clip_stats["std"] + self.clip_stats["mean"]

    @torch.inference_mode()
    def generate(self, prompt: str, negative_prompt: str = "", num_images: int = 1,
                 steps: int = DEFAULT_PRIOR_STEPS, guidance_scale: float = DEFAULT_GUIDANCE,
                 generator=None, latents=None, noise_fn=None, negative_latents=None,
                 negative_noise_fn=None, timings: dict | None = None):
        """-> (image_embeds [N, E], negative_image_embeds [N, E]) f32.
        `latents` [N, E] and `noise_fn(i, shape)` replace the guided run's
        draws from `generator`; `negative_*` the unguided zero-prompt run's.
        `timings` gets `text_encode_s`."""
        n, e = int(num_images), self.config.embed_dim
        gen = generator or torch.Generator(device=self.device).manual_seed(0)

        def drawer(fn):
            def draw(i):
                if fn is None:
                    return torch.randn((n, e), generator=gen, device=self.device)
                return _injected(fn(i, (n, e)), (n, e), self.device)
            return draw

        def start(value):
            if value is None:
                return torch.randn((n, e), generator=gen, device=self.device)
            return _injected(value, (n, e), self.device)

        t0 = time.perf_counter()
        hiddens, pooled, mask = self.encode([negative_prompt] * n + [prompt] * n)
        if timings is not None:
            synchronize(self.device)
            timings["text_encode_s"] = timings.get("text_encode_s", 0.0) + (
                time.perf_counter() - t0)
        embeds = self.unwhiten(self.denoise(hiddens, pooled, mask, int(steps),
                                            float(guidance_scale), 2, start(latents),
                                            drawer(noise_fn)))
        if self.zero_embed is not None:
            return embeds, self.zero_embed[None].expand(n, e).clone()
        hiddens, pooled, mask = self.encode([""] * n)
        negative = self.denoise(hiddens, pooled, mask, int(steps), 1.0, 1,
                                start(negative_latents), drawer(negative_noise_fn))
        return embeds, self.unwhiten(negative)


class KandinskyPipeline(_Module):
    """One Kandinsky 2.x decoder resident on one device; serves txt2img,
    img2img, the depth ControlNet and 2.1's text_image conditioning."""

    def __init__(self, model_name: str, device=None, dtype=None,
                 allow_random_init: bool = False, model_root_dir: str | None = None,
                 weights: dict | None = None):
        """The decoder loads from `<model_root_dir>/<model_name>/` {unet,
        movq[, text_encoder, tokenizer]}, the UNet's geometry read off its
        checkpoint and MoVQ's from movq/config.json, or from `weights`
        {"unet": state dict, "movq": state dict[, "mclip": state dict],
        "unet_cfg": K22UNetConfig, "movq_cfg": MoVQConfig,
        "mclip_cfg": MCLIPConfig, "tokenizer": a fast tokenizer}, or is
        random-initialised from a seed."""
        self.model_name = model_name
        self.model_root_dir = model_root_dir
        self.allow_random_init = allow_random_init
        self.device = resolve_device(device)
        self.dtype = dtype or serving_dtype(self.device)
        unet_cfg, movq_cfg, self.default_size = decoder_configs(model_name)
        model_dir = _model_dir(model_name, model_root_dir)
        files = None if weights is not None else find_checkpoint(
            model_name, model_dir, KANDINSKY_DECODER_FOLDERS, allow_random_init)
        mclip_cfg = tokenizer = None
        if weights is not None:
            unet_cfg = weights.get("unet_cfg", unet_cfg)
            movq_cfg = weights.get("movq_cfg", movq_cfg)
            mclip_cfg, tokenizer = weights.get("mclip_cfg"), weights.get("tokenizer")
        elif files is not None:
            found = decoder_checkpoint(model_name, model_dir, files)
            files, unet_cfg, movq_cfg = found["files"], found["unet_cfg"], found["movq_cfg"]
            mclip_cfg, tokenizer = found["mclip_cfg"], found["tokenizer"]
        elif unet_cfg.conditioning == "text_image":
            _, tokenizer, mclip_cfg = mclip_files(model_name, model_dir)
        self.unet_cfg, self.movq_cfg = unet_cfg, movq_cfg
        self.text_image = unet_cfg.conditioning == "text_image"
        # the hint's channels ride the latent input
        self.controlnet = unet_cfg.in_channels > movq_cfg.latent_channels
        self.latent_channels = movq_cfg.latent_channels
        self.latent_factor = 2 ** (len(movq_cfg.block_out_channels) - 1)

        t0 = time.perf_counter()
        with torch.device("meta"):
            modules = decoder_modules(unet_cfg, movq_cfg,
                                      mclip_cfg if self.text_image else None)
        modules = {k: self._materialise(m) for k, m in modules.items()}
        self.unet, self.movq = modules["unet"], modules["movq"]
        self.mclip = modules.get("text_encoder")
        self.checkpoint = None
        if weights is not None:
            self.unet.load_state_dict(weights["unet"])
            self.movq.load_state_dict(weights["movq"])
            if self.mclip is not None:
                self.mclip.load_state_dict(weights["mclip"])
            self.weights_source = "given"
        elif files is not None:
            t_load = time.perf_counter()
            nbytes = sum(load_movq_(module, files[folder]) if folder == "movq"
                         else load_checkpoint_(module, files[folder], folder)
                         for folder, module in modules.items())
            synchronize(self.device)
            self.checkpoint = {"dir": str(model_dir), "bytes": nbytes,
                               "load_s": time.perf_counter() - t_load}
            self.weights_source = "checkpoint"
        else:
            gen = torch.Generator(device=self.device).manual_seed(model_seed(model_name))
            for module in modules.values():
                random_init_(module, gen)
            self.weights_source = "random"
        self.mclip_tokenizer = tokenizer
        for module in (self.unet, self.movq):
            module.to(memory_format=torch.channels_last)
        synchronize(self.device)
        logger.info("%s resident on %s in %.1fs (dtype=%s, weights=%s, K2.%s)", model_name,
                    device_label(self.device), time.perf_counter() - t0, self.dtype,
                    self.weights_source, "1" if self.text_image else "2")

    # --- stages ---

    def canvas(self, height, width) -> tuple[int, int]:
        """The canvas floored to a multiple of 64, at least 64."""
        return tuple(max(64, (int(d or self.default_size) // 64) * 64) for d in (height, width))

    def encode_text(self, prompt: str, negative_prompt: str, n: int):
        """2.1: MCLIP on [negative, prompt] at 77 tokens -> ({states, pooled}
        of the prompt, of the negative), each tiled to n rows."""
        ids, mask = self.mclip_tokenizer([negative_prompt or "", prompt],
                                         max_length=MCLIP_MAX_LENGTH)
        out = self.mclip(torch.from_numpy(ids).to(self.device),
                         torch.from_numpy(mask).to(self.device))
        states, pooled = out["hidden_states"].float(), out["pooled_proj"].float()

        def row(r):
            return {"text_states": states[r:r + 1].expand(n, -1, -1),
                    "text_embeds": pooled[r:r + 1].expand(n, -1)}

        return row(1), row(0)

    def encode_image(self, image: Image.Image, width: int, height: int, n: int):
        """A start image -> MoVQ latents [n, C, h, w] f32 (LANCZOS to the
        canvas, [-1, 1])."""
        pixels = _pil_to_array(image, width, height)
        x = torch.from_numpy(np.ascontiguousarray(pixels.transpose(2, 0, 1)[None]))
        x = x.to(self.device, self.dtype).contiguous(memory_format=torch.channels_last)
        return self.movq.encode(x).float().expand(n, -1, -1, -1)

    def hint_latents(self, hint, lh: int, lw: int, n: int):
        """A depth hint (HWC or NHWC in [0, 1]) at the latents' size
        [n, 3, lh, lw], by antialiased bilinear."""
        arr = torch.from_numpy(np.array(hint, dtype=np.float32))
        if arr.ndim == 3:
            arr = arr[None]
        arr = arr.permute(0, 3, 1, 2).to(self.device)
        if tuple(arr.shape[-2:]) != (lh, lw):
            arr = F.interpolate(arr, size=(lh, lw), mode="bilinear", align_corners=False,
                                antialias=True)
        return arr.expand(n, -1, -1, -1)

    def denoise(self, latents, embeds, neg_embeds, guidance: float, steps: int,
                scheduler_type: str, t_start: int, hint, draw, image_latents=None):
        """The CFG loop over NCHW f32 latents -> the final latents."""
        scheduler = get_scheduler(scheduler_type)
        schedule = scheduler.schedule(steps)
        lo, hi = scheduler.loop_bounds(schedule, steps, t_start)
        if image_latents is not None:
            latents = scheduler.add_noise(schedule, image_latents, latents, lo)
        else:
            latents = latents * float(schedule.init_noise_sigma)
        state = scheduler.init_state(latents)
        if isinstance(embeds, dict):
            cond = {k: torch.cat([neg_embeds[k], embeds[k]]) for k in embeds}
        else:
            cond = torch.cat([neg_embeds, embeds])
        b, c = latents.shape[:2]
        for i in range(lo, hi):
            inp = scheduler.scale_model_input(schedule, latents, i)
            if hint is not None:
                inp = torch.cat([inp, hint], dim=1)
            model_in = torch.cat([inp, inp]).to(self.dtype)
            t = torch.full((2 * b,), float(schedule.timesteps[i]), device=self.device)
            out = self.unet(model_in, t, cond).float()[:, :c]
            out_u, out_c = out.chunk(2)
            out = out_u + guidance * (out_c - out_u)
            state, latents = scheduler.step(schedule, state, i, latents, out, draw(i))
        return latents

    def decode(self, latents) -> np.ndarray:
        """latents [B, C, h, w] -> uint8 [B, H, W, 3] on the host, quantised
        on the device, one image at a time."""
        out = []
        for k in range(latents.shape[0]):
            pixels = self.movq.decode(latents[k:k + 1].to(self.dtype)).float()
            pixels = ((pixels + 1.0) * 127.5).clamp(0.0, 255.0).round().to(torch.uint8)
            out.append(pixels.permute(0, 2, 3, 1).cpu().numpy())
        return np.concatenate(out)

    # --- public job API ---

    @torch.inference_mode()
    def run(self, prompt: str = "", negative_prompt: str = "",
            pipeline_type: str = "KandinskyV22Pipeline", *,
            num_inference_steps: int = DEFAULT_STEPS, guidance_scale: float = DEFAULT_GUIDANCE,
            height: int | None = None, width: int | None = None,
            num_images_per_prompt: int = 1, scheduler_type: str = DEFAULT_SCHEDULER,
            prior_timesteps: int | None = None, image_embeds=None,
            negative_image_embeds=None, hint=None, image=None, strength: float | None = None,
            seed: int | None = None, registry=None, generator=None, latents=None,
            noise_fn=None, prior_latents=None, prior_noise_fn=None,
            prior_negative_latents=None, prior_negative_noise_fn=None, **kwargs):
        """One job -> (list of uint8 [H, W, 3] arrays, pipeline_config).

        Without `image_embeds` the prior (`prior_name_for` this model,
        resolved in `registry`) runs first on the prompts for
        `prior_timesteps` (25 unset) steps. `image` starts img2img at
        `strength` (0.75); `hint` conditions the depth ControlNet. The SD
        family's other arguments (`pipeline_prior_type`, `control_image`,
        ...) are not read. `latents` [N, C, h, w] and `noise_fn(i, shape)`
        replace the decoder's draws, `prior_*` the prior's."""
        if hint is None and (self.controlnet or "Controlnet" in pipeline_type):
            raise ValueError(
                "Kandinsky ControlNet requires a depth hint: schedule "
                "kandinsky-community/kandinsky-2-2-controlnet-depth with a control image "
                "(the depth estimator builds the hint).")
        if hint is not None and not self.controlnet:
            raise ValueError(
                f"{self.model_name} is not a ControlNet checkpoint; the depth hint cannot "
                "condition it (use kandinsky-community/kandinsky-2-2-controlnet-depth).")
        timings: dict[str, float] = {}
        steps = int(num_inference_steps or DEFAULT_STEPS)
        guidance = float(guidance_scale)
        n = int(num_images_per_prompt or 1)
        prior_steps = int(prior_timesteps or DEFAULT_PRIOR_STEPS)
        strength = min(max(0.75 if strength is None else float(strength), 0.0), 1.0)
        if image is not None:
            width, height = image.size
        height, width = self.canvas(height, width)
        lh, lw = height // self.latent_factor, width // self.latent_factor
        mode = "img2img" if image is not None else "txt2img"
        t_start = (min(max(int(steps * (1.0 - strength)), 0), steps - 1)
                   if image is not None else 0)
        gen = generator or torch.Generator(device=self.device).manual_seed(int(seed or 0))
        t_job = time.perf_counter()
        given = image_embeds is not None
        if not given:
            if registry is None:
                raise ValueError("a Kandinsky job without image_embeds needs the worker's "
                                 "registry to run its prior")
            t0 = time.perf_counter()
            prior = registry.get_pipeline(prior_name_for(self.model_name),
                                          allow_random_init=self.allow_random_init,
                                          pipeline_type=PRIOR_PIPELINE, keep=(self,))
            image_embeds, negative_image_embeds = prior.generate(
                prompt, negative_prompt, num_images=n, steps=prior_steps, generator=gen,
                latents=prior_latents, noise_fn=prior_noise_fn,
                negative_latents=prior_negative_latents,
                negative_noise_fn=prior_negative_noise_fn, timings=timings)
            synchronize(self.device)
            timings["prior_s"] = time.perf_counter() - t0
        embeds = _as_f32(image_embeds, self.device)
        neg = (torch.zeros_like(embeds) if negative_image_embeds is None
               else _as_f32(negative_image_embeds, self.device))
        # split-embeds jobs bring their batch in the embeds
        n = int(embeds.shape[0])
        if self.text_image:
            t0 = time.perf_counter()
            text, neg_text = self.encode_text(prompt, negative_prompt, n)
            embeds, neg = {**text, "image_embeds": embeds}, {**neg_text, "image_embeds": neg}
            synchronize(self.device)
            timings["text_encode_s"] = timings.get("text_encode_s", 0.0) + (
                time.perf_counter() - t0)

        shape = (n, self.latent_channels, lh, lw)

        def draw(i):
            if noise_fn is None:
                return torch.randn(shape, generator=gen, device=self.device)
            return _injected(noise_fn(i, shape), shape, self.device)

        start = (torch.randn(shape, generator=gen, device=self.device) if latents is None
                 else _injected(latents, shape, self.device))
        image_latents = None
        if image is not None:
            with _Timer(self.device, timings, "encode_s"):
                image_latents = self.encode_image(image, width, height, n)
        hint_lat = self.hint_latents(hint, lh, lw, n) if self.controlnet else None
        with _Timer(self.device, timings, "denoise_s"):
            out = self.denoise(start, embeds, neg, guidance, steps, scheduler_type, t_start,
                               hint_lat, draw, image_latents)
        with _Timer(self.device, timings, "decode_s"):
            pixels = self.decode(out)
        timings["unet_step_ms"] = 1000.0 * timings["denoise_s"] / max(steps - t_start, 1)
        timings["pipeline_s"] = time.perf_counter() - t_job
        config = {
            "model": self.model_name, "pipeline": pipeline_type, "scheduler": scheduler_type,
            "mode": "controlnet" if self.controlnet else mode, "steps": steps,
            "size": [width, height], "guidance_scale": guidance,
            "conditioning": self.unet_cfg.conditioning,
            "backend": f"torch-{self.device.type}", "device": device_label(self.device),
            "dtype": str(self.dtype).replace("torch.", ""), "weights": self.weights_source,
            "latents": {"finite": bool(torch.isfinite(out).all()),
                        "absmax": float(out.abs().max())},
            "timings": {k: round(v, 4) for k, v in timings.items()}}
        if given:
            config["prior"] = "given"
        return list(pixels), config
