"""Resident Flux pipeline (FLUX.1-dev and FLUX.1-schnell, and their tiny
stand-ins): rectified-flow txt2img on the MMDiT transformer, the
counterpart of chiaswarm_tpu/pipelines/flux.py on its resident path.

The bundle (the transformer, T5-XXL, CLIP-L and the 16-channel VAE, about
33.7 GB in bf16) stays on the device: each module is built on the `meta`
device, cast to the serving dtype there and only then given memory on the
device, so no f32 copy of its 12 B parameters exists on the card or the
host; random weights are drawn there in that dtype (weights.random_init_).

A job encodes its prompt with CLIP (the pooled vector) and T5 (the
context, `max_sequence_length` tokens, 512 unset, no attention mask, as
the JAX program runs it); draws its initial latents NHWC [n, h/8, w/8,
16] f32 from its generator, as the SD path draws its own; patchifies
them; runs the flow-matching Euler loop over the shifted sigmas
(`_sigma_shift`: dynamic for dev, 1 for schnell), the latents rounded to
the serving dtype once at the start and kept in f32 between steps, as
the JAX program keeps them; then the VAE decode with the uint8
quantisation on the device. Dev's distilled guidance (3.5 unset) is an
input of the transformer, not a second batch row: a job runs its images
once. `scheduler_type` is ignored: flow matching is the family's solver.
The canvas snaps down to a multiple of 16 (one 2x2 patch of latents).

`run_batched` serves a coalesced group in one padded pass: every row its
own prompt and its request's generator, padding rows the empty prompt
and zero latents, discarded before the decode. Adapter and img2img rows
are refused (the members then run alone, as in JAX).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from ..device import device_label, resolve_device, serving_dtype, synchronize
from ..models import configs as cfgs
from ..models.clip import CLIPTextEncoder
from ..models.flux import FluxTransformer, patchify, unpatchify
from ..models.t5 import T5Encoder
from ..models.tokenizer import load_tokenizer
from ..models.vae import AutoencoderKL
from ..schedulers import SchedulerConfig
from ..schedulers.solvers import FlowMatchEulerScheduler
from ..weights import FLUX_FOLDERS, find_checkpoint, load_checkpoint_, model_seed, random_init_
from .common import pad_bucket, split_by_counts
from .stable_diffusion import _Timer

logger = logging.getLogger(__name__)

SCHEDULER_NAME = "FlowMatchEulerScheduler"
DEFAULT_GUIDANCE = 3.5
MAX_SEQUENCE_LENGTH = 512


def flux_configs(model_name: str):
    """(flux_cfg, t5_cfg, clip_cfg, vae_cfg, default_size, default_steps,
    dynamic_shift), as the JAX package's `_flux_configs`: schnell (no
    guidance embedding, 4 steps, unshifted sigmas) by name, dev otherwise
    (28 steps, dynamic shift); `test/*` and `*tiny*` names the tiny
    configs at 64^2."""
    name = model_name.lower()
    schnell = "schnell" in name
    if "tiny" in name or name.startswith("test/"):
        flux = dataclasses.replace(cfgs.TINY_FLUX, guidance_embed=not schnell)
        return flux, cfgs.TINY_T5, cfgs.TINY_CLIP, cfgs.TINY_VAE, 64, 4, not schnell
    flux = dataclasses.replace(cfgs.FluxConfig(), guidance_embed=not schnell)
    return (flux, cfgs.T5Config(), cfgs.SD15_CLIP, cfgs.FLUX_VAE, 1024,
            4 if schnell else 28, not schnell)


def _sigma_shift(image_seq_len: int, dynamic: bool) -> float:
    """The flow-matching sigma shift: exp(mu), mu linear in the image
    tokens from (256, 0.5) to (4096, 1.15), for the dev family's dynamic
    shifting; 1 (unshifted) for schnell."""
    if not dynamic:
        return 1.0
    m = (1.15 - 0.5) / (4096 - 256)
    return math.exp(0.5 + m * (image_seq_len - 256))


class _HashT5Tokenizer:
    """The deterministic stand-in T5 tokenizer (tiny models, or no
    spiece.model): crc32 of each lowercased word, then EOS (1), padded
    with 0."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts: list[str], max_length: int):
        out = np.zeros((len(texts), max_length), np.int64)
        for r, text in enumerate(texts):
            ids = [zlib.crc32(w.encode()) % (self.vocab_size - 2) + 2
                   for w in text.lower().split()][: max_length - 1]
            ids.append(1)
            out[r, : len(ids)] = ids
        return out


class _SentencePieceT5Tokenizer:
    def __init__(self, model_path: Path):
        import sentencepiece

        self.sp = sentencepiece.SentencePieceProcessor(model_file=str(model_path))

    def __call__(self, texts: list[str], max_length: int):
        out = np.zeros((len(texts), max_length), np.int64)
        for r, text in enumerate(texts):
            ids = self.sp.encode(text)[: max_length - 1] + [1]  # EOS 1, PAD 0
            out[r, : len(ids)] = ids
        return out


def _load_t5_tokenizer(model_dir: Path | None, vocab_size: int):
    """sentencepiece over the model's spiece.model where both exist, else
    the hash tokenizer (the JAX package's rule)."""
    if model_dir is not None:
        for rel in ("tokenizer_2/spiece.model", "tokenizer/spiece.model", "spiece.model"):
            path = model_dir / rel
            if path.is_file():
                try:
                    return _SentencePieceT5Tokenizer(path)
                except ImportError:
                    logger.warning("sentencepiece not installed; hash T5 tokenizer")
                    break
    return _HashT5Tokenizer(vocab_size)


class FluxPipeline:
    """One Flux bundle resident on one device; serves txt2img alone and in
    coalesced passes."""

    def __init__(self, model_name: str, device=None, dtype=None,
                 allow_random_init: bool = False, model_root_dir: str | None = None):
        """The bundle loads from `<model_root_dir>/<model_name>/`
        {transformer, text_encoder_2, text_encoder, vae}, or is
        random-initialised from a seed, as the policy in weights.py says."""
        self.model_name = model_name
        self.model_root_dir = model_root_dir
        self.device = resolve_device(device)
        self.dtype = dtype or serving_dtype(self.device)
        (self.config, t5_cfg, clip_cfg, vae_cfg, self.default_size, self.default_steps,
         self.dynamic_shift) = flux_configs(model_name)
        self.latent_factor = 2 ** (len(vae_cfg.block_out_channels) - 1)
        self.latent_channels = vae_cfg.latent_channels

        model_dir = None
        if model_root_dir:
            candidate = Path(model_root_dir).expanduser() / model_name
            model_dir = candidate if candidate.is_dir() else None
        files = find_checkpoint(model_name, model_dir, FLUX_FOLDERS, allow_random_init)
        self.checkpoint = None

        t0 = time.perf_counter()
        with torch.device("meta"):
            modules = {"flux": FluxTransformer(self.config), "t5": T5Encoder(t5_cfg),
                       "clip": CLIPTextEncoder(clip_cfg), "vae": AutoencoderKL(vae_cfg)}
        modules = {key: self._materialise(m) for key, m in modules.items()}
        self.transformer, self.t5 = modules["flux"], modules["t5"]
        self.clip, self.vae = modules["clip"], modules["vae"]
        if files is not None:
            t_load = time.perf_counter()
            nbytes = 0
            for folder, key in zip(FLUX_FOLDERS, ("flux", "t5", "clip", "vae")):
                nbytes += load_checkpoint_(modules[key], files[folder], folder,
                                           text_layers=clip_cfg.num_layers
                                           if key == "clip" else None)
            synchronize(self.device)
            self.checkpoint = {"dir": str(model_dir), "bytes": nbytes,
                               "load_s": time.perf_counter() - t_load}
            self.weights_source = "checkpoint"
        else:
            gen = torch.Generator(device=self.device).manual_seed(model_seed(model_name))
            for module in modules.values():
                random_init_(module, gen)
            self.weights_source = "random"
        self.vae.to(memory_format=torch.channels_last)
        self.clip_tokenizer = load_tokenizer(model_dir, clip_cfg.vocab_size)
        self.t5_tokenizer = _load_t5_tokenizer(model_dir, t5_cfg.vocab_size)
        synchronize(self.device)
        logger.info("%s resident on %s in %.1fs (dtype=%s, weights=%s)", model_name,
                    device_label(self.device), time.perf_counter() - t0, self.dtype,
                    self.weights_source)

    def _materialise(self, module):
        # cast on the meta device first: the device memory is then given in
        # the serving dtype at once
        module = module.to(self.dtype).to_empty(device=self.device)
        return module.eval().requires_grad_(False)

    def release(self) -> int:
        """Nothing per job is kept resident beside the bundle. -> 0 bytes."""
        return 0

    # --- stages ---

    def canvas(self, height, width) -> tuple[int, int]:
        """The canvas snapped down to whole 2x2 patches of latents (16 px)."""
        snap = self.latent_factor * 2
        return tuple(max(snap, (int(d or self.default_size) // snap) * snap)
                     for d in (height, width))

    def encode_prompts(self, prompts: list[str], max_sequence_length: int):
        """-> (T5 context [B, L, 4096], CLIP pooled [B, 768])."""
        clip_ids = torch.from_numpy(self.clip_tokenizer(prompts).astype(np.int64))
        t5_ids = torch.from_numpy(self.t5_tokenizer(prompts, max_sequence_length))
        pooled = self.clip(clip_ids.to(self.device))["pooled"]
        return self.t5(t5_ids.to(self.device)), pooled

    def _latents(self, value, shape) -> torch.Tensor:
        """Injected NHWC latents (numpy or tensor) as f32 on the device."""
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value, dtype=np.float32))
        value = value.to(self.device, torch.float32)
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"latents {tuple(value.shape)} != {tuple(shape)}")
        return value

    def denoise(self, latents, context, pooled, guidance: float, steps: int):
        """The flow-matching Euler loop over NHWC f32 latents -> the final
        NHWC latents (f32)."""
        b, lh, lw, _ = latents.shape
        shift = _sigma_shift((lh // 2) * (lw // 2), self.dynamic_shift)
        scheduler = FlowMatchEulerScheduler(SchedulerConfig(prediction_type="flow",
                                                            shift=shift))
        schedule = scheduler.schedule(steps)
        img, img_ids = patchify(latents.to(self.dtype))
        img = img.float()
        txt_ids = torch.zeros((b, context.shape[1], 3), dtype=torch.int32, device=self.device)
        g = torch.full((b,), float(guidance), device=self.device)
        for i in range(steps):
            t = torch.full((b,), float(schedule.sigmas[i]), device=self.device)
            velocity = self.transformer(img.to(self.dtype), img_ids, context, txt_ids, t,
                                        pooled, guidance=g).float()
            _, img = scheduler.step(schedule, (), i, img, velocity)
        return unpatchify(img, lh, lw)

    def decode(self, latents) -> np.ndarray:
        """NHWC latents -> uint8 [B, H, W, 3] on the host, quantised on the
        device; one image at a time from 768^2 up, so the VAE's
        activations stay those of one image."""
        lh, lw = latents.shape[1:3]
        step = 1 if lh * lw >= 9216 else latents.shape[0]
        out = []
        for k in range(0, latents.shape[0], step):
            z = latents[k:k + step].to(self.dtype).permute(0, 3, 1, 2)
            pixels = self.vae.decode(z.contiguous(memory_format=torch.channels_last)).float()
            pixels = ((pixels + 1.0) * 127.5).clamp(0.0, 255.0).round().to(torch.uint8)
            out.append(pixels.permute(0, 2, 3, 1).cpu().numpy())
        return np.concatenate(out)

    def _stamp(self, pipeline_type: str, steps: int, width: int, height: int,
               guidance: float, max_sequence_length: int) -> dict:
        return {"model": self.model_name, "pipeline": pipeline_type,
                "scheduler": SCHEDULER_NAME, "mode": "txt2img", "steps": steps,
                "size": [width, height], "guidance_scale": guidance,
                "max_sequence_length": max_sequence_length,
                "backend": f"torch-{self.device.type}", "device": device_label(self.device),
                "dtype": str(self.dtype).replace("torch.", ""), "weights": self.weights_source}

    # --- public job API ---

    @torch.inference_mode()
    def run(self, prompt: str = "", negative_prompt: str = "",
            pipeline_type: str = "FluxPipeline", *, num_inference_steps: int | None = None,
            guidance_scale: float = DEFAULT_GUIDANCE, height: int | None = None,
            width: int | None = None, num_images_per_prompt: int = 1,
            max_sequence_length: int = MAX_SEQUENCE_LENGTH, seed: int | None = None,
            latents=None, **kwargs):
        """One job -> (list of uint8 [H, W, 3] arrays, pipeline_config).
        `negative_prompt`, `scheduler_type` and the SD family's other
        arguments are not read, as in the JAX pipeline. `latents` [n, h/8,
        w/8, 16] (NHWC) replaces the initial draw from the job's seed."""
        timings: dict[str, float] = {}
        steps = int(num_inference_steps or self.default_steps)
        guidance = float(guidance_scale)
        n = int(num_images_per_prompt)
        max_seq = int(max_sequence_length)
        height, width = self.canvas(height, width)
        lh, lw = height // self.latent_factor, width // self.latent_factor
        t_job = time.perf_counter()
        with _Timer(self.device, timings, "text_encode_s"):
            context, pooled = self.encode_prompts([prompt] * n, max_seq)
        shape = (n, lh, lw, self.latent_channels)
        gen = torch.Generator(device=self.device).manual_seed(int(seed or 0))
        latents = (torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
                   if latents is None else self._latents(latents, shape))
        with _Timer(self.device, timings, "denoise_s"):
            latents = self.denoise(latents, context, pooled, guidance, steps)
        with _Timer(self.device, timings, "decode_s"):
            pixels = self.decode(latents)
        timings["transformer_step_ms"] = 1000.0 * timings["denoise_s"] / steps
        timings["pipeline_s"] = time.perf_counter() - t_job
        config = {**self._stamp(pipeline_type, steps, width, height, guidance, max_seq),
                  "latents": {"finite": bool(torch.isfinite(latents).all()),
                              "absmax": float(latents.abs().max())},
                  "timings": {k: round(v, 4) for k, v in timings.items()}}
        return list(pixels), config

    @torch.inference_mode()
    def run_batched(self, requests: list[dict], *, height: int | None = None,
                    width: int | None = None, num_inference_steps: int | None = None,
                    guidance_scale: float = DEFAULT_GUIDANCE,
                    pipeline_type: str = "FluxPipeline", latents=None, **_shared):
        """A coalesced txt2img group in one padded pass -> [(images,
        pipeline_config)], one per request, in order. `requests`:
        [{"prompt", "seed", "num_images_per_prompt"}]; what the group
        shares comes as keywords (the SD family's extra ones are not read).
        Each request's rows are its generator's first draw, as its solo
        `run` draws them, so a row does not depend on its batchmates;
        padding rows are zeros with the empty prompt. `latents` [padded,
        h/8, w/8, 16] injects the whole draw. A request with an adapter or
        a start image raises ValueError (its members then run alone)."""
        if any(r.get("lora") for r in requests):
            raise ValueError("flux adapters serve on the single path")
        if any(r.get("image") is not None for r in requests):
            raise ValueError("flux has no coalesced img2img variant")
        timings: dict[str, float] = {}
        steps = int(num_inference_steps or self.default_steps)
        guidance = float(guidance_scale)
        height, width = self.canvas(height, width or height)
        lh, lw = height // self.latent_factor, width // self.latent_factor
        counts = [max(int(r.get("num_images_per_prompt", 1) or 1), 1) for r in requests]
        total = sum(counts)
        padded = pad_bucket(total)
        t_job = time.perf_counter()
        with _Timer(self.device, timings, "text_encode_s"):
            prompts = [p for r, n in zip(requests, counts) for p in [r.get("prompt") or ""] * n]
            context, pooled = self.encode_prompts(prompts + [""] * (padded - total),
                                                  MAX_SEQUENCE_LENGTH)
        shape = (padded, lh, lw, self.latent_channels)
        if latents is None:
            blocks = [torch.randn((n, *shape[1:]), dtype=torch.float32, device=self.device,
                                  generator=torch.Generator(device=self.device).manual_seed(
                                      int(r.get("seed") or 0)))
                      for r, n in zip(requests, counts)]
            blocks.append(torch.zeros((padded - total, *shape[1:]), device=self.device))
            latents = torch.cat(blocks)
        else:
            latents = self._latents(latents, shape)
        with _Timer(self.device, timings, "denoise_s"):
            latents = self.denoise(latents, context, pooled, guidance, steps)
        real = latents[:total]
        with _Timer(self.device, timings, "decode_s"):
            pixels = self.decode(real)
        timings["transformer_step_ms"] = 1000.0 * timings["denoise_s"] / steps
        timings["pipeline_s"] = time.perf_counter() - t_job
        shared = {**self._stamp(pipeline_type, steps, width, height, guidance,
                                MAX_SEQUENCE_LENGTH),
                  "batched_with": len(requests), "padded_rows": padded}
        results, offset = [], 0
        for n, images, rows in zip(counts, split_by_counts(list(pixels), counts),
                                   real.split(counts)):
            results.append((images, {**shared, "batch_rows": [offset, n],
                                     "latents": {"finite": bool(torch.isfinite(rows).all()),
                                                 "absmax": float(rows.abs().max())},
                                     "timings": {k: round(v, 4) for k, v in timings.items()}}))
            offset += n
        return results
