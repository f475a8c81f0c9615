"""Stable Cascade (Wuerstchen v3): the prior (stage C), the latent decoder
(stage B) and the Paella VQ decode (stage A), the counterpart of
chiaswarm_tpu/pipelines/cascade.py.

`CascadePriorPipeline` (StableCascadePriorPipeline) denoises stage C's
16-channel latent, about 1/42.67 of the canvas a side, under the
ratio-space Wuerstchen DDPM with the CFG rows [negative | prompt] in one
batch (20 steps, guidance 4.0 unset), conditioned on CLIP-bigG's states
before the final LayerNorm and its pooled projection through the masked
encode (`attention_mask`: keep through the first EOS, the states zeroed
past it), and a zero image embedding. The hive schedules the prior as the
main pipeline: its `run` resolves, and weight-checks, the decoder that
the job's `decoder` dict names (model_name, pipeline_type,
num_inference_steps) before its own denoise, then hands it the embeddings.

`CascadePipeline` (StableCascadeDecoderPipeline, StableCascadeCombinedPipeline)
turns `image_embeddings` into pixels: 10 unguided stage-B steps on a
latent grid that follows stage C's (2 * (int(side * 10.67) // 2), as the
JAX package truncates it), conditioned on the embeddings through
`effnet_mapper` and on the pooled text alone, then the Paella decode of
the latents times its scale factor, clamped to [0, 1]. A job with only a
prompt (a combined job) runs the prior first, in the worker's registry,
which keeps the decoder resident meanwhile: the job's steps (or
`prior_timesteps`) and guidance steer the prior, and the decoder keeps
its 10 unguided steps.

`cascade_checkpoint` is the one reading of a repo: a prior repo holds
`prior/` and `text_encoder/`, a decoder repo `decoder/`, `text_encoder/`
and `vqgan/`; each UNet's geometry comes off its checkpoint (config.json
for what shapes cannot say), CLIP's from text_encoder/config.json. A
pipeline pointed at the other stage's repo raises MissingWeightsError.
`verify_cascade` holds the same files against the same modules on the
meta device for the setup CLI's `--check`.

Noise: drawn from the job's generator, in order the prior's start latents
and steps, then the decoder's; a test hands each stage JAX's
(`prior_latents`, `prior_noise_fn`, `latents`, `noise_fn`). Timings:
`prior_s`, `text_encode_s`, `denoise_s`, `decode_s`, `unet_step_ms`.
"""

from __future__ import annotations

import logging
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..device import device_label, resolve_device, serving_dtype, synchronize
from ..models import configs as cfgs
from ..models.cascade_unet import StableCascadeUNet
from ..models.clip import CLIPTextConfig, CLIPTextEncoder
from ..models.paella_vq import PaellaVQDecoder
from ..models.tokenizer import load_tokenizer
from ..schedulers import get_scheduler
from ..weights import (
    CASCADE_DECODER_FOLDERS,
    CASCADE_PRIOR_FOLDERS,
    MissingWeightsError,
    check_checkpoint,
    checkpoint_files,
    checkpoint_shapes,
    find_checkpoint,
    infer_cascade_unet_config,
    infer_paella_vq_config,
    is_test_model,
    load_checkpoint_,
    model_seed,
    random_init_,
)
from .kandinsky import _config_json, _injected, _model_dir, _Module
from .stable_diffusion import _Timer

logger = logging.getLogger(__name__)

PRIOR_PIPELINE = "StableCascadePriorPipeline"
DECODER_PIPELINE = "StableCascadeDecoderPipeline"
SCHEDULER = "DDPMWuerstchenScheduler"
# diffusers' pipeline constants: stage C's compression (1024 -> 24), the
# stage-C-to-stage-B grid scale (24 -> 256)
PRIOR_COMPRESSION = 42.67
LATENT_DIM_SCALE = 10.67
DEFAULT_PRIOR_STEPS = 20
DEFAULT_PRIOR_GUIDANCE = 4.0
DECODER_STEPS = 10


def decoder_name_for(prior_name: str) -> str:
    """The decoder a prior's job chains into, as the JAX package names it."""
    if is_test_model(prior_name):
        return "test/tiny-cascade"
    if "prior" in prior_name:
        return prior_name.replace("-prior", "")
    return "stabilityai/stable-cascade"


def prior_name_for(decoder_name: str) -> str:
    """The prior a combined job runs first."""
    if is_test_model(decoder_name):
        return "test/tiny-cascade-prior"
    return decoder_name + "-prior"


def clip_config_from_json(tj: dict | None) -> CLIPTextConfig:
    """CLIPTextModelWithProjection's geometry (laion bigG unset), with
    Stable Cascade's reading: the states before the final LayerNorm."""
    tj = tj or {}
    return CLIPTextConfig(
        vocab_size=int(tj.get("vocab_size", 49408)), hidden_size=int(tj.get("hidden_size", 1280)),
        num_layers=int(tj.get("num_hidden_layers", 32)),
        num_heads=int(tj.get("num_attention_heads", 20)),
        max_positions=int(tj.get("max_position_embeddings", 77)),
        hidden_act=str(tj.get("hidden_act", "gelu")),
        projection_dim=int(tj.get("projection_dim", 1280)), apply_final_norm=False)


def stage_configs(model_name: str, stage: str):
    """(unet_cfg, clip_cfg, vq_cfg or None, default_size) by name, before a
    checkpoint's geometry replaces them: the tiny stand-ins at 64^2, else
    the published stage at 1024^2."""
    tiny = is_test_model(model_name)
    if stage == "prior":
        return ((cfgs.TINY_CASCADE_C if tiny else cfgs.CASCADE_STAGE_C),
                cfgs.TINY_CASCADE_CLIP if tiny else clip_config_from_json(None), None,
                64 if tiny else 1024)
    return ((cfgs.TINY_CASCADE_B if tiny else cfgs.CASCADE_STAGE_B),
            cfgs.TINY_CASCADE_CLIP if tiny else clip_config_from_json(None),
            cfgs.TINY_PAELLA_VQ if tiny else cfgs.PaellaVQConfig(), 64 if tiny else 1024)


def _repo_stage(model_name: str, model_dir: Path, stage: str | None = None) -> str:
    """"prior" or "decoder", the kind of repo `model_dir` holds; a repo of
    the other stage than `stage` raises MissingWeightsError."""
    found = "prior" if (model_dir / "prior").is_dir() else "decoder"
    if stage is not None and stage != found and (model_dir / found).is_dir():
        raise MissingWeightsError(
            f"'{model_name}' is a Stable Cascade {found} repo but this pipeline serves the "
            f"{stage} stage: point the job at the matching repo (prior jobs chain the decoder "
            "through the `decoder` parameter).")
    return found


def cascade_checkpoint(model_name: str, model_dir: Path, stage: str | None = None,
                       files: dict | None = None) -> dict:
    """The one reading of a Stable Cascade repo: {"stage": "prior" or
    "decoder", "files": {folder: safetensors}, "unet_cfg", "clip_cfg"[,
    "vq_cfg"]}. `stage` pins the kind of repo the caller serves: the other
    stage's repo raises MissingWeightsError; a folder without safetensors
    raises FileNotFoundError."""
    found = _repo_stage(model_name, model_dir, stage)
    folders = CASCADE_PRIOR_FOLDERS if found == "prior" else CASCADE_DECODER_FOLDERS
    files = files or checkpoint_files(model_dir, folders)
    out = {"stage": found, "files": files,
           "unet_cfg": infer_cascade_unet_config(checkpoint_shapes(files[found]),
                                                 _config_json(model_dir / found / "config.json")),
           "clip_cfg": clip_config_from_json(
               _config_json(model_dir / "text_encoder" / "config.json"))}
    if found == "decoder":
        out["vq_cfg"] = infer_paella_vq_config(checkpoint_shapes(files["vqgan"]),
                                               _config_json(model_dir / "vqgan" / "config.json"))
    return out


def cascade_modules(unet_cfg, clip_cfg, vq_cfg=None) -> dict:
    """{component: module} of one stage, on the current default device."""
    modules = {"unet": StableCascadeUNet(unet_cfg), "text": CLIPTextEncoder(clip_cfg)}
    if vq_cfg is not None:
        modules["vqgan"] = PaellaVQDecoder(vq_cfg)
    return modules


def verify_cascade(model_name: str, model_dir: Path) -> dict:
    """`--check` of a prior or decoder repo against the modules the worker
    would load, built on the meta device -> {component: parameters}."""
    found = cascade_checkpoint(model_name, model_dir)
    with torch.device("meta"):
        modules = cascade_modules(found["unet_cfg"], found["clip_cfg"], found.get("vq_cfg"))
    folders = {"unet": found["stage"], "text": "text_encoder", "vqgan": "vqgan"}
    return {name: check_checkpoint(module, found["files"][folders[name]], folders[name])
            for name, module in modules.items()}


def attention_mask(ids: np.ndarray, eos_id: int) -> np.ndarray:
    """1 through the first EOS, 0 for the padding after it (the tokenizer
    pads with EOS)."""
    first_eos = np.argmax(ids == eos_id, axis=-1)
    return (np.arange(ids.shape[1])[None] <= first_eos[:, None]).astype(np.int64)


class _CascadeStage(_Module):
    """A stage's construction: its repo through `cascade_checkpoint` (or
    `weights`, or a seeded random init), the modules materialised in the
    serving dtype, CLIP's masked encode."""

    stage = "prior"

    def __init__(self, model_name: str, device=None, dtype=None,
                 allow_random_init: bool = False, model_root_dir: str | None = None,
                 weights: dict | None = None):
        """The stage loads from `<model_root_dir>/<model_name>/`, or from
        `weights` {"unet", "text"[, "vqgan"]: state dicts, "unet_cfg",
        "clip_cfg"[, "vq_cfg"]}, or is random-initialised from a seed."""
        self.model_name = model_name
        self.model_root_dir = model_root_dir
        self.allow_random_init = allow_random_init
        self.device = resolve_device(device)
        self.dtype = dtype or serving_dtype(self.device)
        unet_cfg, clip_cfg, vq_cfg, self.default_size = stage_configs(model_name, self.stage)
        model_dir = _model_dir(model_name, model_root_dir)
        folders = CASCADE_PRIOR_FOLDERS if self.stage == "prior" else CASCADE_DECODER_FOLDERS
        if weights is None and model_dir is not None:
            _repo_stage(model_name, model_dir, self.stage)  # the other stage's repo fails here
        files = None if weights is not None else find_checkpoint(
            model_name, model_dir, folders, allow_random_init)
        if weights is not None:
            unet_cfg = weights.get("unet_cfg", unet_cfg)
            clip_cfg = weights.get("clip_cfg", clip_cfg)
            vq_cfg = weights.get("vq_cfg", vq_cfg)
        elif files is not None:
            found = cascade_checkpoint(model_name, model_dir, self.stage, files)
            unet_cfg, clip_cfg, vq_cfg = found["unet_cfg"], found["clip_cfg"], found.get("vq_cfg")
        self.unet_cfg, self.clip_cfg, self.vq_cfg = unet_cfg, clip_cfg, vq_cfg
        t0 = time.perf_counter()
        with torch.device("meta"):
            modules = cascade_modules(unet_cfg, clip_cfg, vq_cfg)
        modules = {k: self._materialise(m) for k, m in modules.items()}
        self.unet, self.text_encoder = modules["unet"], modules["text"]
        self.vqgan = modules.get("vqgan")
        self.checkpoint = None
        if weights is not None:
            for name, module in modules.items():
                module.load_state_dict(weights[name])
            self.weights_source = "given"
        elif files is not None:
            t_load = time.perf_counter()
            where = {"unet": self.stage, "text": "text_encoder", "vqgan": "vqgan"}
            nbytes = sum(load_checkpoint_(module, files[where[name]], where[name])
                         for name, module in modules.items())
            synchronize(self.device)
            self.checkpoint = {"dir": str(model_dir), "bytes": nbytes,
                               "load_s": time.perf_counter() - t_load}
            self.weights_source = "checkpoint"
        else:
            gen = torch.Generator(device=self.device).manual_seed(model_seed(model_name))
            for module in modules.values():
                random_init_(module, gen)
            self.weights_source = "random"
        self.tokenizer = load_tokenizer(model_dir if files is not None else None,
                                        vocab_size=clip_cfg.vocab_size)
        for module in modules.values():
            module.to(memory_format=torch.channels_last)
        synchronize(self.device)
        logger.info("%s (Cascade %s) resident on %s in %.1fs (dtype=%s, weights=%s)",
                    model_name, self.stage, device_label(self.device),
                    time.perf_counter() - t0, self.dtype, self.weights_source)

    def encode_text(self, texts: list[str]):
        """The masked CLIP encode -> (states [B, S, D] zeroed past the first
        EOS, pooled projection [B, 1, P])."""
        ids = np.asarray(self.tokenizer(texts), np.int64)
        mask = torch.from_numpy(attention_mask(ids, self.clip_cfg.vocab_size - 1)).to(self.device)
        out = self.text_encoder(torch.from_numpy(ids).to(self.device), attention_mask=mask)
        states = out["hidden_states"] * mask[:, :, None].to(out["hidden_states"].dtype)
        return states, out["pooled"][:, None, :]

    def _drawers(self, shape, generator, latents, noise_fn):
        def draw(i):
            if noise_fn is None:
                return torch.randn(shape, generator=generator, device=self.device)
            return _injected(noise_fn(i, shape), shape, self.device)

        start = (torch.randn(shape, generator=generator, device=self.device) if latents is None
                 else _injected(latents, shape, self.device))
        return start, draw


class CascadePriorPipeline(_CascadeStage):
    """The resident stage C: a prompt -> `image_embeddings`; as the main
    pipeline of a job it chains into its decoder."""

    stage = "prior"

    def grid(self, height, width) -> tuple[int, int]:
        """Stage C's latent grid for a canvas (8 a side for the tiny
        stand-ins' compression, 42.67 published), at least 4."""
        compression = 8.0 if is_test_model(self.model_name) else PRIOR_COMPRESSION
        return tuple(max(4, math.ceil(int(d or self.default_size) / compression))
                     for d in (height, width))

    @torch.inference_mode()
    def generate(self, prompt: str, negative_prompt: str = "", num_images: int = 1,
                 steps: int = DEFAULT_PRIOR_STEPS, guidance_scale: float = DEFAULT_PRIOR_GUIDANCE,
                 height: int | None = None, width: int | None = None, generator=None,
                 latents=None, noise_fn=None, timings: dict | None = None):
        """-> image_embeddings [N, 16, ch, cw] f32 (stage C's latents)."""
        n, steps = int(num_images), int(steps)
        ch, cw = self.grid(height, width)
        gen = generator or torch.Generator(device=self.device).manual_seed(0)
        shape = (n, self.unet_cfg.in_channels, ch, cw)
        x, draw = self._drawers(shape, gen, latents, noise_fn)
        t0 = time.perf_counter()
        hiddens, pooled = self.encode_text([negative_prompt or ""] * n + [prompt or ""] * n)
        if timings is not None:
            synchronize(self.device)
            timings["text_encode_s"] = timings.get("text_encode_s", 0.0) + (
                time.perf_counter() - t0)
        scheduler = get_scheduler(SCHEDULER)
        schedule = scheduler.schedule(steps)
        clip_img = torch.zeros((2 * n, 1, self.unet_cfg.clip_image_in_channels),
                               device=self.device, dtype=self.dtype)
        for i in range(steps):
            r = torch.full((2 * n,), float(schedule.timesteps[i]), device=self.device)
            pred = self.unet(torch.cat([x, x]).to(self.dtype), r, pooled, clip_text=hiddens,
                             clip_img=clip_img).float()
            pred_u, pred_c = pred.chunk(2)
            pred = pred_u + float(guidance_scale) * (pred_c - pred_u)
            _, x = scheduler.step(schedule, (), i, x, pred, draw(i))
        return x

    @torch.inference_mode()
    def run(self, prompt: str = "", negative_prompt: str = "",
            pipeline_type: str = PRIOR_PIPELINE, *,
            num_inference_steps: int = DEFAULT_PRIOR_STEPS,
            guidance_scale: float = DEFAULT_PRIOR_GUIDANCE, num_images_per_prompt: int = 1,
            height: int | None = None, width: int | None = None, decoder: dict | None = None,
            seed: int | None = None, registry=None, generator=None, latents=None, noise_fn=None,
            decoder_latents=None, decoder_noise_fn=None, **kwargs):
        """A prior-as-main job -> the decoder's (images, pipeline_config)
        with `prior` stamped. The decoder named by `decoder`
        ({"model_name", "pipeline_type", "num_inference_steps"}; this
        prior's own decoder unset, always for a tiny stand-in) is built in
        `registry` before the prior's denoise. `latents` / `noise_fn`
        replace the prior's draws, `decoder_*` the decoder's."""
        if registry is None:
            raise ValueError("a Stable Cascade prior job needs the worker's registry to build "
                             "its decoder")
        decoder = decoder or {}
        steps = int(num_inference_steps or DEFAULT_PRIOR_STEPS)
        guidance = float(DEFAULT_PRIOR_GUIDANCE if guidance_scale is None else guidance_scale)
        n = int(num_images_per_prompt or 1)
        gen = generator or torch.Generator(device=self.device).manual_seed(int(seed or 0))
        name = decoder.get("model_name", decoder_name_for(self.model_name))
        if is_test_model(self.model_name):
            name = decoder_name_for(self.model_name)  # tiny jobs stay hermetic
        decoder_pipe = registry.get_pipeline(
            name, allow_random_init=self.allow_random_init,
            pipeline_type=decoder.get("pipeline_type", DECODER_PIPELINE), keep=(self,))
        timings: dict[str, float] = {}
        t0 = time.perf_counter()
        embeds = self.generate(prompt, negative_prompt, n, steps, guidance, height, width,
                               generator=gen, latents=latents, noise_fn=noise_fn,
                               timings=timings)
        synchronize(self.device)
        timings["prior_s"] = time.perf_counter() - t0
        images, config = decoder_pipe.run(
            prompt, image_embeddings=embeds,
            num_inference_steps=int(decoder.get("num_inference_steps", DECODER_STEPS)),
            height=height, width=width, generator=gen, latents=decoder_latents,
            noise_fn=decoder_noise_fn)
        config["prior"] = {"model": self.model_name, "pipeline": pipeline_type, "steps": steps,
                           "guidance_scale": guidance}
        # both stages' CLIP encodes, the prior's stage time beside the decoder's
        decoder_text_s = config["timings"].get("text_encode_s", 0.0)
        config["timings"].update({k: round(v, 4) for k, v in timings.items()})
        config["timings"]["text_encode_s"] = round(timings["text_encode_s"] + decoder_text_s, 4)
        return images, config


class CascadePipeline(_CascadeStage):
    """The resident stage B and Paella VQ: `image_embeddings` -> pixels,
    running the prior first for a job with only a prompt."""

    stage = "decoder"

    def latent_grid(self, eh: int, ew: int) -> tuple[int, int]:
        """Stage B's latent grid from stage C's, truncated as the JAX
        package does (24 -> 256 published; x2 for the tiny stand-ins)."""
        scale = 2.0 if is_test_model(self.model_name) else LATENT_DIM_SCALE
        return tuple(2 * (int(d * scale) // 2) for d in (eh, ew))

    def denoise(self, x, embeds, pooled, steps: int, draw):
        """The unguided stage-B loop over NCHW f32 latents."""
        scheduler = get_scheduler(SCHEDULER)
        schedule = scheduler.schedule(steps)
        effnet = embeds.to(self.dtype)
        for i in range(steps):
            r = torch.full((x.shape[0],), float(schedule.timesteps[i]), device=self.device)
            pred = self.unet(x.to(self.dtype), r, pooled, effnet=effnet).float()
            _, x = scheduler.step(schedule, (), i, x, pred, draw(i))
        return x

    def decode(self, latents) -> np.ndarray:
        """Stage B's latents -> uint8 [B, H, W, 3] on the host (the Paella
        decode of latents x scale_factor, [0, 1] to 255), one image at a
        time."""
        out = []
        for k in range(latents.shape[0]):
            x = (latents[k:k + 1] * self.vq_cfg.scale_factor).to(self.dtype)
            pixels = (self.vqgan(x).float() * 255.0).clamp(0.0, 255.0).round().to(torch.uint8)
            out.append(pixels.permute(0, 2, 3, 1).cpu().numpy())
        return np.concatenate(out)

    @torch.inference_mode()
    def run(self, prompt: str = "", negative_prompt: str = "",
            pipeline_type: str = DECODER_PIPELINE, *, num_inference_steps: int = DECODER_STEPS,
            num_images_per_prompt: int = 1, height: int | None = None, width: int | None = None,
            guidance_scale: float | None = None, prior_timesteps: int | None = None,
            image_embeddings=None, seed: int | None = None, registry=None, generator=None,
            latents=None, noise_fn=None, prior_latents=None, prior_noise_fn=None, **kwargs):
        """One job -> (list of uint8 [H, W, 3] arrays, pipeline_config).
        Without `image_embeddings` the prior (`prior_name_for` this model,
        in `registry`) runs first for `prior_timesteps` or the job's steps
        at the job's guidance (4.0 unset), and stage B keeps its 10 steps.
        `latents` [N, 4, h, w] and `noise_fn` replace stage B's draws,
        `prior_*` the prior's."""
        timings: dict[str, float] = {}
        steps = int(num_inference_steps or DECODER_STEPS)
        n = int(num_images_per_prompt or 1)
        height, width = (max(64, (int(d or self.default_size) // 64) * 64)
                         for d in (height, width))
        gen = generator or torch.Generator(device=self.device).manual_seed(int(seed or 0))
        t_job = time.perf_counter()
        if image_embeddings is None:
            if registry is None:
                raise ValueError("a Stable Cascade job without image_embeddings needs the "
                                 "worker's registry to run its prior")
            t0 = time.perf_counter()
            prior = registry.get_pipeline(prior_name_for(self.model_name),
                                          allow_random_init=self.allow_random_init,
                                          pipeline_type=PRIOR_PIPELINE, keep=(self,))
            image_embeddings = prior.generate(
                prompt, negative_prompt, n, int(prior_timesteps or steps),
                DEFAULT_PRIOR_GUIDANCE if guidance_scale is None else float(guidance_scale),
                height, width, generator=gen, latents=prior_latents, noise_fn=prior_noise_fn,
                timings=timings)
            steps = DECODER_STEPS
            synchronize(self.device)
            timings["prior_s"] = time.perf_counter() - t0
        embeds = (image_embeddings if isinstance(image_embeddings, torch.Tensor)
                  else torch.from_numpy(np.asarray(image_embeddings, np.float32)))
        embeds = embeds.to(self.device, torch.float32)
        n = int(embeds.shape[0])
        lh, lw = self.latent_grid(int(embeds.shape[2]), int(embeds.shape[3]))
        shape = (n, self.unet_cfg.in_channels, lh, lw)
        x, draw = self._drawers(shape, gen, latents, noise_fn)
        t0 = time.perf_counter()
        _, pooled = self.encode_text([prompt or ""] * n)
        synchronize(self.device)
        timings["text_encode_s"] = timings.get("text_encode_s", 0.0) + (time.perf_counter() - t0)
        with _Timer(self.device, timings, "denoise_s"):
            out = self.denoise(x, embeds, pooled, steps, draw)
        with _Timer(self.device, timings, "decode_s"):
            pixels = self.decode(out)
        timings["unet_step_ms"] = 1000.0 * timings["denoise_s"] / max(steps, 1)
        timings["pipeline_s"] = time.perf_counter() - t_job
        config = {
            "model": self.model_name, "pipeline": pipeline_type, "scheduler": SCHEDULER,
            "mode": "txt2img", "steps": steps,
            "size": [int(pixels.shape[2]), int(pixels.shape[1])],
            "backend": f"torch-{self.device.type}", "device": device_label(self.device),
            "dtype": str(self.dtype).replace("torch.", ""), "weights": self.weights_source,
            "latents": {"finite": bool(torch.isfinite(out).all()),
                        "absmax": float(out.abs().max())},
            "timings": {k: round(v, 4) for k, v in timings.items()}}
        return list(pixels), config
