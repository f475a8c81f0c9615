"""Kandinsky 3: single-stage T5-conditioned latent diffusion, the
counterpart of chiaswarm_tpu/pipelines/kandinsky3.py.

No prior stage: the prompt conditions `Kandinsky3UNet` directly through
FLAN-UL2's T5 encoder, 128 tokens with a 1-keep mask (position 0 always
kept, so an empty prompt keeps its EOS) that reaches the UNet's
cross-attention and its attention pooling; the padded positions of the T5
states are zeroed before the UNet, as diffusers' encode_prompt does. The
CFG rows [negative | prompt] run as one batch of two per image. DDPM, 25
steps and guidance 3.0 unset, a 1024^2 canvas (64^2 for the tiny
stand-ins), floored to a multiple of 64. img2img encodes its start image
through MoVQ and noises it to the strength's step. The pixels come out of
the port's MoVQ decode.

`k3_checkpoint` is the one recipe that reads a Kandinsky 3 directory
(`unet/`, `movq/`, `text_encoder/`, each folder's config.json; the UNet's
geometry off its checkpoint's shapes, T5's through
`t5_config_from_json`): serving loads what it names and the setup CLI's
`--check` holds the same files against the same modules on the meta
device (`verify_k3`), so a green check means what the worker loads.

Noise: the port draws from the job's generator, the start latents first,
then one draw a step; a test hands it JAX's (`latents`, `noise_fn`).
Timings: `text_encode_s`, `denoise_s`, `decode_s` (JAX has one
`denoise_decode_s`; the difference decided in PR 14), `encode_s` for
img2img, `unet_step_ms`, `pipeline_s`.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..device import device_label, resolve_device, serving_dtype, synchronize
from ..models import configs as cfgs
from ..models.movq import MoVQ
from ..models.t5 import T5Encoder
from ..models.unet_kandinsky3 import Kandinsky3UNet
from ..schedulers import get_scheduler
from ..weights import (
    KANDINSKY3_FOLDERS,
    check_checkpoint,
    checkpoint_files,
    checkpoint_shapes,
    find_checkpoint,
    infer_k3_unet_config,
    is_test_model,
    load_checkpoint_,
    load_movq_,
    model_seed,
    movq_optional,
    random_init_,
)
from .flux import _load_t5_tokenizer
from .kandinsky import _config_json, _injected, _model_dir, _Module
from .stable_diffusion import _pil_to_array, _Timer

logger = logging.getLogger(__name__)

DEFAULT_STEPS = 25
DEFAULT_GUIDANCE = 3.0
DEFAULT_SCHEDULER = "DDPMScheduler"
# the diffusers pipeline tokenizes to 128 T5 tokens (16 for the tiny stand-ins)
MAX_TOKENS = 128
TINY_MAX_TOKENS = 16


def k3_configs(model_name: str):
    """(unet_cfg, movq_cfg, t5_cfg, default_size) by name, before a
    checkpoint's own geometry replaces them: the tiny stand-ins at 64^2,
    else the published model at 1024^2."""
    if is_test_model(model_name):
        return cfgs.TINY_K3_UNET, cfgs.TINY_MOVQ, cfgs.TINY_T5, 64
    return cfgs.K3UNetConfig(), cfgs.MoVQConfig(), cfgs.FLAN_UL2_T5, 1024


def k3_checkpoint(model_dir: Path, files: dict | None = None) -> dict:
    """The one reading of a Kandinsky 3 directory: {"files": {folder:
    safetensors}, "unet_cfg", "movq_cfg", "t5_cfg"}; a folder without
    safetensors raises FileNotFoundError."""
    files = files or checkpoint_files(model_dir, KANDINSKY3_FOLDERS)
    return {"files": files,
            "unet_cfg": infer_k3_unet_config(checkpoint_shapes(files["unet"]),
                                             _config_json(model_dir / "unet" / "config.json")),
            "movq_cfg": cfgs.movq_config_from_json(
                _config_json(model_dir / "movq" / "config.json")),
            "t5_cfg": cfgs.t5_config_from_json(
                _config_json(model_dir / "text_encoder" / "config.json"))}


def k3_modules(unet_cfg, movq_cfg, t5_cfg):
    """{folder: module} of a Kandinsky 3 bundle, on the current default
    device (the meta device for a check or a materialised build)."""
    return {"unet": Kandinsky3UNet(unet_cfg), "movq": MoVQ(movq_cfg),
            "text_encoder": T5Encoder(t5_cfg)}


def verify_k3(model_dir: Path) -> dict:
    """`--check` of a Kandinsky 3 directory: its files against the modules
    the worker would load, built on the meta device -> {component:
    parameters}."""
    found = k3_checkpoint(model_dir)
    with torch.device("meta"):
        modules = k3_modules(found["unet_cfg"], found["movq_cfg"], found["t5_cfg"])
    return {folder: check_checkpoint(module, found["files"][folder], folder,
                                     optional=movq_optional if folder == "movq" else None)
            for folder, module in modules.items()}


class Kandinsky3Pipeline(_Module):
    """One Kandinsky 3 bundle (UNet, MoVQ, T5) resident on one device;
    serves the Kandinsky3Pipeline and Kandinsky3Img2ImgPipeline names."""

    def __init__(self, model_name: str, device=None, dtype=None,
                 allow_random_init: bool = False, model_root_dir: str | None = None,
                 weights: dict | None = None):
        """The bundle loads from `<model_root_dir>/<model_name>/` through
        `k3_checkpoint`, or from `weights` {"unet", "movq", "t5": state
        dicts, "unet_cfg", "movq_cfg", "t5_cfg"}, or is random-initialised
        from a seed."""
        self.model_name = model_name
        self.device = resolve_device(device)
        self.dtype = dtype or serving_dtype(self.device)
        unet_cfg, movq_cfg, t5_cfg, self.default_size = k3_configs(model_name)
        model_dir = _model_dir(model_name, model_root_dir)
        files = None if weights is not None else find_checkpoint(
            model_name, model_dir, KANDINSKY3_FOLDERS, allow_random_init)
        if weights is not None:
            unet_cfg = weights.get("unet_cfg", unet_cfg)
            movq_cfg = weights.get("movq_cfg", movq_cfg)
            t5_cfg = weights.get("t5_cfg", t5_cfg)
        elif files is not None:
            found = k3_checkpoint(model_dir, files)
            unet_cfg, movq_cfg, t5_cfg = found["unet_cfg"], found["movq_cfg"], found["t5_cfg"]
        self.unet_cfg, self.movq_cfg, self.t5_cfg = unet_cfg, movq_cfg, t5_cfg
        self.latent_channels = movq_cfg.latent_channels
        self.latent_factor = 2 ** (len(movq_cfg.block_out_channels) - 1)
        self.max_tokens = TINY_MAX_TOKENS if is_test_model(model_name) else MAX_TOKENS

        t0 = time.perf_counter()
        with torch.device("meta"):
            modules = k3_modules(unet_cfg, movq_cfg, t5_cfg)
        modules = {k: self._materialise(m) for k, m in modules.items()}
        self.unet, self.movq, self.text_encoder = (modules["unet"], modules["movq"],
                                                   modules["text_encoder"])
        self.checkpoint = None
        if weights is not None:
            self.unet.load_state_dict(weights["unet"])
            self.movq.load_state_dict(weights["movq"])
            self.text_encoder.load_state_dict(weights["t5"])
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
        self.tokenizer = _load_t5_tokenizer(model_dir if files is not None else None,
                                            t5_cfg.vocab_size)
        for module in (self.unet, self.movq):
            module.to(memory_format=torch.channels_last)
        synchronize(self.device)
        logger.info("%s resident on %s in %.1fs (dtype=%s, weights=%s)", model_name,
                    device_label(self.device), time.perf_counter() - t0, self.dtype,
                    self.weights_source)

    def canvas(self, height, width) -> tuple[int, int]:
        """The canvas floored to a multiple of 64, at least 64."""
        return tuple(max(64, (int(d or self.default_size) // 64) * 64) for d in (height, width))

    def encode_text(self, prompt: str, negative_prompt: str, n: int):
        """T5 on the CFG rows [negative x n | prompt x n] -> (states [2n, S,
        D] with the padded positions zeroed, the 1-keep mask [2n, S] f32)."""
        ids = np.asarray(self.tokenizer([negative_prompt or ""] * n + [prompt or ""] * n,
                                        self.max_tokens), np.int64)
        mask = (ids != 0).astype(np.float32)
        mask[:, 0] = 1.0
        mask = torch.from_numpy(mask).to(self.device)
        states = self.text_encoder(torch.from_numpy(ids).to(self.device), mask)
        return states * mask[..., None].to(states.dtype), mask

    def encode_image(self, image, width: int, height: int, n: int):
        """A start image -> MoVQ latents [n, C, h, w] f32 (LANCZOS to the
        canvas, [-1, 1])."""
        pixels = _pil_to_array(image, width, height)
        x = torch.from_numpy(np.ascontiguousarray(pixels.transpose(2, 0, 1)[None]))
        x = x.to(self.device, self.dtype).contiguous(memory_format=torch.channels_last)
        return self.movq.encode(x).float().expand(n, -1, -1, -1)

    def denoise(self, latents, context, mask, guidance: float, steps: int,
                scheduler_type: str, t_start: int, draw, image_latents=None):
        """The CFG loop over NCHW f32 latents -> the final latents."""
        scheduler = get_scheduler(scheduler_type)
        schedule = scheduler.schedule(steps)
        lo, hi = scheduler.loop_bounds(schedule, steps, t_start)
        if image_latents is not None:
            latents = scheduler.add_noise(schedule, image_latents, latents, lo)
        else:
            latents = latents * float(schedule.init_noise_sigma)
        state = scheduler.init_state(latents)
        b = latents.shape[0]
        for i in range(lo, hi):
            inp = scheduler.scale_model_input(schedule, latents, i)
            model_in = torch.cat([inp, inp]).to(self.dtype)
            t = torch.full((2 * b,), float(schedule.timesteps[i]), device=self.device)
            pred_u, pred_c = self.unet(model_in, t, context, mask).float().chunk(2)
            pred = pred_u + guidance * (pred_c - pred_u)
            state, latents = scheduler.step(schedule, state, i, latents, pred, draw(i))
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

    @torch.inference_mode()
    def run(self, prompt: str = "", negative_prompt: str = "",
            pipeline_type: str = "Kandinsky3Pipeline", *,
            num_inference_steps: int = DEFAULT_STEPS, guidance_scale: float = DEFAULT_GUIDANCE,
            height: int | None = None, width: int | None = None,
            num_images_per_prompt: int = 1, scheduler_type: str = DEFAULT_SCHEDULER,
            image=None, strength: float | None = None, seed: int | None = None,
            generator=None, latents=None, noise_fn=None, **kwargs):
        """One job -> (list of uint8 [H, W, 3] arrays, pipeline_config).
        `image` starts img2img at `strength` (0.75 unset). `latents` [N, C,
        h, w] and `noise_fn(i, shape)` replace the draws from the job's
        generator; the SD family's other arguments are not read."""
        timings: dict[str, float] = {}
        steps = int(num_inference_steps or DEFAULT_STEPS)
        guidance = float(DEFAULT_GUIDANCE if guidance_scale is None else guidance_scale)
        n = int(num_images_per_prompt or 1)
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
        shape = (n, self.latent_channels, lh, lw)

        def draw(i):
            if noise_fn is None:
                return torch.randn(shape, generator=gen, device=self.device)
            return _injected(noise_fn(i, shape), shape, self.device)

        start = (torch.randn(shape, generator=gen, device=self.device) if latents is None
                 else _injected(latents, shape, self.device))
        with _Timer(self.device, timings, "text_encode_s"):
            context, mask = self.encode_text(prompt, negative_prompt, n)
        image_latents = None
        if image is not None:
            with _Timer(self.device, timings, "encode_s"):
                image_latents = self.encode_image(image, width, height, n)
        with _Timer(self.device, timings, "denoise_s"):
            out = self.denoise(start, context, mask, guidance, steps, scheduler_type, t_start,
                               draw, image_latents)
        with _Timer(self.device, timings, "decode_s"):
            pixels = self.decode(out)
        timings["unet_step_ms"] = 1000.0 * timings["denoise_s"] / max(steps - t_start, 1)
        timings["pipeline_s"] = time.perf_counter() - t_job
        config = {
            "model": self.model_name, "pipeline": pipeline_type, "scheduler": scheduler_type,
            "mode": mode, "steps": steps, "size": [width, height], "guidance_scale": guidance,
            "backend": f"torch-{self.device.type}", "device": device_label(self.device),
            "dtype": str(self.dtype).replace("torch.", ""), "weights": self.weights_source,
            "latents": {"finite": bool(torch.isfinite(out).all()),
                        "absmax": float(out.abs().max())},
            "timings": {k: round(v, 4) for k, v in timings.items()}}
        return list(pixels), config
