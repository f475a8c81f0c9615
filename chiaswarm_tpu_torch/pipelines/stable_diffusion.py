"""Resident Stable-Diffusion pipeline (SD 1.x, SD 2.x, SDXL and the tiny test
models): txt2img, img2img, 4-channel inpaint and dedicated (9-channel)
inpaint; the counterpart of chiaswarm_tpu/pipelines/stable_diffusion.py.

Weights load once and stay on the device. A job runs the CLIP encoders
over [negatives | prompts] in one batch; encodes the start image (masked
first for a 9-channel inpaint checkpoint) with the VAE encoder; runs the
classifier-free-guidance denoise loop (the UNet sees [uncond | cond] rows
stacked, as the JAX program does) with any ported solver; then the VAE
decode with the uint8 quantisation on the device. PyTorch runs eagerly,
so the loop is a Python loop over steps.

Modes, as in the JAX pipeline: `inpaint9` for a 9-channel UNet given a
mask (the mask and the masked image's latents ride on the UNet's channel
axis), else `inpaint` for a mask (latent masking: the kept region follows
the original's noise trajectory), else `img2img` for an image, else
`txt2img`. img2img and inpaint start from the image's latents noised to
`t_start = int(steps * (1 - strength))`.

Noise: the initial latents, each step's ancestral noise and inpaint's
keep noise come from one `torch.Generator` per job on the device, seeded
with the job's seed. A caller may inject them instead (`latents`, NCHW,
and `noise_fn(kind, i, shape)` for kind "step" and "keep"), which is how
the tests hand the port the noise that the JAX pipeline drew.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..device import device_label, resolve_device, serving_dtype, synchronize
from ..models import configs as cfgs
from ..models.clip import CLIPTextEncoder
from ..models.tokenizer import load_tokenizer
from ..models.unet2d import UNet2DConditionModel
from ..models.vae import AutoencoderKL
from ..schedulers import SchedulerConfig, get_scheduler
from ..weights import model_seed, random_init_, require_weights_present

logger = logging.getLogger(__name__)

# job arguments of the JAX pipeline whose features this slice lacks; a
# job that sets one fails with a fatal envelope naming it
_UNPORTED = ("lora", "controlnet_model_name", "refiner", "upscale", "textual_inversion",
             "vae", "control_image")

# model-name marks of families (and their tiny stand-ins) of later slices
_LATER_FAMILIES = ("flux", "kandinsky", "cascade")


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

    A name containing `inpaint` is a dedicated inpaint checkpoint: its
    UNet takes 9 channels (latents, mask, masked-image latents)."""
    name = model_name.lower()
    if "pix2pix" in name or "ip2p" in name:
        raise ValueError(f"{model_name}: edit (instruct-pix2pix) checkpoints are not "
                         "ported to chiaswarm_tpu_torch yet")
    if any(family in name for family in _LATER_FAMILIES):
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
        raise ValueError(f"{model_name}: the SDXL refiner (five time ids with the "
                         "aesthetic score) is not ported to chiaswarm_tpu_torch yet")
    elif family == "sd21":
        pred = "v_prediction" if "768" in name or name.endswith("2-1") else "epsilon"
        out = cfgs.SD21_UNET, [cfgs.SD21_CLIP], cfgs.SD_VAE, 768, pred
    else:
        out = cfgs.SD15_UNET, [cfgs.SD15_CLIP], cfgs.SD_VAE, 512, "epsilon"
    unet_cfg, clip_cfgs, vae_cfg, size, pred = out
    pred = config_prediction_type(model_name, model_root_dir) or pred
    if "inpaint" in name:
        unet_cfg = dataclasses.replace(unet_cfg,
                                       in_channels=2 * vae_cfg.latent_channels + 1)
    return unet_cfg, clip_cfgs, vae_cfg, size, pred


def _pil_to_array(image: Image.Image, width: int, height: int) -> np.ndarray:
    """PIL -> float32 [H, W, 3] in [-1, 1], resized to the job canvas."""
    image = image.convert("RGB")
    if image.size != (width, height):
        image = image.resize((width, height), Image.LANCZOS)
    return np.asarray(image, np.float32) / 127.5 - 1.0


def _mask_to_latent_array(mask: Image.Image, width: int, height: int,
                          factor: int) -> np.ndarray:
    """Mask PIL -> float32 [H/f, W/f, 1]; 1 = repaint, 0 = keep."""
    mask = mask.convert("L").resize((width // factor, height // factor), Image.NEAREST)
    return (np.asarray(mask, np.float32)[..., None] / 255.0 > 0.5).astype(np.float32)


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
    """One SD-family model resident on one device; serves txt2img, img2img
    and inpaint (4- or 9-channel, by the UNet's input channels)."""

    def __init__(self, model_name: str, device=None, dtype=None,
                 allow_random_init: bool = False, weights: dict | None = None,
                 model_root_dir: str | None = None):
        """`weights`: {"unet": sd, "text": [sd, ...], "vae": sd} state dicts
        in the port's key layout (weights.from_jax_params gives them);
        without it the model is random-initialised from a seed, as the
        policy in weights.py permits."""
        self.model_name = model_name
        self.device = resolve_device(device)
        self.dtype = dtype or serving_dtype(self.device)
        unet_cfg, clip_cfgs, vae_cfg, self.default_size, self.prediction_type = (
            family_configs(model_name, model_root_dir))
        self.is_xl = unet_cfg.addition_embed_dim > 0
        self.latent_factor = 2 ** (len(vae_cfg.block_out_channels) - 1)
        self.latent_channels = vae_cfg.latent_channels
        # a dedicated inpaint checkpoint, told by its architecture as in JAX
        self.is_inpaint_unet = unet_cfg.in_channels == 2 * vae_cfg.latent_channels + 1

        t0 = time.perf_counter()
        with torch.device("meta"):
            unet = UNet2DConditionModel(unet_cfg)
            encoders = [CLIPTextEncoder(c) for c in clip_cfgs]
            vae = AutoencoderKL(vae_cfg)
        self.unet, self.vae = self._materialise(unet), self._materialise(vae)
        self.text_encoders = [self._materialise(e) for e in encoders]

        model_dir = None
        if model_root_dir:
            candidate = Path(model_root_dir).expanduser() / model_name
            model_dir = candidate if candidate.is_dir() else None
        if weights is not None:
            self.unet.load_state_dict(weights["unet"])
            for enc, sd in zip(self.text_encoders, weights["text"], strict=True):
                enc.load_state_dict(sd)
            self.vae.load_state_dict(weights["vae"])
            self.weights_source = "given"
        else:
            require_weights_present(model_name, model_dir, allow_random_init)
            gen = torch.Generator(device=self.device).manual_seed(model_seed(model_name))
            for module in (self.unet, *self.text_encoders, self.vae):
                random_init_(module, gen)
            self.weights_source = "random"
        for module in (self.unet, self.vae):
            module.to(memory_format=torch.channels_last)
        self.tokenizers = [load_tokenizer(model_dir, vocab_size=c.vocab_size)
                           for c in clip_cfgs]
        synchronize(self.device)
        logger.info("%s resident on %s in %.1fs (dtype=%s, weights=%s)", model_name,
                    device_label(self.device), time.perf_counter() - t0, self.dtype,
                    self.weights_source)

    def _materialise(self, module):
        module = module.to_empty(device=self.device).to(self.dtype)
        module.eval().requires_grad_(False)
        return module

    # --- stages ---

    def _xl_time_ids(self, height: int, width: int) -> list:
        """SDXL micro-conditioning ids for this canvas: original size, crop
        top-left, target size (the refiner's 5-id layout is not ported)."""
        return [height, width, 0, 0, height, width]

    def encode_prompts(self, prompts: list[str]):
        """-> (context [B, 77, D], pooled [B, P] or None), all encoders in
        one batch; SDXL concatenates both encoders' hidden states."""
        hiddens, pooled = [], None
        for tok, enc in zip(self.tokenizers, self.text_encoders):
            ids = torch.from_numpy(tok(prompts).astype(np.int64)).to(self.device)
            out = enc(ids)
            hiddens.append(out["hidden_states"])
            pooled = out["pooled"]
        context = torch.cat(hiddens, dim=-1) if len(hiddens) > 1 else hiddens[0]
        return context, (pooled if self.is_xl else None)

    def encode_image(self, pixels: np.ndarray):
        """float32 [B, H, W, 3] in [-1, 1] -> scaled latents [B, C, h, w]
        f32 (the latent distribution's mean)."""
        x = torch.from_numpy(np.ascontiguousarray(pixels.transpose(0, 3, 1, 2)))
        x = x.to(self.device, self.dtype).contiguous(memory_format=torch.channels_last)
        return self.vae.encode(x).float()

    def decode(self, latents):
        """scaled latents [B, C, h, w] -> uint8 [B, H, W, 3] on the host,
        quantised on the device as the JAX program does."""
        latents = latents.to(self.dtype).contiguous(memory_format=torch.channels_last)
        pixels = self.vae.decode(latents).float()
        pixels = ((pixels + 1.0) * 127.5).clamp(0.0, 255.0).round().to(torch.uint8)
        return pixels.permute(0, 2, 3, 1).cpu().numpy()

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
            seed: int | None = None, image: Image.Image | None = None,
            mask_image: Image.Image | None = None, strength: float = 0.75,
            latents=None, noise_fn=None, **kwargs):
        """One job -> (list of uint8 [H, W, 3] arrays, pipeline_config).

        `image` starts img2img, with `mask_image` inpaint (white repaints).
        `latents` [N, C, H/8, W/8] replaces the seeded initial draw, and
        `noise_fn(kind, i, shape)` the seeded draws of each step's
        ancestral noise ("step") and of inpaint's keep noise ("keep")."""
        for key in _UNPORTED:
            if kwargs.get(key):
                raise ValueError(f"{key!r} is not supported by chiaswarm_tpu_torch yet")
        timings: dict[str, float] = {}
        steps = int(num_inference_steps)
        n = int(num_images_per_prompt)
        guidance_scale = float(guidance_scale)
        if height is None and image is not None:
            width, height = image.size
        height = int(height or self.default_size)
        width = int(width or self.default_size)
        height, width = (max(64, (d // 64) * 64) for d in (height, width))
        lh, lw = height // self.latent_factor, width // self.latent_factor
        if mask_image is not None:
            if image is None:
                raise ValueError("inpaint requires an init image. None provided")
            mode = "inpaint9" if self.is_inpaint_unet else "inpaint"
        else:
            mode = "txt2img" if image is None else "img2img"
        t_start = 0
        if mode in ("img2img", "inpaint"):
            t_start = min(max(int(steps * (1.0 - float(strength))), 0), steps - 1)
        scheduler = get_scheduler(scheduler_type, **vars(SchedulerConfig(
            prediction_type=self.prediction_type,
            use_karras_sigmas=bool(kwargs.get("use_karras_sigmas", False)))))
        t_job = time.perf_counter()

        with _Timer(self.device, timings, "text_encode_s"):
            context, pooled = self.encode_prompts([negative_prompt] * n + [prompt] * n)
            added = None
            if self.is_xl:
                ids = self._xl_time_ids(height, width)
                added = {
                    "text_embeds": pooled,
                    "time_ids": torch.tensor([ids] * (2 * n), dtype=torch.float32,
                                             device=self.device),
                }

        shape = (n, self.latent_channels, lh, lw)
        gen = torch.Generator(device=self.device).manual_seed(int(seed or 0))

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
                pixels = _pil_to_array(image, width, height)[None]
                if mode == "inpaint9":
                    # the 9-channel checkpoint conditions on the masked
                    # image: the repaint region is blanked before encoding
                    mask_px = np.asarray(mask_image.convert("L").resize(
                        (width, height), Image.NEAREST), np.float32)[None, ..., None] / 255.0
                    pixels = pixels * (mask_px <= 0.5).astype(np.float32)
                # one start image for the whole batch: encoded once
                image_latents = self.encode_image(pixels).expand(shape)
        if mask_image is not None:
            m = _mask_to_latent_array(mask_image, width, height, self.latent_factor)
            mask = torch.from_numpy(m.transpose(2, 0, 1)[None]).to(self.device).expand(
                n, 1, lh, lw)

        schedule = scheduler.schedule(steps)
        start, end = scheduler.loop_bounds(schedule, steps, t_start)
        with _Timer(self.device, timings, "denoise_s"):
            if mode in ("img2img", "inpaint"):
                latents = scheduler.add_noise(schedule, image_latents, latents, start)
            else:
                latents = latents * float(schedule.init_noise_sigma)
            state = scheduler.init_state(latents)
            if mode == "inpaint9":
                cond9 = torch.cat([mask, image_latents], dim=1)
            for i in range(start, end):
                inp = scheduler.scale_model_input(schedule, latents, i)
                if mode == "inpaint9":
                    inp = torch.cat([inp, cond9], dim=1)
                model_in = torch.cat([inp, inp]).to(self.dtype).contiguous(
                    memory_format=torch.channels_last)
                t_vec = torch.full((2 * n,), float(schedule.timesteps[i]),
                                   device=self.device)
                out = self.unet(model_in, t_vec, context, added_cond=added).float()
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

        with _Timer(self.device, timings, "decode_s"):
            pixels = self.decode(latents)
        finite = bool(torch.isfinite(latents).all())
        absmax = float(latents.abs().max())
        timings["unet_step_ms"] = 1000.0 * timings["denoise_s"] / max(end - start, 1)
        timings["pipeline_s"] = time.perf_counter() - t_job

        pipeline_config = {
            "model": self.model_name,
            "pipeline": pipeline_type,
            "scheduler": scheduler_type,
            "mode": mode,
            "steps": steps,
            "size": [width, height],
            "guidance_scale": guidance_scale,
            **({"strength": float(strength), "t_start": t_start}
               if mode in ("img2img", "inpaint") else {}),
            "backend": f"torch-{self.device.type}",
            "device": device_label(self.device),
            "dtype": str(self.dtype).replace("torch.", ""),
            "weights": self.weights_source,
            "latents": {"finite": finite, "absmax": absmax},
            "timings": {k: round(v, 4) for k, v in timings.items()},
        }
        return list(pixels), pipeline_config
