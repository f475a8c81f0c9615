"""Resident Stable-Diffusion pipeline (SDXL and the tiny test models),
txt2img only; the counterpart of chiaswarm_tpu/pipelines/stable_diffusion.py.

Weights load once and stay on the device. A job runs the CLIP encoders
over [negatives | prompts] in one batch, then the classifier-free-guidance
denoise loop (the UNet sees [uncond | cond] rows stacked, as the JAX
program does), stepping DPM-Solver++(2M), then the VAE decode with the
uint8 quantisation on the device. PyTorch runs eagerly, so the loop is a
Python loop over steps.

Initial latents come from a `torch.Generator` seeded with the job's seed,
or are injected by the caller (`latents`, NCHW), which is how the tests
hand the port the noise that the JAX pipeline drew.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

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
_UNPORTED = ("image", "mask_image", "lora", "controlnet_model_name", "refiner",
             "upscale", "textual_inversion", "vae", "control_image")


def family_configs(model_name: str):
    """(unet_cfg, [clip_cfgs], vae_cfg, default_size, prediction_type)."""
    name = model_name.lower()
    if "pix2pix" in name or "ip2p" in name or "inpaint" in name:
        raise ValueError(f"{model_name}: edit and inpaint checkpoints are not "
                         "ported to chiaswarm_tpu_torch yet")
    if "tiny" in name:
        if "xl" in name:
            return (cfgs.TINY_XL_UNET, [cfgs.TINY_CLIP, cfgs.TINY_CLIP_2],
                    cfgs.TINY_VAE, 64, "epsilon")
        return cfgs.TINY_UNET, [cfgs.TINY_CLIP], cfgs.TINY_VAE, 64, "epsilon"
    family = cfgs.model_family(model_name)
    if family == "sdxl":
        return (cfgs.SDXL_UNET, [cfgs.SDXL_CLIP_1, cfgs.SDXL_CLIP_2],
                cfgs.SDXL_VAE, 1024, "epsilon")
    raise ValueError(f"model family {family!r} ({model_name}) is not ported to "
                     "chiaswarm_tpu_torch yet")


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
    """One SD-family model resident on one device; serves txt2img."""

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
            family_configs(model_name))
        self.is_xl = unet_cfg.addition_embed_dim > 0
        self.latent_factor = 2 ** (len(vae_cfg.block_out_channels) - 1)
        self.latent_channels = vae_cfg.latent_channels

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
            # the encoder half of the VAE waits for img2img
            self.vae.load_state_dict({k: v for k, v in weights["vae"].items()
                                      if not k.startswith(("encoder.", "quant_conv."))})
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

    def decode(self, latents):
        """scaled latents [B, C, h, w] -> uint8 [B, H, W, 3] on the host,
        quantised on the device as the JAX program does."""
        latents = latents.to(self.dtype).contiguous(memory_format=torch.channels_last)
        pixels = self.vae.decode(latents).float()
        pixels = ((pixels + 1.0) * 127.5).clamp(0.0, 255.0).round().to(torch.uint8)
        return pixels.permute(0, 2, 3, 1).cpu().numpy()

    # --- public job API ---

    @torch.inference_mode()
    def run(self, prompt: str = "", negative_prompt: str = "",
            pipeline_type: str = "DiffusionPipeline", *,
            num_inference_steps: int = 30, guidance_scale: float = 7.5,
            height: int | None = None, width: int | None = None,
            num_images_per_prompt: int = 1,
            scheduler_type: str = "DPMSolverMultistepScheduler",
            seed: int | None = None, latents=None, **kwargs):
        """One txt2img job -> (list of uint8 [H, W, 3] arrays, pipeline_config).

        `latents` [N, C, H/8, W/8] replaces the seeded initial draw."""
        for key in _UNPORTED:
            if kwargs.get(key):
                raise ValueError(f"{key!r} is not supported by chiaswarm_tpu_torch yet")
        timings: dict[str, float] = {}
        steps = int(num_inference_steps)
        n = int(num_images_per_prompt)
        guidance_scale = float(guidance_scale)
        height = int(height or self.default_size)
        width = int(width or self.default_size)
        height, width = (max(64, (d // 64) * 64) for d in (height, width))
        lh, lw = height // self.latent_factor, width // self.latent_factor
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
        if latents is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed or 0))
            latents = torch.randn(shape, generator=gen, device=self.device,
                                  dtype=torch.float32)
        else:
            if not isinstance(latents, torch.Tensor):
                latents = torch.from_numpy(np.array(latents, dtype=np.float32))
            latents = latents.to(self.device, torch.float32)
            if tuple(latents.shape) != shape:
                raise ValueError(f"latents {tuple(latents.shape)} != {shape}")

        schedule = scheduler.schedule(steps)
        start, end = scheduler.loop_bounds(schedule, steps, 0)
        with _Timer(self.device, timings, "denoise_s"):
            latents = latents * float(schedule.init_noise_sigma)
            state = scheduler.init_state(latents)
            for i in range(start, end):
                inp = scheduler.scale_model_input(schedule, latents, i)
                model_in = torch.cat([inp, inp]).to(self.dtype).contiguous(
                    memory_format=torch.channels_last)
                t_vec = torch.full((2 * n,), float(schedule.timesteps[i]),
                                   device=self.device)
                out = self.unet(model_in, t_vec, context, added_cond=added).float()
                out_u, out_c = out.chunk(2)
                guided = out_u + guidance_scale * (out_c - out_u)
                state, latents = scheduler.step(schedule, state, i, latents, guided)

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
            "mode": "txt2img",
            "steps": steps,
            "size": [width, height],
            "guidance_scale": guidance_scale,
            "backend": f"torch-{self.device.type}",
            "device": device_label(self.device),
            "dtype": str(self.dtype).replace("torch.", ""),
            "weights": self.weights_source,
            "latents": {"finite": finite, "absmax": absmax},
            "timings": {k: round(v, 4) for k, v in timings.items()},
        }
        return list(pixels), pipeline_config
