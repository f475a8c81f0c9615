"""The SD-x2 learned latent upscaler (stabilityai/sd-x2-latent-upscaler),
the counterpart of chiaswarm_tpu/pipelines/upscale.py: the
`StableDiffusionLatentUpscalePipeline` wire name served standalone, and
the stage an SD job's `upscale: true` chains after its denoise (and its
refiner).

`upscale()`: the images (one size for all, floored to multiples of 64)
VAE-encode to scaled latents; the latents, nearest-upsampled 2x, are the
conditioning half of the K-UNet's 8 input channels; Euler in
denoised-sample prediction runs unguided (the reference passes guidance
0) for `steps` steps with Karras preconditioning outside the UNet (x0 =
x / (σ² + 1) + F(x / sqrt(σ² + 1)) · σ / sqrt(σ² + 1)), the continuous
timestep log(σ) / 4, the CLIP states of the prompt before the final
LayerNorm, and a timestep condition of [ones | zeros | the CLIP pooled
output] (noise level 0); the 5th output channel is dropped; the latents
decode at 2x, image by image from (2h)(2w) >= 9216 latents when there are
several images.

Noise: the initial latents come from a `torch.Generator` on the device
(seeded with the job's seed, or the chain's generator), or are injected
(`latents`, NCHW [B, C, 2h, 2w]), which is how the tests hand the port
the JAX pipeline's draw (`normal(key, (B, 2h, 2w, C))`, NHWC). The JAX
program also draws a normal per step (`fold_in(key, i)`); its Euler step
never reads it, nor does the port's.

Weights: `<model_root_dir>/<name>/{unet,text_encoder,vae}/*.safetensors`
with the folders' config.json (the K-UNet's and the VAE's configs read
off the checkpoint, weights.py) and `scheduler/scheduler_config.json`
(prediction type and betas). A test name random-initialises from
crc32(name) at the tiny configs and never reads files; any other name
without its three folders raises MissingWeightsError unless
`allow_random_init` (then the published configs). The prompt tokenizes
with the hash tokenizer, as the JAX pipeline does.
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
from ..models.k_upscaler import TINY_K_UPSCALER, KUpscalerConfig, KUpscalerUNet
from ..models.tokenizer import load_tokenizer
from ..models.vae import AutoencoderKL
from ..schedulers import get_scheduler
from ..weights import (
    MissingWeightsError,
    checkpoint_shapes,
    infer_k_upscaler_config,
    infer_vae_config,
    is_test_model,
    load_checkpoint_,
    model_seed,
    random_init_,
    require_weights_present,
)

logger = logging.getLogger(__name__)

UPSCALER = "stabilityai/sd-x2-latent-upscaler"
TINY_UPSCALER = "test/tiny-upscaler"
FOLDERS = ("unet", "text_encoder", "vae")
_HINT = ("Put its diffusers-layout safetensors under <model_root_dir>/<name>/"
         "{unet,text_encoder,vae}/, or serve the test/tiny upscaler.")


def upscaler_name_for(model_name: str) -> str:
    """The upscaler chained after a pipeline of `model_name`."""
    return TINY_UPSCALER if is_test_model(model_name) else UPSCALER


def _timestep_condition(cond_dim: int, pooled):
    """The fixed noise-level embedding at noise level 0, [ones | zeros],
    then the CLIP pooled output: [B, cond_dim]."""
    b, width = pooled.shape
    half = (cond_dim - width) // 2
    return torch.cat([pooled.new_ones((b, half)), pooled.new_zeros((b, cond_dim - width - half)),
                      pooled], dim=-1)


def _config_json(model_dir: Path, sub: str) -> dict:
    path = model_dir / sub / "config.json"
    return json.loads(path.read_text()) if path.is_file() else {}


def find_upscaler_checkpoint(model_name: str, model_dir: Path | None,
                             allow_random_init: bool) -> dict | None:
    """{folder: sorted safetensors files} of the upscaler's checkpoint, or
    None for random init: test names never read files; a production name
    without all three folders raises MissingWeightsError unless
    `allow_random_init`."""
    if is_test_model(model_name):
        return None
    files = {f: sorted((model_dir / f).glob("*.safetensors")) for f in FOLDERS} if model_dir \
        else {}
    if not files or not all(files.values()):
        require_weights_present(model_name, model_dir, allow_random_init,
                                component="latent upscaler", hint=_HINT)
        return None
    return files


def upscaler_configs(model_dir: Path, files: dict):
    """(unet_cfg, clip_cfg, vae_cfg) of an upscaler checkpoint: the K-UNet's
    and the VAE's off their shapes, CLIP ViT-L's from its config.json (the
    last layer's state before the final LayerNorm), as the JAX loader reads
    them; serving and the setup CLI's `--check` share it."""
    unet_cfg = infer_k_upscaler_config(checkpoint_shapes(files["unet"]),
                                       _config_json(model_dir, "unet"))
    vae_cfg = infer_vae_config(checkpoint_shapes(files["vae"]), _config_json(model_dir, "vae"))
    tj = _config_json(model_dir, "text_encoder")
    clip_cfg = dataclasses.replace(
        cfgs.SD15_CLIP, vocab_size=int(tj.get("vocab_size", 49408)),
        hidden_size=int(tj.get("hidden_size", 768)),
        num_layers=int(tj.get("num_hidden_layers", 12)),
        num_heads=int(tj.get("num_attention_heads", 12)),
        hidden_act=str(tj.get("hidden_act", "quick_gelu")), apply_final_norm=False)
    return unet_cfg, clip_cfg, vae_cfg


class LatentUpscalePipeline:
    """The 2x latent upscaler resident on one device."""

    def __init__(self, model_name: str, device=None, allow_random_init: bool = False,
                 weights: dict | None = None, model_root_dir: str | None = None):
        """`weights`: {"unet": sd, "text": [sd], "vae": sd} in the port's key
        layout at the name's configs (weights.from_jax_params gives them)."""
        self.model_name = model_name
        self.device = resolve_device(device)
        self.dtype = serving_dtype(self.device)
        model_dir = None
        if model_root_dir:
            candidate = Path(model_root_dir).expanduser() / model_name
            model_dir = candidate if candidate.is_dir() else None
        files = None if weights is not None else find_upscaler_checkpoint(
            model_name, model_dir, allow_random_init)
        self.scheduler_json: dict = {}
        if files is not None:
            try:
                unet_cfg, clip_cfg, vae_cfg = upscaler_configs(model_dir, files)
            except Exception as e:  # noqa: BLE001 — as the JAX loader: a checkpoint it cannot read
                raise MissingWeightsError(f"checkpoint under {model_dir} could not be read for "
                                          f"'{model_name}': {e}") from e
            path = model_dir / "scheduler" / "scheduler_config.json"
            self.scheduler_json = json.loads(path.read_text()) if path.is_file() else {}
        elif is_test_model(model_name):
            unet_cfg, vae_cfg = TINY_K_UPSCALER, cfgs.TINY_VAE
            clip_cfg = dataclasses.replace(cfgs.TINY_CLIP, apply_final_norm=False)
        else:  # allow_random_init at the published geometry
            unet_cfg, vae_cfg = KUpscalerConfig(), cfgs.SD_VAE
            clip_cfg = dataclasses.replace(cfgs.SD15_CLIP, apply_final_norm=False)
        self.latent_factor = 2 ** (len(vae_cfg.block_out_channels) - 1)
        self.latent_channels = vae_cfg.latent_channels

        t0 = time.perf_counter()
        with torch.device("meta"):
            unet, text, vae = (KUpscalerUNet(unet_cfg), CLIPTextEncoder(clip_cfg),
                               AutoencoderKL(vae_cfg))
        self.unet, self.text_encoder, self.vae = (
            m.to_empty(device=self.device).to(self.dtype).eval().requires_grad_(False)
            for m in (unet, text, vae))
        self.checkpoint = None
        if weights is not None:
            self.unet.load_state_dict(weights["unet"])
            self.text_encoder.load_state_dict(weights["text"][0])
            self.vae.load_state_dict(weights["vae"])
            self.weights_source = "given"
        elif files is not None:
            nbytes = (load_checkpoint_(self.unet, files["unet"], "unet")
                      + load_checkpoint_(self.text_encoder, files["text_encoder"], "text_encoder",
                                         text_layers=clip_cfg.num_layers)
                      + load_checkpoint_(self.vae, files["vae"], "vae"))
            synchronize(self.device)
            self.checkpoint = {"dir": str(model_dir), "bytes": nbytes,
                               "load_s": time.perf_counter() - t0}
            self.weights_source = "checkpoint"
        else:
            gen = torch.Generator(device=self.device).manual_seed(model_seed(model_name))
            for module in (self.unet, self.text_encoder, self.vae):
                random_init_(module, gen)
            # the Fourier features' frozen weights, N(0, 16) as initialised
            # for training
            self.unet.time_proj.weight.normal_(0.0, 16.0, generator=gen)
            self.weights_source = "random"
        for module in (self.unet, self.vae):
            module.to(memory_format=torch.channels_last)
        self.tokenizer = load_tokenizer(None, vocab_size=clip_cfg.vocab_size)
        # the last upscale()'s stage times
        self.last_timings: dict[str, float] = {}
        synchronize(self.device)
        logger.info("%s resident on %s in %.1fs (dtype=%s, weights=%s)", model_name,
                    device_label(self.device), time.perf_counter() - t0, self.dtype,
                    self.weights_source)

    def release(self) -> None:
        """Free the weights, as the registry evicts the pipeline: a job that
        still holds it fails at its next stage."""
        self.unet = self.text_encoder = self.vae = None

    def scheduler(self):
        """Euler in denoised-sample prediction, with the checkpoint's betas
        where its scheduler config gives them."""
        sj = self.scheduler_json
        kw = {"prediction_type": str(sj.get("prediction_type", "sample"))}
        for field in ("beta_start", "beta_end"):
            if field in sj:
                kw[field] = float(sj[field])
        if "beta_schedule" in sj:
            kw["beta_schedule"] = str(sj["beta_schedule"])
        if "num_train_timesteps" in sj:
            kw["num_train_timesteps"] = int(sj["num_train_timesteps"])
        return get_scheduler("EulerDiscreteScheduler", **kw)

    def decode(self, latents) -> np.ndarray:
        """Scaled latents -> uint8 [B, H, W, 3] on the host, quantised on the
        device."""
        pixels = self.vae.decode(latents.to(self.dtype).contiguous(
            memory_format=torch.channels_last)).float()
        pixels = ((pixels + 1.0) * 127.5).clamp(0.0, 255.0).round().to(torch.uint8)
        return pixels.permute(0, 2, 3, 1).cpu().numpy()

    @torch.inference_mode()
    def upscale(self, images, prompt: str = "", negative_prompt: str = "", steps: int = 20,
                generator: torch.Generator | None = None, latents=None) -> list[np.ndarray]:
        """PIL images (or uint8 [H, W, 3] arrays) of one size -> uint8 arrays
        at twice it. `negative_prompt` is accepted and unused: the stage is
        unguided."""
        if self.unet is None:
            raise RuntimeError(f"upscaler {self.model_name} was evicted; resubmit")
        images = [im if isinstance(im, Image.Image) else Image.fromarray(np.asarray(im))
                  for im in images]
        if any(im.size != images[0].size for im in images):
            raise ValueError("latent upscale requires equal-size input images; got "
                             + str([im.size for im in images]))
        w, h = (max(64, (d // 64) * 64) for d in images[0].size)
        batch, steps = len(images), int(steps)
        timings: dict[str, float] = {}
        t_all = time.perf_counter()
        pixels = np.stack([np.asarray(im.convert("RGB").resize((w, h)), np.float32)
                           for im in images]) / 127.5 - 1.0
        ids = torch.from_numpy(self.tokenizer([prompt] * batch).astype(np.int64)).to(self.device)
        out = self.text_encoder(ids)
        context, pooled = out["hidden_states"], out["pooled"]
        lh, lw = h // self.latent_factor, w // self.latent_factor
        shape = (batch, self.latent_channels, 2 * lh, 2 * lw)
        if latents is None:
            gen = generator or torch.Generator(device=self.device).manual_seed(0)
            latents = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
        else:
            if not isinstance(latents, torch.Tensor):
                latents = torch.from_numpy(np.array(latents, dtype=np.float32))
            latents = latents.to(self.device, torch.float32)
            if tuple(latents.shape) != shape:
                raise ValueError(f"latents {tuple(latents.shape)} != {shape}")
        synchronize(self.device)
        timings["text_encode_s"] = time.perf_counter() - t_all

        t0 = time.perf_counter()
        x = torch.from_numpy(np.ascontiguousarray(pixels.transpose(0, 3, 1, 2)))
        x = x.to(self.device, self.dtype).contiguous(memory_format=torch.channels_last)
        # noise level 0: the conditioning half is the nearest-2x latents
        cond = F.interpolate(self.vae.encode(x).float(), scale_factor=2.0, mode="nearest")
        tcond = _timestep_condition(self.unet.config.time_cond_proj_dim, pooled)
        synchronize(self.device)
        timings["image_encode_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        scheduler = self.scheduler()
        schedule = scheduler.schedule(steps)
        latents = latents * float(schedule.init_noise_sigma)
        state = scheduler.init_state(latents)
        c = self.latent_channels
        for i in range(steps):
            sigma = np.float32(schedule.sigmas[i])
            s2 = sigma * sigma + np.float32(1.0)
            inp = scheduler.scale_model_input(schedule, latents, i)
            model_in = torch.cat([inp, cond], dim=1).to(self.dtype).contiguous(
                memory_format=torch.channels_last)
            # the continuous K-diffusion timestep
            t = torch.full((batch,), float(np.log(sigma) * np.float32(0.25)), device=self.device)
            pred = self.unet(model_in, t, context, tcond).float()[:, :c]
            # Karras preconditioning, outside the UNet as in the reference
            x0 = latents / float(s2) + pred * float(sigma / np.sqrt(s2))
            state, latents = scheduler.step(schedule, state, i, latents, x0)
        synchronize(self.device)
        timings["denoise_s"] = time.perf_counter() - t0
        timings["step_ms"] = 1000.0 * timings["denoise_s"] / max(steps, 1)

        t0 = time.perf_counter()
        if (2 * lh) * (2 * lw) >= 9216 and batch >= 2:
            # the 2x decode holds four times a base decode's activations
            out = np.concatenate([self.decode(latents[k:k + 1]) for k in range(batch)])
        else:
            out = self.decode(latents)
        timings["decode_s"] = time.perf_counter() - t0
        self.last_timings = timings
        self.last_latents = {"finite": bool(torch.isfinite(latents).all()),
                             "absmax": float(latents.abs().max())}
        return list(out)

    def run(self, prompt: str = "", negative_prompt: str = "",
            pipeline_type: str = "StableDiffusionLatentUpscalePipeline", *, image=None,
            num_inference_steps: int = 20, seed: int | None = None, generator=None,
            latents=None, **kwargs):
        """A standalone upscale job (the img2img wire shape with this
        pipeline type) -> (2x images, pipeline_config). The job's other
        arguments are accepted and unused, as by the JAX pipeline."""
        if image is None:
            raise ValueError("latent upscale requires an input image")
        steps = int(num_inference_steps)
        gen = generator or torch.Generator(device=self.device).manual_seed(int(seed or 0))
        t0 = time.perf_counter()
        out = self.upscale(image if isinstance(image, list) else [image], prompt=prompt,
                           negative_prompt=negative_prompt, steps=steps, generator=gen,
                           latents=latents)
        timings = {**self.last_timings, "pipeline_s": time.perf_counter() - t0}
        config = {
            "model": self.model_name,
            "pipeline": pipeline_type,
            "scheduler": "EulerDiscreteScheduler",
            "mode": "upscale",
            "steps": steps,
            "size": [int(out[0].shape[1]), int(out[0].shape[0])],
            "backend": f"torch-{self.device.type}",
            "device": device_label(self.device),
            "dtype": str(self.dtype).replace("torch.", ""),
            "weights": self.weights_source,
            "latents": self.last_latents,
            "timings": {k: round(v, 4) for k, v in timings.items()},
        }
        return out, config
