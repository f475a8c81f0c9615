"""Model configurations the port serves: SD 1.x, SD 2.x, SDXL base and
refiner, Flux (its MMDiT transformer, T5-XXL and the 16-channel VAE; its
CLIP is SD 1.x's CLIP-L), and the tiny stand-ins of the hermetic tests.
Copied from chiaswarm_tpu/models/configs.py, flux.py and t5.py (the port
imports nothing of the JAX package); the other families wait for their
slices of the port.
"""

from __future__ import annotations

import dataclasses

from .clip import CLIPTextConfig
from .unet2d import UNet2DConfig
from .vae import VAEConfig

# --- Stable Diffusion 1.x (512 base) ---
SD15_UNET = UNet2DConfig(
    block_out_channels=(320, 640, 1280, 1280),
    transformer_layers=(1, 1, 1, 0),
    num_attention_heads=8,  # head dim 40/80/160/160
    cross_attention_dim=768,
)
SD15_CLIP = CLIPTextConfig(
    hidden_size=768, num_layers=12, num_heads=12, hidden_act="quick_gelu"
)

# --- Stable Diffusion 2.1 ---
SD21_UNET = UNet2DConfig(
    block_out_channels=(320, 640, 1280, 1280),
    transformer_layers=(1, 1, 1, 0),
    num_attention_heads=(5, 10, 20, 20),  # head dim 64 throughout
    cross_attention_dim=1024,
)
SD21_CLIP = CLIPTextConfig(
    hidden_size=1024, num_layers=23, num_heads=16, hidden_act="gelu"
)

# --- SDXL base (stabilityai/stable-diffusion-xl-base-1.0) ---
SDXL_UNET = UNet2DConfig(
    block_out_channels=(320, 640, 1280),
    transformer_layers=(0, 2, 10),
    mid_transformer_layers=10,
    num_attention_heads=(5, 10, 20),  # head dim 64 throughout
    cross_attention_dim=2048,
    addition_embed_dim=2816,  # 1280 pooled + 6*256 time ids
)
SDXL_CLIP_1 = CLIPTextConfig(
    hidden_size=768,
    num_layers=12,
    num_heads=12,
    hidden_act="quick_gelu",
    hidden_state_index=-2,
)
SDXL_CLIP_2 = CLIPTextConfig(
    hidden_size=1280,
    num_layers=32,
    num_heads=20,
    hidden_act="gelu",
    hidden_state_index=-2,
    projection_dim=1280,
)
# --- SDXL refiner (single 1280 encoder, 2560 context) ---
SDXL_REFINER_UNET = UNet2DConfig(
    block_out_channels=(384, 768, 1536, 1536),
    transformer_layers=(0, 4, 4, 0),
    mid_transformer_layers=4,
    num_attention_heads=(6, 12, 24, 24),  # head dim 64 throughout
    cross_attention_dim=1280,
    addition_embed_dim=2560,  # 1280 pooled + 5*256 time ids
)

SD_VAE = VAEConfig()
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
# Flux: 16-channel latents, shifted and scaled, no 1x1 quant convs
# (black-forest-labs/FLUX.1-* AutoencoderKL config)
FLUX_VAE = VAEConfig(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
                     use_quant_conv=False)


# --- Flux (black-forest-labs/FLUX.1-dev and -schnell) ---
@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64  # 16 latent channels x 2x2 patch
    hidden_size: int = 3072
    num_heads: int = 24
    depth_double: int = 19
    depth_single: int = 38
    mlp_ratio: float = 4.0
    context_dim: int = 4096  # T5-XXL d_model
    pooled_dim: int = 768  # CLIP-L pooled
    guidance_embed: bool = True  # dev's distilled guidance; schnell: False
    axes_dims_rope: tuple[int, ...] = (16, 56, 56)
    theta: int = 10_000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


TINY_FLUX = FluxConfig(
    in_channels=16,  # 4 latent channels x 2x2 patch (tiny VAE)
    hidden_size=32,
    num_heads=2,
    depth_double=1,
    depth_single=1,
    context_dim=32,
    pooled_dim=32,
    guidance_embed=True,
    axes_dims_rope=(4, 6, 6),
)


# --- T5 encoders (Flux's T5-XXL) ---
@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


# the tiny config keeps every structural feature
TINY_T5 = T5Config(vocab_size=1000, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2)


# --- tiny configs for hermetic tests / test_tiny_model jobs ---
TINY_UNET = UNet2DConfig(
    block_out_channels=(32, 64),
    transformer_layers=(1, 1),
    mid_transformer_layers=1,
    layers_per_block=1,
    num_attention_heads=4,
    cross_attention_dim=32,
)
TINY_XL_UNET = UNet2DConfig(
    block_out_channels=(32, 64),
    transformer_layers=(1, 1),
    mid_transformer_layers=1,
    layers_per_block=1,
    num_attention_heads=4,
    cross_attention_dim=64,
    addition_embed_dim=128,  # 32 pooled + 6*16 time-id features
    addition_time_embed_dim=16,
)
TINY_CLIP = CLIPTextConfig(
    vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4, max_positions=77
)
TINY_CLIP_2 = CLIPTextConfig(
    vocab_size=1000,
    hidden_size=32,
    num_layers=2,
    num_heads=4,
    max_positions=77,
    projection_dim=32,
    hidden_state_index=-2,
)
TINY_VAE = VAEConfig(block_out_channels=(32, 32), layers_per_block=1)


def model_family(model_name: str) -> str:
    """Classify a hive model name into an architecture family."""
    name = model_name.lower()
    if "xl" in name and "refiner" in name:
        return "sdxl_refiner"
    if "xl" in name or "playground" in name:
        return "sdxl"
    if "stable-diffusion-2" in name or name.endswith("-v2-1") or "768" in name:
        return "sd21"
    return "sd15"


def auto_family(model_name: str) -> str:
    """The family a model name belongs to, as the JAX registry's
    `_auto_family` tells it: "flux", "sd_upscale", "sdxl" or "sd" for the
    families the port serves, else the later families' names. The one
    place that maps a name to a family: the registry, the coalesce key,
    the capacity tables and the SD configs all ask it."""
    name = model_name.lower()
    if "kandinsky-3" in name or "kandinsky3" in name:
        return "kandinsky3"
    if "kandinsky" in name:
        return "kandinsky_prior" if "prior" in name else "kandinsky"
    if "cascade" in name:
        return "cascade_prior" if "prior" in name else "cascade"
    if "flux" in name:
        return "flux"
    if name.startswith("deepfloyd/") or "tiny-if" in name:
        return "deepfloyd_if"
    if "latent-upscaler" in name or "tiny-upscaler" in name:
        return "sd_upscale"
    return "sdxl" if "xl" in model_family(model_name) else "sd"
