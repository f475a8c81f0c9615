"""Model configurations the port serves: SDXL base and the tiny stand-ins
of the hermetic tests. Copied from chiaswarm_tpu/models/configs.py (the
port imports nothing of the JAX package); the other families wait for
their slices of the port.
"""

from __future__ import annotations

from .clip import CLIPTextConfig
from .unet2d import UNet2DConfig
from .vae import VAEConfig

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
SDXL_VAE = VAEConfig(scaling_factor=0.13025)

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
