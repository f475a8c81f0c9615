"""Model configurations the port serves: SD 1.x, SD 2.x, SDXL base and
refiner, Flux (its MMDiT transformer, T5-XXL and the 16-channel VAE; its
CLIP is SD 1.x's CLIP-L), Kandinsky 2.x (the diffusion prior, the
image-embed decoder UNet, MoVQ and 2.1's MCLIP text tower), Kandinsky 3
(its UNet; FLAN-UL2's T5 encoder through `t5_config_from_json`), Stable
Cascade (stage C and stage B of one UNet class, the Paella VQ decoder),
and the tiny stand-ins of the hermetic tests. Copied from
chiaswarm_tpu/models/ configs.py, flux.py, t5.py, prior.py,
unet_kandinsky.py, unet_kandinsky3.py, cascade_unet.py, paella_vq.py,
movq.py, mclip.py and clap.py, and pipelines/kandinsky.py's
`prior_config_with_overrides` (the port imports nothing of the JAX
package); the other families wait for their slices of the port.
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


def t5_config_from_json(cj: dict | None) -> T5Config:
    """Geometry from a transformers T5 / UL2 config.json, Flux's T5-XXL
    where a key is absent. Kandinsky 3 rides FLAN-UL2's encoder: d_model
    4096, 32 layers, d_ff 16384, 16 heads of 256 (so heads x d_kv need
    not be d_model)."""
    cj = cj or {}
    base = T5Config()
    return T5Config(**{f.name: type(getattr(base, f.name))(cj.get(f.name, getattr(base, f.name)))
                       for f in dataclasses.fields(T5Config)})


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


# --- Kandinsky 2.x (kandinsky-community/kandinsky-2-2-* and -2-1*) ---
@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """diffusers' PriorTransformer geometry (the -prior repos)."""

    embed_dim: int = 1280  # CLIP image-embedding width (ViT-bigG)
    num_heads: int = 32
    head_dim: int = 64  # inner width = heads x head_dim = 2048
    num_layers: int = 20
    text_seq: int = 77
    text_dim: int = 1280  # the text tower's hidden width
    additional_tokens: int = 4  # [text embed, time, sample, prd]

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim


TINY_PRIOR = PriorConfig(embed_dim=32, num_heads=4, head_dim=16, num_layers=2, text_seq=77,
                         text_dim=32)


def prior_config_with_overrides(cfg: PriorConfig, config_json: dict | None) -> PriorConfig:
    """Geometry overrides from prior/config.json (2.1 and 2.2 priors share
    the 20-layer 2048-wide transformer and differ in embedding width)."""
    cj = config_json or {}
    return dataclasses.replace(
        cfg,
        embed_dim=int(cj.get("embedding_dim", cfg.embed_dim)),
        num_heads=int(cj.get("num_attention_heads", cfg.num_heads)),
        head_dim=int(cj.get("attention_head_dim", cfg.head_dim)),
        num_layers=int(cj.get("num_layers", cfg.num_layers)))


@dataclasses.dataclass(frozen=True)
class K22UNetConfig:
    """The Kandinsky decoder UNet (diffusers UNet2DConditionModel with
    ResnetDownsample / SimpleCrossAttn blocks and scale-shift resnets).
    Serving reads the geometry off the checkpoint
    (weights.infer_k22_unet_config); these defaults are the JAX package's."""

    in_channels: int = 4
    out_channels: int = 8  # learned variance: the pipeline keeps [:4]
    block_out_channels: tuple[int, ...] = (384, 768, 1280, 1280)
    layers_per_block: int = 3
    attention_head_dim: int = 64
    cross_attention_dim: int = 768
    encoder_hid_dim: int = 1280  # the image embedding's width (2.2)
    image_proj_tokens: int = 32
    down_attention: tuple[bool, ...] = (False, True, True, True)
    norm_num_groups: int = 32
    # "image" (2.2): the image embedding feeds the additive time branch and
    # the cross-attention tokens; "text_image" (2.1): MCLIP's states and
    # pooled projection ride beside it. DeepFloyd IF's "text" mode comes
    # with the IF slice of the port.
    conditioning: str = "image"
    # 2.1: the prior embedding's width (encoder_hid_dim is then the text's)
    image_embed_dim: int = 768


# kandinsky-community/kandinsky-2-2-decoder's unet/config.json
K22_DECODER_UNET = K22UNetConfig(block_out_channels=(384, 768, 1152, 1536))

TINY_K22_UNET = K22UNetConfig(
    block_out_channels=(32, 64), layers_per_block=1, attention_head_dim=8,
    cross_attention_dim=16, encoder_hid_dim=32, image_proj_tokens=2,
    down_attention=(False, True), norm_num_groups=8)


@dataclasses.dataclass(frozen=True)
class MoVQConfig:
    """diffusers VQModel with norm_type="spatial" (Kandinsky 2.x's movq)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    vq_embed_dim: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 1.0  # 2.x's movq does not scale its latents


TINY_MOVQ = MoVQConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)


def movq_config_from_json(cj: dict | None) -> MoVQConfig:
    """Geometry from a diffusers VQModel config.json."""
    cj = cj or {}
    base = MoVQConfig()
    return MoVQConfig(
        in_channels=int(cj.get("in_channels", base.in_channels)),
        out_channels=int(cj.get("out_channels", base.out_channels)),
        latent_channels=int(cj.get("latent_channels", base.latent_channels)),
        vq_embed_dim=int(cj.get("vq_embed_dim", base.vq_embed_dim)),
        block_out_channels=tuple(int(c) for c in cj.get("block_out_channels",
                                                        base.block_out_channels)),
        layers_per_block=int(cj.get("layers_per_block", base.layers_per_block)),
        norm_num_groups=int(cj.get("norm_num_groups", base.norm_num_groups)),
        scaling_factor=float(cj.get("scaling_factor", base.scaling_factor)))


@dataclasses.dataclass(frozen=True)
class MCLIPConfig:
    """Kandinsky 2.1's MultilingualCLIP: an XLM-RoBERTa trunk and one
    Linear into the CLIP space (the JAX package's ClapTextConfig)."""

    vocab_size: int = 250_002
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_positions: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5


MCLIP_XLMR_LARGE = MCLIPConfig()
TINY_MCLIP = MCLIPConfig(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
                         intermediate_size=64, max_positions=80, projection_dim=16)

# Kandinsky 2.1's prior text tower: CLIP ViT-L/14 with quick_gelu
K21_CLIP = CLIPTextConfig(hidden_size=768, num_layers=12, num_heads=12,
                          hidden_act="quick_gelu", projection_dim=768)
K21_PRIOR = PriorConfig(embed_dim=768, text_dim=768, num_heads=32, num_layers=20)
# kandinsky-community/kandinsky-2-1's unet/config.json: text_image, the
# prior's 768-wide embedding as 10 tokens ahead of MCLIP's 1024-wide states
K21_DECODER_UNET = dataclasses.replace(K22_DECODER_UNET, conditioning="text_image",
                                       encoder_hid_dim=1024, image_embed_dim=768,
                                       image_proj_tokens=10)
TINY_K21_UNET = dataclasses.replace(TINY_K22_UNET, conditioning="text_image",
                                    encoder_hid_dim=TINY_MCLIP.hidden_size,
                                    image_embed_dim=TINY_PRIOR.embed_dim, image_proj_tokens=3)


# --- Kandinsky 3 (kandinsky-community/kandinsky-3) ---
@dataclasses.dataclass(frozen=True)
class K3UNetConfig:
    """diffusers' Kandinsky3UNet; serving reads the geometry off the
    checkpoint (weights.infer_k3_unet_config)."""

    in_channels: int = 4
    time_embedding_dim: int = 1536
    groups: int = 32
    attention_head_dim: int = 64
    layers_per_block: int = 3
    block_out_channels: tuple[int, ...] = (384, 768, 1536, 3072)
    cross_attention_dim: int = 4096
    encoder_hid_dim: int = 4096
    add_cross_attention: tuple[bool, ...] = (False, True, True, True)
    add_self_attention: tuple[bool, ...] = (False, True, True, True)
    expansion_ratio: int = 4
    compression_ratio: int = 2

    @property
    def init_channels(self) -> int:
        return self.block_out_channels[0] // 2


# layers_per_block >= 2: the up blocks' channel plan needs a first and a
# last pair
TINY_K3_UNET = K3UNetConfig(
    time_embedding_dim=32, groups=4, attention_head_dim=8, layers_per_block=2,
    block_out_channels=(16, 32), cross_attention_dim=32, encoder_hid_dim=32,
    add_cross_attention=(False, True), add_self_attention=(False, True))
# google/flan-ul2's encoder, kandinsky-community/kandinsky-3's text_encoder
FLAN_UL2_T5 = T5Config(vocab_size=32128, d_model=4096, d_kv=256, num_heads=16, d_ff=16384,
                       num_layers=32)


# --- Stable Cascade (stabilityai/stable-cascade-prior and -cascade) ---
@dataclasses.dataclass(frozen=True)
class CascadeUNetConfig:
    """diffusers' StableCascadeUNet, one class for stage C (the prior) and
    stage B (the decoder); the defaults are stage C's."""

    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 1
    timestep_ratio_embedding_dim: int = 64
    conditioning_dim: int = 2048
    block_out_channels: tuple[int, ...] = (2048, 2048)
    num_attention_heads: tuple[int, ...] = (32, 32)
    down_num_layers_per_block: tuple[int, ...] = (8, 24)
    up_num_layers_per_block: tuple[int, ...] = (24, 8)
    down_blocks_repeat_mappers: tuple[int, ...] = (1, 1)
    up_blocks_repeat_mappers: tuple[int, ...] = (1, 1)
    # per level: whether each layer carries an attention block after its
    # resnet and timestep block
    attention: tuple[bool, ...] = (True, True)
    clip_text_pooled_in_channels: int = 1280
    clip_text_in_channels: int = 0  # 0: absent (stage B)
    clip_image_in_channels: int = 0  # 0: absent (stage B)
    clip_seq: int = 4
    effnet_in_channels: int = 0  # stage B: 16, stage C's latent channels
    pixel_mapper_in_channels: int = 0  # stage B: 3
    kernel_size: int = 3
    self_attn: bool = True
    timestep_conditioning_type: tuple[str, ...] = ("sca", "crp")
    # None: strided-conv scalers (stage B); a tuple: 1x1-conv scalers,
    # each with a bilinear rescale where True (stage C: (False,))
    switch_level: tuple[bool, ...] | None = None


# stabilityai/stable-cascade-prior's prior/config.json (about 3.6 B)
CASCADE_STAGE_C = CascadeUNetConfig(clip_text_in_channels=1280, clip_image_in_channels=768,
                                    switch_level=(False,))
# stabilityai/stable-cascade's decoder/config.json (about 1.56 B)
CASCADE_STAGE_B = CascadeUNetConfig(
    in_channels=4, out_channels=4, patch_size=2, conditioning_dim=1280,
    block_out_channels=(320, 640, 1280, 1280), num_attention_heads=(0, 0, 20, 20),
    down_num_layers_per_block=(2, 6, 28, 6), up_num_layers_per_block=(6, 28, 6, 2),
    down_blocks_repeat_mappers=(1, 1, 1, 1), up_blocks_repeat_mappers=(3, 3, 2, 2),
    attention=(False, False, True, True), effnet_in_channels=16, pixel_mapper_in_channels=3,
    timestep_conditioning_type=("sca",), switch_level=None)
TINY_CASCADE_C = CascadeUNetConfig(
    timestep_ratio_embedding_dim=8, conditioning_dim=32, block_out_channels=(32, 32),
    num_attention_heads=(4, 4), down_num_layers_per_block=(1, 2), up_num_layers_per_block=(2, 1),
    down_blocks_repeat_mappers=(1, 2), up_blocks_repeat_mappers=(2, 1),
    clip_text_pooled_in_channels=16, clip_text_in_channels=16, clip_image_in_channels=12,
    clip_seq=2, switch_level=(False,))
TINY_CASCADE_B = CascadeUNetConfig(
    in_channels=4, out_channels=4, patch_size=2, timestep_ratio_embedding_dim=8,
    conditioning_dim=16, block_out_channels=(16, 32), num_attention_heads=(0, 4),
    down_num_layers_per_block=(1, 2), up_num_layers_per_block=(2, 1),
    down_blocks_repeat_mappers=(1, 1), up_blocks_repeat_mappers=(2, 1), attention=(False, True),
    clip_text_pooled_in_channels=16, effnet_in_channels=16, pixel_mapper_in_channels=3,
    clip_seq=2, timestep_conditioning_type=("sca",), switch_level=None)


@dataclasses.dataclass(frozen=True)
class PaellaVQConfig:
    """Stable Cascade's stage A, diffusers' PaellaVQModel (its decoder)."""

    out_channels: int = 3
    up_down_scale_factor: int = 2
    levels: int = 2
    bottleneck_blocks: int = 12
    embed_dim: int = 384
    latent_channels: int = 4
    scale_factor: float = 0.3764

    def c_levels(self) -> tuple[int, ...]:
        return tuple(self.embed_dim // (2 ** i) for i in reversed(range(self.levels)))


TINY_PAELLA_VQ = PaellaVQConfig(levels=2, bottleneck_blocks=2, embed_dim=32, latent_channels=4)
# Stable Cascade's CLIP-bigG with projection for the tiny stand-ins; its
# published tower is SDXL_CLIP_2's widths, read from config.json
TINY_CASCADE_CLIP = CLIPTextConfig(vocab_size=1000, hidden_size=16, num_layers=2, num_heads=4,
                                   max_positions=77, projection_dim=16, apply_final_norm=False)


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
