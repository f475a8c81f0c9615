"""Weights: the load-or-random-init policy, the diffusers checkpoint loader,
seeded random init, and conversion of the JAX package's parameter trees
into the port's state dicts.

Policy (a copy of chiaswarm_tpu/weights.py and of the JAX pipeline's
`_load_params`):

- `<model_root_dir>/<name>/` exists: its `unet/`, `vae/` and
  `text_encoder/` (`text_encoder_2/` for a second encoder) safetensors
  load, every `*.safetensors` of a folder in sorted order. A folder
  without safetensors gives random init where the name allows it (below)
  and `MissingWeightsError` where it does not; a file that is present but
  broken raises `CheckpointError` and never falls back.
- no model directory: `test/*` and `*tiny*` model names, and callers that
  pass `allow_random_init=True` (benchmarks, bring-up: speed does not
  depend on weight values), get seeded random init; anything else raises
  `MissingWeightsError`, a ValueError, so the worker returns a fatal
  envelope and the hive does not resubmit.

The port's modules use diffusers / transformers key names, so a
checkpoint loads without a rename; the loader makes only the fix-ups of
chiaswarm_tpu/models/conversion.py (`checkpoint_key`, `checkpoint_tensor`).

The SD-x2 upscaler's configs are read off its checkpoint as the JAX
package's `infer_k_upscaler_config` / `infer_vae_config` read them, from
the tensors' shapes (`checkpoint_shapes`, no tensor loaded) and the
folders' config.json.

Flux's model directory holds `transformer/` (diffusers'
FluxTransformer2DModel names, which the port's module keeps),
`text_encoder_2/` (T5, transformers' names; `encoder.embed_tokens` is the
tied `shared` table), `text_encoder/` (CLIP-L) and `vae/`, as the JAX
FluxPipeline's `_convert_params` reads them (`FLUX_FOLDERS`).

Kandinsky 2.x: a decoder directory holds `unet/`, `movq/` and, for 2.1,
`text_encoder/` (MCLIP) and `tokenizer/tokenizer.json`; a prior directory
`prior/` (PriorTransformer, with the `clip_mean` / `clip_std` whitening
stats, read apart by `read_tensors`), `text_encoder/` (CLIP) and
optionally `zero_image_embed.npy` (`KANDINSKY_DECODER_FOLDERS`,
`KANDINSKY_PRIOR_FOLDERS`). The loader drops MoVQ's codebook
(`quantize.*`) and MCLIP's unused CLS pooler; a MoVQ whose SpatialNorm
group norms are non-affine (no `norm_layer` weights) loads with identity
ones (`load_movq_`). `infer_k22_unet_config` reads the decoder UNet's
geometry off its checkpoint, as the JAX package's `infer_k22_unet_config`,
the ControlNet variant's extra hint channels in `conv_in` too.

`from_jax_params` inverts chiaswarm_tpu/models/conversion.py's
`convert_unet` (a ControlNet's tree too) / `convert_vae` / `convert_clip`
/ `convert_k_upscaler` / `convert_safety_checker` / `convert_flux` /
`convert_t5` / `convert_kandinsky_unet` / `convert_movq` / `convert_prior`
/ `convert_mclip`, and the detectors'
`convert_dpt` / `convert_hed` / `convert_openpose_body` /
`convert_pidinet` / `convert_mlsd` / `convert_lineart` /
`convert_zoedepth` / `convert_upernet` (and the tiny PoseNet's tree):
flax paths become diffusers / transformers / upstream key names again,
HWIO conv kernels become OIHW, Dense [in, out] kernels become Linear
[out, in]. Where a JAX converter folds BatchNorms or re-parameterises
kernels, the inverse gives that folded form, which the port's detectors
load as well as the published one. `load_detector_state_` is the
detectors' strict loader.
"""

from __future__ import annotations

import logging
import math
import re
import zlib
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .models.configs import CascadeUNetConfig, K22UNetConfig, K3UNetConfig, PaellaVQConfig
from .models.k_upscaler import KUpscalerConfig
from .models.layers import FusedGroupNorm
from .models.t5 import RMSNorm
from .models.vae import VAEConfig

logger = logging.getLogger(__name__)

# a checkpoint's text-encoder folders, by the encoder's position
TEXT_ENCODER_FOLDERS = ("text_encoder", "text_encoder_2")
# a Flux model directory's folders: the transformer, T5, CLIP-L, the VAE
FLUX_FOLDERS = ("transformer", "text_encoder_2", "text_encoder", "vae")
# a Kandinsky 2.x decoder's folders (2.1 adds MCLIP's text_encoder/), and
# a prior's
KANDINSKY_DECODER_FOLDERS = ("unet", "movq")
KANDINSKY_PRIOR_FOLDERS = ("prior", "text_encoder")
# the prior's whitening stats, which are no parameters of the module
PRIOR_STATS = ("clip_mean", "clip_std")
# a Kandinsky 3 directory: the UNet, MoVQ and the FLAN-UL2 T5 encoder
KANDINSKY3_FOLDERS = ("unet", "movq", "text_encoder")
# Stable Cascade: a prior repo's stage C and CLIP-bigG, a decoder repo's
# stage B, CLIP-bigG and the Paella VQ
CASCADE_PRIOR_FOLDERS = ("prior", "text_encoder")
CASCADE_DECODER_FOLDERS = ("decoder", "text_encoder", "vqgan")


class MissingWeightsError(ValueError):
    """Model weights are not present on this worker (fatal job error)."""


class CheckpointError(RuntimeError):
    """A checkpoint file that is present but does not load: unreadable, a
    key the module lacks, a shape that differs, or a parameter that no
    file holds. Not a ValueError: another worker's files may be whole, so
    the hive may resubmit the job."""


def is_test_model(model_name: str) -> bool:
    name = model_name.lower()
    return name.startswith("test/") or "tiny" in name


def random_init_permitted(model_name: str, allow_random_init: bool) -> bool:
    return allow_random_init or is_test_model(model_name)


def require_weights_present(model_name: str, model_dir: Path | None,
                            allow_random_init: bool, component: str = "model",
                            hint: str | None = None) -> bool:
    """True when the caller may proceed with random init; raises
    MissingWeightsError for a production model whose weights are absent."""
    if random_init_permitted(model_name, allow_random_init):
        return True
    where = f" (looked in {model_dir})" if model_dir is not None else ""
    if hint is None:
        hint = ("Put its diffusers-layout safetensors under <model_root_dir>/<name>/"
                "{unet,vae,text_encoder[_2]}/, serve test/tiny models, or pass "
                "allow_random_init=True.")
    raise MissingWeightsError(
        f"{component} weights for '{model_name}' are not present on this "
        f"worker{where}. {hint}")


def model_seed(model_name: str) -> int:
    """The random-init seed of a model. Not hash(): str hash is salted per
    process, and weights must agree across workers."""
    return zlib.crc32(model_name.encode())


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in parameter order: norms 1/0 (RMSNorm scales 1),
    biases 0, embeddings N(0, 0.02) (positions 0.01, as the JAX package),
    every other weight N(0, 1/fan_in) (LeCun normal, flax's Dense/Conv
    default). It draws in the parameters' own dtype and device, so a
    module materialised in bf16 on the card is seeded there, with no f32
    copy anywhere."""
    for name, p in module.named_parameters():
        owner_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        owner = module.get_submodule(owner_name)
        if isinstance(owner, (nn.LayerNorm, FusedGroupNorm, RMSNorm)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif isinstance(owner, nn.Embedding):
            std = 0.01 if owner_name.endswith("position_embedding") else 0.02
            p.normal_(0.0, std, generator=generator)
        elif leaf == "bias":
            p.zero_()
        else:
            p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=generator)


# --- diffusers checkpoints ---

def checkpoint_folders(n_encoders: int) -> tuple[str, ...]:
    """The folders of a model directory that the pipeline loads."""
    return ("unet", "vae", *TEXT_ENCODER_FOLDERS[:n_encoders])


def find_checkpoint(model_name: str, model_dir: Path | None, folders,
                    allow_random_init: bool) -> dict[str, list[Path]] | None:
    """{folder: sorted safetensors files} to load, or None for random init
    (raises MissingWeightsError where the policy forbids it)."""
    if model_dir is None:
        require_weights_present(model_name, None, allow_random_init)
        return None
    files = {}
    for folder in folders:
        files[folder] = sorted((model_dir / folder).glob("*.safetensors"))
        if not files[folder]:
            require_weights_present(model_name, model_dir, allow_random_init)
            logger.warning("no safetensors under %s; falling back to random init",
                           model_dir / folder)
            return None
    return files


def checkpoint_files(model_dir: Path, folders) -> dict[str, list[Path]]:
    """{folder: sorted safetensors files} of a model directory; a folder
    without any raises FileNotFoundError."""
    files = {f: sorted((model_dir / f).glob("*.safetensors")) for f in folders}
    for folder, found in files.items():
        if not found:
            raise FileNotFoundError(f"no safetensors under {model_dir / folder}")
    return files


_LEGACY_VAE_ATTENTION = ((".query.", ".to_q."), (".key.", ".to_k."), (".value.", ".to_v."),
                         (".proj_attn.", ".to_out.0."))
_TEXT_LAYER = re.compile(r"text_model\.encoder\.layers\.(\d+)\.")


def checkpoint_key(key: str, folder: str, text_layers: int | None = None) -> str | None:
    """A checkpoint key -> the port's, or None for one that is dropped:
    `position_ids` buffers, MCLIP's CLS pooler, MoVQ's codebook, the
    prior's whitening stats (read apart), and text-encoder layers past the
    config's `text_layers` (SD 2.x's OpenCLIP-H files hold 24, the port
    runs 23), and the Paella VQ's encoder and quantizer (`vqgan/`).
    T5's `encoder.embed_tokens` is its tied `shared` table.
    The VAE's legacy attention names (query/key/value/proj_attn) become
    diffusers' (to_q/to_k/to_v/to_out.0)."""
    if key.endswith("position_ids") or key.startswith("transformer.pooler."):
        return None
    if (folder == "movq" and key.startswith("quantize.")) or (
            folder == "prior" and key in PRIOR_STATS):
        return None
    if folder == "vqgan" and not key.startswith(("up_blocks.", "out_block.")):
        return None  # the Paella VQ's encoder and quantizer: serving only decodes
    if key == "encoder.embed_tokens.weight":
        return "shared.weight"  # T5's token table, tied to `shared`
    if text_layers is not None:
        layer = _TEXT_LAYER.match(key)
        if layer and int(layer.group(1)) >= text_layers:
            return None
    if folder in ("vae", "movq"):
        for old, new in _LEGACY_VAE_ATTENTION:
            key = key.replace(old, new)
    return key


def movq_optional(name: str) -> bool:
    """MoVQ's parameters that a checkpoint may lack: the SpatialNorm group
    norms' scale and shift, which a non-affine checkpoint leaves at
    identity."""
    return ".norm_layer." in name


def checkpoint_shape(name: str, shape) -> tuple:
    """The shape a checkpoint tensor takes in the port: SD 1.x's
    transformer `proj_in` / `proj_out` are 1x1 convolutions [C, C, 1, 1]
    in its files; the port's are Linear [C, C]."""
    shape = tuple(shape)
    if (name.endswith(("proj_in.weight", "proj_out.weight")) and len(shape) == 4
            and shape[2:] == (1, 1)):
        return shape[:2]
    return shape


def checkpoint_tensor(name: str, tensor: torch.Tensor) -> torch.Tensor:
    """A checkpoint tensor in the port's shape (`checkpoint_shape`)."""
    return tensor.reshape(checkpoint_shape(name, tensor.shape))


def _checkpoint_headers(files: list[Path]):
    """(path, key, shape) of every tensor in safetensors files, read from
    their headers."""
    from safetensors import SafetensorError, safe_open

    for path in files:
        try:
            with safe_open(str(path), framework="pt") as f:
                entries = [(key, tuple(f.get_slice(key).get_shape())) for key in f.keys()]
        except (SafetensorError, OSError) as e:
            raise CheckpointError(f"{path}: unreadable safetensors file ({e})") from e
        for key, shape in entries:
            yield path, key, shape


def _checkpoint_fit(module: nn.Module, files: list[Path], folder: str,
                    text_layers: int | None, optional):
    """How one folder's files fit `module`, from their headers: (the
    tensors to load [(path, key, name)], the keys the module lacks
    [(path, key)], the shapes that differ [(path, key, shape, name,
    module's shape)], the parameters no file holds, save those that
    `optional(name)` accepts). The one rule of the loader and the check."""
    targets = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    plan, extra, misshaped, loaded = [], [], [], set()
    for path, key, shape in _checkpoint_headers(files):
        name = checkpoint_key(key, folder, text_layers)
        if name is None:
            continue
        if name not in targets:
            extra.append((path, key))
            continue
        shape = checkpoint_shape(name, shape)
        if shape != targets[name]:
            misshaped.append((path, key, shape, name, targets[name]))
        plan.append((path, key, name))
        loaded.add(name)
    missing = sorted(n for n in set(targets) - loaded if optional is None or not optional(n))
    return plan, extra, misshaped, missing


@torch.no_grad()
def load_checkpoint_(module: nn.Module, files: list[Path], folder: str,
                     text_layers: int | None = None, optional=None) -> int:
    """Copy one folder's safetensors into `module`'s own parameters, cast to
    their dtype, one tensor at a time (no second copy of the module on its
    device): a strict load, held to the files' headers before any tensor
    is read (`_checkpoint_fit`, the rule `check_checkpoint` holds too), so
    a key the module lacks, a shape that differs or a parameter that no
    file holds raises CheckpointError, naming the key and the file; a
    parameter whose name `optional(name)` accepts may be absent, and keeps
    its value. -> bytes read."""
    from safetensors import SafetensorError, safe_open

    plan, extra, misshaped, missing = _checkpoint_fit(module, files, folder, text_layers,
                                                      optional)
    if extra:
        path, key = extra[0]
        raise CheckpointError(f"{path}: unexpected key {key!r} (the {folder} module has no "
                              "such parameter)")
    if misshaped:
        path, key, shape, name, want = misshaped[0]
        raise CheckpointError(f"{path}: {key!r} has shape {shape}, the {folder} module's "
                              f"{name!r} {want}")
    if missing:
        raise CheckpointError(f"{files[0].parent}: {len(missing)} {folder} parameters in no "
                              f"file, e.g. {missing[:3]}")
    targets = module.state_dict()  # views of the parameters
    for path in files:
        try:
            with safe_open(str(path), framework="pt") as f:
                for _, key, name in (entry for entry in plan if entry[0] == path):
                    targets[name].copy_(checkpoint_tensor(name, f.get_tensor(key)))
        except (SafetensorError, OSError) as e:
            raise CheckpointError(f"{path}: unreadable safetensors file ({e})") from e
    return sum(path.stat().st_size for path in files)


@torch.no_grad()
def load_movq_(movq: nn.Module, files: list[Path]) -> int:
    """MoVQ's load: the SpatialNorm scale and shift set to identity first,
    where a non-affine checkpoint leaves them (`movq_optional`). -> bytes
    read."""
    for name, p in movq.named_parameters():
        if movq_optional(name):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
    return load_checkpoint_(movq, files, "movq", optional=movq_optional)


def check_checkpoint(module: nn.Module, files: list[Path], folder: str,
                     text_layers: int | None = None, optional=None) -> int:
    """What `load_checkpoint_` would load, held against `module` (on any
    device, the meta device too) by the loader's own rule
    (`_checkpoint_fit`), from the files' headers alone: raises
    CheckpointError naming every key the module lacks, every parameter no
    file holds and every shape that differs. -> the module's parameter
    count."""
    if not files:
        raise CheckpointError(f"no safetensors for the {folder} module")
    _, extra, misshaped, missing = _checkpoint_fit(module, files, folder, text_layers,
                                                   optional)
    if extra or missing or misshaped:
        raise CheckpointError(
            f"{files[0].parent}: the {folder} checkpoint does not fit its module: "
            f"missing {missing}, unexpected {sorted(key for _, key in extra)}, misshaped "
            f"{[f'{key} {shape} != {want}' for _, key, shape, _, want in misshaped]}")
    return sum(p.numel() for p in module.parameters())


def read_tensors(files: list[Path], keys) -> dict[str, torch.Tensor]:
    """The tensors of `keys` that the safetensors files hold (f32, CPU)."""
    from safetensors import SafetensorError, safe_open

    out = {}
    for path in files:
        try:
            with safe_open(str(path), framework="pt") as f:
                for key in set(keys) & set(f.keys()):
                    out[key] = f.get_tensor(key).float()
        except (SafetensorError, OSError) as e:
            raise CheckpointError(f"{path}: unreadable safetensors file ({e})") from e
    return out


def infer_k22_unet_config(shapes: dict, config_json: dict | None = None) -> K22UNetConfig:
    """The Kandinsky decoder UNet's config from its checkpoint's shapes, as
    the JAX package infers it: levels, widths and resnets from the down
    blocks' conv1, where attention is from its to_q, the cross width from
    add_k_proj, the input channels (a ControlNet's 4 + 3 hint channels)
    from conv_in, the conditioning from the projection keys (2.1's
    `encoder_hid_proj.text_proj` gives "text_image"), the image tokens from
    the projection's width; head width and groups from config.json (64 and
    32 unset). A checkpoint of neither mode (DeepFloyd IF's text UNet)
    raises ValueError: that family is not ported yet."""
    cj = config_json or {}
    blocks: dict[int, int] = {}
    attn: set[int] = set()
    layers = 1
    for k in shapes:
        if m := re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.conv1\.weight", k):
            blocks[int(m.group(1))] = int(shapes[k][0])
            layers = max(layers, int(m.group(2)) + 1)
        if m := re.match(r"down_blocks\.(\d+)\.attentions\.0\.to_q\.weight", k):
            attn.add(int(m.group(1)))
    n = max(blocks) + 1
    cross = int(shapes[f"down_blocks.{min(attn)}.attentions.0.add_k_proj.weight"][1])
    image_w = shapes.get("encoder_hid_proj.image_embeds.weight")
    if image_w is None:
        raise ValueError("not a Kandinsky 2.x decoder UNet (no image projection): "
                         "DeepFloyd IF's text UNet is not ported to chiaswarm_tpu_torch yet")
    text_image = "encoder_hid_proj.text_proj.weight" in shapes
    hid_dim = int(shapes["encoder_hid_proj.text_proj.weight"][1] if text_image else image_w[1])
    return K22UNetConfig(
        in_channels=int(shapes["conv_in.weight"][1]),
        out_channels=int(shapes["conv_out.weight"][0]),
        block_out_channels=tuple(blocks[i] for i in range(n)),
        layers_per_block=layers,
        attention_head_dim=int(cj.get("attention_head_dim", 64)),
        cross_attention_dim=cross,
        encoder_hid_dim=hid_dim,
        image_proj_tokens=int(image_w[0]) // cross,
        down_attention=tuple(i in attn for i in range(n)),
        norm_num_groups=int(cj.get("norm_num_groups", 32)),
        conditioning="text_image" if text_image else "image",
        image_embed_dim=int(image_w[1]) if text_image else 768)


def infer_k3_unet_config(shapes: dict, config_json: dict | None = None) -> K3UNetConfig:
    """The Kandinsky 3 UNet's config from its checkpoint's shapes, as the
    JAX package infers it: levels and widths from each down level's
    resnets, self- and cross-attention from the attention indices, the
    context widths from `encoder_hid_proj`, the compression ratio from
    level 0's first bottleneck, the expansion from a feed-forward; head
    width and groups from config.json (64 and 32 unset)."""
    cj = config_json or {}
    blocks: dict[int, int] = {}
    layers = 1
    self_attn, cross_attn = set(), set()
    for k in shapes:
        if m := re.match(r"down_blocks\.(\d+)\.resnets_in\.(\d+)\.resnet_blocks\.3\."
                         r"projection\.weight", k):
            blocks[int(m.group(1))] = int(shapes[k][0])
            layers = max(layers, int(m.group(2)) + 1)
        if m := re.match(r"down_blocks\.(\d+)\.attentions\.(\d+)\.attention\.", k):
            (self_attn if m.group(2) == "0" else cross_attn).add(int(m.group(1)))
    n = max(blocks) + 1
    block_out = tuple(blocks[i] for i in range(n))
    hid = shapes["encoder_hid_proj.projection_linear.weight"]
    h0 = int(shapes["down_blocks.0.resnets_in.0.resnet_blocks.0.projection.weight"][0])
    first = min(self_attn | cross_attn) if (self_attn or cross_attn) else 0
    ff = (shapes.get(f"down_blocks.{first}.attentions.0.feed_forward.0.weight")
          or shapes.get(f"down_blocks.{first}.attentions.1.feed_forward.0.weight"))
    return K3UNetConfig(
        in_channels=int(shapes["conv_in.weight"][1]),
        time_embedding_dim=int(shapes["time_embedding.linear_2.weight"][0]),
        groups=int(cj.get("groups", 32)),
        attention_head_dim=int(cj.get("attention_head_dim", 64)),
        layers_per_block=layers,
        block_out_channels=block_out,
        cross_attention_dim=int(hid[0]),
        encoder_hid_dim=int(hid[1]),
        add_cross_attention=tuple(i in cross_attn for i in range(n)),
        add_self_attention=tuple(i in self_attn for i in range(n)),
        expansion_ratio=int(ff[0] // ff[1]) if ff else 4,
        compression_ratio=max(1, block_out[0] // h0))


def infer_cascade_unet_config(shapes: dict, config_json: dict | None = None
                              ) -> CascadeUNetConfig:
    """A Stable Cascade UNet's config from its checkpoint's shapes, as the
    JAX package infers it; config.json gives what shapes cannot (patch
    size, head counts, clip_seq, self_attn, switch levels, the
    conditioning order), with the released configs' values unset."""
    cj = config_json or {}
    levels = 1 + max(int(m.group(1)) for k in shapes
                     if (m := re.match(r"down_blocks\.(\d+)\.", k)))
    block_out, down_layers, up_layers, attention = [], [], [], []
    for i in range(levels):
        res = sorted(int(m.group(1)) for k in shapes
                     if (m := re.match(rf"down_blocks\.{i}\.(\d+)\.depthwise\.weight$", k)))
        block_out.append(int(shapes[f"down_blocks.{i}.{res[0]}.depthwise.weight"][0]))
        down_layers.append(len(res))
        up_layers.append(sum(1 for k in shapes if re.match(
            rf"up_blocks\.{levels - 1 - i}\.\d+\.depthwise\.weight$", k)))
        attention.append(any(re.match(rf"down_blocks\.{i}\.\d+\.attention\.to_q\.", k)
                             for k in shapes))

    def repeats(prefix):
        return tuple(1 + len({m.group(1) for k in shapes
                              if (m := re.match(rf"{prefix}\.{i}\.(\d+)\.weight$", k))})
                     for i in range(levels))

    t_dim = next((int(v[1]) for k, v in shapes.items() if k.endswith(".mapper.weight")), 64)
    conds = tuple(cj.get("timestep_conditioning_type", [
        c for c in ("sca", "crp") if any(k.endswith(f".mapper_{c}.weight") for k in shapes)]))
    clip_seq = int(cj.get("clip_seq") or 4)
    ctp = shapes["clip_txt_pooled_mapper.weight"]
    patch = int(cj.get("patch_size") or 1)
    heads_cj = cj.get("num_attention_heads")
    if heads_cj is None:
        heads = tuple(c // 64 if a else 0 for c, a in zip(block_out, attention))
    elif isinstance(heads_cj, int):
        heads = (heads_cj,) * levels
    else:
        heads = tuple(int(h or 0) for h in heads_cj)
    self_attn = cj.get("self_attn", True)
    if isinstance(self_attn, (list, tuple)):
        self_attn = bool(self_attn[0])
    switch = None
    if any(".blocks." in k for k in shapes if k.startswith(("down_downscalers", "up_upscalers"))):
        switch = tuple(cj.get("switch_level") or [False] * (levels - 1))

    def width(key, axis=1):
        return int(shapes[key][axis]) if key in shapes else 0

    dw = next(k for k in shapes if k.endswith(".depthwise.weight"))
    return CascadeUNetConfig(
        in_channels=int(shapes["embedding.1.weight"][1]) // patch ** 2,
        out_channels=int(shapes["clf.1.weight"][0]) // patch ** 2,
        patch_size=patch,
        timestep_ratio_embedding_dim=t_dim,
        conditioning_dim=int(ctp[0]) // clip_seq,
        block_out_channels=tuple(block_out),
        num_attention_heads=heads,
        down_num_layers_per_block=tuple(down_layers),
        up_num_layers_per_block=tuple(reversed(up_layers)),
        down_blocks_repeat_mappers=repeats("down_repeat_mappers"),
        up_blocks_repeat_mappers=repeats("up_repeat_mappers"),
        attention=tuple(attention),
        clip_text_pooled_in_channels=int(ctp[1]),
        clip_text_in_channels=width("clip_txt_mapper.weight"),
        clip_image_in_channels=width("clip_img_mapper.weight"),
        clip_seq=clip_seq,
        effnet_in_channels=width("effnet_mapper.0.weight"),
        pixel_mapper_in_channels=width("pixels_mapper.0.weight"),
        kernel_size=int(shapes[dw][-1]),
        self_attn=bool(self_attn),
        timestep_conditioning_type=conds,
        switch_level=switch)


def infer_paella_vq_config(shapes: dict, config_json: dict | None = None) -> PaellaVQConfig:
    """The Paella VQ decoder's config from its `up_blocks.*` / `out_block.*`
    shapes, as the JAX package infers it (the scale factor from
    config.json, 0.3764 unset)."""
    cj = config_json or {}
    in_w = shapes["up_blocks.0.0.weight"]
    ct = sorted(int(m.group(1)) for k in shapes
                if (m := re.match(r"up_blocks\.(\d+)\.weight$", k)))
    mix = sorted(int(m.group(1)) for k in shapes
                 if (m := re.match(r"up_blocks\.(\d+)\.gammas$", k)))
    first_ct = ct[0] if ct else 1 + (mix[-1] if mix else 0)
    factor = int(cj.get("up_down_scale_factor") or 2)
    return PaellaVQConfig(
        out_channels=int(shapes["out_block.0.weight"][0]) // factor ** 2,
        up_down_scale_factor=factor, levels=len(ct) + 1,
        bottleneck_blocks=sum(1 for i in mix if i < first_ct),
        embed_dim=int(in_w[0]), latent_channels=int(in_w[1]),
        scale_factor=float(cj.get("scale_factor") or 0.3764))


def checkpoint_shapes(files: list[Path]) -> dict[str, tuple]:
    """{key: shape} of the tensors in safetensors files, read from their
    headers."""
    return {key: shape for _, key, shape in _checkpoint_headers(files)}


def infer_k_upscaler_config(shapes: dict, config_json: dict | None = None) -> KUpscalerConfig:
    """The K-UNet's config from its checkpoint's shapes, as the JAX
    package infers it: levels, widths and resnets from the down blocks'
    conv1, where the cross- and self-attention are from the attn2 / attn1
    keys, the q/k/v bias from the bias keys; head width and group size
    from config.json (64 and 32 unset)."""
    cj = config_json or {}
    blocks: dict[int, int] = {}
    layers = 1
    cross, down_self, up_self = set(), set(), set()
    for k in shapes:
        if m := re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.conv1\.weight", k):
            blocks[int(m.group(1))] = int(shapes[k][0])
            layers = max(layers, int(m.group(2)) + 1)
        if m := re.match(r"down_blocks\.(\d+)\.attentions\.0\.attn2\.to_q\.", k):
            cross.add(int(m.group(1)))
        if m := re.match(r"down_blocks\.(\d+)\.attentions\.0\.attn1\.to_q\.", k):
            down_self.add(int(m.group(1)))
        if m := re.match(r"up_blocks\.(\d+)\.attentions\.0\.attn1\.to_q\.", k):
            up_self.add(int(m.group(1)))
    n = max(blocks) + 1
    first = min(cross) if cross else 1
    return KUpscalerConfig(
        in_channels=int(shapes["conv_in.weight"][1]),
        out_channels=int(shapes["conv_out.weight"][0]),
        block_out_channels=tuple(blocks[i] for i in range(n)),
        layers_per_block=layers,
        cross_attention_dim=int(shapes[f"down_blocks.{first}.attentions.0.attn2.to_k.weight"][1]),
        attention_head_dim=int(cj.get("attention_head_dim", 64)),
        resnet_group_size=int(cj.get("resnet_group_size") or cj.get("norm_num_groups") or 32),
        time_cond_proj_dim=int(shapes["time_embedding.cond_proj.weight"][1]),
        cross_attention=tuple(i in cross for i in range(n)),
        down_self_attention=tuple(i in down_self for i in range(n)),
        up_self_attention=tuple(i in up_self for i in range(n)),
        attention_bias=any(k.endswith("attn2.to_q.bias") for k in shapes))


def infer_vae_config(shapes: dict, config_json: dict | None = None) -> VAEConfig:
    """A VAE's config from its checkpoint's shapes; the scaling factor is
    training metadata that only config.json holds (0.18215 unset)."""
    blocks: dict[int, int] = {}
    layers = 1
    for k in shapes:
        if m := re.match(r"encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.conv1\.weight", k):
            blocks[int(m.group(1))] = int(shapes[k][0])
            layers = max(layers, int(m.group(2)) + 1)
    return VAEConfig(
        in_channels=int(shapes["encoder.conv_in.weight"][1]),
        latent_channels=int(shapes["decoder.conv_in.weight"][1]),
        block_out_channels=tuple(blocks[i] for i in range(max(blocks) + 1)),
        layers_per_block=layers,
        scaling_factor=float((config_json or {}).get("scaling_factor", 0.18215)),
        use_quant_conv="quant_conv.weight" in shapes)


# --- JAX parameter tree -> port state dicts ---

# torch module names that themselves end in _<digit> (the forward
# conversion only merges *separate* digit parts into their parent)
_KEEP_SUFFIX = {"linear_1", "linear_2"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix, key, value


def _split_index(component: str) -> str:
    if component in _KEEP_SUFFIX:
        return component
    return re.sub(r"_(\d+)$", r".\1", component)


def _tensor(leaf: str, value) -> tuple[str, np.ndarray]:
    value = np.asarray(value)
    if leaf == "kernel":
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        return "weight", value.T  # Dense [in, out] -> Linear [out, in]
    if leaf in ("scale", "embedding"):
        return "weight", value
    return leaf, value


def _state_dict(tree: dict, rename) -> dict[str, torch.Tensor]:
    out = {}
    for path, leaf, value in _flatten(tree):
        new_leaf, arr = _tensor(leaf, value)
        name = ".".join([_split_index(p) for p in path] + [new_leaf])
        out[rename(name)] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def _vae_name(name: str) -> str:
    name = name.replace("mid_block_resnets.", "mid_block.resnets.")
    name = name.replace("mid_block_attentions.", "mid_block.attentions.")
    return re.sub(r"(down_blocks|up_blocks)_(\d+)_(resnets|downsamplers|upsamplers)\.",
                  r"\1.\2.\3.", name)


def _clip_name(name: str) -> str:
    if name == "position_embedding":
        return "text_model.embeddings.position_embedding.weight"
    if name.startswith("text_projection."):
        return name
    if name.startswith("token_embedding."):
        return "text_model.embeddings." + name
    if name.startswith("layers."):
        name = "encoder." + re.sub(r"\.(fc[12])\.", r".mlp.\1.", name)
    return "text_model." + name


def unet_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    return _state_dict(tree, lambda name: name)


# a ControlNet's tree has the UNet's names, and its `blocks_N` and
# `controlnet_down_blocks_N` split into indices the same way
controlnet_state_dict = unet_state_dict


def vae_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    return _state_dict(tree, _vae_name)


def clip_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    # the position table is a bare param at the tree's root
    tree = dict(tree)
    pos = tree.pop("position_embedding", None)
    out = _state_dict(tree, _clip_name)
    if pos is not None:
        out[_clip_name("position_embedding")] = torch.from_numpy(
            np.array(pos, dtype=np.float32))
    return out


def _k_upscaler_name(name: str) -> str:
    if name == "time_proj_weight":
        return "time_proj.weight"
    name = name.replace("time_embedding_cond_proj.", "time_embedding.cond_proj.")
    name = re.sub(r"^time_embedding_linear\.(\d)\.", r"time_embedding.linear_\1.", name)
    return re.sub(r"^(down|up)_blocks_(\d+)_(resnets|attentions)\.", r"\1_blocks.\2.\3.", name)


def k_upscaler_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    return _state_dict(tree, _k_upscaler_name)


_SAFETY_LAYER = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                 "out": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
                 "ln1": "layer_norm1", "ln2": "layer_norm2"}


def _safety_name(name: str) -> str:
    tower = "vision_model.vision_model."
    if name.startswith(("concept_embeds", "special_care_embeds")):
        return name
    name = name.removeprefix("vision.")
    if name == "projection.weight":
        return "visual_projection.weight"
    if m := re.match(r"layer_(\d+)_(\w+?)\.(weight|bias)$", name):
        return f"{tower}encoder.layers.{m.group(1)}.{_SAFETY_LAYER[m.group(2)]}.{m.group(3)}"
    fixed = {"cls_embed": "embeddings.class_embedding",
             "pos_embed": "embeddings.position_embedding.weight",
             "patch_embed.weight": "embeddings.patch_embedding.weight"}
    if name in fixed:
        return tower + fixed[name]
    return tower + name.replace("pre_ln.", "pre_layrnorm.").replace("post_ln.", "post_layernorm.")


def safety_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    return _state_dict(tree, _safety_name)


def _dense(out: dict, name: str, node: dict) -> None:
    """A flax Dense {kernel [in, out], bias} -> Linear `name`.weight / .bias."""
    out[f"{name}.weight"] = np.asarray(node["kernel"]).T
    if "bias" in node:
        out[f"{name}.bias"] = np.asarray(node["bias"])


def _split_dense(out: dict, names: list[str], node: dict, widths: list[int]) -> None:
    """A fused flax Dense -> Linears `names`, its output columns cut in
    `widths` in order (the inverse of convert_flux's fusions)."""
    cuts = np.cumsum(widths)[:-1]
    for name, w in zip(names, np.split(np.asarray(node["kernel"]).T, cuts, axis=0)):
        out[f"{name}.weight"] = w
    if "bias" in node:
        for name, b in zip(names, np.split(np.asarray(node["bias"]), cuts)):
            out[f"{name}.bias"] = b


_FLUX_TOP = {"img_in": "x_embedder", "txt_in": "context_embedder",
             "final_layer_linear": "proj_out"}
_FLUX_MLP = {"time_in": "timestep_embedder", "vector_in": "text_embedder",
             "guidance_in": "guidance_embedder"}
_FLUX_DOUBLE = {"img_mod": "norm1.linear", "txt_mod": "norm1_context.linear",
                "img_attn_proj": "attn.to_out.0", "txt_attn_proj": "attn.to_add_out",
                "img_mlp_0": "ff.net.0.proj", "img_mlp_2": "ff.net.2",
                "txt_mlp_0": "ff_context.net.0.proj", "txt_mlp_2": "ff_context.net.2"}


def flux_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Inverse of `convert_flux`: the fused `*_attn_qkv` back into to_q /
    to_k / to_v (the text stream's add_q_proj / add_k_proj / add_v_proj),
    a single block's `linear1` into to_q / to_k / to_v / proj_mlp, and
    `final_layer_mod`'s (shift, scale) halves into norm_out.linear's
    (scale, shift)."""
    out: dict[str, np.ndarray] = {}
    for key, node in tree.items():
        if key in _FLUX_TOP:
            _dense(out, _FLUX_TOP[key], node)
        elif key in _FLUX_MLP:
            base = f"time_text_embed.{_FLUX_MLP[key]}"
            _dense(out, f"{base}.linear_1", node["in_layer"])
            _dense(out, f"{base}.linear_2", node["out_layer"])
        elif key == "final_layer_mod":
            # output rows (shift; scale) -> (scale; shift)
            _dense(out, "norm_out.linear", node)
            for leaf in ("weight", "bias"):
                if (name := f"norm_out.linear.{leaf}") in out:
                    shift, scale = np.split(out[name], 2)
                    out[name] = np.concatenate([scale, shift])
        elif m := re.match(r"double_blocks_(\d+)$", key):
            base = f"transformer_blocks.{m.group(1)}"
            for sub, leaves in node.items():
                if sub in _FLUX_DOUBLE:
                    _dense(out, f"{base}.{_FLUX_DOUBLE[sub]}",
                           leaves["lin"] if sub.endswith("_mod") else leaves)
                elif sub.endswith("_attn_qkv"):
                    names = (("to_q", "to_k", "to_v") if sub == "img_attn_qkv"
                             else ("add_q_proj", "add_k_proj", "add_v_proj"))
                    width = np.asarray(leaves["kernel"]).shape[1] // 3
                    _split_dense(out, [f"{base}.attn.{n}" for n in names], leaves, [width] * 3)
                elif sub.endswith("_attn_norm"):
                    q, k = (("norm_q", "norm_k") if sub == "img_attn_norm"
                            else ("norm_added_q", "norm_added_k"))
                    out[f"{base}.attn.{q}.weight"] = np.asarray(leaves["query_scale"])
                    out[f"{base}.attn.{k}.weight"] = np.asarray(leaves["key_scale"])
        elif m := re.match(r"single_blocks_(\d+)$", key):
            base = f"single_transformer_blocks.{m.group(1)}"
            _dense(out, f"{base}.norm.linear", node["modulation"]["lin"])
            _dense(out, f"{base}.proj_out", node["linear2"])
            hidden = np.asarray(node["linear2"]["kernel"]).shape[1]
            fused = np.asarray(node["linear1"]["kernel"]).shape[1]
            _split_dense(out, [f"{base}.attn.to_q", f"{base}.attn.to_k", f"{base}.attn.to_v",
                               f"{base}.proj_mlp"], node["linear1"],
                         [hidden] * 3 + [fused - 3 * hidden])
            out[f"{base}.attn.norm_q.weight"] = np.asarray(node["norm"]["query_scale"])
            out[f"{base}.attn.norm_k.weight"] = np.asarray(node["norm"]["key_scale"])
        else:
            raise KeyError(f"flux tree: unexpected {key!r}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def t5_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Inverse of `convert_t5` (transformers' T5EncoderModel names)."""
    out: dict[str, np.ndarray] = {}
    for path, leaf, value in _flatten(tree):
        value = np.asarray(value)
        if path == ("token_embedding",):
            out["shared.weight"] = value
            continue
        if path == ("final_norm",):
            out["encoder.final_layer_norm.weight"] = value
            continue
        base = f"encoder.block.{int(path[0].split('_')[1])}.layer"
        sub = path[1:]
        if sub == ("attn_norm",):
            out[f"{base}.0.layer_norm.weight"] = value
        elif sub == ("attention",) and leaf == "relative_attention_bias":
            out[f"{base}.0.SelfAttention.relative_attention_bias.weight"] = value
        elif sub[0] == "attention":
            out[f"{base}.0.SelfAttention.{sub[1]}.weight"] = value.T
        elif sub == ("ff_norm",):
            out[f"{base}.1.layer_norm.weight"] = value
        else:
            out[f"{base}.1.DenseReluDense.{sub[0]}.weight"] = value.T
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def _prefixed(name: str, table) -> str:
    for old, new in table:
        if name.startswith(old):
            return new + name[len(old):]
    return name


_K22_TOP = (("aug_emb_text_proj.", "add_embedding.text_proj."),
            ("aug_emb_text_norm.", "add_embedding.text_norm."),
            ("aug_emb_image_proj.", "add_embedding.image_proj."),
            ("aug_emb_proj.", "add_embedding.image_proj."),
            ("aug_emb_norm.", "add_embedding.image_norm."),
            ("hid_proj_image.", "encoder_hid_proj.image_embeds."),
            ("hid_proj_text.", "encoder_hid_proj.text_proj."),
            ("hid_proj_norm.", "encoder_hid_proj.norm."),
            ("hid_proj.", "encoder_hid_proj.image_embeds."),
            ("mid_block_resnets.", "mid_block.resnets."),
            ("mid_block_attentions.", "mid_block.attentions."))


def k22_unet_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """The inverse of convert_kandinsky_unet (both conditioning modes)."""
    return _state_dict(tree, lambda name: _prefixed(name, _K22_TOP))


def _movq_name(name: str) -> str:
    name = name.replace("mid_block_resnets.", "mid_block.resnets.")
    name = name.replace("mid_block_attentions.", "mid_block.attentions.")
    name = re.sub(r"(down|up)_blocks_(\d+)_(down|up)samplers_0_conv\.",
                  r"\1_blocks.\2.\3samplers.0.conv.", name)
    return re.sub(r"(down|up)_blocks_(\d+)_resnets\.", r"\1_blocks.\2.resnets.", name)


def movq_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """The inverse of convert_movq (its filled SpatialNorm scales too)."""
    return _state_dict(tree, _movq_name)


def _prior_name(name: str) -> str:
    name = _prefixed(name, (("embed_proj.", "embedding_proj."),))
    name = re.sub(r"^(transformer_blocks\.\d+)\.(to_q|to_k|to_v|to_out)\.",
                  r"\1.attn1.\2.", name)
    return name.replace(".ff_proj.", ".ff.net.0.proj.").replace(".ff_out.", ".ff.net.2.")


def prior_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """The inverse of convert_prior's parameters (the stats come apart)."""
    return _state_dict(tree, _prior_name)


_MCLIP_LAYER = (("self_attn.", "attention.self."), ("attn_out.", "attention.output.dense."),
                ("attn_norm.", "attention.output.LayerNorm."),
                ("intermediate.", "intermediate.dense."), ("output_norm.", "output.LayerNorm."),
                ("output.", "output.dense."))


def _mclip_name(name: str) -> str:
    if name.startswith("transformation."):
        return "LinearTransformation." + name[len("transformation."):]
    if m := re.match(r"layers\.(\d+)\.(.*)$", name):
        return f"transformer.encoder.layer.{m.group(1)}." + _prefixed(m.group(2), _MCLIP_LAYER)
    return "transformer.embeddings." + _prefixed(name, (("embed_norm.", "LayerNorm."),))


def mclip_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """The inverse of convert_mclip (no CLS pooler: MCLIP does not use it)."""
    return _state_dict(tree, _mclip_name)


def k3_unet_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """The inverse of convert_kandinsky3_unet: the generic names, the 2x2
    transposed convs' (kh, kw, in, out) kernels back to [in, out, kh, kw]."""
    out = _state_dict(tree, lambda name: name)
    for path, leaf, value in _flatten(tree):
        if leaf == "kernel" and path[-1].endswith("up_sample"):
            name = ".".join(_split_index(p) for p in path) + ".weight"
            out[name] = torch.from_numpy(np.array(np.asarray(value).transpose(2, 3, 0, 1),
                                                  dtype=np.float32))
    return out


def _conv_t_unflipped(value) -> torch.Tensor:
    """A transposed conv the JAX package stores as a forward conv's kernel
    (flipped, [kh, kw, in, out]) -> torch's ConvTranspose2d [in, out, kh, kw]."""
    w = np.flip(np.asarray(value).transpose(2, 3, 0, 1), (2, 3))
    return torch.from_numpy(np.array(w, dtype=np.float32, order="C"))


def _cascade_tree_state(tree: dict, special) -> dict[str, torch.Tensor]:
    """Every `_N` of a flax name an index again; `special(path, leaf,
    value)` may give (name, tensor) for a layout of its own."""
    out = {}
    for path, leaf, value in _flatten(tree):
        name = ".".join(re.sub(r"_(\d+)", r".\1", p) for p in path)
        name = name.replace(".attention_to_", ".attention.to_")
        got = special(name, leaf, np.asarray(value))
        if got is not None:
            out[got[0]] = got[1]
            continue
        new_leaf, arr = _tensor(leaf, value)
        out[f"{name}.{new_leaf}"] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def cascade_unet_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """The inverse of convert_cascade_unet: stage B's transposed-conv
    upscalers un-flipped; stage C's 1x1 scalers back into their
    UpDownBlock2d slot (`blocks.0` down, `blocks.1` up)."""
    # each scaler's port name -> whether it is a 1x1 mapping conv (stage C)
    mapping = {re.sub(r"_(\d+)", r".\1", key): np.asarray(node["kernel"]).shape[0] == 1
               for key, node in tree.items()
               if key.startswith(("down_downscalers", "up_upscalers"))}

    def special(name, leaf, value):
        if name not in mapping:
            return None
        if mapping[name]:
            slot = "blocks.0" if name.startswith("down") else "blocks.1"
            new_leaf, arr = _tensor(leaf, value)
            return f"{name}.{slot}.{new_leaf}", torch.from_numpy(np.array(arr, np.float32))
        if name.startswith("up_upscalers") and leaf == "kernel":
            return f"{name}.weight", _conv_t_unflipped(value)
        return None

    return _cascade_tree_state(tree, special)


def paella_vq_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """The inverse of convert_paella_vq's decoder tree: the transposed convs
    between levels un-flipped."""

    def special(name, leaf, value):
        if re.fullmatch(r"up_blocks\.\d+", name) and leaf == "kernel":
            return f"{name}.weight", _conv_t_unflipped(value)
        return None

    return _cascade_tree_state(tree, special)


def from_jax_params(tree: dict) -> dict:
    """{"unet": tree, "text": [tree, ...], "vae": tree, "cn": tree,
    "k_unet": tree, "safety": tree, "flux": tree, "t5": tree} (numpy
    leaves; any of them) -> {"unet": state dict, "text": [state dict, ...],
    "vae": state dict, "controlnet": state dict, "k_unet": state dict,
    "safety": state dict, "flux": state dict, "t5": state dict} in the
    port's (diffusers / transformers) key layout, f32. "k_unet" is the
    SD-x2 upscaler's UNet, "safety" the whole safety checker's tree,
    "flux" Flux's transformer and "t5" its T5 encoder; "k22_unet",
    "movq", "prior" and "mclip" are Kandinsky 2.x's decoder UNet, MoVQ,
    diffusion prior (its parameters) and 2.1's MCLIP, under the same names.
    A detector's tree under its DETECTOR_STATE_DICTS name ("dpt", "hed",
    "openpose_body", "pose_net", "pidinet", "mlsd", "lineart",
    "zoedepth", "upernet") gives its state dict under the same name."""
    convert = {"unet": ("unet", unet_state_dict), "vae": ("vae", vae_state_dict),
               "cn": ("controlnet", controlnet_state_dict),
               "k_unet": ("k_unet", k_upscaler_state_dict),
               "safety": ("safety", safety_state_dict),
               "flux": ("flux", flux_state_dict), "t5": ("t5", t5_state_dict),
               "k22_unet": ("k22_unet", k22_unet_state_dict),
               "movq": ("movq", movq_state_dict), "prior": ("prior", prior_state_dict),
               "mclip": ("mclip", mclip_state_dict),
               "k3_unet": ("k3_unet", k3_unet_state_dict),
               "cascade_unet": ("cascade_unet", cascade_unet_state_dict),
               "paella_vq": ("paella_vq", paella_vq_state_dict)}
    out = {name: fn(tree[key]) for key, (name, fn) in convert.items() if key in tree}
    if "text" in tree:
        out["text"] = [clip_state_dict(t) for t in tree["text"]]
    for name, fn in DETECTOR_STATE_DICTS.items():
        if name in tree:
            out[name] = fn(tree[name])
    return out


# --- the preprocessors' detectors (pipelines/aux_models.py) ---

_CONV_T = "convT"          # a transposed conv: flax (kh, kw, in, out) -> torch (in, out, kh, kw)
_CONV_T_FLIP = "convT_flip"  # the same, its kernel flipped (JAX's input-dilated conv)


def _detector_state(tree: dict, name_of) -> dict[str, torch.Tensor]:
    """A detector's flax tree -> {port key: f32 tensor}. `name_of(path)`
    maps a "/"-joined flax module path to the port's module name, and may
    return (name, kind) where a kernel needs a special layout; a leaf that
    is not kernel/scale/bias keeps its name under the module."""
    out = {}
    for path, leaf, value in _flatten(tree):
        named = name_of("/".join(path), leaf)
        name, kind = named if isinstance(named, tuple) else (named, None)
        value = np.asarray(value, np.float32)
        if leaf == "kernel" and kind == _CONV_T:
            key, value = f"{name}.weight", value.transpose(2, 3, 0, 1)
        elif leaf == "kernel" and kind == _CONV_T_FLIP:
            key, value = f"{name}.weight", np.flip(value.transpose(2, 3, 0, 1), (2, 3))
        elif leaf in ("kernel", "scale", "bias"):
            new_leaf, value = _tensor(leaf, value)
            key = f"{name}.{new_leaf}" if name else new_leaf
        else:
            key = name if kind == "full" else (f"{name}.{leaf}" if name else leaf)
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return out


_DPT_LAYER = {"q": "attention.attention.query", "k": "attention.attention.key",
              "v": "attention.attention.value", "out": "attention.output.dense",
              "fc1": "intermediate.dense", "fc2": "output.dense", "ln1": "layernorm_before",
              "ln2": "layernorm_after"}
_DPT_RCU = {"rcu1/conv1": "residual_layer1.convolution1",
            "rcu1/conv2": "residual_layer1.convolution2",
            "rcu2/conv1": "residual_layer2.convolution1",
            "rcu2/conv2": "residual_layer2.convolution2"}


def dpt_state_dict(tree: dict, n_taps: int = 4) -> dict[str, torch.Tensor]:
    """Inverse of chiaswarm_tpu's `convert_dpt` (transformers' DPT names)."""

    def name_of(path: str, leaf: str):
        if path == "" and leaf == "cls_token":
            return "dpt.embeddings.cls_token", "full"
        if path == "" and leaf == "pos_embed":
            return "dpt.embeddings.position_embeddings", "full"
        if path == "patch_embed":
            return "dpt.embeddings.patch_embeddings.projection"
        if m := re.match(r"layer_(\d+)/(\w+)$", path):
            return f"dpt.encoder.layer.{m.group(1)}.{_DPT_LAYER[m.group(2)]}"
        if m := re.match(r"reassemble_(\d)_(readout|project|resize)$", path):
            k, part = int(m.group(1)), m.group(2)
            stage = "neck.reassemble_stage"
            if part == "readout":
                return f"{stage}.readout_projects.{k}.0"
            if part == "project":
                return f"{stage}.layers.{k}.projection"
            return f"{stage}.layers.{k}.resize", (_CONV_T if k < 2 else None)
        if m := re.match(r"conv_(\d)$", path):
            return f"neck.convs.{m.group(1)}"
        if m := re.match(r"fusion_(\d)_(rcu\d/conv\d|project)$", path):
            j = n_taps - 1 - int(m.group(1))
            part = "projection" if m.group(2) == "project" else _DPT_RCU[m.group(2)]
            return f"neck.fusion_stage.layers.{j}.{part}"
        head = {"head_conv1": 0, "head_conv2": 2, "head_conv3": 4}
        return f"head.head.{head[path]}"

    return _detector_state(tree, name_of)


def hed_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Inverse of `convert_hed` (ControlNetHED's names)."""
    return _detector_state(tree, lambda path, leaf: ".".join(
        _split_index(p) for p in path.split("/")) if path else "")


def openpose_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Inverse of `convert_openpose_body` (pytorch-openpose's prefixed names)."""
    return _detector_state(tree, lambda path, leaf: path.replace("/", "."))


def pose_net_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """The tiny PoseNet's flax tree (auto-named Conv_N, _ResBlock_N) -> the port's."""

    def name_of(path: str, leaf: str):
        path = re.sub(r"_ResBlock_(\d+)", r"res.\1", path)
        return re.sub(r"Conv_(\d+)", r"conv.\1", path).replace("/", ".")

    return _detector_state(tree, name_of)


def pidinet_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Inverse of `convert_pidinet`: the plain (re-parameterised) kernels,
    under the checkpoint's names."""

    def name_of(path: str, leaf: str):
        path = re.sub(r"^(dilations|attentions)_(\d)", r"\1.\2", path)
        path = re.sub(r"^conv_reduces_(\d)", r"conv_reduces.\1.conv", path)
        return path.replace("/", ".")

    return _detector_state(tree, name_of)


def mlsd_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Inverse of `convert_mlsd`: the folded convs, under the checkpoint's names."""
    expanded = {int(k.split("_")[1]) for k, v in tree.items()
                if k.startswith("features_") and "expand" in v}

    def name_of(path: str, leaf: str):
        if path == "features_0/conv":
            return "backbone.features.0.0"
        if m := re.match(r"features_(\d+)/(expand/conv|depthwise/conv|project)$", path):
            idx, part = int(m.group(1)), m.group(2)
            if idx in expanded:
                part = {"expand/conv": "0.0", "depthwise/conv": "1.0", "project": "2"}[part]
            else:
                part = {"depthwise/conv": "0.0", "project": "1"}[part]
            return f"backbone.features.{idx}.conv.{part}"
        if m := re.match(r"block(\d+)/conv(\d)$", path):
            blk, conv = m.groups()
            return f"block{blk}.conv{conv}" + ("" if conv == "3" else ".0")
        raise KeyError(path)

    return _detector_state(tree, name_of)


def lineart_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Inverse of `convert_lineart` (the transposed convs un-flipped)."""
    fixed = {"model0_conv": "model0.1", "model1_conv0": "model1.0", "model1_conv1": "model1.3",
             "model3_conv0": ("model3.0", _CONV_T_FLIP),
             "model3_conv1": ("model3.3", _CONV_T_FLIP), "model4_conv": "model4.1"}

    def name_of(path: str, leaf: str):
        if m := re.match(r"res_(\d+)_conv([01])$", path):
            return f"model2.{m.group(1)}.conv_block.{1 if m.group(2) == '0' else 5}"
        return fixed[path]

    return _detector_state(tree, name_of)


def zoedepth_state_dict(tree: dict, reassemble_factors=(4, 2, 1, 0.5)) -> dict[str, torch.Tensor]:
    """Inverse of `convert_zoedepth` (transformers' names)."""
    convt = {f"neck/reassemble_stage/layers_{i}/resize"
             for i, f in enumerate(reassemble_factors) if f > 1}

    def name_of(path: str, leaf: str):
        name = ".".join(_split_index(p) for p in path.split("/"))
        name = re.sub(r"\.readout_projects\.(\d+)\.proj$", r".readout_projects.\1.0", name)
        if leaf == "relative_position_bias":
            return f"{name}.relative_position_bias.relative_position_bias_table", "full"
        return name, (_CONV_T if path in convt else None)

    return _detector_state(tree, name_of)


def upernet_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Inverse of `convert_upernet`: the folded decode-head convs, under
    transformers' names."""

    def name_of(path: str, leaf: str):
        stages = "backbone.encoder.stages"
        if path == "patch_embeddings":
            return "backbone.embeddings.patch_embeddings"
        if path == "embeddings_norm":
            return "backbone.embeddings.layernorm"
        if m := re.match(r"downsample_(norm|conv)_(\d)$", path):
            return f"{stages}.{m.group(2)}.downsampling_layer.{0 if m.group(1) == 'norm' else 1}"
        if m := re.match(r"stage_(\d+)_layer_(\d+)(?:/(\w+))?$", path):
            base = f"{stages}.{m.group(1)}.layers.{m.group(2)}"
            if m.group(3) is None:
                return f"{base}.layer_scale_parameter", "full"
            return f"{base}.{'layernorm' if m.group(3) == 'norm' else m.group(3)}"
        if m := re.match(r"feature_norm_(\d)$", path):
            return f"backbone.hidden_states_norms.stage{int(m.group(1)) + 1}"
        if m := re.match(r"(psp|lateral|fpn)_(\d)/conv$", path):
            kind, i = m.groups()
            return {"psp": f"decode_head.psp_modules.{i}.1.conv",
                    "lateral": f"decode_head.lateral_convs.{i}.conv",
                    "fpn": f"decode_head.fpn_convs.{i}.conv"}[kind]
        if path in ("bottleneck/conv", "fpn_bottleneck/conv"):
            return "decode_head." + path.replace("/", ".")
        if path == "classifier":
            return "decode_head.classifier"
        raise KeyError(path)

    return _detector_state(tree, name_of)


DETECTOR_STATE_DICTS = {"dpt": dpt_state_dict, "hed": hed_state_dict,
                        "openpose_body": openpose_state_dict, "pose_net": pose_net_state_dict,
                        "pidinet": pidinet_state_dict, "mlsd": mlsd_state_dict,
                        "lineart": lineart_state_dict, "zoedepth": zoedepth_state_dict,
                        "upernet": upernet_state_dict}


@torch.no_grad()
def load_detector_state_(module: nn.Module, state: dict, source: str, ignore=None) -> None:
    """Copy `state` ({key: tensor or array}) into `module`'s parameters, cast
    to their dtype: a strict load (CheckpointError for a key the module
    lacks, unless `ignore` matches it or is True; a shape that differs; a
    parameter that `state` lacks)."""
    targets = module.state_dict()
    loaded = set()
    for key, value in state.items():
        if key not in targets:
            if ignore is True or (ignore is not None and ignore.search(key)):
                continue
            raise CheckpointError(f"{source}: unexpected key {key!r}")
        tensor = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value) else value)
        if tuple(tensor.shape) != tuple(targets[key].shape):
            raise CheckpointError(f"{source}: {key!r} has shape {tuple(tensor.shape)}, the "
                                  f"module's {tuple(targets[key].shape)}")
        targets[key].copy_(tensor)
        loaded.add(key)
    missing = sorted(set(targets) - loaded)
    if missing:
        raise CheckpointError(f"{source}: {len(missing)} parameters in no file, e.g. "
                              f"{missing[:3]}")
