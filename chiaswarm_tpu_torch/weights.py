"""Weights: the random-init policy, seeded random init, and conversion of
the JAX package's parameter trees into the port's state dicts.

Policy (a copy of chiaswarm_tpu/weights.py):

- `test/*` and `*tiny*` model names: random init is the point (hermetic
  CPU tests, `test_tiny_model` jobs) and is always allowed.
- anything else: missing weights raise `MissingWeightsError`, a
  ValueError, so the worker returns a fatal envelope and the hive does
  not resubmit.
- benchmarks and bring-up opt in explicitly with `allow_random_init=True`
  (speed does not depend on weight values).

`from_jax_params` inverts chiaswarm_tpu/models/conversion.py's
`convert_unet` / `convert_vae` / `convert_clip`: flax paths become
diffusers / transformers key names again, HWIO conv kernels become OIHW
and Dense [in, out] kernels become Linear [out, in]. The port's modules
use those key names, so a diffusers state dict loads without conversion.
"""

from __future__ import annotations

import math
import re
import zlib
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .models.layers import FusedGroupNorm


class MissingWeightsError(ValueError):
    """Model weights are not present on this worker (fatal job error)."""


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
        hint = ("chiaswarm_tpu_torch does not load checkpoints yet; serve "
                "test/tiny models or pass allow_random_init=True.")
    raise MissingWeightsError(
        f"{component} weights for '{model_name}' are not present on this "
        f"worker{where}. {hint}")


def model_seed(model_name: str) -> int:
    """The random-init seed of a model. Not hash(): str hash is salted per
    process, and weights must agree across workers."""
    return zlib.crc32(model_name.encode())


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in parameter order: norms 1/0, biases 0, embeddings
    N(0, 0.02) (positions 0.01, as the JAX package), every other weight
    N(0, 1/fan_in) (LeCun normal, flax's Dense/Conv default)."""
    for name, p in module.named_parameters():
        owner_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        owner = module.get_submodule(owner_name)
        if isinstance(owner, (nn.LayerNorm, FusedGroupNorm)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif isinstance(owner, nn.Embedding):
            std = 0.01 if owner_name.endswith("position_embedding") else 0.02
            p.normal_(0.0, std, generator=generator)
        elif leaf == "bias":
            p.zero_()
        else:
            p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=generator)


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


def from_jax_params(tree: dict) -> dict:
    """{"unet": tree, "text": [tree, ...], "vae": tree} (numpy leaves) ->
    {"unet": state dict, "text": [state dict, ...], "vae": state dict}
    in the port's (diffusers / transformers) key layout, f32."""
    return {
        "unet": unet_state_dict(tree["unet"]),
        "text": [clip_state_dict(t) for t in tree["text"]],
        "vae": vae_state_dict(tree["vae"]),
    }
