"""How many images one coalesced pass may hold on the device, and how
much free memory a pipeline needs before the registry builds it
(`resident_bytes`): the pieces of chiaswarm_tpu/chips/requirements.py
that batching and residency read, for the port's one device.

Memory: every family has a parameter footprint and a per-image activation
estimate at 1024² (the JAX package's tables, copied), scaled by canvas
area. The device's memory comes from `torch.cuda.get_device_properties`;
on the CPU the host heap is not device memory and every batch fits (the
ceiling), as in the JAX package, and so do the tiny test models.

On the card a second limit comes from the GroupNorm kernel: it takes at
most one batch row per resident CTA (`ops/group_norm.py` `plan_launch`),
and a coalesced UNet call runs 2 x padded rows (classifier-free guidance).
On the H100 that is 132 rows at one CTA per SM, so 66 images, 64 after the
power-of-two floor: `max_batch_rows` derives it from the kernel's plan,
so a change to the kernel moves the limit with it.

A pass of r rows runs pad_bucket(r) rows, so every budget here is a power
of two: any group within it pads to at most the budget itself.
"""

from __future__ import annotations

import functools

import torch

from .models.configs import auto_family, model_family
from .ops.group_norm import max_batch_rows
from .weights import is_test_model

# parameter + resident-state footprint, GiB (bf16, text encoders and VAE
# included)
FAMILY_PARAMS_GB: dict[str, float] = {
    "sd15": 1.8,
    "sd21": 2.1,
    "sdxl": 8.0,
    "sdxl_refiner": 7.2,
    "flux": 31.4,
    # the Kandinsky 2.2 decoder (UNet, MoVQ), the 2.1 decoder (its UNet,
    # MoVQ and MCLIP) and the prior (the prior transformer, CLIP bigG),
    # charged apart, as a decoder's job builds both: their bf16 parameters
    # are 2.45, 3.45 and 3.21 GiB on an H100 (chip_smoke.py
    # serve_kandinsky_path); 2.1's smaller prior is charged as 2.2's
    "kandinsky": 2.5,
    "kandinsky21": 3.5,
    "kandinsky_prior": 3.25,
    # Kandinsky 3 (its UNet, MoVQ and FLAN-UL2's T5 encoder) and Stable
    # Cascade's decoder (stage B, CLIP-bigG, the Paella VQ) and prior
    # (stage C, CLIP-bigG), charged apart as the Kandinsky pair: their bf16
    # parameters are 22.05, 4.23 and 7.98 GiB at the published geometry
    # (chip_smoke.py serve_kandinsky3_path, serve_cascade_path)
    "kandinsky3": 22.5,
    "cascade": 4.5,
    "cascade_prior": 8.25,
    "deepfloyd_if": 18.0,
}

# transient activations per image, GiB at a 1024² canvas; Kandinsky 3's
# and Stable Cascade's are the peak device memory a job or stage held
# above its bundles on an H100, rounded up to a quarter GiB: 2.04 (K3),
# 1.03 (the decoder's stage B and Paella decode), 0.11 (the prior's stage
# C) GiB (chip_smoke.py serve_kandinsky3_path, serve_cascade_path, which
# hold each reading within resident_bytes)
FAMILY_ACT_GB_PER_IMAGE: dict[str, float] = {
    "sd15": 1.0,
    "sd21": 1.1,
    "sdxl": 2.0,
    "sdxl_refiner": 1.8,
    "flux": 2.5,
    "kandinsky": 1.2,
    "kandinsky21": 1.2,
    "kandinsky_prior": 0.05,
    "kandinsky3": 2.25,
    "cascade": 1.25,
    "cascade_prior": 0.25,
    "deepfloyd_if": 1.5,
}

# native serving canvas per family (everything else serves 1024)
_FAMILY_CANVAS: dict[str, int] = {"sd15": 512, "sd21": 768, "kandinsky": 512,
                                  "kandinsky21": 512, "kandinsky_prior": 512}

_DEFAULT_PARAMS_GB = 2.0
_DEFAULT_ACT_GB = 1.0
# the rows limit off the card
CEILING = 256


def _family_key(model_name: str) -> str:
    """Capacity bucket: the name's family (configs.auto_family), the SD
    families by model_family's finer split, a Kandinsky 2.1 decoder by its
    name (it carries MCLIP), a prior without a row of its own charged as
    its decoder."""
    family = auto_family(model_name)
    if family in ("sd", "sdxl", "sd_upscale"):
        return model_family(model_name)
    if family == "kandinsky" and ("2-1" in model_name or "2_1" in model_name):
        return "kandinsky21"
    return family if family in FAMILY_PARAMS_GB else family.removesuffix("_prior")


def _area_scale(height: int, width: int | None = None) -> float:
    width = height if width is None else width
    return max((height * width) / (1024.0 * 1024.0), 0.05)


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def default_canvas(model_name: str) -> int:
    """The family's native canvas (the estimate when a job names no dims)."""
    return _FAMILY_CANVAS.get(_family_key(model_name), 1024)


def fit_batch(device, model_name: str, batch: int, size: int, width: int | None = None) -> int:
    """Largest batch (<= `batch`) the device's memory fits; 0 when the
    model does not fit at all."""
    device = torch.device(device)
    if device.type != "cuda" or is_test_model(model_name):
        return batch
    memory_gb = torch.cuda.get_device_properties(device).total_memory / (1 << 30)
    fam = _family_key(model_name)
    free = memory_gb - FAMILY_PARAMS_GB.get(fam, _DEFAULT_PARAMS_GB)
    per_image = FAMILY_ACT_GB_PER_IMAGE.get(fam, _DEFAULT_ACT_GB) * _area_scale(size, width)
    if free < per_image:
        return 0
    return min(batch, int(free / per_image))


def resident_bytes(device, model_name: str) -> int:
    """The device memory a pipeline of `model_name` needs to be built and
    serve one image at its family's canvas: its parameter footprint and
    one image's activations; 0 off the card and for the tiny test models."""
    if torch.device(device).type != "cuda" or is_test_model(model_name):
        return 0
    fam = _family_key(model_name)
    size = default_canvas(model_name)
    gib = (FAMILY_PARAMS_GB.get(fam, _DEFAULT_PARAMS_GB)
           + FAMILY_ACT_GB_PER_IMAGE.get(fam, _DEFAULT_ACT_GB) * _area_scale(size))
    return int(gib * (1 << 30))


def free_bytes(device) -> int:
    """The device memory a new allocation can take: the driver's free
    memory and the blocks the caching allocator holds unused."""
    device = torch.device(device)
    return (torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def kernel_image_limit(device) -> int | None:
    """The most images one coalesced pass may hold by the GroupNorm
    kernel's plan (half its batch rows: the UNet's CFG rows), None off the
    card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(device)
    return _kernel_rows(props.multi_processor_count,
                        getattr(props, "shared_memory_per_block_optin", 227 << 10)) // 2


@functools.lru_cache(maxsize=None)
def _kernel_rows(sms: int, smem_per_block: int) -> int:
    return max_batch_rows(sms, smem_per_block)


def _budget(device, fit: int) -> int:
    budget = _pow2_floor(fit) if fit >= 1 else 1
    limit = kernel_image_limit(device)
    return budget if limit is None else min(budget, _pow2_floor(limit))


def coalesce_rows_limit(device, model_name: str, size: int, width: int | None = None,
                        ceiling: int = CEILING) -> int:
    """Most images one coalesced group may hold: the scheduler sizes its
    groups with it, so a group arrives admissible. A model that does not
    fit at all still groups one job (the solo path raises for it)."""
    return _budget(device, fit_batch(device, model_name, ceiling, size, width))


def coalesced_fit(device, model_name: str, total_rows: int, size: int,
                  width: int | None = None) -> int:
    """The row budget of one pass for a coalesced group of `total_rows`
    images (the callback splits the group into passes of at most this
    many). Raises ValueError when even one image does not fit."""
    total_rows = max(int(total_rows), 1)
    fit = fit_batch(device, model_name, max(total_rows, CEILING), size, width)
    if fit == 0:
        raise ValueError(f"{model_name} does not fit on {device} at {size}x{width or size}")
    return min(total_rows, _budget(device, fit))
