"""chiaswarm_tpu_torch ops: the plain versions of the two kernels against
the JAX package's Pallas kernels (interpret mode on the CPU), and the
routing rule (CPU tensor -> plain version; the kernel wrappers take CUDA
tensors only and raise on anything else). The CUDA kernels themselves run
only on the card: chip_smoke.py holds them against these plain versions.
The GroupNorm kernel's launch plan is plain arithmetic and is checked here
at every main-path shape, with the H100's limits passed in.

Tolerances are those of the JAX package's own kernel tests:
tests/test_flash_attention.py (f32 2e-5) and tests/test_group_norm.py
(f32 2e-5 atol and rtol).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from chiaswarm_tpu.ops.group_norm import group_norm as jax_group_norm
from chiaswarm_tpu_torch.ops import dot_product_attention, group_norm
from chiaswarm_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from chiaswarm_tpu_torch.ops.group_norm import fused_group_norm, reference_group_norm


def _rand(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("b,sq,skv,h,d,scale", [
    (2, 256, 256, 3, 32, None),
    (2, 256, 77, 3, 32, None),   # ragged cross-attention length
    (2, 130, 256, 3, 32, None),  # ragged query edge
    (2, 64, 64, 3, 32, None),
    (1, 64, 64, 1, 16, 0.5),     # custom scale
    (1, 128, 128, 1, 512, None),  # the VAE mid-block's single 512-wide head
    # SD 1.x's head widths (8 heads of 40, 80 and 160 at its four levels):
    # self-attention, the ragged 77-token cross-attention, a ragged query
    (2, 256, 256, 2, 40, None), (2, 256, 77, 2, 40, None), (2, 130, 256, 2, 40, None),
    (2, 256, 256, 2, 80, None), (2, 256, 77, 2, 80, None), (1, 130, 77, 2, 80, None),
    (2, 128, 128, 2, 160, None), (2, 128, 77, 2, 160, None), (1, 130, 130, 1, 160, None),
    # Flux's head width (24 heads of 128 in its joint attention): self-
    # attention, 77 keys, a ragged query and ragged keys
    (1, 256, 256, 2, 128, None), (2, 256, 77, 2, 128, None), (1, 130, 256, 2, 128, None),
    (1, 256, 200, 1, 128, None),
])
def test_attention_plain_matches_jax_kernel(b, sq, skv, h, d, scale):
    q, k, v = _rand((b, sq, h, d), 0), _rand((b, skv, h, d), 1), _rand((b, skv, h, d), 2)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                               block_q=128, block_k=128, interpret=True)
    got = reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=scale)
    assert got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 8, 32), 32),
    ((2, 8, 8, 64), 32),
    ((1, 16, 16, 96), 32),   # group width 3
    ((3, 5, 7, 64), 16),     # odd spatial dims
    ((2, 64, 32), 16),       # [B, S, C] tokens
])
@pytest.mark.parametrize("silu,eps", [(False, 1e-5), (True, 1e-6)])
def test_group_norm_plain_matches_jax_kernel(shape, groups, silu, eps):
    x = _rand(shape, 3, 2.0, 0.3)
    scale, bias = _rand(shape[-1:], 4), _rand(shape[-1:], 5)
    want = jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                          groups=groups, eps=eps, act="silu" if silu else None,
                          interpret=True)
    got = reference_group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias), groups, eps, silu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_cpu_tensors_take_the_plain_versions():
    q, k = torch.from_numpy(_rand((1, 32, 2, 16), 6)), torch.from_numpy(_rand((1, 9, 2, 16), 7))
    torch.testing.assert_close(dot_product_attention(q, k, k), reference_attention(q, k, k),
                               rtol=0, atol=0)
    x = torch.from_numpy(_rand((2, 4, 4, 64), 8))
    w, b = torch.ones(64), torch.zeros(64)
    torch.testing.assert_close(group_norm(x, w, b, groups=32, act="silu"),
                               reference_group_norm(x, w, b, 32, 1e-5, True), rtol=0, atol=0)


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 64, 1, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention(q, q, q)
    x = torch.zeros(1, 4, 4, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_group_norm(x, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="unsupported activation"):
        group_norm(x, torch.ones(64), torch.zeros(64), act="gelu")


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """A change to a header that a source includes, directly or through
    another header, or to the flags, moves the library to a new path, so
    it is rebuilt; an unrelated header does not. Needs no nvcc."""
    from chiaswarm_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    (tmp_path / "unused.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.local_headers(tmp_path / "k.cu") == [(tmp_path / "a.cuh").resolve(),
                                                       (tmp_path / "b.cuh").resolve()]
    first = _build.library_path("k")
    (tmp_path / "unused.cuh").write_text("// v2\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-DEXTRA"))
    assert _build.library_path("k") not in (first, second)


def test_attention_source_includes_the_hopper_header():
    from chiaswarm_tpu_torch.ops import _build

    headers = _build.local_headers(_build.CSRC / "flash_attention.cu")
    assert [h.name for h in headers] == ["hopper.cuh"]


def test_attention_entry_point_matches_the_kernel_source():
    """The wrapper's ctypes signature is `fa_forward`'s, argument for
    argument, and the head widths it names as tensor-core routes are the
    bf16 cases of the source's dispatch (read from the source: needs no
    nvcc)."""
    import ctypes
    import re

    from chiaswarm_tpu_torch.ops import _build
    from chiaswarm_tpu_torch.ops import flash_attention as fa

    source = (_build.CSRC / "flash_attention.cu").read_text()
    params = re.search(r"int fa_forward\((.*?)\)\s*\{", source, re.S).group(1)
    ctype = {"void*": ctypes.c_void_p, "int*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    kinds = [re.match(r"(?:const\s+)?(\w+\s*\*?)", p.strip()).group(1).replace(" ", "")
             for p in params.split(",")]
    assert [ctype[k] for k in kinds] == fa.FA_FORWARD_ARGS
    dispatch = source[source.index("int fa_forward("):]
    cases = [int(d) for d in re.findall(r"case (\d+):", dispatch)]
    assert tuple(sorted(cases)) == fa.TENSOR_CORE_WIDTHS


# --- the GroupNorm kernel's launch plan (pure arithmetic) ---

# H100 SXM: 132 SMs, 227 KB of shared memory a CTA may ask for, and one
# CTA of the kernel per SM when it asks for all of it
H100 = {"sms": 132, "smem_per_block": 232448, "blocks_per_sm": 1}

# every GroupNorm call of the SDXL 1024^2 main path: (x, silu, eps, whether
# it fits in the card's shared memory, about 30 MB). UNet at CFG batch 2:
UNET_NORMS = [
    ((2, 128, 128, 320), True, 1e-5, True), ((2, 64, 64, 320), True, 1e-5, True),
    ((2, 64, 64, 640), True, 1e-5, True), ((2, 64, 64, 640), False, 1e-6, True),
    ((2, 32, 32, 640), True, 1e-5, True), ((2, 32, 32, 1280), True, 1e-5, True),
    ((2, 32, 32, 1280), False, 1e-6, True), ((2, 32, 32, 2560), True, 1e-5, True),
    ((2, 32, 32, 1920), True, 1e-5, True), ((2, 64, 64, 1920), True, 1e-5, False),
    ((2, 64, 64, 1280), True, 1e-5, True), ((2, 64, 64, 960), True, 1e-5, True),
    ((2, 128, 128, 960), True, 1e-5, False), ((2, 128, 128, 640), True, 1e-5, False),
]
# VAE decoder at batch 1
VAE_NORMS = [
    ((1, 128, 128, 512), True, 1e-6, True), ((1, 128, 128, 512), False, 1e-6, True),
    ((1, 256, 256, 512), True, 1e-6, False), ((1, 512, 512, 512), True, 1e-6, False),
    ((1, 512, 512, 256), True, 1e-6, False), ((1, 1024, 1024, 256), True, 1e-6, False),
    ((1, 1024, 1024, 128), True, 1e-6, False),
]

# every GroupNorm call of the SD 1.x 512^2 UNet (64^2 latents) at CFG batch
# 2: all 61 fit on chip
SD15_UNET_NORMS = [
    ((2, 64, 64, 320), True, 1e-5, True), ((2, 64, 64, 320), False, 1e-6, True),
    ((2, 32, 32, 320), True, 1e-5, True), ((2, 32, 32, 640), False, 1e-6, True),
    ((2, 16, 16, 640), True, 1e-5, True), ((2, 16, 16, 1280), True, 1e-5, True),
    ((2, 16, 16, 1280), False, 1e-6, True), ((2, 8, 8, 1280), True, 1e-5, True),
    ((2, 8, 8, 1280), False, 1e-6, True), ((2, 8, 8, 2560), True, 1e-5, True),
    ((2, 16, 16, 2560), True, 1e-5, True), ((2, 16, 16, 1920), True, 1e-5, True),
    ((2, 32, 32, 960), True, 1e-5, True),
]
# the SD 2.x 768^2 UNet (96^2 latents): all but (2,96,96,960) fit
SD21_UNET_NORMS = [
    ((2, 96, 96, 320), True, 1e-5, True), ((2, 96, 96, 320), False, 1e-6, True),
    ((2, 48, 48, 320), True, 1e-5, True), ((2, 48, 48, 640), True, 1e-5, True),
    ((2, 48, 48, 640), False, 1e-6, True), ((2, 24, 24, 640), True, 1e-5, True),
    ((2, 24, 24, 1280), True, 1e-5, True), ((2, 24, 24, 1280), False, 1e-6, True),
    ((2, 12, 12, 1280), True, 1e-5, True), ((2, 12, 12, 1280), False, 1e-6, True),
    ((2, 12, 12, 2560), True, 1e-5, True), ((2, 24, 24, 2560), True, 1e-5, True),
    ((2, 24, 24, 1920), True, 1e-5, True), ((2, 48, 48, 1920), True, 1e-5, True),
    ((2, 48, 48, 1280), True, 1e-5, True), ((2, 48, 48, 960), True, 1e-5, True),
    ((2, 96, 96, 960), True, 1e-5, False), ((2, 96, 96, 640), True, 1e-5, True),
]
# the VAE decoder and encoder at 512^2 and 768^2, batch 1
SD_VAE_NORMS = [
    ((1, 64, 64, 512), True, 1e-6, True), ((1, 64, 64, 512), False, 1e-6, True),
    ((1, 256, 256, 256), True, 1e-6, False), ((1, 512, 512, 128), True, 1e-6, False),
    ((1, 256, 256, 128), True, 1e-6, True), ((1, 128, 128, 256), True, 1e-6, True),
    ((1, 96, 96, 512), True, 1e-6, True), ((1, 96, 96, 512), False, 1e-6, True),
    ((1, 192, 192, 512), True, 1e-6, False), ((1, 384, 384, 512), True, 1e-6, False),
    ((1, 384, 384, 256), True, 1e-6, False), ((1, 768, 768, 256), True, 1e-6, False),
    ((1, 768, 768, 128), True, 1e-6, False), ((1, 384, 384, 128), True, 1e-6, False),
    ((1, 192, 192, 256), True, 1e-6, True),
]


def _plan(shape, elem_size=2, groups=32):
    from chiaswarm_tpu_torch.ops.group_norm import plan_launch

    b, c = shape[0], shape[-1]
    return plan_launch(b, int(np.prod(shape[1:-1])), c, groups, elem_size, **H100)


def _check_plan_covers(plan):
    """The kernel's index arithmetic under this plan: the slabs of each
    batch row cover its rows once, with no empty CTA; the grid is resident;
    the partials and the shared memory fit."""
    assert plan.grid <= H100["sms"] * H100["blocks_per_sm"]
    assert plan.chunks * plan.rows_per_cta >= plan.rows > (plan.chunks - 1) * plan.rows_per_cta
    assert plan.smem_bytes <= H100["smem_per_block"]
    assert 0 <= plan.keep_rows <= plan.rows_per_cta
    # CTA blockIdx writes partial [blockIdx][g]; phase B reads batch b's
    # CTAs b * chunks .. (b + 1) * chunks - 1
    last = ((plan.grid - 1) * plan.groups + plan.groups - 1) * 8 + 8
    assert last == plan.scratch_bytes


@pytest.mark.parametrize("shape,silu,eps,fits",
                         UNET_NORMS + VAE_NORMS + SD15_UNET_NORMS + SD21_UNET_NORMS + SD_VAE_NORMS)
def test_group_norm_plan_main_path(shape, silu, eps, fits):
    """Each main-path call takes the path the design names: the 11 SDXL
    UNet and 2 VAE shapes under the card's shared memory read x once, as
    do every SD 1.x UNet call and all but one SD 2.x UNet call; the rest
    keep what fits and read the remainder again."""
    plan = _plan(shape)
    assert plan.on_chip == fits
    # each batch row's share of the SMs, slabs at most one row longer than
    # an even split
    assert plan.rows_per_cta == -(-plan.rows // (132 // plan.batch))
    if not fits:
        # what does not fit keeps as much as shared memory holds
        assert plan.smem_bytes + plan.channels * 2 > H100["smem_per_block"]
    _check_plan_covers(plan)


@pytest.mark.parametrize("shape,fits", [
    ((2, 64, 64, 640), True), ((2, 128, 128, 320), False), ((1, 1024, 1024, 128), False),
    ((2, 64, 64, 1920), False), ((2, 8, 8, 64), True), ((1, 16, 16, 96), True),
])
def test_group_norm_plan_f32(shape, fits):
    """f32 holds half as many elements on chip as bf16."""
    plan = _plan(shape, elem_size=4, groups=32)
    assert plan.on_chip == fits
    _check_plan_covers(plan)


@pytest.mark.parametrize("shape,groups", [
    ((2, 33, 31, 640), 32),   # rows that do not divide among the CTAs
    ((1, 64, 128, 640), 32),  # B = 1 ...
    ((2, 64, 64, 640), 32),   # ... and B = 2 at the same N*C
    ((3, 5, 7, 64), 16),      # fewer rows than SMs; slabs of one row
    ((64, 3, 3, 64), 32),     # many batch rows, two CTAs each
    ((132, 2, 2, 64), 32),    # one CTA per batch row
    ((2, 40, 40, 320), 32),   # groups of 10 channels straddle the 8-channel vectors
    ((1, 16, 16, 96), 32),    # groups of 3: a thread's channels span 4 groups
])
def test_group_norm_plan_edges(shape, groups):
    plan = _plan(shape, groups=groups)
    _check_plan_covers(plan)
    assert 1 <= plan.fold_slots <= 8


def test_group_norm_plan_refuses_what_the_kernel_does_not_take():
    from chiaswarm_tpu_torch.ops.group_norm import plan_launch

    with pytest.raises(ValueError, match="channels"):
        plan_launch(1, 16, 4104, 8, 2, **H100)
    with pytest.raises(ValueError, match="channels"):
        plan_launch(1, 16, 100, 32, 2, **H100)
    with pytest.raises(ValueError, match="groups"):
        plan_launch(1, 16, 4096, 1024, 2, **H100)
    with pytest.raises(ValueError, match="batch 133"):
        plan_launch(133, 16, 64, 32, 2, **H100)
    with pytest.raises(ValueError, match="batch 1"):
        plan_launch(1, 16, 64, 32, 2, 132, 232448, 0)


def test_group_norm_plan_struct_matches_the_kernel_source():
    """The wrapper's `_PlanArgs` is csrc/group_norm.cu's `GnPlan` field for
    field and type for type, and the plan's constants are the kernel's
    (read from the source: needs no nvcc)."""
    import ctypes
    import re

    from chiaswarm_tpu_torch.ops import _build
    from chiaswarm_tpu_torch.ops.group_norm import MAX_THREADS, STAGES, _PlanArgs

    source = (_build.CSRC / "group_norm.cu").read_text()
    body = re.search(r"struct GnPlan \{(.*?)\};", source, re.S).group(1)
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    fields = []
    for line in body.splitlines():
        m = re.match(r"\s*(void\*|int|float)\s+([^;]+);", line)
        if m:
            fields += [(name.strip(), ctype[m.group(1)]) for name in m.group(2).split(",")]
    assert fields == list(_PlanArgs._fields_)
    assert f"constexpr int kMaxThreads = {MAX_THREADS};" in source
    assert f"constexpr int kStages = {STAGES};" in source
