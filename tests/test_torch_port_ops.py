"""chiaswarm_tpu_torch ops: the plain versions of the two kernels against
the JAX package's Pallas kernels (interpret mode on the CPU), and the
routing rule (CPU tensor -> plain version; the kernel wrappers take CUDA
tensors only and raise on anything else). The CUDA kernels themselves run
only on the card: chip_smoke.py holds them against these plain versions.

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
