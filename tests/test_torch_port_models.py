"""chiaswarm_tpu_torch models and weights against the JAX package.

Each module gets seeded random weights in the port's (diffusers /
transformers) key layout; chiaswarm_tpu's converters turn them into JAX
params; `weights.from_jax_params` turns those back into the port's state
dicts, which load into a fresh port module. The same numpy inputs then go
through the JAX module and the port module, on the CPU in f32.

Tolerance: 1e-4 absolute and relative. Both sides compute in f32; the
difference is summation order in XLA's and PyTorch's convolutions and
matmuls (~1e-6 relative per op), compounded through a few dozen ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.models import configs as jax_cfgs
from chiaswarm_tpu.models import layers as jax_layers
from chiaswarm_tpu.models.clip import CLIPTextEncoder as JaxCLIP
from chiaswarm_tpu.models.conversion import convert_clip, convert_unet, convert_vae
from chiaswarm_tpu.models.unet2d import UNet2DConditionModel as JaxUNet
from chiaswarm_tpu.models.vae import AutoencoderKL as JaxVAE
from chiaswarm_tpu_torch import weights
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.models import layers
from chiaswarm_tpu_torch.models.clip import CLIPTextEncoder
from chiaswarm_tpu_torch.models.unet2d import UNet2DConditionModel
from chiaswarm_tpu_torch.models.vae import AutoencoderKL

TOL = dict(atol=1e-4, rtol=1e-4)


def _random(module, seed=0):
    weights.random_init_(module, torch.Generator().manual_seed(seed))
    return module.eval()


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _port_from_jax(make, jax_params, to_state_dict):
    """A fresh port module loaded from JAX params via from_jax_params."""
    module = make().eval()
    module.load_state_dict(to_state_dict(jax_params))
    return module


@pytest.mark.parametrize("make,convert,back", [
    (lambda: UNet2DConditionModel(cfgs.TINY_XL_UNET), convert_unet, weights.unet_state_dict),
    (lambda: AutoencoderKL(cfgs.TINY_VAE), convert_vae, weights.vae_state_dict),
    (lambda: CLIPTextEncoder(cfgs.TINY_CLIP), convert_clip, weights.clip_state_dict),
    (lambda: CLIPTextEncoder(cfgs.TINY_CLIP_2), convert_clip, weights.clip_state_dict),
])
def test_from_jax_params_inverts_conversion(make, convert, back):
    state = _numpy_sd(_random(make()))
    restored = back(convert(state))
    assert set(restored) == set(state)
    for key, value in state.items():
        np.testing.assert_array_equal(restored[key].numpy(), value, err_msg=key)


def test_from_jax_params_whole_tree():
    unet = _random(UNet2DConditionModel(cfgs.TINY_XL_UNET))
    vae = _random(AutoencoderKL(cfgs.TINY_VAE), 1)
    clips = [_random(CLIPTextEncoder(c), 2 + i)
             for i, c in enumerate((cfgs.TINY_CLIP, cfgs.TINY_CLIP_2))]
    tree = {"unet": convert_unet(_numpy_sd(unet)), "vae": convert_vae(_numpy_sd(vae)),
            "text": [convert_clip(_numpy_sd(c)) for c in clips]}
    out = weights.from_jax_params(tree)
    unet.load_state_dict(out["unet"])
    vae.load_state_dict(out["vae"])
    for clip, sd in zip(clips, out["text"]):
        clip.load_state_dict(sd)


def test_resnet_block():
    make = lambda: layers.ResnetBlock2D(64, 32, temb_dim=128)  # noqa: E731
    params = convert_unet(_numpy_sd(_random(make())))
    x, temb = _rand((2, 8, 8, 64), 1), _rand((2, 128), 2)
    want = jax_layers.ResnetBlock2D(32).apply({"params": params}, jnp.asarray(x),
                                              jnp.asarray(temb))
    port = _port_from_jax(make, params, weights.unet_state_dict)
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(temb))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_transformer_2d():
    make = lambda: layers.Transformer2DModel(64, 4, 16, 2, cross_dim=32)  # noqa: E731
    params = convert_unet(_numpy_sd(_random(make())))
    x, ctx = _rand((2, 8, 8, 64), 3), _rand((2, 77, 32), 4)
    want = jax_layers.Transformer2DModel(4, 16, 2).apply({"params": params}, jnp.asarray(x),
                                                        jnp.asarray(ctx))
    port = _port_from_jax(make, params, weights.unet_state_dict)
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_tiny_xl_unet():
    make = lambda: UNet2DConditionModel(cfgs.TINY_XL_UNET)  # noqa: E731
    params = convert_unet(_numpy_sd(_random(make())))
    x, ctx = _rand((2, 16, 16, 4), 5), _rand((2, 77, 64), 6)
    t = np.array([7.0, 451.0], np.float32)
    added = {"text_embeds": _rand((2, 32), 7),
             "time_ids": np.array([[64, 64, 0, 0, 64, 64]] * 2, np.float32)}
    want = jax.jit(JaxUNet(jax_cfgs.TINY_XL_UNET).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        added_cond={k: jnp.asarray(v) for k, v in added.items()})
    port = _port_from_jax(make, params, weights.unet_state_dict)
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                   added_cond={k: torch.from_numpy(v) for k, v in added.items()})
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_tiny_vae_decoder():
    make = lambda: AutoencoderKL(cfgs.TINY_VAE)  # noqa: E731
    params = convert_vae(_numpy_sd(_random(make())))
    z = _rand((1, 8, 8, 4), 8)
    vae = JaxVAE(jax_cfgs.TINY_VAE)
    want = jax.jit(lambda p, z: vae.apply({"params": p}, z, method=vae.decode))(
        params, jnp.asarray(z))
    port = _port_from_jax(make, params, weights.vae_state_dict)
    with torch.no_grad():
        got = port.decode(_nchw(z))
    assert got.shape == (1, 3, 16, 16)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("port_cfg,jax_cfg", [
    (cfgs.TINY_CLIP, jax_cfgs.TINY_CLIP),
    (cfgs.TINY_CLIP_2, jax_cfgs.TINY_CLIP_2),  # penultimate state + pooled projection
])
def test_tiny_clip(port_cfg, jax_cfg):
    make = lambda: CLIPTextEncoder(port_cfg)  # noqa: E731
    params = convert_clip(_numpy_sd(_random(make())))
    ids = np.full((2, 77), port_cfg.vocab_size - 1, np.int32)
    ids[:, 0] = port_cfg.vocab_size - 2
    ids[0, 1:6] = [5, 17, 3, 99, 42]
    ids[1, 1:3] = [7, 8]
    want = JaxCLIP(jax_cfg).apply({"params": params}, jnp.asarray(ids))
    port = _port_from_jax(make, params, weights.clip_state_dict)
    with torch.no_grad():
        got = port(torch.from_numpy(ids.astype(np.int64)))
    for key in ("hidden_states", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                   err_msg=key)


# SD 1.x / 2.x structure at small width: four levels, the last one plain,
# one mid transformer, two resnets a down block; head widths that differ
# per level (as SD 1.x's 8 heads of 40/80/160/160) or one width at every
# level (as SD 2.x's 64)
_SD_STRUCTURE = dict(block_out_channels=(32, 32, 64, 64), transformer_layers=(1, 1, 1, 0),
                     mid_transformer_layers=1, layers_per_block=2, cross_attention_dim=48)


@pytest.mark.parametrize("heads", [(4, 2, 8, 8), (2, 2, 4, 4)], ids=["sd15-like", "sd21-like"])
def test_sd_structured_unet(heads):
    port_cfg = cfgs.SD15_UNET.__class__(**_SD_STRUCTURE, num_attention_heads=heads)
    jax_cfg = jax_cfgs.SD15_UNET.__class__(**_SD_STRUCTURE, num_attention_heads=heads)
    make = lambda: UNet2DConditionModel(port_cfg)  # noqa: E731
    state = _numpy_sd(_random(make(), 9))
    params = convert_unet(state)
    restored = weights.unet_state_dict(params)
    assert set(restored) == set(state)
    for key, value in state.items():
        np.testing.assert_array_equal(restored[key].numpy(), value, err_msg=key)
    x, ctx = _rand((2, 16, 16, 4), 10), _rand((2, 77, 48), 11)
    t = np.array([981.0, 1.0], np.float32)
    want = jax.jit(JaxUNet(jax_cfg).apply)({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(ctx))
    port = _port_from_jax(make, params, weights.unet_state_dict)
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_sd21_style_clip():
    """SD 2.x's encoder at small width: gelu, the last layer's output
    through the final LayerNorm (hidden_state_index -1), no projection."""
    port_cfg = cfgs.SD21_CLIP.__class__(vocab_size=1000, hidden_size=32, num_layers=3,
                                        num_heads=4, hidden_act="gelu")
    jax_cfg = jax_cfgs.SD21_CLIP.__class__(vocab_size=1000, hidden_size=32, num_layers=3,
                                           num_heads=4, hidden_act="gelu")
    assert (port_cfg.hidden_state_index, jax_cfg.hidden_state_index) == (-1, -1)
    assert jax_cfg.apply_final_norm
    make = lambda: CLIPTextEncoder(port_cfg)  # noqa: E731
    params = convert_clip(_numpy_sd(_random(make(), 12)))
    ids = np.full((2, 77), port_cfg.vocab_size - 1, np.int32)
    ids[:, 0] = port_cfg.vocab_size - 2
    ids[0, 1:4] = [11, 12, 13]
    ids[1, 1:7] = [3, 1, 4, 1, 5, 9]
    want = JaxCLIP(jax_cfg).apply({"params": params}, jnp.asarray(ids))
    port = _port_from_jax(make, params, weights.clip_state_dict)
    with torch.no_grad():
        got = port(torch.from_numpy(ids.astype(np.int64)))
    for key in ("hidden_states", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                   err_msg=key)
