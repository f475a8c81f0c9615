"""chiaswarm_tpu_torch's SD 1.x / 2.x slice against the JAX package.

- `family_configs` against the JAX pipeline's `_family_configs`, name for
  name: the SD 1.x checkpoints and their fine-tunes (every name that is not
  XL and not 2.x), SD 2.1 (768, v-prediction), SD 2.1-base (epsilon), both
  dedicated inpainting checkpoints (9 channels), SDXL, the SDXL refiner,
  instruct-pix2pix and the tiny models; the families of later slices
  raise, naming theirs.
- The checkpoint's `scheduler/scheduler_config.json` under the model root
  sets the prediction type for every family, as the JAX package reads it.
- Whole txt2img jobs of tiny models (SD and SDXL structure) whose
  scheduler config says `v_prediction`, and of tiny SD without one, in JAX
  and in the port with the same weights and the initial latents that JAX
  drew: the decoded uint8 images must agree within 2/255 (f32 on both
  sides; rounding to uint8 can flip a pixel by one level). The JAX
  pipeline reads the port's random weights and the scheduler config from
  a temporary model root; the port reads the same scheduler config.
- chip_smoke.py's SD phases rehearsed at a tiny size on the CPU.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chiaswarm_tpu.pipelines import stable_diffusion as jax_sd
from chiaswarm_tpu_torch.pipelines.stable_diffusion import (
    SDPipeline,
    config_prediction_type,
    family_configs,
)
from chiaswarm_tpu_torch.weights import from_jax_params

SERVED = [
    "runwayml/stable-diffusion-v1-5",
    "CompVis/stable-diffusion-v1-4",
    "prompthero/openjourney",
    "prompthero/openjourney-v4",
    "nitrosocke/mo-di-diffusion",
    "stabilityai/stable-diffusion-2-1",
    "stabilityai/stable-diffusion-2-1-base",
    "stabilityai/stable-diffusion-2",
    "runwayml/stable-diffusion-inpainting",
    "stabilityai/stable-diffusion-2-inpainting",
    "stabilityai/stable-diffusion-xl-base-1.0",
    "diffusers/stable-diffusion-xl-1.0-inpainting-0.1",
    "test/tiny-sd",
    "test/tiny-inpaint",
    "test/tiny-xl",
]


@pytest.fixture
def model_root(sdaas_root, tmp_path, monkeypatch):
    """An empty model root, the JAX package's and the port's."""
    root = tmp_path / "models"
    root.mkdir()
    monkeypatch.setenv("CHIASWARM_MODEL_ROOT_DIR", str(root))
    return root


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _same_config(port_cfg, jax_cfg, what):
    ref = _fields(jax_cfg)
    for key, value in _fields(port_cfg).items():
        assert ref[key] == value, (what, key)


@pytest.mark.parametrize("name", SERVED)
def test_family_configs_match_jax(name, model_root):
    unet, clips, vae, size, pred = family_configs(name, str(model_root))
    j_unet, j_clips, j_vae, j_size, j_pred = jax_sd._family_configs(name)
    _same_config(unet, j_unet, "unet")
    assert len(clips) == len(j_clips)
    for port_clip, jax_clip in zip(clips, j_clips):
        _same_config(port_clip, jax_clip, "clip")
    _same_config(vae, j_vae, "vae")
    assert (size, pred) == (j_size, j_pred)
    assert unet.in_channels == (9 if "inpaint" in name else 4)


@pytest.mark.parametrize("name,size,pred,head_widths", [
    ("runwayml/stable-diffusion-v1-5", 512, "epsilon", (40, 80, 160, 160)),
    ("prompthero/openjourney", 512, "epsilon", (40, 80, 160, 160)),
    ("stabilityai/stable-diffusion-2-1", 768, "v_prediction", (64, 64, 64, 64)),
    ("stabilityai/stable-diffusion-2-1-base", 768, "epsilon", (64, 64, 64, 64)),
])
def test_sd_families_at_published_widths(name, size, pred, head_widths, model_root):
    unet, clips, _, got_size, got_pred = family_configs(name, str(model_root))
    assert (got_size, got_pred) == (size, pred)
    assert tuple(c // h for c, h in zip(unet.block_out_channels,
                                        unet.heads_per_block())) == head_widths
    assert unet.transformer_layers == (1, 1, 1, 0) and unet.addition_embed_dim == 0
    assert len(clips) == 1 and clips[0].hidden_state_index == -1


@pytest.mark.parametrize("name,match", [
    ("stabilityai/stable-diffusion-xl-refiner-1.0", "refiner"),
    ("timbrooks/instruct-pix2pix", "instruct-pix2pix"),
])
def test_formerly_refused_names_are_served(name, match, model_root):
    """The SDXL refiner and the instruct-pix2pix checkpoint raised until the
    port served them; now they configure as the JAX package does."""
    unet, clips, vae, size, pred = family_configs(name, str(model_root))
    j_unet, j_clips, j_vae, j_size, j_pred = jax_sd._family_configs(name)
    _same_config(unet, j_unet, "unet")
    for port_clip, jax_clip in zip(clips, j_clips, strict=True):
        _same_config(port_clip, jax_clip, "clip")
    assert (size, pred) == (j_size, j_pred)
    if match == "refiner":
        assert len(clips) == 1 and unet.addition_embed_dim == 2560
    else:
        assert unet.in_channels == 8 and size == 512


@pytest.mark.parametrize("name,match", [
    ("black-forest-labs/FLUX.1-schnell", "FluxPipeline"),
    ("kandinsky-community/kandinsky-2-2-decoder", "KandinskyPipeline"),
    ("stabilityai/stable-cascade", "not ported"),
    ("test/tiny-flux", "FluxPipeline"),
])
def test_later_families_raise(name, match, model_root):
    with pytest.raises(ValueError, match=match):
        family_configs(name, str(model_root))


def _write_scheduler_config(root, name, payload: str):
    path = root / name / "scheduler"
    path.mkdir(parents=True, exist_ok=True)
    (path / "scheduler_config.json").write_text(payload)


@pytest.mark.parametrize("name", [
    "runwayml/stable-diffusion-v1-5", "stabilityai/stable-diffusion-2-1",
    "stabilityai/stable-diffusion-2-1-base", "stabilityai/stable-diffusion-xl-base-1.0",
    "test/tiny-xl",
])
@pytest.mark.parametrize("payload", [
    '{"prediction_type": "v_prediction"}', '{"prediction_type": "epsilon"}',
    '{"_class_name": "PNDMScheduler"}', "not json",
])
def test_scheduler_config_sets_prediction_type(name, payload, model_root):
    """The checkpoint's scheduler config overrides the name's prediction
    type for every family; a config without one, or one that does not
    parse, leaves the name's."""
    _write_scheduler_config(model_root, name, payload)
    pred = family_configs(name, str(model_root))[-1]
    assert pred == jax_sd._family_configs(name)[-1]
    stated = json.loads(payload).get("prediction_type") if payload[0] == "{" else None
    assert config_prediction_type(name, str(model_root)) == stated
    if stated:
        assert pred == stated


def _save_safetensors(pipe, root):
    from safetensors.numpy import save_file

    parts = {"unet": pipe.unet, "vae": pipe.vae}
    for i, enc in enumerate(pipe.text_encoders):
        parts["text_encoder" + ("_2" if i else "")] = enc
    for sub, module in parts.items():
        (root / sub).mkdir(parents=True)
        save_file({k: v.detach().numpy().copy() for k, v in module.state_dict().items()},
                  str(root / sub / "model.safetensors"))


@pytest.mark.parametrize("model,pred", [
    ("test/tiny-sd", None),
    ("test/tiny-sd", "v_prediction"),
    ("test/tiny-xl", "v_prediction"),
])
def test_tiny_txt2img_prediction_type_matches_jax(model, pred, model_root):
    """A model directory whose scheduler config says v_prediction gives a
    v-prediction denoise in the port as in JAX (the port once read only
    the name, and gave epsilon)."""
    seeded = SDPipeline(model, device="cpu")
    _save_safetensors(seeded, model_root / model)
    if pred:
        _write_scheduler_config(model_root, model, json.dumps({"prediction_type": pred}))
    reference = jax_sd.SDPipeline(model)
    params = jax.tree_util.tree_map(np.asarray, reference.params)
    port = SDPipeline(model, device="cpu", weights=from_jax_params(params),
                      model_root_dir=str(model_root))
    assert port.prediction_type == (pred or "epsilon")

    seed, size, steps = 5, 64, 4
    job = dict(prompt="a lighthouse at dusk", negative_prompt="blurry",
               num_inference_steps=steps, height=size, width=size, guidance_scale=6.0)
    want, _ = reference.run(rng=jax.random.key(seed), **job)
    # the JAX pipeline's draw: split(rng, 3) -> init_rng -> NHWC normal
    _, init_rng, _ = jax.random.split(jax.random.key(seed), 3)
    noise = np.asarray(jax.random.normal(init_rng, (1, size // 2, size // 2, 4), jnp.float32))
    got, config = port.run(latents=noise.transpose(0, 3, 1, 2), **job)

    assert config["latents"]["finite"]
    want = np.asarray(want[0], np.int16)
    got = np.asarray(got[0], np.int16)
    assert got.shape == want.shape == (size, size, 3)
    assert np.abs(got - want).max() <= 2


def test_chip_smoke_sd_phases_rehearse_on_cpu(tmp_path):
    """chip_smoke.py's SD phases at a tiny size on the CPU: phase 4's tiny
    SD checks pass (the CPU against itself, the v-prediction model read as
    such), and the served SD path, with tiny stand-ins of its three models,
    passes every envelope check and then fails its launch-count check, as
    it must where no kernel runs."""
    import importlib.util
    from pathlib import Path

    import torch

    from chiaswarm_tpu_torch.registry import Registry

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.tiny_sd_checks(device="cpu", size=64) == {"test/tiny-sd": 0, smoke.TINY_V: 0}
    root = tmp_path / "models"
    _write_scheduler_config(root, smoke.TINY_V, '{"prediction_type": "v_prediction"}')
    with pytest.raises(smoke.SmokeFailure,
                       match="flash_attention was never launched on the SD path"):
        smoke.serve_sd_path("cpu", Registry(torch.device("cpu"), str(root)), device="cpu",
                            sd15="test/tiny-sd", sd15_inpaint="test/tiny-inpaint",
                            sd21=smoke.TINY_V, size15=64, size21=128, steps=3)
