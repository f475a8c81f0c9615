"""chiaswarm_tpu_torch's NSFW safety checker against the JAX package.

- `SafetyConfig` and `TINY_SAFETY` equal JAX's field for field.
- The port's seeded checker converted by the JAX package's
  `convert_safety_checker` and back by `weights.from_jax_params` (the
  same tensors); both modules, f32 on the CPU: the concept scores equal
  JAX's within 1e-5 absolute (the cosines of the same embeddings; the
  reference's own test holds only the flags), and the flags are equal,
  on inputs made to hit a concept and a special-care embedding as well as
  on random ones.
- `NSFWChecker` with its host preprocessing (bicubic to the canvas, CLIP
  normalisation) against JAX's `NSFWChecker`, both reading one
  checkpoint in the published (transformers) layout, `position_ids`
  included: equal flags, scores within 1e-5.
- The policy cases of tests/test_safety.py: a production name without
  files disables the checker ((False, False) from `flag_images`), the
  setting "" disables it, a tiny name checks (True); a broken checkpoint
  is cached as disabled; `flag_images` never raises.
- The envelopes: a solo job and each member of a coalesced pass carry
  their own `nsfw` and `nsfw_checked`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu.models import safety as jax_models
from chiaswarm_tpu.models.conversion import convert_safety_checker
from chiaswarm_tpu.pipelines import safety as jax_safety
from chiaswarm_tpu.settings import Settings as JaxSettings
from chiaswarm_tpu_torch import settings as port_settings
from chiaswarm_tpu_torch.models.safety import TINY_SAFETY, SafetyChecker, SafetyConfig
from chiaswarm_tpu_torch.pipelines import safety
from chiaswarm_tpu_torch.registry import Registry
from chiaswarm_tpu_torch.weights import MissingWeightsError, from_jax_params
from chiaswarm_tpu_torch.workflows.diffusion import (
    diffusion_batched_callback,
    diffusion_callback,
)

SCORE_TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_checkers():
    """Each test builds its own checkers: both packages keep one a process."""
    safety._CHECKER = safety._CHECKER_KEY = None
    jax_safety._CHECKER = jax_safety._CHECKER_NAME = None
    yield
    safety._CHECKER = safety._CHECKER_KEY = None
    jax_safety._CHECKER = jax_safety._CHECKER_NAME = None


def _image(seed, size=(48, 40)):
    rng = np.random.default_rng(seed)
    return Image.fromarray((rng.random((size[1], size[0], 3)) * 255).astype(np.uint8))


@pytest.mark.parametrize("port,ref", [(SafetyConfig(), jax_models.SafetyConfig()),
                                      (TINY_SAFETY, jax_models.TINY_SAFETY)])
def test_configs_match_jax(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


_JAX_TOWER = jax.jit(jax_models.CLIPVisionEncoder(jax_models.TINY_SAFETY).apply)
_JAX_CHECKER = jax.jit(jax_models.SafetyChecker(jax_models.TINY_SAFETY).apply)


def _jax_scores(params, pixels):
    """The reference's arithmetic after the tower, on its embeddings."""
    e = np.asarray(_JAX_TOWER({"params": params["vision"]}, jnp.asarray(pixels)), np.float32)

    def cos(a, b):
        a = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-8)
        b = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-8)
        return a @ b.T

    special = cos(e, params["special_care_embeds"]) - params["special_care_embeds_weights"]
    adjust = np.where((special > 0).any(-1, keepdims=True), 0.01, 0.0)
    return cos(e, params["concept_embeds"]) - params["concept_embeds_weights"] + adjust, e


def _seeded_state(seed=9) -> dict:
    """A seeded checker's state dict in the published layout."""
    seeded = SafetyChecker(TINY_SAFETY)
    safety.init_random_(seeded, torch.Generator().manual_seed(seed))
    return {k: v.detach().numpy().copy() for k, v in seeded.state_dict().items()}


def test_checker_scores_and_flags_match_jax():
    """The port's seeded checker read by the JAX package's
    `convert_safety_checker`, and back through from_jax_params (the same
    tensors); both modules on inputs made to hit a concept and a
    special-care embedding."""
    state = _seeded_state()
    params = convert_safety_checker(state)
    back = from_jax_params({"safety": params})["safety"]
    assert set(back) == set(state)
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), state[key], err_msg=key)
    size = TINY_SAFETY.image_size
    pixels = np.random.default_rng(3).standard_normal((4, size, size, 3)).astype(np.float32)
    # image 0 alone hits concept 1 (its threshold halfway between image 0's
    # cosine, 1, and the next image's); image 1 hits a special-care
    # embedding, which lifts every concept score by 0.01
    _, e = _jax_scores(params, pixels)
    unit = e / np.linalg.norm(e, axis=-1, keepdims=True)
    params["concept_embeds"][1] = e[0]
    params["concept_embeds_weights"][1] = (1.0 + (unit[1:] @ unit[0]).max()) / 2
    params["special_care_embeds"][0] = e[1]
    want, _ = _jax_scores(params, pixels)
    want_flags = np.asarray(_JAX_CHECKER({"params": params}, jnp.asarray(pixels)))
    model = SafetyChecker(TINY_SAFETY).eval()
    model.load_state_dict(from_jax_params({"safety": params})["safety"])
    with torch.no_grad():
        got, flags = model(torch.from_numpy(pixels.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.numpy(), want, atol=SCORE_TOL, rtol=0)
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    assert want_flags[0] and not want_flags.all()


def test_published_layout_checkpoint_checks_as_in_jax(tmp_path, monkeypatch, sdaas_root):
    """A checkpoint in the published layout (position_ids included) under
    a test name, which both packages then read (a production name would be
    a ViT-L at full width): the same flags on images of another size than
    the canvas (bicubic and CLIP normalisation on the host), and scores
    within SCORE_TOL of JAX's arithmetic."""
    from safetensors.numpy import save_file

    name = "test/tiny-safety-checkpoint"
    state = _seeded_state()
    state["vision_model.vision_model.embeddings.position_ids"] = np.arange(
        17, dtype=np.int64)[None]
    (tmp_path / name).mkdir(parents=True)
    save_file(state, str(tmp_path / name / "model.safetensors"))

    port = safety.NSFWChecker(name, "cpu", str(tmp_path))
    assert port.available and port.weights_source == "checkpoint"
    images = [_image(s) for s in range(4)]
    got, flags = port.scores(images)
    monkeypatch.setenv("CHIASWARM_MODEL_ROOT_DIR", str(tmp_path))
    reference = jax_safety.NSFWChecker(name)
    assert reference.available and reference.check(images) == flags
    size = TINY_SAFETY.image_size
    batch = np.stack([(np.asarray(im.convert("RGB").resize((size, size), Image.BICUBIC),
                                  np.float32) / 255.0 - safety._MEAN) / safety._STD
                      for im in images])
    want, _ = _jax_scores(jax.tree_util.tree_map(np.asarray, reference.params), batch)
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)
    # uint8 arrays, as the pipelines hand them over, are the same images
    assert port.scores([np.asarray(im) for im in images])[1] == flags


def test_missing_production_weights_disable_the_checker(tmp_path):
    name = "CompVis/stable-diffusion-safety-checker"
    with pytest.raises(MissingWeightsError):
        safety.NSFWChecker(name, "cpu", str(tmp_path))
    checker = safety.get_checker(name, str(tmp_path), "cpu")
    assert not checker.available and checker.check([_image(0)]) is None
    registry = Registry(CPU, str(tmp_path))
    assert safety.flag_images([_image(0)], registry.safety_checker) == (False, False)


def test_empty_setting_disables_the_checker(tmp_path):
    registry = Registry(CPU, str(tmp_path), safety_checker_model="")
    assert safety.flag_images([_image(0)], registry.safety_checker) == (False, False)


def test_tiny_checker_checks(tmp_path):
    registry = Registry(CPU, str(tmp_path), safety_checker_model="test/tiny-safety")
    nsfw, checked = safety.flag_images([_image(0), _image(1)], registry.safety_checker)
    assert checked is True and isinstance(nsfw, bool)
    assert registry.safety_checker() is registry.safety_checker()  # one per process


def test_broken_checkpoint_is_cached_as_disabled(tmp_path, monkeypatch):
    folder = tmp_path / "CompVis" / "stable-diffusion-safety-checker"
    folder.mkdir(parents=True)
    (folder / "model.safetensors").write_bytes(b"not a safetensors file")
    built = []
    real = safety.NSFWChecker

    def counting(*args, **kwargs):
        built.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(safety, "NSFWChecker", counting)
    registry = Registry(CPU, str(tmp_path))
    for _ in range(2):
        assert safety.flag_images([_image(0)], registry.safety_checker) == (False, False)
    assert len(built) == 1


def test_flag_images_never_raises():
    def broken():
        raise RuntimeError("no device")

    class Failing:
        def check(self, images):
            raise RuntimeError("boom")

    assert safety.flag_images([_image(0)], broken) == (False, False)
    assert safety.flag_images([_image(0)], Failing) == (False, False)


def test_settings_name_the_checker_as_jax(monkeypatch, sdaas_root):
    assert (port_settings.Settings().safety_checker_model
            == JaxSettings().safety_checker_model == safety.DEFAULT_SAFETY_MODEL)
    monkeypatch.setenv("CHIASWARM_SAFETY_CHECKER_MODEL", "")
    assert port_settings.load_settings().safety_checker_model == ""


# --- the envelopes ---

def test_solo_envelope_carries_the_checkers_flag(tmp_path):
    registry = Registry(CPU, str(tmp_path), safety_checker_model="test/tiny-safety")
    _, config = diffusion_callback("cpu", "test/tiny-sd", registry=registry, prompt="a cat",
                                   num_inference_steps=2, height=64, width=64, seed=3,
                                   content_type="image/png")
    assert config["nsfw_checked"] is True and isinstance(config["nsfw"], bool)
    assert "safety_s" in config["timings"]


class _FlagsFirst:
    """A checker that flags the first job it sees and records each call."""

    def __init__(self):
        self.calls = []

    def check(self, images):
        self.calls.append(len(images))
        return [len(self.calls) == 1] * len(images)


def test_each_member_of_a_pass_is_flagged_on_its_own(tmp_path):
    stub = _FlagsFirst()
    registry = Registry(CPU, str(tmp_path))
    registry.safety_checker = lambda: stub
    requests = [{"model_name": "test/tiny-sd", "prompt": p, "seed": s, "height": 64,
                 "width": 64, "num_inference_steps": 2, "num_images_per_prompt": n}
                for p, s, n in (("a cat", 1, 2), ("a dog", 2, 1))]
    out = diffusion_batched_callback("cpu", requests, registry=registry)
    assert stub.calls == [2, 1]
    assert [(c["nsfw"], c["nsfw_checked"]) for _, c in out] == [(True, True), (False, True)]
    assert all(c["batched_with"] == 2 for _, c in out)
