"""chiaswarm_tpu_torch's Flux slice (FLUX.1-dev and schnell: T5, the MMDiT
transformer, flow-matching Euler, solo and coalesced txt2img) against the
JAX package, on the CPU in f32.

- The configs (FluxConfig, T5Config, their tiny stand-ins, the Flux VAE)
  equal JAX's.
- T5 (TINY_T5, with an attention mask, the first block's position bias
  shared by every block) and the Flux transformer (TINY_FLUX, dev and
  schnell) against JAX's modules on the same parameters: T5 within 1e-5
  (as CLIP in test_torch_port_models.py), the transformer within 1e-4
  absolute and relative (as the UNet there: two stacks of matmuls,
  summed in another order). The transformer's parameters come from a
  JAX init through `weights.from_jax_params`; `from_jax_params` inverts
  `convert_flux` and `convert_t5` exactly, both ways. A T5 file whose
  token table is `encoder.embed_tokens` alone loads it into `shared`.
- `FlowMatchEulerScheduler`'s sigmas and timesteps equal numpy's (the
  JAX package's, computed by the same numpy) bit for bit, for the dev
  shift and schnell's 1; a step within 1e-6. `_sigma_shift` equals JAX's
  at 256, 1024 and 4096 image tokens. patchify / unpatchify round-trip
  exactly and give JAX's patches and ids.
- Whole jobs: the port's seeded tiny-flux and tiny-flux-schnell written
  as diffusers safetensors (`chip_smoke.write_flux`) under a model root
  that the JAX FluxPipeline reads, JAX's initial latents
  (`normal(split(key(seed))[1], (b, h/8, w/8, C))`) handed to the port:
  the uint8 images agree within 2/255 (f32 on both sides; rounding to
  uint8 can flip a level) and the envelopes' shared fields are JAX's.
  `run_batched` rows equal their solo twins.
- The coalesce key's Flux arm equals JAX's on the same job dicts; the
  registry builds FluxPipeline by wire name and by model name, and on the
  card first evicts least recently used pipelines until the new bundle
  and one image fit in the free memory (the memory handed in); Flux's
  capacity rows and resident bytes on an 80 GB card; a production Flux name without files
  raises MissingWeightsError, and no CUDA device raises.
- The worker serves Flux jobs alone and coalesced through the fake hive;
  its poll says `flux_runnable: 1` and no longer names flux among
  `unconverted_families`. chip_smoke.py's Flux phases rehearse on the CPU.
"""

import asyncio
import copy
import dataclasses
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu import coalesce as jax_coalesce
from chiaswarm_tpu import registry as jax_registry
from chiaswarm_tpu.models import configs as jax_cfgs
from chiaswarm_tpu.models import conversion as jax_conversion
from chiaswarm_tpu.models import flux as jax_flux
from chiaswarm_tpu.models import t5 as jax_t5
from chiaswarm_tpu.pipelines import flux as jax_flux_pipe
from chiaswarm_tpu.schedulers import FlowMatchEulerScheduler as JaxFlowMatch
from chiaswarm_tpu.schedulers.common import SchedulerConfig as JaxSchedulerConfig
from chiaswarm_tpu_torch import capacity, coalesce, weights
from chiaswarm_tpu_torch import registry as registry_mod
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.models.flux import FluxTransformer, patchify, unpatchify
from chiaswarm_tpu_torch.models.t5 import T5Encoder, relative_position_buckets
from chiaswarm_tpu_torch.pipelines import flux as flux_pipe
from chiaswarm_tpu_torch.pipelines.flux import FluxPipeline
from chiaswarm_tpu_torch.registry import (
    Registry,
    check_pipeline_type,
    job_family,
    unconverted_family_keywords,
)
from chiaswarm_tpu_torch.schedulers import get_scheduler
from chiaswarm_tpu_torch.settings import Settings
from chiaswarm_tpu_torch.weights import MissingWeightsError, from_jax_params

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
SIZE = 64
STEPS = 4
DEV, SCHNELL = "black-forest-labs/FLUX.1-dev", "black-forest-labs/FLUX.1-schnell"
TINY = ("test/tiny-flux", "test/tiny-flux-schnell")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _state(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _seeded(module, seed):
    """Seeded weights, with every bias and norm scale moved off its init
    value so that a swapped or dropped one shows."""
    weights.random_init_(module, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return module.eval()


# --- configs ---

@pytest.mark.parametrize("port,ref", [
    (cfgs.FluxConfig(), jax_flux.FluxConfig()), (cfgs.TINY_FLUX, jax_flux.TINY_FLUX),
    (cfgs.T5Config(), jax_t5.T5Config()), (cfgs.TINY_T5, jax_t5.TINY_T5),
    (cfgs.FLUX_VAE, jax_cfgs.FLUX_VAE)])
def test_configs_match_jax(port, ref):
    port, ref = dataclasses.asdict(port), dataclasses.asdict(ref)
    assert {k: port[k] for k in ref if k in port} == {k: ref[k] for k in ref if k in port}
    assert set(port) <= set(ref)


@pytest.mark.parametrize("name", [*TINY, DEV, SCHNELL])
def test_flux_configs_match_jax(name):
    port = flux_pipe.flux_configs(name)
    ref = jax_flux_pipe._flux_configs(name)
    for p, r in zip(port[:4], ref[:4]):
        p, r = dataclasses.asdict(p), dataclasses.asdict(r)
        assert {k: p[k] for k in r if k in p} == {k: r[k] for k in r if k in p}
    assert port[4:] == ref[4:]


# --- modules ---

def test_relative_position_buckets_match_jax():
    for length, buckets, distance in ((12, 32, 128), (200, 32, 128), (64, 16, 20)):
        np.testing.assert_array_equal(
            relative_position_buckets(length, length, buckets, distance),
            jax_t5.relative_position_buckets(length, length, buckets, distance))


def test_t5_matches_jax():
    """The port's seeded tiny T5 read by convert_t5 and run by the JAX
    module, with a mask that drops the last keys of one row; the tree
    back through from_jax_params is the port's state, exactly."""
    port = _seeded(T5Encoder(cfgs.TINY_T5), 3)
    state = _state(port)
    tree = jax_conversion.convert_t5(state)
    back = from_jax_params({"t5": tree})["t5"]
    assert set(back) == set(state)
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), state[key], err_msg=key)
    ids = np.random.default_rng(4).integers(0, 1000, (2, 20))
    mask = np.ones((2, 20), np.int32)
    mask[1, 13:] = 0
    model = jax_t5.T5Encoder(jax_t5.TINY_T5)
    for m in (mask, None):
        want = model.apply({"params": tree}, jnp.asarray(ids),
                           None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = port(torch.from_numpy(ids), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_t5_checkpoint_reads_the_tied_token_table(tmp_path):
    """A transformers T5 file may hold the token table as
    `encoder.embed_tokens.weight` alone (tied to `shared`): it loads into
    `shared`."""
    from safetensors.numpy import save_file

    state = _state(_seeded(T5Encoder(cfgs.TINY_T5), 4))
    state["encoder.embed_tokens.weight"] = state.pop("shared.weight")
    save_file(state, str(tmp_path / "model.safetensors"))
    fresh = T5Encoder(cfgs.TINY_T5)
    weights.load_checkpoint_(fresh, [tmp_path / "model.safetensors"], "text_encoder_2")
    np.testing.assert_array_equal(fresh.shared.weight.detach().numpy(),
                                  state["encoder.embed_tokens.weight"])


def _jax_flux_tree(cfg, seed):
    """A JAX init of the tiny transformer, its biases and norm scales moved
    off their init values."""
    s_img, s_txt = 4, 8
    params = jax_flux.FluxTransformer(cfg).init(
        jax.random.key(seed), jnp.zeros((1, s_img, cfg.in_channels)),
        jnp.zeros((1, s_img, 3), jnp.int32), jnp.zeros((1, s_txt, cfg.context_dim)),
        jnp.zeros((1, s_txt, 3), jnp.int32), jnp.zeros((1,)), jnp.zeros((1, cfg.pooled_dim)),
        guidance=jnp.ones((1,)))["params"]
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if path[-1].key in ("bias", "query_scale", "key_scale"):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(move, params)


@pytest.mark.parametrize("model", TINY)
def test_flux_transformer_matches_jax(model):
    """JAX's tiny transformer (dev with the guidance embedding, schnell
    without) through from_jax_params into the port's module: the
    velocities agree; the port's state through convert_flux is JAX's tree,
    exactly."""
    jax_cfg = jax_flux_pipe._flux_configs(model)[0]
    tree = _jax_flux_tree(jax_cfg, 11)
    port = FluxTransformer(flux_pipe.flux_configs(model)[0]).eval()
    port.load_state_dict(from_jax_params({"flux": tree})["flux"])
    again = jax_conversion.convert_flux(_state(port))
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    flat_again = dict(jax.tree_util.tree_leaves_with_path(again))
    assert set(map(str, flat)) == set(map(str, flat_again))
    for path, value in flat.items():
        np.testing.assert_array_equal(flat_again[path], np.asarray(value), err_msg=str(path))

    b, h, w = 2, 8, 12
    latents = _rand((b, h, w, 4), 1)
    txt, pooled = _rand((b, 7, 32), 2), _rand((b, 32), 3)
    t = np.asarray([0.8, 0.25], np.float32)
    g = np.asarray([3.5, 1.0], np.float32)
    img, ids = jax_flux.patchify(jnp.asarray(latents))
    want = jax_flux.FluxTransformer(jax_cfg).apply(
        {"params": tree}, img, ids, jnp.asarray(txt), jnp.zeros((b, 7, 3), jnp.int32),
        jnp.asarray(t), jnp.asarray(pooled), guidance=jnp.asarray(g))
    p_img, p_ids = patchify(torch.from_numpy(latents))
    with torch.no_grad():
        got = port(p_img, p_ids, torch.from_numpy(txt), torch.zeros((b, 7, 3), dtype=torch.int32),
                   torch.from_numpy(t), torch.from_numpy(pooled), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_from_jax_params_inverts_convert_flux_exactly():
    """The port's seeded state -> convert_flux -> from_jax_params gives it
    back bit for bit: the q/k/v and q/k/v/mlp fusions and the (scale,
    shift) swap of norm_out undone."""
    port = _seeded(FluxTransformer(cfgs.TINY_FLUX), 5)
    state = _state(port)
    tree = jax_conversion.convert_flux(state)
    assert set(tree["final_layer_mod"]) == {"kernel", "bias"}
    back = from_jax_params({"flux": tree})["flux"]
    assert set(back) == set(state)
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), state[key], err_msg=key)
    # the swap is real: norm_out's first half is JAX's second
    hidden = cfgs.TINY_FLUX.hidden_size
    np.testing.assert_array_equal(state["norm_out.linear.bias"][:hidden],
                                  tree["final_layer_mod"]["bias"][hidden:])


def test_patchify_round_trips_and_matches_jax():
    x = _rand((2, 6, 10, 4), 7)
    img, ids = patchify(torch.from_numpy(x))
    want, want_ids = jax_flux.patchify(jnp.asarray(x))
    np.testing.assert_array_equal(img.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(unpatchify(img, 6, 10).numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(jax_flux.unpatchify(want, 6, 10)), unpatchify(img, 6, 10).numpy())


# --- the solver ---

@pytest.mark.parametrize("steps", [4, 28])
@pytest.mark.parametrize("shift", [1.0, "dev"])
def test_flow_match_schedule_matches_jax(steps, shift):
    if shift == "dev":
        shift = flux_pipe._sigma_shift(4096, True)
    port = get_scheduler("FlowMatchEulerScheduler", prediction_type="flow", shift=shift)
    ref = JaxFlowMatch(JaxSchedulerConfig(prediction_type="flow", shift=shift))
    got, want = port.schedule(steps), ref.schedule(steps)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_array_equal(got.timesteps, want.timesteps)
    assert got.sigmas[-1] == 0.0 and got.init_noise_sigma == want.init_noise_sigma == 1.0
    sample, velocity = _rand((1, 16, 8), 8), _rand((1, 16, 8), 9)
    for i in (0, steps // 2, steps - 1):
        _, a = port.step(got, (), i, torch.from_numpy(sample), torch.from_numpy(velocity))
        _, b = ref.step(want, (), i, jnp.asarray(sample), jnp.asarray(velocity), None)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
        a = port.add_noise(got, torch.from_numpy(sample), torch.from_numpy(velocity), i)
        b = ref.add_noise(want, jnp.asarray(sample), jnp.asarray(velocity), i)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    assert type(get_scheduler("FlowMatchEulerDiscreteScheduler")) is type(port)


@pytest.mark.parametrize("tokens", [256, 1024, 4096])
def test_sigma_shift_matches_jax(tokens):
    for dynamic in (True, False):
        assert flux_pipe._sigma_shift(tokens, dynamic) == jax_flux_pipe._sigma_shift(
            tokens, dynamic)


def test_hash_t5_tokenizer_matches_jax(tmp_path):
    texts = ["a lighthouse on a cliff", "", "Dusk, Snow " * 40]
    for length in (8, 256, 512):
        np.testing.assert_array_equal(flux_pipe._HashT5Tokenizer(1000)(texts, length),
                                      jax_flux_pipe._HashT5Tokenizer(1000)(texts, length))
    # no spiece.model: the hash tokenizer, as JAX's rule says
    assert isinstance(flux_pipe._load_t5_tokenizer(tmp_path, 1000), flux_pipe._HashT5Tokenizer)


# --- whole jobs against the JAX pipeline ---

@pytest.fixture(scope="module")
def flux_root(tmp_path_factory):
    """A model root holding the port's seeded tiny-flux and
    tiny-flux-schnell in the diffusers layout, with the JAX pipelines that
    read it -> (root, {name: JAX FluxPipeline})."""
    root = tmp_path_factory.mktemp("flux")
    models = root / "models"
    smoke = _chip_smoke()
    for k, name in enumerate(TINY):
        pipe = FluxPipeline(name, device="cpu")
        for module in (pipe.transformer, pipe.t5, pipe.clip):
            _seeded(module, 20 + k)
        smoke.write_flux(pipe, models / name)
    mp = pytest.MonkeyPatch()
    mp.setenv("SDAAS_ROOT", str(root / "sdaas"))
    mp.setenv("CHIASWARM_MODEL_ROOT_DIR", str(models))
    jax_registry.clear_cache()
    refs = {name: jax_flux_pipe.FluxPipeline(name) for name in TINY}
    yield models, refs
    jax_registry.clear_cache()
    mp.undo()


def _close(got, want):
    got, want = np.asarray(got, np.int16), np.asarray(want, np.int16)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2


@pytest.mark.parametrize("name", TINY)
def test_tiny_flux_job_matches_jax(flux_root, name):
    """One two-image job on each package from the same files: JAX's initial
    latents handed to the port, the images within 2/255."""
    models, refs = flux_root
    port = FluxPipeline(name, device="cpu", model_root_dir=str(models))
    assert port.weights_source == "checkpoint"
    key = jax.random.key(21)
    kw = dict(num_inference_steps=STEPS, height=SIZE, width=SIZE, num_images_per_prompt=2,
              guidance_scale=4.0)
    want, want_cfg = refs[name].run("a red lighthouse", rng=key, **kw)
    latents = np.asarray(jax.random.normal(jax.random.split(key)[1], (2, 32, 32, 4),
                                           jnp.float32))
    got, cfg = port.run("a red lighthouse", latents=latents, **kw)
    for g, w in zip(got, want, strict=True):
        _close(g, np.asarray(w))
    for k in ("model", "pipeline", "scheduler", "mode", "steps", "size", "guidance_scale"):
        assert cfg[k] == want_cfg[k], k
    assert cfg["latents"]["finite"]
    assert {"text_encode_s", "denoise_s", "decode_s"} <= set(cfg["timings"])


def test_run_batched_rows_equal_their_solo_twins(flux_root):
    models, _ = flux_root
    port = FluxPipeline(TINY[0], device="cpu", model_root_dir=str(models))
    requests = [{"prompt": "a red lighthouse", "seed": 5},
                {"prompt": "a fox in snow", "seed": 6, "num_images_per_prompt": 2}]
    results = port.run_batched(requests, num_inference_steps=STEPS, guidance_scale=3.5)
    assert [c["batch_rows"] for _, c in results] == [[0, 1], [1, 2]]
    assert {c["padded_rows"] for _, c in results} == {4}
    assert all(c["batched_with"] == 2 for _, c in results)
    for r, (images, _) in zip(requests, results):
        solo, _ = port.run(r["prompt"], seed=r["seed"], num_inference_steps=STEPS,
                           guidance_scale=3.5,
                           num_images_per_prompt=r.get("num_images_per_prompt", 1))
        assert len(images) == len(solo)
        for g, w in zip(images, solo):
            _close(g, w)
    with pytest.raises(ValueError, match="adapters"):
        port.run_batched([{"prompt": "x", "lora": {"lora": "a"}}])
    with pytest.raises(ValueError, match="img2img"):
        port.run_batched([{"prompt": "x", "image": object()}])


# --- wire: the coalesce key, the registry, capacity, the worker ---

_FLUX_TXT = {"workflow": "txt2img", "model_name": DEV, "prompt": "a boat",
             "num_inference_steps": 28, "guidance_scale": 3.5}
KEY_JOBS = {
    "explicit": _FLUX_TXT,
    "in-parameters": {**{k: v for k, v in _FLUX_TXT.items() if k not in (
        "num_inference_steps", "guidance_scale")},
        "parameters": {"num_inference_steps": 4, "guidance_scale": 0.0,
                       "pipeline_type": "FluxPipeline"}},
    "schnell": {**_FLUX_TXT, "model_name": SCHNELL, "num_inference_steps": 4},
    "canvas": {**_FLUX_TXT, "height": 768, "width": 768},
    "no-steps": {k: v for k, v in _FLUX_TXT.items() if k != "num_inference_steps"},
    "no-guidance": {k: v for k, v in _FLUX_TXT.items() if k != "guidance_scale"},
    "img2img": {**_FLUX_TXT, "workflow": "img2img", "start_image_uri": "http://h/i.png",
                "height": 512, "width": 512},
    "lora": {**_FLUX_TXT, "lora": "style.safetensors"},
    "controlnet": {**_FLUX_TXT, "parameters": {"controlnet": {
        "control_image_uri": "http://h/c.png"}}},
    "sd-pipeline-name": {**_FLUX_TXT, "parameters": {"pipeline_type": "StableDiffusionPipeline"}},
    "max-sequence-length": {**_FLUX_TXT, "parameters": {"max_sequence_length": 256}},
    "tiny": {**_FLUX_TXT, "parameters": {"test_tiny_model": True}},
    "interactive": {**_FLUX_TXT, "priority": "interactive"},
}


@pytest.mark.parametrize("name", sorted(KEY_JOBS))
def test_coalesce_key_flux_arm_matches_jax(name, sdaas_root):
    job = KEY_JOBS[name]
    got = coalesce.coalesce_key(copy.deepcopy(job))
    assert got == jax_coalesce.coalesce_key(copy.deepcopy(job))
    batchable = name in ("explicit", "in-parameters", "schnell", "canvas", "tiny",
                         "interactive")
    assert (got is not None) == batchable
    if batchable:
        assert got[1] == "flux"


@pytest.mark.parametrize("model,pipeline_type", [
    (DEV, "FluxPipeline"), (DEV, "DiffusionPipeline"), (SCHNELL, "AutoPipelineForText2Image"),
    ("test/tiny-flux", None), (DEV, "StableDiffusionPipeline"),
    ("stabilityai/stable-diffusion-xl-base-1.0", "FluxPipeline")])
def test_job_family_as_jax(model, pipeline_type):
    if pipeline_type in (None, "DiffusionPipeline") or pipeline_type.startswith("AutoPipeline"):
        want = jax_registry._auto_family(model)
    else:
        want = jax_registry.family_of(pipeline_type)
    got = job_family(model, pipeline_type)
    assert got == ("sd" if want == "sdxl" else want)


def test_registry_builds_flux_by_wire_and_model_name(tmp_path):
    registry = Registry(torch.device("cpu"), str(tmp_path))
    check_pipeline_type("FluxPipeline")
    by_wire = registry.get_pipeline("test/tiny-flux", pipeline_type="FluxPipeline")
    assert isinstance(by_wire, FluxPipeline) and by_wire.weights_source == "random"
    assert registry.get_pipeline("test/tiny-flux", pipeline_type="DiffusionPipeline") is by_wire
    assert registry.get_pipeline("test/tiny-flux") is by_wire
    schnell = registry.get_pipeline("test/tiny-flux-schnell")
    assert not schnell.dynamic_shift and schnell.transformer.time_text_embed.guidance_embedder \
        is None
    assert registry.resident_models() == ["test/tiny-flux", "test/tiny-flux-schnell"]


@pytest.mark.parametrize("free_gib,released", [
    (20.0, ["sdxl-a", "sdxl-b"]),  # 20 + 2 x 8 >= 33.9: the newest stays
    (40.0, []),  # fits beside all three
    (2.0, ["sdxl-a", "sdxl-b", "sdxl-c"]),  # never fits: the build is tried alone
])
def test_registry_makes_room_by_bytes_before_a_build(tmp_path, monkeypatch, free_gib, released):
    """Three resident 8 GiB bundles, `free_gib` free: a Flux build that
    needs 33.9 GiB evicts the least recently used until it fits, or until
    nothing else is resident."""
    registry = Registry(torch.device("cpu"), str(tmp_path))
    gone = []

    class Resident:
        def __init__(self, name):
            self.name = name

        def release(self):
            gone.append(self.name)
            return 0

    for name in ("sdxl-a", "sdxl-b", "sdxl-c"):
        registry._pipelines[(name, "sd")] = Resident(name)
    gib = 1 << 30
    monkeypatch.setattr(registry_mod, "resident_bytes",
                        lambda device, name: int(33.9 * gib) if "flux" in name else 0)
    monkeypatch.setattr(registry_mod, "free_bytes",
                        lambda device: int((free_gib + 8 * len(gone)) * gib))
    assert isinstance(registry.get_pipeline("test/tiny-flux"), FluxPipeline)
    assert gone == released
    assert registry.resident_models() == sorted(
        {"sdxl-a", "sdxl-b", "sdxl-c", "test/tiny-flux"} - set(released))


def test_resident_bytes_of_a_build():
    """What the registry makes room for on the card: the family's
    footprint and one image at its canvas; nothing off the card or for a
    tiny test model."""
    card, gib = torch.device("cuda"), 1 << 30
    assert capacity.resident_bytes(card, DEV) == int((31.4 + 2.5) * gib)
    assert capacity.resident_bytes(card, "stabilityai/stable-diffusion-xl-base-1.0") == int(
        10.0 * gib)
    assert capacity.resident_bytes(card, "runwayml/stable-diffusion-v1-5") == int(
        (1.8 + 0.25) * gib)
    assert capacity.resident_bytes(card, "test/tiny-flux") == 0
    assert capacity.resident_bytes(torch.device("cpu"), DEV) == 0


def test_production_flux_without_files_raises_and_cuda_is_required(tmp_path, monkeypatch):
    with pytest.raises(MissingWeightsError):
        FluxPipeline(DEV, device="cpu", model_root_dir=str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FluxPipeline("test/tiny-flux")


def test_flux_rows_on_an_80_gb_card(monkeypatch):
    """capacity.py on an H100 (its properties handed in): FLUX.1-dev
    (31.4 GiB resident, 2.5 GiB an image at 1024²) fits one job and 16
    images a pass at 1024², 32 at 512², none past the card."""
    props = types.SimpleNamespace(total_memory=int(79.1 * 2**30), multi_processor_count=132,
                                  shared_memory_per_block_optin=232448)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: props)
    card = torch.device("cuda")
    assert capacity.fit_batch(card, DEV, 1, 1024) == 1
    assert capacity.fit_batch(card, DEV, 256, 1024) == 19
    assert capacity.coalesce_rows_limit(card, DEV, 1024) == 16
    assert capacity.coalesce_rows_limit(card, SCHNELL, 512) == 64
    assert capacity.coalesced_fit(card, DEV, 4, 1024) == 4
    props.total_memory = 32 * 2**30
    assert capacity.fit_batch(card, DEV, 1, 1024) == 0


def test_unconverted_families_no_longer_name_flux():
    assert "flux" not in unconverted_family_keywords()
    # a family still to port keeps its words
    assert "suno/bark" in unconverted_family_keywords()


def _image(artifact):
    import base64
    import hashlib
    import io

    from PIL import Image

    blob = base64.b64decode(artifact["blob"])
    assert hashlib.sha256(blob).hexdigest() == artifact["sha256_hash"]
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def test_worker_serves_flux_jobs(tmp_path):
    """Through the fake hive: a dev job alone (max_sequence_length 256,
    which keeps it out of a pass), then two schnell jobs with explicit
    steps and guidance queued before the first poll, served as one
    coalesced pass; all on the tiny stand-ins."""
    hive = FakeHive(token="tok")
    try:
        settings = Settings(sdaas_token="tok", sdaas_uri=hive.uri, worker_name="port-flux",
                            model_root_dir=str(tmp_path / "models"))
        worker = worker_mod.Worker(settings=settings, device="cpu", poll_seconds=0.01)
        common = {"workflow": "txt2img", "prompt": "a lighthouse", "height": SIZE,
                  "width": SIZE, "num_inference_steps": 2, "content_type": "image/png"}
        hive.enqueue({**common, "id": "dev-1", "model_name": DEV, "seed": 1,
                      "parameters": {"test_tiny_model": True, "pipeline_type": "FluxPipeline",
                                     "max_sequence_length": 256, "guidance_scale": 4.0}})
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=1), timeout=120))
        hive.enqueue(*({**common, "id": f"schnell-{i}", "model_name": SCHNELL, "seed": 10 + i,
                        "guidance_scale": 0.0,
                        "parameters": {"test_tiny_model": True, "pipeline_type": "FluxPipeline"}}
                       for i in range(2)))
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=3), timeout=120))
        results = {r["id"]: r for r in hive.wait_for_results(3, timeout=10)}
    finally:
        hive.close()
    poll = hive.polls[0]
    assert int(poll["flux_runnable"]) == 1
    assert "flux" not in poll["unconverted_families"].split(",")
    dev = results["dev-1"]
    assert not dev.get("fatal_error"), dev["pipeline_config"]
    cfg = dev["pipeline_config"]
    assert (cfg["model"], cfg["scheduler"], cfg["mode"], cfg["steps"]) == (
        "test/tiny-flux", "FlowMatchEulerScheduler", "txt2img", 2)
    assert cfg["guidance_scale"] == 4.0 and cfg["max_sequence_length"] == 256
    assert cfg["seed"] == 1 and "batched_with" not in cfg and cfg["latents"]["finite"]
    assert _image(dev["artifacts"]["primary"]).shape == (SIZE, SIZE, 3)
    for i in range(2):
        r = results[f"schnell-{i}"]
        assert not r.get("fatal_error"), r["pipeline_config"]
        cfg = r["pipeline_config"]
        assert cfg["model"] == "test/tiny-flux-schnell" and cfg["seed"] == 10 + i
        assert cfg["batched_with"] == 2 and cfg["batch_rows"] == [i, 1]
        assert _image(r["artifacts"]["primary"]).shape == (SIZE, SIZE, 3)


def test_chip_smoke_flux_phases_rehearse_on_cpu():
    """chip_smoke.py's Flux path, its step beside a resident SDXL pipeline
    and its tiny checks at a tiny size on the CPU: every envelope, pass
    and poll check runs; the launches are printed, not held (no kernel
    runs here)."""
    smoke = _chip_smoke()
    paths, served = smoke.serve_flux_path("cpu", device="cpu", dev=TINY[0], schnell=TINY[1],
                                          size=SIZE, dev_steps=2, schnell_steps=2, hold=False)
    assert set(paths) == {"flux_dev_0", "flux_dev_1", "flux_dev_pass", "flux_dev_pass_twin",
                          "flux_schnell"}
    assert served["pass_vs_alone"]["first_row_vs_alone_max_pixel_diff"] <= 2
    assert int(served["advertised"]["flux_runnable"]) == 1
    registry = Registry(torch.device("cpu"), str(REPO / ".no-models"))
    registry.get_pipeline("test/tiny-xl")
    beside = smoke.serve_flux_beside_sd("cpu", registry, device="cpu", sdxl="test/tiny-xl",
                                        schnell=TINY[1], dev=TINY[0], size=SIZE, steps=2,
                                        hold=False)
    assert beside["schnell"]["evicted"] == [] and beside["dev"]["evicted"] == []
    assert beside["dev"]["resident_after"] == ["test/tiny-flux", "test/tiny-flux-schnell",
                                               "test/tiny-xl"]
    assert smoke.tiny_flux_checks(device="cpu") == {
        name: {"diff": 0, "batched_diff": 0} for name in TINY}
