"""chiaswarm_tpu_torch loads diffusers checkpoints and bounds its pipeline
residency, as the JAX package does.

- Fault 3.1 as a test: `test/tiny-sd` served through the worker's
  `Registry(device, model_root_dir)` from safetensors of another seed (in
  diffusers layout, and in the legacy layout that needs every fix-up of
  the loader: SD 1.x's 1x1-convolution `proj_in` / `proj_out`, the VAE's
  `query/key/value/proj_attn`, `position_ids`, one text-encoder layer
  more than the config runs) reports `weights: checkpoint`, and its image
  is within 2/255 of the JAX `SDPipeline` reading the same files with its
  own loader (`_convert_params`), JAX's initial noise injected (f32 on both
  sides; rounding to uint8 can flip a pixel by one level).
- Each fix-up alone: a module loaded from the legacy file equals the
  module the file was written from, bit for bit.
- A file that is present but broken raises CheckpointError naming the
  key or the file, and never falls back to random init: a wrong shape, a
  key the module lacks, a parameter that no file holds, bytes that are
  not safetensors. A detector's state that lacks a parameter is a
  CheckpointError too (DPT), and a detector behind the negative cache
  (M-LSD) is then cached as None, so its job is served degraded.
- The policy: a folder without safetensors gives random init for a test
  name and MissingWeightsError for a production name (before any device
  memory is taken); no model directory behaves as before, with a hint
  that says where the files go.
- LRU residency: five pipelines leave four, a fetch refreshes recency,
  the evicted name rebuilds on its next fetch, and a job that still holds
  the evicted pipeline runs to its end.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from chiaswarm_tpu import embed_cache
from chiaswarm_tpu.pipelines import stable_diffusion as jax_sd
from chiaswarm_tpu_torch import registry as registry_mod
from chiaswarm_tpu_torch import weights
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.models.clip import CLIPTextEncoder
from chiaswarm_tpu_torch.models.unet2d import UNet2DConditionModel
from chiaswarm_tpu_torch.models.vae import AutoencoderKL
from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
from chiaswarm_tpu_torch.registry import Registry

SIZE = 64
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_embed_cache():
    """The JAX pipeline caches prompt embeddings by model name; these tests
    serve `test/tiny-sd` on another seed's weights, so no embedding may
    pass between them and the other modules' tests."""
    embed_cache.reset()
    yield
    embed_cache.reset()


@pytest.fixture
def model_root(sdaas_root, tmp_path, monkeypatch):
    """An empty model root, the JAX package's and the port's."""
    root = tmp_path / "models"
    root.mkdir()
    monkeypatch.setenv("CHIASWARM_MODEL_ROOT_DIR", str(root))
    return root


def _numpy(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def legacy(state: dict, folder: str, fixups=("proj", "vae", "position_ids", "spare_layer"),
           text_layers: int = 2) -> dict:
    """A diffusers-layout state dict rewritten in the older layouts that
    published checkpoints still use."""
    out = {}
    for key, value in state.items():
        if "proj" in fixups and key.endswith(("proj_in.weight", "proj_out.weight")):
            value = value[:, :, None, None]  # SD 1.x's 1x1 convolutions
        if "vae" in fixups and folder == "vae":
            for new, old in ((".to_q.", ".query."), (".to_k.", ".key."),
                             (".to_v.", ".value."), (".to_out.0.", ".proj_attn.")):
                key = key.replace(new, old)
        out[key] = value
    if folder.startswith("text_encoder"):
        if "position_ids" in fixups:
            out["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
        if "spare_layer" in fixups:
            first = "text_model.encoder.layers.0."
            spare = f"text_model.encoder.layers.{text_layers}."
            out.update({spare + k[len(first):]: v for k, v in state.items()
                        if k.startswith(first)})
    return out


def save_checkpoint(pipe, model_dir, layout: str = "diffusers"):
    parts = {"unet": pipe.unet, "vae": pipe.vae}
    for i, enc in enumerate(pipe.text_encoders):
        parts["text_encoder" + ("_2" if i else "")] = enc
    for folder, module in parts.items():
        (model_dir / folder).mkdir(parents=True)
        state = _numpy(module)
        if layout == "legacy":
            state = legacy(state, folder)
        save_file(state, str(model_dir / folder / "diffusion_pytorch_model.safetensors"))


@pytest.mark.parametrize("layout", ["diffusers", "legacy"])
def test_checkpoint_served_through_registry_matches_jax(layout, model_root):
    """Fault 3.1: the port served random weights where JAX read the files."""
    other = SDPipeline("test/tiny-sd-other", device="cpu")
    save_checkpoint(other, model_root / "test/tiny-sd", layout)
    port = Registry(CPU, str(model_root)).get_pipeline("test/tiny-sd")
    assert port.weights_source == "checkpoint"
    assert port.checkpoint["bytes"] == sum(
        f.stat().st_size for f in (model_root / "test/tiny-sd").rglob("*.safetensors"))
    for mine, theirs in ((port.unet, other.unet), (port.vae, other.vae),
                         (port.text_encoders[0], other.text_encoders[0])):
        for key, value in theirs.state_dict().items():
            assert torch.equal(mine.state_dict()[key], value), key

    reference = jax_sd.SDPipeline("test/tiny-sd")
    seed = 5
    job = dict(prompt="a lighthouse at dusk", negative_prompt="blurry",
               num_inference_steps=4, height=SIZE, width=SIZE, guidance_scale=6.0)
    want, _ = reference.run(rng=jax.random.key(seed), **job)
    _, init_rng, _ = jax.random.split(jax.random.key(seed), 3)
    noise = np.asarray(jax.random.normal(init_rng, (1, SIZE // 2, SIZE // 2, 4), jnp.float32))
    got, config = port.run(latents=noise.transpose(0, 3, 1, 2), **job)

    assert config["weights"] == "checkpoint"
    diff = np.abs(np.asarray(got[0], np.int16) - np.asarray(want[0], np.int16))
    assert diff.max() <= 2


# --- the fix-ups, one at a time ---

FIXUPS = {
    # fix-up: (the module it applies to, its checkpoint folder)
    "proj": (lambda: UNet2DConditionModel(cfgs.TINY_UNET), "unet"),
    "vae": (lambda: AutoencoderKL(cfgs.TINY_VAE), "vae"),
    "position_ids": (lambda: CLIPTextEncoder(cfgs.TINY_CLIP), "text_encoder"),
    "spare_layer": (lambda: CLIPTextEncoder(cfgs.TINY_CLIP_2), "text_encoder_2"),
}


@pytest.mark.parametrize("fixup", sorted(FIXUPS))
def test_each_fixup_loads_bit_for_bit(fixup, tmp_path):
    make, folder = FIXUPS[fixup]
    source = make()
    weights.random_init_(source, torch.Generator().manual_seed(3))
    state = _numpy(source)
    written = legacy(state, folder, fixups=(fixup,))
    assert any(k not in state or written[k].shape != state[k].shape for k in written)
    path = tmp_path / "model.safetensors"
    save_file(written, str(path))
    target = make()
    nbytes = weights.load_checkpoint_(target, [path], folder, text_layers=2
                                      if folder.startswith("text") else None)
    assert nbytes == path.stat().st_size
    for key, value in source.state_dict().items():
        assert torch.equal(target.state_dict()[key], value), key


def test_checkpoint_key_rules():
    key = weights.checkpoint_key
    assert key("encoder.mid_block.attentions.0.query.weight", "vae") == (
        "encoder.mid_block.attentions.0.to_q.weight")
    assert key("decoder.mid_block.attentions.0.proj_attn.bias", "vae") == (
        "decoder.mid_block.attentions.0.to_out.0.bias")
    # the legacy names are the VAE's alone
    assert key("down_blocks.1.attentions.0.query.weight", "unet") == (
        "down_blocks.1.attentions.0.query.weight")
    assert key("text_model.embeddings.position_ids", "text_encoder") is None
    assert key("text_model.encoder.layers.23.mlp.fc1.weight", "text_encoder", 23) is None
    assert key("text_model.encoder.layers.22.mlp.fc1.weight", "text_encoder", 23) == (
        "text_model.encoder.layers.22.mlp.fc1.weight")
    conv = torch.zeros(8, 8, 1, 1)
    assert weights.checkpoint_tensor("x.proj_in.weight", conv).shape == (8, 8)
    assert weights.checkpoint_tensor("x.conv_in.weight", conv).shape == (8, 8, 1, 1)


# --- broken files ---

def _vae_state():
    vae = AutoencoderKL(cfgs.TINY_VAE)
    weights.random_init_(vae, torch.Generator().manual_seed(4))
    return _numpy(vae)


def _broken(kind: str, state: dict):
    key = "decoder.conv_in.weight"
    if kind == "shape":
        state[key] = state[key][:, :-1]
        return state, rf"{key}.*shape"
    if kind == "unknown":
        state["decoder.mystery.weight"] = np.zeros(3, np.float32)
        return state, "unexpected key 'decoder.mystery.weight'"
    if kind == "missing":
        del state[key]
        return state, rf"in no file, e.g. \['{key}'\]"
    return None, "unreadable safetensors file"


@pytest.mark.parametrize("kind", ["shape", "unknown", "missing", "unreadable"])
def test_broken_file_raises_naming_it(kind, tmp_path):
    state, match = _broken(kind, _vae_state())
    path = tmp_path / "vae.safetensors"
    if state is None:
        path.write_bytes(b"not a safetensors file")
    else:
        save_file(state, str(path))
    with pytest.raises(weights.CheckpointError, match=match) as err:
        weights.load_checkpoint_(AutoencoderKL(cfgs.TINY_VAE), [path], "vae")
    if kind != "missing":
        assert str(path) in str(err.value)


@pytest.mark.parametrize("kind", ["whole", "shape", "unknown", "missing", "unreadable"])
def test_check_holds_the_loaders_rule(kind, tmp_path):
    """`check_checkpoint` (the setup CLI's `--check`, on the meta device)
    refuses from the headers exactly what `load_checkpoint_` refuses, and
    names the key; a whole file passes both, with the module's count."""
    state, _ = (_vae_state(), None) if kind == "whole" else _broken(kind, _vae_state())
    path = tmp_path / "vae.safetensors"
    if state is None:
        path.write_bytes(b"not a safetensors file")
    else:
        save_file(state, str(path))
    with torch.device("meta"):
        meta = AutoencoderKL(cfgs.TINY_VAE)
    if kind == "whole":
        n = weights.check_checkpoint(meta, [path], "vae")
        assert n == sum(p.numel() for p in meta.parameters())
        weights.load_checkpoint_(AutoencoderKL(cfgs.TINY_VAE), [path], "vae")
        return
    with pytest.raises(weights.CheckpointError) as err:
        weights.check_checkpoint(meta, [path], "vae")
    named = {"shape": "decoder.conv_in.weight", "unknown": "decoder.mystery.weight",
             "missing": "decoder.conv_in.weight", "unreadable": str(path)}[kind]
    assert named in str(err.value)
    with pytest.raises(weights.CheckpointError):
        weights.load_checkpoint_(AutoencoderKL(cfgs.TINY_VAE), [path], "vae")


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_detector_missing_a_parameter_is_a_checkpoint_error(tmp_path):
    from safetensors.torch import load_file
    from safetensors.torch import save_file as save_torch

    from chiaswarm_tpu_torch.pipelines import aux_models as aux

    smoke = _chip_smoke()
    dpt, pose = "test/tiny-dpt", "test/tiny-pose"
    smoke.write_detectors(tmp_path, 5, tiny=True, depth_model=dpt, pose_model=pose,
                          skip=("hed", "pose", "pidinet", "lineart", "zoe", "upernet"))
    dpt_file = tmp_path / dpt / "model.safetensors"
    state = load_file(str(dpt_file))
    dropped = "head.head.0.weight"
    del state[dropped]
    save_torch(state, str(dpt_file))
    mlsd_file = tmp_path / aux.DEFAULT_ANNOTATORS / smoke.MLSD_FILE
    state = torch.load(str(mlsd_file), weights_only=True)
    del state[next(iter(state))]
    torch.save(state, str(mlsd_file))

    aux.clear()
    try:
        det = aux.Detectors("cpu", str(tmp_path), dpt, pose)
        with pytest.raises(weights.CheckpointError, match=rf"in no file, e.g. \['{dropped}'\]"):
            det.depth()
        assert det.mlsd() is None and det.mlsd() is None
    finally:
        aux.clear()


def test_broken_checkpoint_never_falls_back(model_root):
    pipe = SDPipeline("test/tiny-sd", device="cpu")
    save_checkpoint(pipe, model_root / "test/tiny-sd")
    vae_file = model_root / "test/tiny-sd" / "vae" / "diffusion_pytorch_model.safetensors"
    state, _ = _broken("shape", _vae_state())
    save_file(state, str(vae_file))
    with pytest.raises(weights.CheckpointError, match="decoder.conv_in.weight"):
        Registry(CPU, str(model_root)).get_pipeline("test/tiny-sd", allow_random_init=True)


# --- the policy ---

def test_folder_without_safetensors(model_root, caplog):
    (model_root / "test/tiny-sd" / "unet").mkdir(parents=True)
    with caplog.at_level(logging.WARNING):
        pipe = Registry(CPU, str(model_root)).get_pipeline("test/tiny-sd")
    assert pipe.weights_source == "random" and pipe.checkpoint is None
    assert "falling back to random init" in caplog.text

    name = "runwayml/stable-diffusion-v1-5"
    save_checkpoint(pipe, model_root / name)  # every folder but one holds files
    for f in (model_root / name / "vae").iterdir():
        f.unlink()
    with pytest.raises(weights.MissingWeightsError, match=f"looked in {model_root / name}"):
        Registry(CPU, str(model_root)).get_pipeline(name)


def test_no_model_directory(model_root):
    registry = Registry(CPU, str(model_root))
    assert registry.get_pipeline("test/tiny-sd").weights_source == "random"
    with pytest.raises(weights.MissingWeightsError) as err:
        registry.get_pipeline("runwayml/stable-diffusion-v1-5")
    assert "does not load" not in str(err.value)
    assert "{unet,vae,text_encoder[_2]}" in str(err.value)
    assert registry.resident_models() == ["test/tiny-sd"]


# --- residency ---

def test_registry_evicts_the_least_recently_used():
    assert registry_mod.MAX_RESIDENT_PIPELINES == 4
    registry = Registry(CPU)
    names = ["test/tiny-sd", "test/tiny-xl", "test/tiny-inpaint", "test/tiny-pix2pix"]
    built = {name: registry.get_pipeline(name) for name in names}
    held = built["test/tiny-xl"]  # as a job that runs on it holds it
    # fetches refresh recency: tiny-xl becomes the least recently used
    assert registry.get_pipeline("test/tiny-sd") is built["test/tiny-sd"]
    assert registry.get_pipeline("test/tiny-inpaint") is built["test/tiny-inpaint"]
    fifth = registry.get_pipeline("test/tiny-xl-inpaint")
    assert registry.resident_models() == sorted(
        ["test/tiny-sd", "test/tiny-inpaint", "test/tiny-pix2pix", "test/tiny-xl-inpaint"])
    assert registry.get_pipeline("test/tiny-xl-inpaint") is fifth
    # the evicted pipeline still serves the job that holds it
    images, config = held.run(prompt="still served", num_inference_steps=2)
    assert config["latents"]["finite"] and images[0].shape == (SIZE, SIZE, 3)
    # its name rebuilds on its next fetch, evicting the then least recently
    # used (tiny-pix2pix)
    rebuilt = registry.get_pipeline("test/tiny-xl")
    assert rebuilt is not held
    assert registry.resident_models() == sorted(
        ["test/tiny-sd", "test/tiny-inpaint", "test/tiny-xl-inpaint", "test/tiny-xl"])


def test_chip_smoke_checkpoint_phase_rehearses_on_cpu():
    """chip_smoke.py's checkpoint path at a tiny size on the CPU: the
    seeded weights are written as fp16 safetensors, the worker's Registry
    loads them and serves the job, which passes its envelope checks and
    then fails its launch-count check, as it must where no kernel runs."""
    smoke = _chip_smoke()
    with pytest.raises(smoke.SmokeFailure,
                       match="flash_attention was never launched on the checkpoint path"):
        smoke.serve_checkpoint_path("cpu", device="cpu", model="test/tiny-sd", size=SIZE,
                                    steps=3)
