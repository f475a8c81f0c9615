"""chiaswarm_tpu_torch's per-job adapters (LoRA, textual inversion, custom
VAE) against the JAX package.

- `resolve_lora` in its four forms, and `job_arguments.format_args` on
  adapter jobs, against JAX's (each side on its own deep copy).
- The factors parsed from kohya and PEFT files (UNet, te1, te2, `.alpha`, a
  conv-shaped factor, an unknown module, a tensor that is no factor) equal
  JAX's bit for bit; the modules they match on the port's Linear modules
  equal JAX's `match_dense_factors` + `match_te_dense_factors`, module for
  module, for an adapter over every Linear of tiny-xl and of tiny-sd.
- Whole jobs on the same weights (the port's written as safetensors under a
  model root that JAX reads too), JAX's noise injected into the port as in
  the other port tests: tiny-xl with a kohya adapter over the UNet and both
  text encoders at scale 1.0 and at 0.5 given as
  `cross_attention_kwargs.scale`; tiny-sd with a PEFT adapter whose
  `proj_in` / `proj_out` factors are 1x1 convs, which JAX serves by its
  merged route and the port by its delta (both drop those modules); each
  textual-inversion format; a custom VAE on txt2img and on img2img. The
  decoded images agree within 2/255, the bound of the JAX package's own
  port tests (f32 on both sides; rounding to uint8 can flip a level).
- `lora_scale` 0 gives the plain image bit for bit, and so does a plain
  job after an adapter job; the four fatal cases come back through the
  port's worker and fake hive as fatal envelopes, and an adapter job is
  served there; the factor cache's byte cap; eviction drops adapter state.
- chip_smoke.py's adapter phases rehearsed at a tiny size on the CPU.
"""

import asyncio
import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import load_file, save_file

from chiaswarm_tpu import embed_cache as jax_embed_cache
from chiaswarm_tpu import job_arguments as jax_job_arguments
from chiaswarm_tpu import lora_cache as jax_lora_cache
from chiaswarm_tpu import registry as jax_registry
from chiaswarm_tpu import settings as jax_settings
from chiaswarm_tpu.loras import resolve_lora as jax_resolve_lora
from chiaswarm_tpu.models import lora as jax_lora
from chiaswarm_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from chiaswarm_tpu.models.tokenizer import PlaceholderTokenizer as JaxPlaceholderTokenizer
from chiaswarm_tpu.pipelines import stable_diffusion as jax_sd
from chiaswarm_tpu_torch import job_arguments, settings
from chiaswarm_tpu_torch import worker as worker_mod
from chiaswarm_tpu_torch.fake_hive import FakeHive
from chiaswarm_tpu_torch.lora_cache import ByteLRU, LoraCache
from chiaswarm_tpu_torch.loras import resolve_lora
from chiaswarm_tpu_torch.models import lora
from chiaswarm_tpu_torch.models.tokenizer import HashTokenizer, PlaceholderTokenizer
from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
from chiaswarm_tpu_torch.registry import Registry

SIZE = 64
SDXL = "stabilityai/stable-diffusion-xl-base-1.0"
SD15 = "runwayml/stable-diffusion-v1-5"
MODELS = ("test/tiny-xl", "test/tiny-sd")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


smoke = _chip_smoke()


# --- references and arguments ---

@pytest.mark.parametrize("ref", ["style.safetensors", "publisher/repo",
                                 "publisher/repo/w.safetensors",
                                 "publisher/repo/sub/dirs/w.safetensors", "/a//b/"])
def test_resolve_lora_matches_jax(ref):
    assert resolve_lora(ref, "~/loras") == jax_resolve_lora(ref, "~/loras")


ADAPTER_JOBS = {
    "bare-lora": {"workflow": "txt2img", "model_name": SDXL, "prompt": "a boat",
                  "lora": "my-style.safetensors", "parameters": {"lora_scale": 0.7}},
    "repo-lora-xattn": {"workflow": "txt2img", "model_name": SD15,
                        "lora": "publisher/repo/sub/dir/w.safetensors",
                        "parameters": {"cross_attention_kwargs": {"scale": 0.5},
                                       "scheduler_type": "LCMScheduler"}},
    "ti-vae": {"workflow": "txt2img", "model_name": SD15, "prompt": "a <cat-toy>",
               "parameters": {"textual_inversion": "sd-concepts-library/cat-toy",
                              "vae": "stabilityai/sd-vae-ft-mse", "test_tiny_model": True}},
    "echo-with-lora": {"workflow": "echo", "model_name": "none", "lora": "publisher/repo"},
}


@pytest.mark.parametrize("name", sorted(ADAPTER_JOBS))
def test_job_arguments_match_jax(name, tmp_path):
    job = ADAPTER_JOBS[name]
    root = str(tmp_path / "loras")
    jax_callback, jax_args = asyncio.run(jax_job_arguments.format_args(
        copy.deepcopy(job), jax_settings.Settings(lora_root_dir=root), "cpu"))
    callback, args = job_arguments.format_args(copy.deepcopy(job),
                                               settings.Settings(lora_root_dir=root))
    assert callback.__name__ == jax_callback.__name__
    assert args == jax_args


def test_settings_read_the_adapter_overrides(monkeypatch, tmp_path):
    monkeypatch.setenv("SDAAS_ROOT", str(tmp_path))
    monkeypatch.setenv("CHIASWARM_LORA_ROOT_DIR", "/srv/loras")
    monkeypatch.setenv("CHIASWARM_LORA_CACHE_MB", "3")
    monkeypatch.setenv("CHIASWARM_LORA_OPERAND_CACHE_MB", "0")
    port, ref = settings.load_settings(), jax_settings.load_settings()
    for field in ("lora_root_dir", "lora_cache_mb", "lora_operand_cache_mb"):
        assert getattr(port, field) == getattr(ref, field)
    assert (port.lora_cache_mb, port.lora_operand_cache_mb) == (3, 0)
    assert settings.Settings().lora_root_dir == jax_settings.Settings().lora_root_dir


def test_placeholder_tokenizer_matches_jax():
    placeholders = {"<cat-toy>": [1000, 1001], "cat-toy": [1000, 1001], "<x>": [1002]}
    port = PlaceholderTokenizer(HashTokenizer(1000), placeholders)
    ref = JaxPlaceholderTokenizer(JaxHashTokenizer(1000), placeholders)
    texts = ["a photo of <cat-toy> on <x>", "cat-toy", "", "no placeholder here"]
    np.testing.assert_array_equal(port(texts), ref(texts))


# --- adapter files ---

def _every_linear(pipe, layout, rank=2, seed=0):
    """An adapter over every Linear of the UNet and of each text encoder."""
    rng = np.random.default_rng(seed)
    state = {}
    parts = [(pipe.unet, "lora_unet_", "unet.")]
    parts += [(enc, f"lora_te{i + 1}_", "text_encoder" + ("_2." if i else "."))
              for i, enc in enumerate(pipe.text_encoders)]
    for module, kohya, peft in parts:
        for name, m in module.named_modules():
            if isinstance(m, torch.nn.Linear):
                out_f, in_f = m.weight.shape
                a = rng.standard_normal((rank, in_f)).astype(np.float32)
                b = rng.standard_normal((out_f, rank)).astype(np.float32)
                if layout == "kohya":
                    base = kohya + name.replace(".", "_")
                    state.update({f"{base}.lora_down.weight": a, f"{base}.lora_up.weight": b,
                                  f"{base}.alpha": np.float32(1.0)})
                else:
                    state.update({f"{peft}{name}.lora_A.weight": a,
                                  f"{peft}{name}.lora_B.weight": b})
    return state


def _with_strays(path):
    """Add to an adapter file: a 3x3-conv factor, a factor of no module, a
    text-encoder name of no known encoder, a tensor that is no factor."""
    state = load_file(str(path))
    rng = np.random.default_rng(5)
    state.update({
        "lora_unet_down_blocks_0_resnets_0_conv1.lora_down.weight":
            rng.standard_normal((2, 32, 3, 3)).astype(np.float16),
        "lora_unet_down_blocks_0_resnets_0_conv1.lora_up.weight":
            rng.standard_normal((32, 2, 1, 1)).astype(np.float16),
        "lora_unet_not_a_module.lora_down.weight": np.ones((2, 8), np.float16),
        "lora_unet_not_a_module.lora_up.weight": np.ones((8, 2), np.float16),
        "text_encoder_3.layers.0.q_proj.lora_A.weight": np.ones((2, 8), np.float16),
        "unrelated.tensor": np.ones((3,), np.float16),
    })
    save_file(state, str(path))


def _save_safetensors(pipe, root):
    """The pipeline's weights as diffusers-layout safetensors under root."""
    parts = {"unet": pipe.unet, "vae": pipe.vae}
    for i, enc in enumerate(pipe.text_encoders):
        parts["text_encoder" + ("_2" if i else "")] = enc
    for sub, module in parts.items():
        (root / sub).mkdir(parents=True)
        save_file({k: v.detach().numpy().copy() for k, v in module.state_dict().items()},
                  str(root / sub / "model.safetensors"))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The port's tiny models written as safetensors under a model root, a
    Registry over it, the JAX pipelines reading the same root, and the
    adapter files: under the LoRA root, a kohya adapter of tiny-xl (UNet,
    te1, te2, alpha), a PEFT adapter of tiny-sd with 1x1-conv proj_in /
    proj_out (and two variants of it), the three textual-inversion formats;
    under the model root, a custom VAE of the tiny VAE config."""
    root = tmp_path_factory.mktemp("adapters")
    models, loras = root / "models", root / "loras"
    mp = pytest.MonkeyPatch()
    mp.setenv("SDAAS_ROOT", str(root / "sdaas"))
    mp.setenv("CHIASWARM_MODEL_ROOT_DIR", str(models))
    mp.setenv("CHIASWARM_LORA_ROOT_DIR", str(loras))
    for model in MODELS:
        _save_safetensors(SDPipeline(model, device="cpu"), models / model)
    registry = Registry(torch.device("cpu"), str(models), str(loras))
    port = {m: registry.get_pipeline(m) for m in MODELS}
    xl, sd = port["test/tiny-xl"], port["test/tiny-sd"]
    files = {
        "kohya": smoke.write_lora(loras / "xl-kohya.safetensors", xl, "kohya", rank=4,
                                  alpha=2.0, te_rank=2, seed=31),
        "peft": smoke.write_lora(loras / "sd-peft.safetensors", sd, "peft", rank=4, seed=32,
                                 conv_proj=True),
    }
    # the same adapter without its conv-shaped factors; and with, instead, a
    # 2-D factor on a resnet conv (the form of the JAX package's own test),
    # which sends JAX to its merged route
    peft = load_file(str(loras / "sd-peft.safetensors"))
    linear = {k: v for k, v in peft.items() if v.ndim == 2}
    save_file(linear, str(loras / "sd-peft-linear.safetensors"))
    rng = np.random.default_rng(37)
    save_file({**linear,
               "unet.down_blocks.0.resnets.0.conv1.lora_A.weight":
                   rng.standard_normal((4, 9)).astype(np.float16),
               "unet.down_blocks.0.resnets.0.conv1.lora_B.weight":
                   rng.standard_normal((9, 4)).astype(np.float16)},
              str(loras / "sd-peft-merged.safetensors"))
    smoke.write_ti(loras / "sd-diffusers.safetensors", sd, "diffusers", seed=33)
    smoke.write_ti(loras / "sd-kohya.safetensors", sd, "kohya", seed=34)
    smoke.write_ti(loras / "xl-dual.safetensors", xl, "dual", seed=35)
    smoke.write_vae(models / "test/tiny-vae", sd, seed=36, subfolder="vae")
    jax_registry.clear_cache()
    jax_lora_cache.reset()
    jax_embed_cache.reset()
    reference = {m: jax_sd.SDPipeline(m) for m in MODELS}
    yield {"root": root, "models": models, "loras": loras, "registry": registry,
           "port": port, "jax": reference, "files": files}
    jax_registry.clear_cache()
    jax_lora_cache.reset()
    jax_embed_cache.reset()
    mp.undo()


@pytest.mark.parametrize("layout", ["kohya", "peft"])
def test_factors_match_jax_bit_for_bit(env, layout):
    path = env["loras"] / f"strays-{layout}.safetensors"
    if layout == "kohya":
        smoke.write_lora(path, env["port"]["test/tiny-xl"], "kohya", rank=4, alpha=2.0,
                         te_rank=2, seed=41)
    else:
        smoke.write_lora(path, env["port"]["test/tiny-sd"], "peft", rank=4, te_rank=2,
                         seed=42, conv_proj=True)
    _with_strays(path)
    got = lora.collect_lora_deltas(lora.load_lora_state(path))
    want = jax_lora.collect_lora_deltas(jax_lora.load_lora_state(path))
    assert sorted(got) == sorted(want)
    assert any(k.startswith("te0:") for k in got)
    assert any(k.startswith("te1:") for k in got) == (layout == "kohya")
    for key, (a, b, alpha) in got.items():
        ra, rb, ralpha = want[key]
        assert a.dtype == ra.dtype and np.array_equal(a, ra)
        assert b.dtype == rb.dtype and np.array_equal(b, rb)
        assert alpha == ralpha
    assert lora.factors_nbytes(got) == jax_lora.factors_nbytes(want)


def _jax_matched(reference, factors):
    unet, unet_miss = jax_lora.match_dense_factors(factors, reference.params["unet"])
    text, text_miss = jax_lora.match_te_dense_factors(factors, reference.params["text"])
    keys = {k.replace("/", "_") for k in (*unet, *text)}
    return keys, unet_miss + text_miss


@pytest.mark.parametrize("model,layout", [("test/tiny-xl", "kohya"), ("test/tiny-sd", "peft"),
                                          ("test/tiny-xl", "strays")])
def test_matched_modules_equal_jax(env, model, layout):
    pipe, reference = env["port"][model], env["jax"][model]
    if layout == "strays":
        path = env["loras"] / "strays-matched.safetensors"
        smoke.write_lora(path, pipe, "kohya", rank=4, alpha=2.0, te_rank=2, seed=41)
        _with_strays(path)
        state = load_file(str(path))
    else:
        state = _every_linear(pipe, layout)
    factors = lora.collect_lora_deltas(state)
    index = dict(pipe.unet_index)
    for te in pipe.text_indexes:
        index.update(te)
    matched, unmatched = lora.match_factors(factors, index)
    want, want_unmatched = _jax_matched(reference, jax_lora.collect_lora_deltas(state))
    assert set(matched) == want
    assert unmatched == want_unmatched
    if layout != "strays":
        # every Linear of the model, under the key JAX gives it
        assert set(matched) == set(index) and unmatched == 0


# --- whole jobs against the JAX pipeline ---

def _jax_noise(seed):
    """The JAX pipeline's draws for a job seeded `seed` -> (initial latents
    NCHW, noise_fn): split(rng, 3), init_rng's NHWC normal, and step_rng
    folded with i."""
    _, init_rng, step_rng = jax.random.split(jax.random.key(seed), 3)

    def nhwc(key, shape):
        n, c, h, w = shape
        return np.asarray(jax.random.normal(key, (n, h, w, c), jnp.float32)).transpose(0, 3, 1, 2)

    def noise_fn(kind, i, shape):
        return nhwc(jax.random.fold_in(step_rng, i if kind == "step" else 7919 + i), shape)

    return nhwc(init_rng, (1, 4, SIZE // 2, SIZE // 2)), noise_fn


def _start_image(w=96, h=80):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 7 + yy / 11)], -1)
    return Image.fromarray((255 * rgb).astype(np.uint8))


def _lora(name, env):
    return resolve_lora(name, str(env["loras"]))


# five jobs, so that each JAX program compiles once: the tiny-xl adapter at
# scale 1.0, then at 0.5 with the dual textual inversion (one delta program
# for both); tiny-sd's PEFT adapter with 1x1-conv factors (delta), the
# adapter JAX merges, with a diffusers textual inversion and a custom VAE,
# then a kohya textual inversion and the custom VAE on img2img
JOBS = {
    "xl-kohya-unet-te1-te2": ("test/tiny-xl", lambda env: dict(
        lora=_lora("xl-kohya.safetensors", env))),
    "xl-kohya-scale-0.5-xattn-ti-dual": ("test/tiny-xl", lambda env: dict(
        lora=_lora("xl-kohya.safetensors", env), cross_attention_kwargs={"scale": 0.5},
        prompt="a <xl-dual> cube", textual_inversion="xl-dual.safetensors")),
    # the port drops the 1x1-conv factors; JAX, without them, runs its delta
    "sd-peft-conv": ("test/tiny-sd", lambda env: dict(
        lora=_lora("sd-peft.safetensors", env))),
    "sd-peft-jax-merged-ti-diffusers-vae": ("test/tiny-sd", lambda env: dict(
        lora=_lora("sd-peft-merged.safetensors", env), prompt="a <smoke-style> cube",
        textual_inversion="sd-diffusers.safetensors", vae="test/tiny-vae")),
    "sd-ti-kohya-vae-img2img": ("test/tiny-sd", lambda env: dict(
        prompt="a <sd-kohya> cube", textual_inversion="sd-kohya.safetensors",
        vae="test/tiny-vae", image=_start_image(), strength=0.75)),
}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_adapter_job_matches_jax(env, name):
    model, make = JOBS[name]
    job = dict(prompt="a red cube", negative_prompt="blurry", num_inference_steps=2,
               guidance_scale=6.0, height=SIZE, width=SIZE,
               scheduler_type="EulerAncestralDiscreteScheduler")
    job.update(make(env))
    seed = 17
    reference = dict(job)
    if name == "sd-peft-conv":
        reference["lora"] = _lora("sd-peft-linear.safetensors", env)
    want, want_cfg = env["jax"][model].run(rng=jax.random.key(seed), **reference)
    latents, noise_fn = _jax_noise(seed)
    got, config = env["port"][model].run(latents=latents, noise_fn=noise_fn, **job)
    assert config["mode"] == want_cfg["mode"]
    if "lora" in job:
        assert config["lora_mode"] == "delta"
        assert want_cfg["lora_mode"] == ("merged" if "merged" in name else "delta")
        written = env["files"]["kohya" if "kohya" in name else "peft"]
        assert config["lora_modules"]["matched"] == written["modules"] - written["conv"]
        assert config["lora_modules"]["unmatched"] == (1 if "merged" in name
                                                       else written["conv"])
        assert config["lora_scale"] == (0.5 if "0.5" in name else 1.0)
    want, got = np.asarray(want[0], np.int16), np.asarray(got[0], np.int16)
    assert np.abs(got - want).max() <= 2
    # the adapter moved the image: the plain job differs
    plain = {k: v for k, v in job.items() if k not in (
        "lora", "cross_attention_kwargs", "textual_inversion", "vae")}
    base, _ = env["port"][model].run(latents=latents, noise_fn=noise_fn, **plain)
    assert np.abs(np.asarray(base[0], np.int16) - got).max() > 2


def test_jax_merged_route_raises_on_conv_shaped_factors(env):
    """A reference fault the port does not copy: JAX's merged route forms
    B @ A for a 1x1-conv factor pair, which numpy cannot broadcast, so a job
    whose adapter has such factors fails there; the port drops them (as
    JAX's delta path and its KNOWN GAP note intend) and serves the rest,
    which the job above holds against JAX without them."""
    with pytest.raises(ValueError, match="broadcast"):
        env["jax"]["test/tiny-sd"].run(prompt="x", num_inference_steps=2, height=SIZE,
                                       width=SIZE, lora=_lora("sd-peft.safetensors", env))


def test_scale_zero_and_later_plain_jobs_are_bit_for_bit(env):
    pipe = env["port"]["test/tiny-xl"]
    latents, noise_fn = _jax_noise(3)
    job = dict(prompt="a red cube", negative_prompt="blurry", num_inference_steps=2,
               height=SIZE, width=SIZE, latents=latents, noise_fn=noise_fn,
               scheduler_type="EulerAncestralDiscreteScheduler")
    before, _ = pipe.run(**job)
    zero, config = pipe.run(lora=_lora("xl-kohya.safetensors", env), lora_scale=0.0, **job)
    after, _ = pipe.run(**job)
    assert config["lora_mode"] == "delta" and config["lora_scale"] == 0.0
    assert np.array_equal(zero[0], before[0]) and np.array_equal(after[0], before[0])
    # no hook outlives its pass
    assert not any(m._forward_hooks for m in pipe.unet.modules())
    assert not any(m._forward_hooks for e in pipe.text_encoders for m in e.modules())


# --- the worker: adapter jobs and the fatal cases ---

def test_worker_serves_adapters_and_refuses_bad_ones(env, tmp_path):
    loras = env["loras"]
    # an adapter whose factors fit no module of tiny-sd
    save_file({"lora_unet_down_blocks_0_attentions_0_proj_in.lora_down.weight":
               np.ones((2, 7), np.float16),
               "lora_unet_down_blocks_0_attentions_0_proj_in.lora_up.weight":
               np.ones((32, 2), np.float16)}, str(loras / "no-match.safetensors"))
    save_file({"<wide>": np.ones((1, 48), np.float32)}, str(loras / "wide-ti.safetensors"))
    hive = FakeHive(token="tok")
    common = {"workflow": "txt2img", "model_name": SD15, "prompt": "a red cube",
              "num_inference_steps": 2, "height": SIZE, "width": SIZE, "seed": 5,
              "content_type": "image/png"}
    tiny = {"test_tiny_model": True}
    jobs = [
        {**common, "id": "served", "model_name": SDXL, "lora": "xl-kohya.safetensors",
         "prompt": "a <xl-dual> cube",
         "parameters": {**tiny, "lora_scale": 0.7, "textual_inversion": "xl-dual.safetensors",
                        "vae": "test/tiny-vae"}},
        {**common, "id": "missing-lora", "lora": "absent.safetensors", "parameters": tiny},
        {**common, "id": "no-match", "lora": "no-match.safetensors", "parameters": tiny},
        {**common, "id": "wide-ti", "parameters": {**tiny, "textual_inversion":
                                                   "wide-ti.safetensors"}},
        {**common, "id": "missing-vae", "parameters": {**tiny, "vae": "absent/vae"}},
    ]
    try:
        registry = env["registry"]
        worker = worker_mod.Worker(
            settings=settings.Settings(sdaas_token="tok", sdaas_uri=hive.uri,
                                       model_root_dir=str(env["models"]),
                                       lora_root_dir=str(loras)),
            device="cpu", registry=registry, poll_seconds=0.01)
        hive.enqueue(*jobs)
        asyncio.run(asyncio.wait_for(worker.run(max_jobs=len(jobs)), timeout=120))
        results = {r["id"]: r for r in hive.wait_for_results(len(jobs), timeout=10)}
    finally:
        hive.close()
    served = results["served"]
    assert not served.get("fatal_error"), served["pipeline_config"]
    config = served["pipeline_config"]
    assert config["lora_mode"] == "delta" and config["lora_scale"] == 0.7
    assert config["model"] == "test/tiny-xl" and "adapters_s" in config["timings"]
    for job_id, message in (("missing-lora", "Could not load lora"),
                            ("no-match", "no modules matched"),
                            ("wide-ti", "match no text encoder"),
                            ("missing-vae", "Could not load custom VAE")):
        result = results[job_id]
        assert result.get("fatal_error"), job_id
        assert message in result["pipeline_config"]["error"], result["pipeline_config"]


# --- caches and eviction ---

def test_byte_lru_cap():
    cache = ByteLRU(100)
    cache.put("a", 1, 40)
    cache.put("b", 2, 40)
    assert cache.get("a") == 1  # a is now the most recent
    cache.put("c", 3, 40)  # over the cap: b, the least recent, goes
    assert (cache.get("b"), cache.get("a"), cache.get("c")) == (None, 1, 3)
    assert cache.resident_bytes == 80 and len(cache) == 2
    cache.put("huge", 4, 101)  # larger than the cap: not kept, nothing evicted
    assert cache.get("huge") is None and len(cache) == 2
    cache.put("a", 5, 10)  # a replacement re-counts its bytes
    assert cache.resident_bytes == 50
    assert cache.drop(lambda k: k in ("a", "c")) == 50 and len(cache) == 0


def test_factor_cache_disabled_still_loads_and_reload_drops_stacks(env):
    ref = _lora("xl-kohya.safetensors", env)
    cache = LoraCache(0, 1 << 30)
    first, hit = cache.resolve(ref, "m", None)
    second, hit_again = cache.resolve(ref, "m", None)
    assert not hit and not hit_again and sorted(first) == sorted(second)
    assert len(cache.factors) == 0
    cache = LoraCache(1 << 30, 1 << 30)
    cache.resolve(ref, "m", None)
    assert cache.resolve(ref, "m", None)[1]
    cache.keep_stacks("m", ref, "stacks", 10)
    assert cache.stacks("m", ref) == "stacks"
    cache.factors.drop(lambda k: True)
    cache.resolve(ref, "m", None)  # read from the file again: its stacks go
    assert cache.stacks("m", ref) is None


def test_eviction_drops_adapter_state(env):
    registry = Registry(torch.device("cpu"), str(env["models"]), str(env["loras"]))
    pipe = registry.get_pipeline("test/tiny-sd")
    _, config = pipe.run(prompt="a <smoke-style> cube", num_inference_steps=2, height=SIZE,
                         width=SIZE, lora=_lora("sd-peft.safetensors", env),
                         textual_inversion="sd-diffusers.safetensors", vae="test/tiny-vae")
    stacks = registry.lora_cache.operands.resident_bytes
    assert config["operand_cache"] == {"hits": 0, "misses": 1, "bytes_saved": 0}
    assert stacks > 0 and pipe._ti_cache and pipe._vae_cache
    for filler in ("test/tiny-xl", "test/tiny-inpaint", "test/tiny-pix2pix",
                   "test/tiny-xl-inpaint"):
        registry.get_pipeline(filler)
    assert "test/tiny-sd" not in registry.resident_models()
    assert registry.lora_cache.operands.resident_bytes == 0
    assert not pipe._ti_cache and not pipe._vae_cache
    # the factors stay: they are the model's no more than any other's
    assert len(registry.lora_cache.factors) == 1


# --- chip_smoke.py ---

def test_chip_smoke_adapter_phases_rehearse_on_cpu():
    """Phase 4's adapter checks pass (the CPU against itself), and the
    served adapter path, with tiny stand-ins of SDXL and SD 1.5, passes its
    envelope and bit-for-bit checks and then fails its launch-count check,
    as it must where no kernel runs."""
    checks = smoke.tiny_adapter_checks(device="cpu", steps=1)
    assert len(checks) == 5 and all(c["max_pixel_diff"] == 0 for c in checks.values())
    assert checks["test/tiny-sd PEFT LoRA with conv-shaped proj_in / proj_out"][
        "lora_modules"]["unmatched"] == 14
    with pytest.raises(smoke.SmokeFailure,
                       match="flash_attention was never launched on the adapter path"):
        smoke.serve_adapter_path("cpu", {"flash_attention": 0, "group_norm": 0}, device="cpu",
                                 sdxl="test/tiny-xl", sd15="test/tiny-sd", size_xl=SIZE,
                                 size15=SIZE, steps=1, lcm_steps=1)
