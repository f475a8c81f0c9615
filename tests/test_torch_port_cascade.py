"""chiaswarm_tpu_torch's Stable Cascade against the JAX package's, on the CPU
in f32, with the same seeded inputs and JAX's parameters carried across by
`weights.from_jax_params`.

- The configs (`CascadeUNetConfig`, the tiny stage C and B, `PaellaVQConfig`)
  equal JAX's; the published stage C and B are what JAX's
  `infer_cascade_unet_config` reads off their shapes.
- `DDPMWuerstchenScheduler`: the ratio schedule, every step of a loop and
  `add_noise` against JAX's, within 1e-5 (f32 arithmetic in another order; the
  bound of the SD solvers' tests, test_torch_port_solvers.py).
- Stage C and stage B at the tiny configs, and the Paella VQ decoder,
  within 3e-4 absolute and 1e-3 relative for the UNets (the bound of JAX's
  own torch-parity test of these modules, tests/test_cascade_conversion.py)
  and 1e-5 for the decoder.
- `from_jax_params` inverts `convert_cascade_unet` (stage C's switch-level
  scalers, stage B's transposed upscalers) and `convert_paella_vq` exactly;
  both packages infer the same configs off the same shapes.
- A prior-as-main job with a `decoder` dict and a combined job against
  JAX's pipelines, JAX's draws injected (each stage's start
  `normal(key)` and step noise `normal(fold_in(key, i))` from JAX's splits
  of the job's key): the uint8 images within 2/255.
- The wire names, the name mapping between prior and decoder, the
  `unconverted_families` advertisement, `format_args` passing
  `prior_timesteps` and the `decoder` dict through as JAX's does, the
  capacity rows against the published parameters, `chip_smoke.py`'s launch
  arithmetic against the modules' wrapper calls on the meta device, and the
  smoke's Cascade path rehearsed on the CPU.

JAX's modules are initialised as seeded arrays of the shapes its init
gives; its two whole-job programs per stage compile once (module-scoped
fixtures).
"""

import asyncio
import copy
import dataclasses
import importlib.util
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu import job_arguments as jax_job_arguments
from chiaswarm_tpu import registry as jax_registry
from chiaswarm_tpu.models import cascade_unet as jax_cascade
from chiaswarm_tpu.models import clip as jax_clip
from chiaswarm_tpu.models import conversion as jax_conv
from chiaswarm_tpu.models import paella_vq as jax_paella
from chiaswarm_tpu.pipelines import cascade as jax_pipe
from chiaswarm_tpu.schedulers import get_scheduler as jax_get_scheduler
from chiaswarm_tpu.settings import Settings as JaxSettings
from chiaswarm_tpu_torch import job_arguments, registry, weights
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.models.cascade_unet import StableCascadeUNet
from chiaswarm_tpu_torch.models.paella_vq import PaellaVQDecoder
from chiaswarm_tpu_torch.pipelines import cascade
from chiaswarm_tpu_torch.schedulers import get_scheduler
from chiaswarm_tpu_torch.settings import Settings
from chiaswarm_tpu_torch.weights import from_jax_params
from tests.test_torch_port_kandinsky3 import _fast_init, _nchw, _np, _seeded, recorded_calls

REPO = Path(__file__).resolve().parents[1]
PRIOR, DECODER = "test/tiny-cascade-prior", "test/tiny-cascade"
RNG = np.random.default_rng(1717)


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _state(port_state) -> dict:
    return {k: v.numpy() for k, v in port_state.items()}


# --- configs and the scheduler ---

def test_configs_equal_jax():
    pairs = ((cfgs.CascadeUNetConfig(), jax_cascade.CascadeUNetConfig()),
             (cfgs.TINY_CASCADE_C, jax_cascade.TINY_CASCADE_C),
             (cfgs.TINY_CASCADE_B, jax_cascade.TINY_CASCADE_B),
             (cfgs.PaellaVQConfig(), jax_paella.PaellaVQConfig()),
             (cfgs.TINY_PAELLA_VQ, jax_paella.TINY_PAELLA_VQ))
    for port, ref in pairs:
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert cfgs.PaellaVQConfig().c_levels() == jax_paella.PaellaVQConfig().c_levels()
    jclip = jax_pipe._TINY_CASCADE_CLIP
    assert dataclasses.asdict(cfgs.TINY_CASCADE_CLIP) == dataclasses.asdict(jclip)
    for tj in ({}, {"hidden_size": 64, "num_hidden_layers": 3, "projection_dim": 32}):
        assert dataclasses.asdict(cascade.clip_config_from_json(tj)) == dataclasses.asdict(
            jax_pipe._clip_cfg_from_json(tj))


@pytest.mark.parametrize("stage", ["C", "B"])
def test_published_stages_read_as_jax_reads_them(stage):
    """The published geometry's shapes (the port's modules on the meta
    device) through both packages' inference give the published config."""
    cfg = cfgs.CASCADE_STAGE_C if stage == "C" else cfgs.CASCADE_STAGE_B
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in StableCascadeUNet(cfg).state_dict().items()}
    cj = {"patch_size": cfg.patch_size, "num_attention_heads": list(cfg.num_attention_heads),
          "switch_level": None if cfg.switch_level is None else list(cfg.switch_level)}
    port = weights.infer_cascade_unet_config(shapes, cj)
    jax_cfg = jax_conv.infer_cascade_unet_config(
        {k: np.broadcast_to(np.uint8(0), s) for k, s in shapes.items()}, cj)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg) == dataclasses.asdict(cfg)


def test_wuerstchen_scheduler_matches_jax():
    steps = 12
    port, ref = get_scheduler("DDPMWuerstchenScheduler"), jax_get_scheduler(
        "DDPMWuerstchenScheduler")
    ps, js = port.schedule(steps), ref.schedule(steps)
    np.testing.assert_array_equal(ps.timesteps, js.timesteps)
    np.testing.assert_array_equal(ps.sigmas, js.sigmas)
    assert port.uses_ancestral_noise and ps.init_noise_sigma == js.init_noise_sigma
    x = _randn(2, 4, 6, 6)
    jx = jnp.asarray(x)
    for i in range(steps):
        out, noise = _randn(2, 4, 6, 6), _randn(2, 4, 6, 6)
        _, jx = ref.step(js, (), i, jx, jnp.asarray(out), jnp.asarray(noise))
        _, x = port.step(ps, (), i, torch.from_numpy(x), torch.from_numpy(out),
                         torch.from_numpy(noise))
        x = x.numpy()
        np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-5, atol=1e-5, err_msg=f"step {i}")
    x0, noise = _randn(2, 4, 6, 6), _randn(2, 4, 6, 6)
    for i in (0, 5, steps - 1):
        np.testing.assert_allclose(
            port.add_noise(ps, torch.from_numpy(x0), torch.from_numpy(noise), i).numpy(),
            np.asarray(ref.add_noise(js, jnp.asarray(x0), jnp.asarray(noise), i)),
            rtol=1e-5, atol=1e-5)


# --- modules ---

def _stage_inputs(stage: str, b: int = 2):
    if stage == "C":
        return (_randn(b, 8, 8, 16), np.asarray([0.3, 0.9], np.float32)[:b], _randn(b, 1, 16),
                {"clip_text": _randn(b, 5, 16), "clip_img": _randn(b, 1, 12)})
    return (_randn(b, 14, 14, 4), np.asarray([0.2, 0.7], np.float32)[:b], _randn(b, 1, 16),
            {"effnet": jnp.asarray(_randn(b, 3, 3, 16))})


@pytest.mark.parametrize("stage", ["C", "B"])
def test_stage_matches_jax_and_round_trips(stage):
    jcfg = jax_cascade.TINY_CASCADE_C if stage == "C" else jax_cascade.TINY_CASCADE_B
    pcfg = cfgs.TINY_CASCADE_C if stage == "C" else cfgs.TINY_CASCADE_B
    module = jax_cascade.StableCascadeUNet(jcfg)
    x, r, pooled, kw = _stage_inputs(stage)
    import functools

    params = _np(_seeded(jax.eval_shape(functools.partial(module.init, **kw),
                                        jax.random.key(0), x, r, pooled)["params"], 7))
    want = np.asarray(module.apply({"params": params}, x, r, pooled, **kw))
    state = from_jax_params({"cascade_unet": params})["cascade_unet"]
    port = StableCascadeUNet(pcfg).eval()
    port.load_state_dict(state, strict=True)
    tkw = {k: _nchw(v) if k == "effnet" else torch.from_numpy(v) for k, v in kw.items()}
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(r), torch.from_numpy(pooled), **tkw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-3, atol=3e-4)
    # JAX's own converter on the port's diffusers-named state gives the tree back
    numpy_state = _state(state)
    cj = {"patch_size": jcfg.patch_size, "num_attention_heads": list(jcfg.num_attention_heads),
          "clip_seq": jcfg.clip_seq,
          "switch_level": None if jcfg.switch_level is None else list(jcfg.switch_level)}
    back_cfg, back = jax_conv.convert_cascade_unet(numpy_state, cj)
    np.testing.assert_equal(jax.tree_util.tree_map(np.asarray, back), params)
    assert back_cfg == jcfg
    port_cfg = weights.infer_cascade_unet_config({k: v.shape for k, v in numpy_state.items()}, cj)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(pcfg)


def test_paella_decoder_matches_jax_and_round_trips():
    module = jax_paella.PaellaVQDecoder(jax_paella.TINY_PAELLA_VQ)
    x = _randn(2, 6, 6, 4)
    params = _np(_seeded(jax.eval_shape(module.init, jax.random.key(0), x)["params"], 8))
    want = np.asarray(module.apply({"params": params}, x))
    state = from_jax_params({"paella_vq": params})["paella_vq"]
    port = PaellaVQDecoder(cfgs.TINY_PAELLA_VQ).eval()
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    numpy_state = _state(state)
    # a published file's encoder and quantizer keys: JAX drops them, so does the loader
    numpy_state["in_block.1.weight"] = np.zeros((32, 12, 1, 1), np.float32)
    numpy_state["vquantizer.codebook.weight"] = np.zeros((16, 4), np.float32)
    back_cfg, back = jax_conv.convert_paella_vq(numpy_state, {"scale_factor": 0.3764})
    np.testing.assert_equal(jax.tree_util.tree_map(np.asarray, back), params)
    port_cfg = weights.infer_paella_vq_config({k: v.shape for k, v in numpy_state.items()},
                                              {"scale_factor": 0.3764})
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(back_cfg)
    assert weights.checkpoint_key("in_block.1.weight", "vqgan") is None
    assert weights.checkpoint_key("vquantizer.codebook.weight", "vqgan") is None
    assert weights.checkpoint_key("up_blocks.0.0.weight", "vqgan") == "up_blocks.0.0.weight"


# --- whole jobs ---

@pytest.fixture(scope="module")
def stages():
    """JAX's tiny prior and decoder (seeded parameters, registered in JAX's
    registry so each finds the other) and the port's on the same weights in
    a CPU registry."""
    with _fast_init((jax_cascade.StableCascadeUNet, jax_clip.CLIPTextEncoder,
                     jax_paella.PaellaVQDecoder), seed=60):
        jprior = jax_pipe.CascadePriorPipeline(PRIOR, allow_random_init=True)
        jdec = jax_pipe.CascadePipeline(DECODER, allow_random_init=True)
    keys = [(PRIOR, "cascade_prior", 0, ()), (DECODER, "cascade", 0, ())]
    jax_registry._CACHE[keys[0]] = jprior
    jax_registry._CACHE[keys[1]] = jdec
    reg = registry.Registry(torch.device("cpu"), None, safety_checker_model="")
    for name, jpipe, cls, kind in ((PRIOR, jprior, cascade.CascadePriorPipeline, "cascade_prior"),
                                   (DECODER, jdec, cascade.CascadePipeline, "cascade")):
        params = _np(jpipe.params)
        tree = {"cascade_unet": params["unet"], "text": [params["text"]]}
        if "vqgan" in params:
            tree["paella_vq"] = params["vqgan"]
        w = from_jax_params(tree)
        given = {"unet": w["cascade_unet"], "text": w["text"][0]}
        if "paella_vq" in w:
            given["vqgan"] = w["paella_vq"]
        reg._pipelines[(name, kind)] = cls(name, device="cpu", weights=given)
    yield jprior, jdec, reg
    for key in keys:
        jax_registry._CACHE.pop(key, None)


def _draws(key, shape):
    """JAX's draws under `key` for NHWC `shape` -> (start NCHW, noise_fn)."""
    start = np.asarray(jax.random.normal(key, shape, jnp.float32)).transpose(0, 3, 1, 2)

    def noise_fn(i, _shape):
        return np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape,
                                            jnp.float32)).transpose(0, 3, 1, 2)

    return start, noise_fn


def _diff(want, got) -> int:
    return max(int(np.abs(np.asarray(w, np.int16) - g.astype(np.int16)).max())
               for w, g in zip(want, got))


def test_prior_as_main_job_matches_jax(stages):
    """The prior schedules its decoder through the job's `decoder` dict:
    JAX's prior draws from split(key)[0], the decoder from split(split(key)
    [1], 3)[2]."""
    jprior, _, reg = stages
    seed, steps = 11, 4
    key = jax.random.key(seed)
    prior_key, dec_key = jax.random.split(key)
    dec_key = jax.random.split(dec_key, 3)[2]
    p_start, p_noise = _draws(prior_key, (1, 8, 8, 16))
    d_start, d_noise = _draws(dec_key, (1, 16, 16, 4))
    decoder = {"model_name": DECODER, "num_inference_steps": 3}
    want, jcfg = jprior.run(prompt="a red fox", negative_prompt="blurry",
                            num_inference_steps=steps, guidance_scale=4.0, rng=key,
                            decoder=dict(decoder))
    prior = reg.get_pipeline(PRIOR, pipeline_type="StableCascadePriorPipeline")
    got, cfg = prior.run("a red fox", "blurry", num_inference_steps=steps, guidance_scale=4.0,
                         registry=reg, decoder=dict(decoder), latents=p_start, noise_fn=p_noise,
                         decoder_latents=d_start, decoder_noise_fn=d_noise)
    assert cfg["prior"] == jcfg["prior"]
    assert cfg["steps"] == jcfg["steps"] == 3 and cfg["size"] == jcfg["size"]
    assert {"prior_s", "text_encode_s", "denoise_s", "decode_s"} <= set(cfg["timings"])
    assert _diff(want, got) <= 2


def test_combined_job_matches_jax(stages):
    """A StableCascadeCombinedPipeline job: the job's steps and guidance
    steer the prior, the decoder runs its 10 unguided steps; JAX splits the
    key in three, the prior's draws from [1], the decoder's from [2]."""
    _, jdec, reg = stages
    seed, steps = 12, 3
    _, prior_key, dec_key = jax.random.split(jax.random.key(seed), 3)
    p_start, p_noise = _draws(prior_key, (1, 8, 8, 16))
    d_start, d_noise = _draws(dec_key, (1, 16, 16, 4))
    want, jcfg = jdec.run(prompt="a lighthouse", negative_prompt="", num_inference_steps=steps,
                          guidance_scale=5.0, rng=jax.random.key(seed))
    dec = reg.get_pipeline(DECODER, pipeline_type="StableCascadeCombinedPipeline")
    got, cfg = dec.run("a lighthouse", "", "StableCascadeCombinedPipeline",
                       num_inference_steps=steps, guidance_scale=5.0, registry=reg,
                       prior_latents=p_start, prior_noise_fn=p_noise, latents=d_start,
                       noise_fn=d_noise)
    assert cfg["steps"] == jcfg["steps"] == 10
    assert cfg["scheduler"] == jcfg["scheduler"] == "DDPMWuerstchenScheduler"
    assert "prior_s" in cfg["timings"]
    assert _diff(want, got) <= 2


def test_prior_refuses_a_decoder_repo(tmp_path):
    """A pipeline pointed at the other stage's repo fails with JAX's error,
    before any weights load."""
    (tmp_path / "stabilityai/stable-cascade/decoder").mkdir(parents=True)
    with pytest.raises(weights.MissingWeightsError, match="decoder repo"):
        cascade.CascadePriorPipeline("stabilityai/stable-cascade", device="cpu",
                                     model_root_dir=str(tmp_path))


# --- wiring ---

def test_wire_names_and_advertisement():
    for wire in ("StableCascadeDecoderPipeline", "StableCascadePriorPipeline",
                 "StableCascadeCombinedPipeline", "Kandinsky3Pipeline",
                 "Kandinsky3Img2ImgPipeline"):
        assert registry.PIPELINE_FAMILIES[wire] == jax_registry.PIPELINE_FAMILIES[wire]
    words = registry.unconverted_family_keywords()
    assert not {"kandinsky-3", "kandinsky3", "cascade"} & set(words)
    assert registry.job_family("stabilityai/stable-cascade-prior", "DiffusionPipeline") \
        == jax_registry._auto_family("stabilityai/stable-cascade-prior") == "cascade_prior"
    for name in ("stabilityai/stable-cascade-prior", "my/cascade-prior-x", PRIOR,
                 "stabilityai/stable-cascade"):
        assert cascade.decoder_name_for(name) == jax_pipe._decoder_name_for(name)
        assert cascade.prior_name_for(name) == jax_pipe._prior_name_for(name)


def test_format_args_pass_the_decoder_dict_and_prior_steps():
    job = {"id": "c1", "workflow": "txt2img", "model_name": "stabilityai/stable-cascade-prior",
           "prompt": "a fox", "height": 1024, "width": 1024,
           "parameters": {"pipeline_type": "StableCascadePriorPipeline", "prior_timesteps": 20,
                          "decoder": {"model_name": "stabilityai/stable-cascade",
                                      "num_inference_steps": 10}}}
    _, jax_args = asyncio.run(jax_job_arguments.format_args(copy.deepcopy(job), JaxSettings(),
                                                            "cpu"))
    _, args = job_arguments.format_args(copy.deepcopy(job), Settings(), "cpu")
    for key in ("decoder", "prior_timesteps", "pipeline_type", "num_inference_steps"):
        assert args[key] == jax_args[key], key


def test_capacity_rows_hold_the_published_stages():
    """The cascade and cascade_prior rows at or above the bf16 parameter
    bytes of their modules at the published geometry (meta device)."""
    from chiaswarm_tpu_torch.capacity import FAMILY_PARAMS_GB, _family_key

    for name, stage in (("stabilityai/stable-cascade-prior", "prior"),
                        ("stabilityai/stable-cascade", "decoder")):
        unet_cfg, clip_cfg, vq_cfg, _ = cascade.stage_configs(name, stage)
        with torch.device("meta"):
            modules = cascade.cascade_modules(unet_cfg, clip_cfg, vq_cfg)
        params = sum(p.numel() for m in modules.values() for p in m.parameters())
        row = _family_key(name)
        assert row == ("cascade_prior" if stage == "prior" else "cascade")
        assert FAMILY_PARAMS_GB[row] * 2**30 >= 2 * params, (name, params)


@pytest.mark.parametrize("published", [True, False])
def test_chip_smoke_prediction_matches_the_modules(published):
    """`chip_smoke.cascade_calls` equals the wrapper calls of a stage C call
    (two CFG rows, 77 text states, the image embedding and the pooled text)
    and a stage B call (one row, the pooled text) at 1024^2 (64^2 tiny),
    run on the meta device."""
    import math

    smoke = chip_smoke()
    c, b = ((cfgs.CASCADE_STAGE_C, cfgs.CASCADE_STAGE_B) if published
            else (cfgs.TINY_CASCADE_C, cfgs.TINY_CASCADE_B))
    size = 1024 if published else 64
    dtype = torch.bfloat16
    with torch.device("meta"):
        stage_c, stage_b = StableCascadeUNet(c).to(dtype), StableCascadeUNet(b).to(dtype)
    grid = max(4, math.ceil(size / (cascade.PRIOR_COMPRESSION if published else 8.0)))
    lat = 2 * (int(grid * (cascade.LATENT_DIM_SCALE if published else 2.0)) // 2)

    def meta(*shape):
        return torch.empty(shape, device="meta", dtype=dtype)

    recorded = {}
    with torch.no_grad():
        for part, fn in (
                ("prior", lambda: stage_c(meta(2, c.in_channels, grid, grid),
                                          torch.empty((2,), device="meta"),
                                          meta(2, 1, c.clip_text_pooled_in_channels),
                                          clip_text=meta(2, 77, c.clip_text_in_channels),
                                          clip_img=meta(2, 1, c.clip_image_in_channels))),
                ("decoder", lambda: stage_b(meta(1, b.in_channels, lat, lat),
                                            torch.empty((1,), device="meta"),
                                            meta(1, 1, b.clip_text_pooled_in_channels),
                                            effnet=meta(1, b.effnet_in_channels, grid, grid)))):
            with recorded_calls({"flash_attention": Counter(), "group_norm": Counter()}) as got:
                fn()
            recorded[part] = got
    assert smoke.cascade_calls(c, b, size, dtype, tiny=not published) == recorded
    if published:
        attn = recorded["prior"]["flash_attention"]
        assert attn == Counter({((2, 576, 32, 64), (2, 661, 32, 64), dtype): 64})
        assert sum(recorded["decoder"]["flash_attention"].values()) == 136


def test_chip_smoke_path_rehearses_on_cpu():
    """The smoke's Cascade path on the tiny stand-ins: seeded repos, the
    setup CLI's verdicts, the registry builds, a prior-as-main job and a
    combined job through the worker; launches printed, not held."""
    smoke = chip_smoke()
    paths, served = smoke.serve_cascade_path("cpu", device="cpu", tiny=True, hold=False,
                                             prior_steps=3)
    assert set(paths) == {"cascade_prior_main", "cascade_combined"}
    assert set(served["cli"]["counts"]) == {PRIOR, DECODER}
    for job in served["jobs"].values():
        assert job["predicted"]["flash_attention"] > 0
