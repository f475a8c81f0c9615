"""chiaswarm_tpu_torch's Kandinsky 2.2 path against the JAX package's
KandinskyPipeline, whole jobs on the CPU in f32.

JAX's tiny decoder and prior (test/tiny-kandinsky, -prior) are the
reference; their parameters reach the port through
`weights.from_jax_params`. JAX draws every noise inside its programs from
`split(key(seed), 3)`: the prior's start latents `normal(prior_rng, (n,
E))` and step noise `normal(fold_in(prior_rng, i))` (the unguided
zero-prompt negative run the same from `fold_in(prior_rng, 1)`), the
decoder's start `normal(dec_rng, (n, h, w, C))` and step noise
`normal(fold_in(dec_rng, i))`; the tests hand the port exactly those
arrays (`_inject`). The decoded uint8 images agree within 2/255 (f32 on
both sides; rounding to uint8 can flip a level), the bound of the other
whole-job tests of the port.

- txt2img with a prompt and a negative prompt: the prior's guided run and
  its zero-prompt negative run, then the decoder.
- The negative from `zero_image_embed.npy` and the un-whitening through
  `clip_mean` / `clip_std`: the port's prior read from diffusers files
  (written by `chip_smoke.write_kandinsky`), JAX's prior given the same
  stats and embedding.
- Split embeds: `image_embeds` / `negative_image_embeds` of two rows, no
  prior.
- img2img at strength 0.5 (MoVQ.encode of the LANCZOS-resized start image,
  noised to the first kept step).
- The errors JAX raises: a prior-typed job, a hint on a checkpoint without
  hint channels, a ControlNet job without a hint; the port's `run` keeps
  the JAX messages.

JAX's tiny pipelines are built with their modules' random init replaced
by seeded arrays of the same shapes (`_fast_init`: flax's eager init runs
a module op by op, tens of seconds on the CPU); their programs are JAX's
own. Each distinct program compiles once per module (module-scoped
fixtures, one canvas and step count per mode).
"""

import contextlib
import functools
import importlib.util
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu import registry as jax_registry
from chiaswarm_tpu.models import clip as jax_clip
from chiaswarm_tpu.models import movq as jax_movq
from chiaswarm_tpu.models import prior as jax_prior
from chiaswarm_tpu.models import unet_kandinsky as jax_unet
from chiaswarm_tpu.pipelines import kandinsky as jax_kandinsky
from chiaswarm_tpu_torch.pipelines.kandinsky import (
    KandinskyPipeline,
    KandinskyPriorPipeline,
    prior_name_for,
)
from chiaswarm_tpu_torch.registry import Registry
from chiaswarm_tpu_torch.weights import from_jax_params, read_tensors

REPO = Path(__file__).resolve().parents[1]
DECODER, PRIOR, CN = "test/tiny-kandinsky", "test/tiny-kandinsky-prior", (
    "test/tiny-kandinsky-controlnet")
E, SIZE, LAT = 32, 64, 32  # the tiny prior's width, the canvas, its latents
TOL = 2


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _seeded(shapes, seed: int):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        return (1.0 if name == "scale" else 0.0) + 0.1 * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def _fast_init(seed: int = 0):
    """JAX's Kandinsky modules initialised as seeded arrays of the shapes
    their flax init gives (jax.eval_shape), for the pipelines built inside."""
    classes = (jax_unet.K22UNet, jax_movq.MoVQ, jax_prior.DiffusionPrior,
               jax_clip.CLIPTextEncoder)
    counter = iter(range(seed, seed + 1000))

    def init(self, rng, *args, **kw):
        shapes = jax.eval_shape(functools.partial(nn.Module.init, self), rng, *args, **kw)
        return {"params": _seeded(shapes["params"], next(counter))}

    saved = [(cls, cls.__dict__.get("init")) for cls in classes]
    try:
        for cls in classes:
            cls.init = init
        yield
    finally:
        for cls, old in saved:
            if old is None:
                del cls.init
            else:
                cls.init = old


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _register_jax(pipe, name: str, family: str):
    jax_registry._CACHE[(name, family, 0, ())] = pipe
    return (name, family, 0, ())


def _port_decoder(jpipe, name: str) -> KandinskyPipeline:
    params = _np(jpipe.params)
    w = from_jax_params({"k22_unet": params["unet"], "movq": params["vae"]})
    return KandinskyPipeline(name, device="cpu", weights={
        "unet": w["k22_unet"], "movq": w["movq"], "unet_cfg": _port_cfg(jpipe.unet_cfg)})


def _port_cfg(jax_cfg):
    from chiaswarm_tpu_torch.models.configs import K22UNetConfig

    fields = K22UNetConfig.__dataclass_fields__
    return K22UNetConfig(**{k: getattr(jax_cfg, k) for k in fields})


def _port_prior(jprior, **extra) -> KandinskyPriorPipeline:
    params = _np(jprior.params)
    w = from_jax_params({"prior": params["prior"], "text": [params["text"]]})
    return KandinskyPriorPipeline(PRIOR, device="cpu", weights={
        "prior": w["prior"], "text": w["text"][0], **extra})


@pytest.fixture(scope="module")
def env():
    """JAX's tiny prior, decoder and ControlNet decoder (the prior in JAX's
    registry, where the decoder's job finds it) and the port's on their
    parameters, in a registry of the port's own."""
    with _fast_init(11):
        jprior = jax_kandinsky.KandinskyPriorPipeline(PRIOR)
        jdec = jax_kandinsky.KandinskyPipeline(DECODER)
        jcn = jax_kandinsky.KandinskyPipeline(CN)
    key = _register_jax(jprior, PRIOR, "kandinsky_prior")
    prior, dec, cn = _port_prior(jprior), _port_decoder(jdec, DECODER), _port_decoder(jcn, CN)
    registry = Registry(torch.device("cpu"), safety_checker_model="")
    registry._pipelines[(PRIOR, "kandinsky_prior")] = prior
    yield {"jax": {"prior": jprior, "decoder": jdec, "cn": jcn},
           "port": {"prior": prior, "decoder": dec, "cn": cn}, "registry": registry}
    jax_registry._CACHE.pop(key, None)


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _nchw(a):
    return a.transpose(0, 3, 1, 2)


def _inject(seed: int, n: int, prior: bool = True) -> dict:
    """Every draw JAX's KandinskyPipeline.run makes for `seed`, as the
    port's run takes them (NCHW latents)."""
    _, prior_rng, dec_rng = jax.random.split(jax.random.key(seed), 3)
    shape = (n, LAT, LAT, 4)
    out = {"latents": _nchw(_normal(dec_rng, shape)),
           "noise_fn": lambda i, s: _nchw(_normal(jax.random.fold_in(dec_rng, i), shape))}
    if prior:
        neg_rng = jax.random.fold_in(prior_rng, 1)
        out.update(
            prior_latents=_normal(prior_rng, (n, E)),
            prior_noise_fn=lambda i, s: _normal(jax.random.fold_in(prior_rng, i), (n, E)),
            prior_negative_latents=_normal(neg_rng, (n, E)),
            prior_negative_noise_fn=lambda i, s: _normal(jax.random.fold_in(neg_rng, i), (n, E)))
    return out


def _assert_images_close(jax_images, port_images, tol=TOL):
    assert len(jax_images) == len(port_images)
    for want, got in zip(jax_images, port_images):
        want = np.asarray(want).astype(np.int16)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert int(np.abs(got.astype(np.int16) - want).max()) <= tol
        assert want.std() > 1.0  # not a constant image


TXT = dict(prompt="a red fox in fresh snow", negative_prompt="blurry", height=SIZE,
           width=SIZE, num_inference_steps=3, prior_timesteps=2)


def test_txt2img_matches_jax(env):
    want, jcfg = env["jax"]["decoder"].run(rng=jax.random.key(7), **TXT)
    got, cfg = env["port"]["decoder"].run(registry=env["registry"], **TXT, **_inject(7, 1))
    _assert_images_close(want, got)
    for key in ("model", "scheduler", "mode", "steps", "size", "guidance_scale"):
        assert cfg[key] == jcfg[key], key
    assert cfg["pipeline"] == jcfg["pipeline"] == "KandinskyV22Pipeline"
    assert {"prior_s", "text_encode_s", "denoise_s", "decode_s"} <= set(cfg["timings"])


def test_zero_image_embed_and_clip_stats_match_jax(env, tmp_path):
    """The port's prior read from files (prior/ with clip_mean / clip_std,
    text_encoder/, zero_image_embed.npy), JAX's handed the same stats and
    embedding."""
    smoke = chip_smoke()
    smoke.write_kandinsky(env["port"]["prior"], tmp_path / PRIOR, zero_embed=True)
    prior = KandinskyPriorPipeline(PRIOR, device="cpu", model_root_dir=str(tmp_path))
    assert prior.weights_source == "checkpoint" and prior.zero_embed is not None
    files = sorted((tmp_path / PRIOR / "prior").glob("*.safetensors"))
    stats = {k: v.numpy().reshape(-1) for k, v in read_tensors(
        files, ("clip_mean", "clip_std")).items()}
    zero = np.load(tmp_path / PRIOR / "zero_image_embed.npy").reshape(-1)
    jprior = env["jax"]["prior"]
    jprior.clip_stats = {"mean": stats["clip_mean"], "std": stats["clip_std"]}
    jprior._zero_embed = zero
    try:
        want, _ = env["jax"]["decoder"].run(rng=jax.random.key(8), **TXT)
        embeds, neg = jax.device_get(jprior.generate(
            TXT["prompt"], TXT["negative_prompt"], steps=2,
            rng=jax.random.split(jax.random.key(8), 3)[1]))
    finally:
        jprior.clip_stats, jprior._zero_embed = None, None
    registry = Registry(torch.device("cpu"), safety_checker_model="")
    registry._pipelines[(PRIOR, "kandinsky_prior")] = prior
    got, _ = env["port"]["decoder"].run(registry=registry, **TXT, **_inject(8, 1))
    _assert_images_close(want, got)
    inject = _inject(8, 1)
    ours, ours_neg = prior.generate(TXT["prompt"], TXT["negative_prompt"], steps=2,
                                    latents=inject["prior_latents"],
                                    noise_fn=inject["prior_noise_fn"])
    np.testing.assert_allclose(ours.numpy(), np.asarray(embeds), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours_neg.numpy(), np.broadcast_to(zero, (1, E)))


def test_split_embeds_match_jax(env):
    rng = np.random.default_rng(3)
    embeds = rng.standard_normal((2, E)).astype(np.float32)
    neg = rng.standard_normal((2, E)).astype(np.float32)
    kw = dict(image_embeds=embeds, negative_image_embeds=neg, height=SIZE, width=SIZE,
              num_inference_steps=3, prompt="ignored by 2.2")
    want, _ = env["jax"]["decoder"].run(rng=jax.random.key(9), **kw)
    got, cfg = env["port"]["decoder"].run(**kw, **_inject(9, 2, prior=False))
    _assert_images_close(want, got)
    assert cfg["prior"] == "given" and "prior_s" not in cfg["timings"]


def test_img2img_matches_jax(env):
    rng = np.random.default_rng(4)
    start = Image.fromarray((rng.random((80, 72, 3)) * 255).astype(np.uint8)).resize((64, 64))
    kw = dict(TXT, num_inference_steps=4, strength=0.5, image=start)
    want, jcfg = env["jax"]["decoder"].run(rng=jax.random.key(10), **kw)
    got, cfg = env["port"]["decoder"].run(registry=env["registry"], **kw, **_inject(10, 1))
    _assert_images_close(want, got)
    assert cfg["mode"] == jcfg["mode"] == "img2img"


def test_controlnet_with_a_768_hint_matches_jax(env):
    """The depth hint at the ControlNet's locked 768^2 canvas, shrunk to the
    latents by antialiased bilinear on both sides."""
    yy, xx = np.mgrid[0:768, 0:768].astype(np.float32) / 768
    hint = np.stack([0.5 + 0.5 * np.sin(9 * xx + 5 * yy * yy)] * 3, axis=-1).astype(np.float32)
    kw = dict(TXT, pipeline_type="KandinskyV22ControlnetPipeline", hint=hint)
    want, jcfg = env["jax"]["cn"].run(rng=jax.random.key(12), **kw)
    got, cfg = env["port"]["cn"].run(registry=env["registry"], **kw, **_inject(12, 1))
    _assert_images_close(want, got)
    assert cfg["mode"] == jcfg["mode"] == "controlnet"
    lat = env["port"]["cn"].hint_latents(hint, LAT, LAT, 1)
    want_lat = jax.image.resize(jnp.asarray(hint)[None], (1, LAT, LAT, 3), "bilinear")
    np.testing.assert_allclose(lat.permute(0, 2, 3, 1).numpy(), np.asarray(want_lat),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["prior-typed", "hint-on-plain", "controlnet-without-hint"])
def test_errors_match_jax(env, case):
    port, jx = env["port"], env["jax"]
    if case == "prior-typed":
        calls = (lambda: jx["prior"].run(prompt="x"), lambda: port["prior"].run(prompt="x"))
        match = "prepipeline stage"
    elif case == "hint-on-plain":
        hint = np.zeros((1, 8, 8, 3), np.float32)
        calls = tuple(lambda p=p: p.run(prompt="x", hint=hint, num_inference_steps=2,
                                        pipeline_type="KandinskyV22ControlnetPipeline")
                      for p in (jx["decoder"], port["decoder"]))
        match = "not a ControlNet checkpoint"
    else:
        calls = tuple(lambda p=p: p.run(prompt="x", num_inference_steps=2)
                      for p in (jx["cn"], port["cn"]))
        match = "requires a depth hint"
    for call in calls:
        with pytest.raises(Exception, match=match):
            call()


@pytest.mark.parametrize("decoder,prior", [
    (DECODER, PRIOR), ("kandinsky-community/kandinsky-2-2-decoder",
                       "kandinsky-community/kandinsky-2-2-prior"),
    ("kandinsky-community/kandinsky-2-1", "kandinsky-community/kandinsky-2-1-prior"),
    ("kandinsky-community/kandinsky-2-2-controlnet-depth",
     "kandinsky-community/kandinsky-2-2-prior")])
def test_prior_name_matches_jax(decoder, prior):
    assert prior_name_for(decoder) == jax_kandinsky._prior_name_for(decoder) == prior


def test_prior_build_never_evicts_its_decoder(env, monkeypatch):
    """On the card the registry makes room by bytes: a prior built from
    inside its decoder's job evicts the other pipelines, never the decoder
    (the free memory handed in)."""
    from chiaswarm_tpu_torch import registry as registry_mod

    class Resident:
        def release(self):
            return 0

    registry = Registry(torch.device("cpu"), safety_checker_model="")
    decoder = env["port"]["decoder"]
    registry._pipelines[("old-sd", "sd")] = Resident()
    registry._pipelines[(DECODER, "kandinsky")] = decoder
    freed = []
    monkeypatch.setattr(registry_mod, "resident_bytes",
                        lambda device, name: 10 if "prior" in name else 0)
    monkeypatch.setattr(registry_mod, "free_bytes", lambda device: 0)
    monkeypatch.setattr(Resident, "release", lambda self: freed.append(self) or 0)
    prior = registry.get_pipeline(PRIOR, pipeline_type="KandinskyV22PriorPipeline",
                                  keep=(decoder,))
    assert isinstance(prior, KandinskyPriorPipeline)
    assert len(freed) == 1
    assert registry.resident_models() == sorted([DECODER, PRIOR])
