"""chiaswarm_tpu_torch's Kandinsky 3 against the JAX package's, on the CPU in
f32, with the same seeded inputs and JAX's parameters carried across by
`weights.from_jax_params`.

- `K3UNetConfig`, `TINY_K3_UNET` and `FLAN_UL2_T5` equal JAX's; the
  port's `t5_config_from_json` gives JAX's `T5Config` for a FLAN-UL2-shaped
  config.json and for an empty one.
- The UNet at TINY_K3_UNET (conditional group norms, the bottleneck
  resnets with their up and down positions, masked cross-attention, the
  attention pooling, the skip wiring; JAX's FusedGroupNorm as the JAX
  package runs it on the CPU), within 1e-4 absolute and relative (JAX's
  own torch-parity test of this UNet holds 2e-4 / 1e-3).
- A tiny T5 whose heads x d_kv (64) is not d_model (32), with a padded
  row, within 1e-5.
- `from_jax_params` inverts `convert_kandinsky3_unet` exactly (the 2x2
  transposed convs too), and `infer_k3_unet_config` reads JAX's geometry
  off the same checkpoint shapes.
- Tiny txt2img and img2img jobs (4 DDPM steps, guidance 3.0, 64^2) against
  JAX's `Kandinsky3Pipeline`, JAX's draws injected (`normal(key(seed))` for
  the start, `normal(fold_in(key(seed), i))` a step): the uint8 images
  within 2/255, the bound of the port's other whole-job tests.
- The wire names, the `test_tiny_model` stand-in, the published geometry's
  parameters against the capacity row, `chip_smoke.py`'s launch arithmetic
  against the modules' own wrapper calls on the meta device, and the
  smoke's Kandinsky 3 path rehearsed on the CPU.

JAX's modules are initialised as seeded arrays of the shapes its init
gives (`_fast_init`); each of JAX's two programs compiles once (a
module-scoped fixture).
"""

import contextlib
import dataclasses
import functools
import importlib.util
from collections import Counter
from pathlib import Path
from unittest import mock

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chiaswarm_tpu.models import conversion as jax_conv
from chiaswarm_tpu.models import movq as jax_movq
from chiaswarm_tpu.models import t5 as jax_t5
from chiaswarm_tpu.models import unet_kandinsky3 as jax_k3
from chiaswarm_tpu.pipelines import kandinsky3 as jax_pipe
from chiaswarm_tpu_torch import weights
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.models.t5 import T5Encoder
from chiaswarm_tpu_torch.models.unet_kandinsky3 import Kandinsky3UNet
from chiaswarm_tpu_torch.pipelines.kandinsky3 import Kandinsky3Pipeline
from chiaswarm_tpu_torch.weights import from_jax_params

REPO = Path(__file__).resolve().parents[1]
TINY = "test/tiny-kandinsky3"
RNG = np.random.default_rng(317)
STEPS, SIZE = 4, 64


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
def _fast_init(classes, seed: int = 0):
    """JAX's modules initialised as seeded arrays of the shapes their flax
    init gives (jax.eval_shape), for the pipelines built inside."""
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


def _randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# --- configs ---

def test_configs_equal_jax():
    for port, ref in ((cfgs.K3UNetConfig(), jax_k3.K3UNetConfig()),
                      (cfgs.TINY_K3_UNET, jax_k3.TINY_K3_UNET)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.init_channels == ref.init_channels
    flan = {"vocab_size": 32128, "d_model": 4096, "d_kv": 256, "num_heads": 16, "d_ff": 16384,
            "num_layers": 32, "relative_attention_num_buckets": 32,
            "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
            "feed_forward_proj": "gated-gelu", "is_encoder_decoder": True}
    for cj in (flan, {}, None, {"d_model": 512, "num_heads": 8}):
        assert dataclasses.asdict(cfgs.t5_config_from_json(cj)) == dataclasses.asdict(
            jax_t5.t5_config_from_json(cj))
    assert cfgs.t5_config_from_json(flan) == cfgs.FLAN_UL2_T5


# --- modules ---

def test_unet_matches_jax():
    cfg = jax_k3.TINY_K3_UNET
    module = jax_k3.Kandinsky3UNet(cfg)
    b, hw, s = 2, 16, 8
    x, t = _randn(b, hw, hw, 4), np.asarray([3.0, 250.0], np.float32)
    ctx = _randn(b, s, cfg.encoder_hid_dim)
    mask = np.ones((b, s), np.float32)
    mask[0, 5:] = 0.0  # a ragged row: the mask reaches the pooling and the cross-attention
    params = _np(_seeded(jax.eval_shape(module.init, jax.random.key(0), x, t, ctx, mask)[
        "params"], 1))
    want = np.asarray(module.apply({"params": params}, x, t, ctx, mask))
    port = Kandinsky3UNet(cfgs.TINY_K3_UNET).eval()
    port.load_state_dict(from_jax_params({"k3_unet": params})["k3_unet"], strict=True)
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                   torch.from_numpy(mask)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_t5_with_wide_heads_matches_jax():
    """heads x d_kv = 64 against d_model = 32 (FLAN-UL2's 16 x 256 against
    4096), a padded row masked."""
    jcfg = jax_t5.T5Config(vocab_size=1000, d_model=32, d_kv=16, num_heads=4, d_ff=48,
                           num_layers=2)
    module = jax_t5.T5Encoder(jcfg)
    ids = RNG.integers(2, 1000, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.float32)
    mask[1, 7:] = 0.0
    ids[1, 7:] = 0
    params = _np(_seeded(jax.eval_shape(module.init, jax.random.key(0), ids)["params"], 2))
    want = np.asarray(module.apply({"params": params}, ids, mask))
    port = T5Encoder(cfgs.T5Config(**dataclasses.asdict(jcfg))).eval()
    port.load_state_dict(from_jax_params({"t5": params})["t5"], strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conversion_round_trips_and_infers_jax_geometry():
    """The port's state dict (diffusers' names) through JAX's own converter
    gives back the JAX tree exactly; both packages infer the same config
    off it."""
    cfg = jax_k3.TINY_K3_UNET
    module = jax_k3.Kandinsky3UNet(cfg)
    params = _np(_seeded(jax.eval_shape(module.init, jax.random.key(0), _randn(1, 16, 16, 4),
                                        np.zeros((1,), np.float32), _randn(1, 4, 32),
                                        np.ones((1, 4), np.float32))["params"], 3))
    state = {k: v.numpy() for k, v in from_jax_params({"k3_unet": params})["k3_unet"].items()}
    cj = {"attention_head_dim": cfg.attention_head_dim, "groups": cfg.groups}
    jcfg, back = jax_conv.convert_kandinsky3_unet(state, cj)
    np.testing.assert_equal(jax.tree_util.tree_map(np.asarray, back), params)
    shapes = {k: tuple(v.shape) for k, v in state.items()}
    port_cfg = weights.infer_k3_unet_config(shapes, cj)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


# --- whole jobs ---

@pytest.fixture(scope="module")
def pipes():
    """JAX's tiny Kandinsky 3 pipeline (seeded parameters) and the port's on
    the same weights."""
    with _fast_init((jax_k3.Kandinsky3UNet, jax_t5.T5Encoder, jax_movq.MoVQ), seed=40):
        jpipe = jax_pipe.Kandinsky3Pipeline(TINY, allow_random_init=True)
    params = _np(jpipe.params)
    w = from_jax_params({"k3_unet": params["unet"], "movq": params["movq"], "t5": params["t5"]})
    port = Kandinsky3Pipeline(TINY, device="cpu", weights={
        "unet": w["k3_unet"], "movq": w["movq"], "t5": w["t5"]})
    return jpipe, port


def _inject(seed: int, n: int, lat: int, channels: int = 4):
    rng = jax.random.key(seed)
    shape = (n, lat, lat, channels)
    start = np.asarray(jax.random.normal(rng, shape, jnp.float32)).transpose(0, 3, 1, 2)

    def noise_fn(i, _shape):
        return np.asarray(jax.random.normal(jax.random.fold_in(rng, i), shape,
                                            jnp.float32)).transpose(0, 3, 1, 2)

    return rng, start, noise_fn


@pytest.mark.parametrize("mode", ["txt2img", "img2img"])
def test_job_matches_jax(pipes, mode):
    jpipe, port = pipes
    seed = 5 if mode == "txt2img" else 6
    rng, start, noise_fn = _inject(seed, 1, SIZE // port.latent_factor)
    kw = {"num_inference_steps": STEPS, "guidance_scale": 3.0, "height": SIZE, "width": SIZE}
    if mode == "img2img":
        arr = (np.add.outer(np.arange(SIZE), np.arange(SIZE)) % 256).astype(np.uint8)
        kw = {**kw, "image": Image.fromarray(np.stack([arr, arr[::-1], 255 - arr], -1)),
              "strength": 0.75}
    want, jcfg = jpipe.run(prompt="a red fox in snow", negative_prompt="blurry", rng=rng,
                           scheduler_type="DDPMScheduler", **kw)
    got, cfg = port.run("a red fox in snow", "blurry", latents=start, noise_fn=noise_fn,
                        scheduler_type="DDPMScheduler", **kw)
    assert cfg["mode"] == jcfg["mode"] == mode
    assert cfg["size"] == jcfg["size"] and cfg["steps"] == jcfg["steps"] == STEPS
    assert {"text_encode_s", "denoise_s", "decode_s"} <= set(cfg["timings"])
    diff = np.abs(np.asarray(want[0], np.int16) - got[0].astype(np.int16)).max()
    assert diff <= 2, diff


def test_defaults_and_mask_follow_jax(pipes):
    """25 steps at guidance 3.0 unset; the T5 keep-mask keeps position 0 of
    an empty prompt; padded positions of the states are zero."""
    _, port = pipes
    import inspect

    sig = inspect.signature(port.run)
    assert sig.parameters["num_inference_steps"].default == 25
    assert sig.parameters["guidance_scale"].default == 3.0
    assert sig.parameters["scheduler_type"].default == "DDPMScheduler"
    with torch.no_grad():
        states, mask = port.encode_text("a fox", "", 1)
    assert mask.shape == (2, port.max_tokens) and mask[0, 0] == 1 and mask[0, 1:].sum() == 0
    # "a fox" is two words and the EOS: three kept positions
    assert mask[1, :3].sum() == 3 and mask[1, 3:].sum() == 0
    assert float(states[0, 1:].abs().max()) == 0.0 and float(states[1, 3:].abs().max()) == 0.0
    assert port.canvas(None, 100) == (64, 64) and port.canvas(130, 200) == (128, 192)


# --- wiring ---

def test_wire_names_and_stand_in():
    from chiaswarm_tpu import registry as jax_registry
    from chiaswarm_tpu_torch import registry
    from chiaswarm_tpu_torch.workflows.diffusion import tiny_stand_in

    for wire in ("Kandinsky3Pipeline", "Kandinsky3Img2ImgPipeline"):
        assert registry.PIPELINE_FAMILIES[wire] == jax_registry.PIPELINE_FAMILIES[wire]
    assert registry.job_family("kandinsky-community/kandinsky-3", "AutoPipelineForText2Image") \
        == "kandinsky3"
    assert tiny_stand_in("kandinsky-community/kandinsky-3") == TINY
    reg = registry.Registry(torch.device("cpu"), None, safety_checker_model="")
    assert isinstance(reg.get_pipeline(TINY, pipeline_type="Kandinsky3Img2ImgPipeline"),
                      Kandinsky3Pipeline)


def test_capacity_row_holds_the_published_bundle():
    """The kandinsky3 row at or above the bf16 parameter bytes of the
    published UNet, MoVQ and FLAN-UL2 encoder, built on the meta device."""
    from chiaswarm_tpu_torch.capacity import FAMILY_PARAMS_GB, _family_key
    from chiaswarm_tpu_torch.pipelines.kandinsky3 import k3_modules

    with torch.device("meta"):
        modules = k3_modules(cfgs.K3UNetConfig(), cfgs.MoVQConfig(), cfgs.FLAN_UL2_T5)
    params = sum(p.numel() for m in modules.values() for p in m.parameters())
    assert _family_key("kandinsky-community/kandinsky-3") == "kandinsky3"
    assert FAMILY_PARAMS_GB["kandinsky3"] * 2**30 >= 2 * params
    assert 2 * params / 2**30 > 20.0  # about 11.8 B parameters


@contextlib.contextmanager
def recorded_calls(counts: dict):
    """The modules' GroupNorm and attention wrapper calls recorded into
    `counts` under the wrappers' counter keys (run on the meta device)."""
    from chiaswarm_tpu_torch.models import cascade_unet, layers, movq

    def gn(x, scale, bias, *, groups=32, eps=1e-5, act=None):
        counts["group_norm"][(tuple(x.shape), str(x.dtype).replace("torch.", ""),
                              act == "silu", float(eps))] += 1
        return torch.empty_like(x)

    def fa(q, k, v, scale=None):
        counts["flash_attention"][(tuple(q.shape), tuple(k.shape), q.dtype)] += 1
        return torch.empty_like(q)

    with mock.patch.object(layers, "group_norm", gn), \
            mock.patch.object(movq, "dot_product_attention", fa), \
            mock.patch.object(cascade_unet, "dot_product_attention", fa):
        yield counts


@pytest.mark.parametrize("published", [True, False])
def test_chip_smoke_prediction_matches_the_modules(published):
    """`chip_smoke.k3_calls`, config arithmetic alone, equals the wrapper
    calls of a UNet call with two rows, a MoVQ decode and an encode, shape
    for shape (the published bundle at 1024^2, the tiny one at 64^2)."""
    from chiaswarm_tpu_torch.models.movq import MoVQ

    smoke = chip_smoke()
    c, m, size = ((cfgs.K3UNetConfig(), cfgs.MoVQConfig(), 1024) if published
                  else (cfgs.TINY_K3_UNET, cfgs.TINY_MOVQ, 64))
    dtype = torch.bfloat16
    with torch.device("meta"):
        unet, vq = Kandinsky3UNet(c).to(dtype), MoVQ(m).to(dtype)
    lat = size // 2 ** (len(m.block_out_channels) - 1)

    def meta(*shape):
        return torch.empty(shape, device="meta", dtype=dtype)

    recorded = {}
    with torch.no_grad():
        for part, fn in (("unet", lambda: unet(meta(2, c.in_channels, lat, lat),
                                               torch.empty((2,), device="meta"),
                                               meta(2, 128, c.encoder_hid_dim),
                                               torch.ones((2, 128), device="meta"))),
                         ("decode", lambda: vq.decode(meta(1, m.latent_channels, lat, lat))),
                         ("encode", lambda: vq.encode(meta(1, 3, size, size)))):
            with recorded_calls({"flash_attention": Counter(), "group_norm": Counter()}) as got:
                fn()
            recorded[part] = got
    assert smoke.k3_calls(c, m, size, dtype=dtype) == recorded
    if published:
        # one GroupNorm a UNet call: (2, 128, 128, 192), 32 groups of 6 channels
        assert recorded["unet"]["group_norm"] == Counter(
            {((2, 128, 128, 192), "bfloat16", True, 1e-5): 1})
        assert sum(recorded["decode"]["flash_attention"].values()) == 1


def test_chip_smoke_path_rehearses_on_cpu():
    """The smoke's Kandinsky 3 path on the tiny stand-in: seeded files, the
    setup CLI's verdicts (ok, then FAILED naming the removed tensor), the
    registry build, txt2img and img2img through the worker; the launches
    are printed, not held (no kernels on the CPU)."""
    smoke = chip_smoke()
    paths, served = smoke.serve_kandinsky3_path("cpu", device="cpu", tiny=True, hold=False,
                                                steps=3)
    assert set(paths) == {"k3_txt2img", "k3_img2img"}
    assert set(served["jobs"]) == {"k3-txt2img", "k3-img2img"}
    assert served["jobs"]["k3-img2img"]["predicted"]["group_norm"] > 0
    assert served["cli"]["counts"]["text_encoder"] > 0
