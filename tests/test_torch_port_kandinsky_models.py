"""chiaswarm_tpu_torch's Kandinsky 2.x modules against the JAX package's, on
the CPU in f32, with the same seeded numpy inputs and JAX's parameters
carried across by `weights.from_jax_params`.

- MoVQ (TINY_MOVQ): `encode`, `decode`, the decoder's `SpatialNorm` (its
  latent map upsampled by nearest) and `VQAttention` (one head of the
  block's width), within 1e-5 absolute and relative (as the VAE in
  test_torch_port_img2img.py; JAX's own torch-parity test of the decode
  holds 1e-4).
- The decoder UNet (TINY_K22_UNET): `KResnetBlock` (scale-shift AdaGN, with
  its down- and upsampling), `KAttention` (the added K/V ahead of the self
  K/V, the norm on [B, S, C] tokens) and `K22UNet` in the "image" (2.2)
  and "text_image" (2.1) modes and with the ControlNet's 7-channel
  conv_in, within 1e-4 absolute and relative (as the UNet in
  test_torch_port_models.py: stacks of matmuls summed in another order;
  JAX's test_torch_parity_unet.py holds its torch mirror to 1e-4).
- `DiffusionPrior` (TINY_PRIOR) with the causal + text keep-mask and
  without a mask, within 1e-5; MCLIP (TINY_MCLIP, padded rows) within 1e-5.
- `from_jax_params` inverts convert_kandinsky_unet (both modes),
  convert_movq, convert_prior and convert_mclip exactly: JAX's own
  converters map the port's state dicts back onto the JAX trees.
  `infer_k22_unet_config` reads the geometry JAX's reads off the same
  checkpoint shapes. A MoVQ file without the SpatialNorm group norms'
  affine weights loads with identity ones, as JAX's convert_movq fills
  them; its codebook is dropped.
- The configs (PriorConfig, K22UNetConfig, MoVQConfig, MCLIP's, the tiny
  ones, `movq_config_from_json`, `prior_config_with_overrides`) equal
  JAX's field by field.
- The tokenizer.json reader against `tokenizers` / `transformers`: a
  WordLevel file as JAX's 2.1 test writes it, and a Unigram file in
  XLM-R's layout (Replace normalizers around a sentencepiece Precompiled
  charsmap built in the test, Metaspace, <s> $A </s>, <mask> as an added
  token) from seeded pieces: ids and mask equal, on texts that hit the
  charsmap, unknown characters, truncation and padding.

No JAX pipeline is built: each module's JAX program runs once.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.models import clap as jax_clap
from chiaswarm_tpu.models import conversion as jax_conv
from chiaswarm_tpu.models import mclip as jax_mclip
from chiaswarm_tpu.models import movq as jax_movq
from chiaswarm_tpu.models import prior as jax_prior
from chiaswarm_tpu.models import unet_kandinsky as jax_unet
from chiaswarm_tpu.pipelines import kandinsky as jax_kandinsky
from chiaswarm_tpu_torch import weights
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.models.mclip import MCLIPTextEncoder
from chiaswarm_tpu_torch.models.movq import MoVQ, SpatialNorm, VQAttention
from chiaswarm_tpu_torch.models.prior import DiffusionPrior
from chiaswarm_tpu_torch.models.tokenizer import load_fast_tokenizer
from chiaswarm_tpu_torch.models.unet_kandinsky import K22UNet, KAttention, KResnetBlock
from chiaswarm_tpu_torch.weights import from_jax_params

RNG = np.random.default_rng(2016)


def _init(module, *args):
    """A module's parameters as seeded numpy arrays of the shapes its init
    gives (`jax.eval_shape`: flax's init would run the module op by op):
    kernels N(0, 1/fan_in), the rest N(0, 0.1) about 1 for scales, 0
    otherwise."""
    shapes = jax.eval_shape(module.init, *args)["params"]

    def leaf(path, s):
        name = str(path[-1].key)
        x = RNG.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        return (1.0 if name == "scale" else 0.0) + 0.1 * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _randn(*shape, scale=1.0):
    return (scale * RNG.standard_normal(shape)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: {set(a) ^ set(b)}"
        for k in a:
            _trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                      err_msg=path)


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


def _numpy_state(state):
    return {k: v.numpy() for k, v in state.items()}


K21_TINY = dataclasses.replace(jax_unet.TINY_K22_UNET, conditioning="text_image",
                               encoder_hid_dim=24, image_embed_dim=12, image_proj_tokens=3)
CN_TINY = dataclasses.replace(jax_unet.TINY_K22_UNET, in_channels=7)
UNET_CASES = {"image": (jax_unet.TINY_K22_UNET, cfgs.TINY_K22_UNET),
              "text_image": (K21_TINY, dataclasses.replace(
                  cfgs.TINY_K22_UNET, conditioning="text_image", encoder_hid_dim=24,
                  image_embed_dim=12, image_proj_tokens=3)),
              "controlnet": (CN_TINY, dataclasses.replace(cfgs.TINY_K22_UNET, in_channels=7))}


def _cond(mode, b=2):
    if mode == "text_image":
        return {"text_states": _randn(b, 5, 24), "text_embeds": _randn(b, 16),
                "image_embeds": _randn(b, 12)}
    return _randn(b, 32)


# --- MoVQ ---

@pytest.fixture(scope="module")
def movq():
    module = jax_movq.MoVQ(jax_movq.TINY_MOVQ)
    x = _randn(1, 16, 16, 3)
    params = _init(module, jax.random.key(1), jnp.asarray(x))
    port = _load(MoVQ(cfgs.TINY_MOVQ), from_jax_params({"movq": params})["movq"])
    return module, params, port


def test_movq_encode_and_decode_match_jax(movq):
    module, params, port = movq
    x = _randn(2, 16, 16, 3)
    z = module.apply({"params": params}, jnp.asarray(x), method=module.encode)
    with torch.no_grad():
        _close(_nhwc(port.encode(_nchw(x))), z, 1e-5)
        zz = _randn(2, 8, 8, 4)
        want = module.apply({"params": params}, jnp.asarray(zz), method=module.decode)
        _close(_nhwc(port.decode(_nchw(zz))), want, 1e-5)


def test_spatial_norm_matches_jax():
    module = jax_movq.SpatialNorm(16, groups=8)
    f, zq = _randn(2, 8, 8, 16), _randn(2, 2, 2, 4)
    params = _init(module, jax.random.key(2), jnp.asarray(f), jnp.asarray(zq))
    sd = weights._state_dict(params, lambda n: n)
    port = _load(SpatialNorm(16, 4, groups=8), sd)
    with torch.no_grad():
        got = port(_nchw(f), _nchw(zq))
    _close(_nhwc(got), module.apply({"params": params}, jnp.asarray(f), jnp.asarray(zq)), 1e-5)


@pytest.mark.parametrize("spatial", [False, True], ids=["encoder", "decoder"])
def test_vq_attention_matches_jax(spatial):
    module = jax_movq.VQAttention(32, groups=8, spatial=spatial)
    x, zq = _randn(2, 4, 4, 32), _randn(2, 2, 2, 4)
    args = (jnp.asarray(x), jnp.asarray(zq)) if spatial else (jnp.asarray(x),)
    params = _init(module, jax.random.key(3), *args)
    port = _load(VQAttention(32, 8, 4 if spatial else None),
                 weights._state_dict(params, lambda n: n.replace("to_out_0", "to_out.0")))
    with torch.no_grad():
        got = port(_nchw(x), _nchw(zq) if spatial else None)
    _close(_nhwc(got), module.apply({"params": params}, *args), 1e-5)


def test_movq_roundtrips_through_jax_conversion(movq):
    _, params, port = movq
    _trees_equal(jax_conv.convert_movq(_numpy_state(port.state_dict())), params)


def test_movq_fills_non_affine_spatial_norm(tmp_path, movq):
    """A checkpoint without the SpatialNorm group norms' weights loads with
    identity scale and shift, as JAX's convert_movq fills them; the
    codebook is dropped."""
    from safetensors.numpy import save_file

    _, _, port = movq
    state = {k: v for k, v in _numpy_state(port.state_dict()).items() if ".norm_layer." not in k}
    state["quantize.embedding.weight"] = _randn(16, 4)
    save_file(state, str(tmp_path / "movq.safetensors"))
    fresh = MoVQ(cfgs.TINY_MOVQ)
    weights.load_movq_(fresh, [tmp_path / "movq.safetensors"])
    want = jax_conv.convert_movq(state)
    _trees_equal(jax_conv.convert_movq(_numpy_state(fresh.state_dict())), want)
    with pytest.raises(weights.CheckpointError, match="parameters in no file"):
        weights.load_checkpoint_(MoVQ(cfgs.TINY_MOVQ), [tmp_path / "movq.safetensors"], "movq")


# --- the decoder UNet ---

@pytest.fixture(scope="module")
def unets():
    out = {}
    for mode, (jcfg, pcfg) in UNET_CASES.items():
        module = jax_unet.K22UNet(jcfg)
        cond = jax.tree_util.tree_map(jnp.asarray, _cond("text_image" if mode == "text_image"
                                                         else "image", 1))
        params = _init(module, jax.random.key(4), jnp.zeros((1, 8, 8, jcfg.in_channels)),
                       jnp.zeros((1,)), cond)
        port = _load(K22UNet(pcfg), from_jax_params({"k22_unet": params})["k22_unet"])
        out[mode] = (module, params, port)
    return out


@pytest.mark.parametrize("mode", list(UNET_CASES))
def test_k22_unet_matches_jax(unets, mode):
    module, params, port = unets[mode]
    jcfg = UNET_CASES[mode][0]
    x, t = _randn(2, 8, 8, jcfg.in_channels), np.array([3.0, 777.0], np.float32)
    cond = _cond("text_image" if mode == "text_image" else "image")
    want = jax.jit(module.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                 jax.tree_util.tree_map(jnp.asarray, cond))
    tcond = ({k: torch.from_numpy(v) for k, v in cond.items()} if isinstance(cond, dict)
             else torch.from_numpy(cond))
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(t), tcond)
    _close(_nhwc(got), want, 1e-4)


@pytest.mark.parametrize("mode", list(UNET_CASES))
def test_k22_unet_roundtrips_and_infers_config(unets, mode):
    """JAX's converter maps the port's state dict back onto the JAX tree,
    and the port's config inference reads what JAX's reads."""
    _, params, port = unets[mode]
    state = _numpy_state(port.state_dict())
    cj = {"attention_head_dim": 8, "norm_num_groups": 8}
    jax_cfg, converted = jax_conv.convert_kandinsky_unet(state, cj)
    _trees_equal(converted, params)
    ours = weights.infer_k22_unet_config({k: v.shape for k, v in state.items()}, cj)
    assert ours == UNET_CASES[mode][1]
    for field in dataclasses.fields(ours):
        assert getattr(ours, field.name) == getattr(jax_cfg, field.name), field.name


@pytest.mark.parametrize("down,up", [(False, False), (True, False), (False, True)],
                         ids=["plain", "down", "up"])
def test_k_resnet_block_matches_jax(down, up):
    module = jax_unet.KResnetBlock(24, groups=8, down=down, up=up)
    x, temb = _randn(2, 8, 8, 16), _randn(2, 40)
    params = _init(module, jax.random.key(5), jnp.asarray(x), jnp.asarray(temb))
    port = _load(KResnetBlock(16, 24, 40, 8, down=down, up=up),
                 weights._state_dict(params, lambda n: n))
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(temb))
    _close(_nhwc(got), module.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb)),
           1e-5)


def test_k_attention_matches_jax():
    """Ragged KV: 3 context tokens ahead of 36 self tokens."""
    module = jax_unet.KAttention(4, 8, 32, groups=8)
    x, ctx = _randn(2, 6, 6, 32), _randn(2, 3, 16)
    params = _init(module, jax.random.key(6), jnp.asarray(x), jnp.asarray(ctx))
    port = _load(KAttention(32, 4, 8, 16, 8),
                 weights._state_dict(params, lambda n: n.replace("to_out_0", "to_out.0")))
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(ctx))
    _close(_nhwc(got), module.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx)),
           1e-5)


def test_infer_config_refuses_deepfloyds_text_unet():
    module = jax_unet.K22UNet(jax_unet.TINY_IF_UNET)
    params = jax.eval_shape(module.init, jax.random.key(7), jnp.zeros((1, 8, 8, 3)),
                            jnp.zeros((1,)), jnp.zeros((1, 4, 32)))["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), params)
    shapes = {k: v.shape for k, v in weights._state_dict(zeros, lambda n: n).items()}
    shapes["encoder_hid_proj.weight"] = shapes.pop("hid_proj.weight")
    with pytest.raises(ValueError, match="DeepFloyd IF"):
        weights.infer_k22_unet_config(shapes)


# --- the prior and MCLIP ---

@pytest.fixture(scope="module")
def prior():
    module = jax_prior.DiffusionPrior(jax_prior.TINY_PRIOR)
    args = (jnp.zeros((1, 32)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)), jnp.zeros((1, 32)))
    params = _init(module, jax.random.key(8), *args)
    port = _load(DiffusionPrior(cfgs.TINY_PRIOR), from_jax_params({"prior": params})["prior"])
    return module, params, port


@pytest.mark.parametrize("masked", [True, False], ids=["causal-keep-mask", "no-mask"])
def test_prior_matches_jax(prior, masked):
    module, params, port = prior
    args = (_randn(2, 32), np.array([5.0, 900.0], np.float32), _randn(2, 77, 32),
            _randn(2, 32))
    mask = None
    if masked:
        mask = np.ones((2, 77), np.float32)
        mask[0, 9:], mask[1, 30:] = 0.0, 0.0
    want = module.apply({"params": params}, *map(jnp.asarray, args),
                        attention_mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args),
                   attention_mask=None if mask is None else torch.from_numpy(mask))
    _close(got.numpy(), want, 1e-5)


def test_prior_roundtrips_through_jax_conversion(prior):
    _, params, port = prior
    state = _numpy_state(port.state_dict())
    state["clip_mean"], state["clip_std"] = _randn(1, 32), _randn(1, 32)
    converted, stats = jax_conv.convert_prior(state)
    _trees_equal(converted, params)
    np.testing.assert_array_equal(stats["mean"], state["clip_mean"].reshape(-1))


def test_mclip_matches_jax():
    module = jax_mclip.MCLIPTextEncoder(jax_mclip.TINY_MCLIP)
    ids = RNG.integers(3, 1000, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.float32)
    mask[1, 5:] = 0.0
    ids[1, 5:] = 1
    params = _init(module, jax.random.key(9), jnp.asarray(ids), jnp.asarray(mask))
    port = _load(MCLIPTextEncoder(cfgs.TINY_MCLIP), from_jax_params({"mclip": params})["mclip"])
    want = module.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    _close(got["hidden_states"].numpy(), want["hidden_states"], 1e-5)
    _close(got["pooled_proj"].numpy(), want["pooled_proj"], 1e-5)
    # JAX's converter reads the published layout the port keeps (a CLS
    # pooler beside it, which both drop)
    state = _numpy_state(port.state_dict())
    state["transformer.pooler.dense.weight"] = _randn(32, 32)
    _trees_equal(jax_conv.convert_mclip(state), params)


# --- configs ---

@pytest.mark.parametrize("ours,theirs", [
    (cfgs.PriorConfig(), jax_prior.PriorConfig()), (cfgs.TINY_PRIOR, jax_prior.TINY_PRIOR),
    (cfgs.TINY_K22_UNET, jax_unet.TINY_K22_UNET), (cfgs.MoVQConfig(), jax_movq.MoVQConfig()),
    (cfgs.TINY_MOVQ, jax_movq.TINY_MOVQ), (cfgs.MCLIP_XLMR_LARGE, jax_mclip.MCLIP_XLMR_LARGE),
    (cfgs.TINY_MCLIP, jax_mclip.TINY_MCLIP),
], ids=["prior", "tiny-prior", "tiny-unet", "movq", "tiny-movq", "mclip", "tiny-mclip"])
def test_configs_match_jax(ours, theirs):
    for field in dataclasses.fields(ours):
        assert getattr(ours, field.name) == getattr(theirs, field.name), field.name


def test_k22_unet_config_defaults_match_jax_beside_the_published_widths():
    """The port's K22UNetConfig() is JAX's; the published decoder's widths
    (its unet/config.json) differ in the last two levels."""
    theirs = jax_unet.K22UNetConfig()
    for field in dataclasses.fields(cfgs.K22UNetConfig):
        assert getattr(cfgs.K22UNetConfig(), field.name) == getattr(theirs, field.name)
    assert cfgs.K22_DECODER_UNET.block_out_channels == (384, 768, 1152, 1536)


@pytest.mark.parametrize("cj", [None, {"block_out_channels": [32, 64], "latent_channels": 4,
                                       "layers_per_block": 1, "norm_num_groups": 8,
                                       "scaling_factor": 0.5}])
def test_movq_config_from_json_matches_jax(cj):
    assert dataclasses.asdict(cfgs.movq_config_from_json(cj)) == dataclasses.asdict(
        jax_movq.movq_config_from_json(cj))


@pytest.mark.parametrize("cj", [None, {"embedding_dim": 768, "num_layers": 6},
                                {"num_attention_heads": 8, "attention_head_dim": 32}])
def test_prior_config_overrides_match_jax(cj):
    ours = cfgs.prior_config_with_overrides(cfgs.PriorConfig(), cj)
    theirs = jax_kandinsky.prior_config_with_overrides(jax_prior.PriorConfig(), cj)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_mclip_config_from_json_matches_jax(tmp_path):
    from chiaswarm_tpu_torch.pipelines.kandinsky import mclip_config_from_json

    cj = {"vocab_size": 1000, "transformerDimensions": 32, "numDims": 16,
          "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
          "max_position_embeddings": 80, "layer_norm_eps": 1e-5}
    (tmp_path / "text_encoder").mkdir()
    (tmp_path / "text_encoder" / "config.json").write_text(json.dumps(cj))
    theirs = jax_kandinsky.KandinskyPipeline._mclip_config_from_dir(tmp_path)
    assert isinstance(theirs, jax_clap.ClapTextConfig)
    ours = mclip_config_from_json(cj)
    for field in dataclasses.fields(ours):
        assert getattr(ours, field.name) == getattr(theirs, field.name), field.name


# --- the tokenizer.json reader ---

def charsmap(mapping: dict) -> bytes:
    """A sentencepiece precompiled charsmap: darts-clone units over the
    UTF-8 keys (each node's children at a base of its own, a multiple of
    256), then the NUL-terminated replacements."""
    blob, offsets = b"", {}
    for key, value in mapping.items():
        offsets[key] = len(blob)
        blob += value.encode() + b"\0"
    trie: dict = {}
    for key in mapping:
        node = trie
        for c in key.encode():
            node = node.setdefault(c, {})
        node[None] = offsets[key]
    units, next_base = {}, [256]

    def place(node, pos):
        base = next_base[0]
        next_base[0] += 256
        units[pos] = units.get(pos, 0) | ((pos ^ base) << 10) | ((1 << 8) if None in node else 0)
        if None in node:
            units[base] = (1 << 31) | node[None]
        for c, child in node.items():
            if c is not None:
                units[base ^ c] = c
                place(child, base ^ c)

    place(trie, 0)
    arr = np.zeros(max(units) + 1, dtype="<u4")
    for pos, unit in units.items():
        arr[pos] = unit
    raw = arr.tobytes()
    return len(raw).to_bytes(4, "little") + raw + blob


def _word_level(path):
    from tokenizers import Tokenizer, pre_tokenizers
    from tokenizers.models import WordLevel

    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "a": 4, "red": 5, "fox": 6}
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path / "tokenizer.json"))
    return {"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
            "unk_token": "<unk>", "model_max_length": 80}


def _unigram(path):
    from tokenizers import Regex, Tokenizer, normalizers, pre_tokenizers, processors
    from tokenizers.models import Unigram

    rng = np.random.default_rng(5)
    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = [(p, 0.0) for p in ("<s>", "<pad>", "</s>", "<unk>")]
    seen = {p for p, _ in vocab}
    for w in ("▁a", "▁red", "▁fox", "▁re", "d", "▁f", "ox", "▁", "fi", "▁the", "s", "ing",
              "▁run"):
        vocab.append((w, float(-rng.uniform(1, 8))))
        seen.add(w)
    for c in letters:
        if c not in seen:
            vocab.append((c, float(-rng.uniform(8, 12))))
            seen.add(c)
    while len(vocab) < 200:
        w = "▁" * int(rng.integers(0, 2)) + "".join(rng.choice(list(letters),
                                                               int(rng.integers(2, 5))))
        if w not in seen:
            vocab.append((w, float(-rng.uniform(2, 14))))
            seen.add(w)
    vocab.append(("<mask>", 0.0))
    tok = Tokenizer(Unigram(vocab, unk_id=3, byte_fallback=False))
    tok.normalizer = normalizers.Sequence([
        normalizers.Replace("``", '"'), normalizers.Replace("''", '"'),
        normalizers.Precompiled(charsmap({"ﬁ": "fi", "Ａ": "A", "é": "é", "　": " ",
                                          "ｆｏｘ": "fox"})),
        normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>", pair="<s> $A </s> </s> $B </s>",
        special_tokens=[("<s>", 0), ("</s>", 2)])
    tok.add_special_tokens(["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    tok.save(str(path / "tokenizer.json"))
    return {"tokenizer_class": "XLMRobertaTokenizer", "pad_token": "<pad>",
            "model_max_length": 512}


TEXTS = ["a red fox", "", "the ﬁre  fox runs", "Ａ ｆｏｘ QQQ zz", "café　run", "``quoted''",
         "x" * 300, "a <mask> fox", "a blue fox!!", "red " * 100]


@pytest.mark.parametrize("kind", ["WordLevel", "Unigram"])
def test_tokenizer_reader_matches_tokenizers(tmp_path, kind):
    from transformers import PreTrainedTokenizerFast

    config = (_word_level if kind == "WordLevel" else _unigram)(tmp_path)
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(config))
    theirs = PreTrainedTokenizerFast(tokenizer_file=str(tmp_path / "tokenizer.json"),
                                     pad_token=config["pad_token"])
    ours = load_fast_tokenizer(tmp_path)
    for text in TEXTS:
        want = theirs([text, "fox"], padding="max_length", truncation=True, max_length=77,
                      return_tensors="np")
        ids, mask = ours([text, "fox"], max_length=77)
        np.testing.assert_array_equal(ids, want["input_ids"], err_msg=repr(text))
        np.testing.assert_array_equal(mask, want["attention_mask"], err_msg=repr(text))


def test_tokenizer_reader_refuses_what_it_cannot_read(tmp_path):
    (tmp_path / "tokenizer.json").write_text(json.dumps(
        {"model": {"type": "BPE", "vocab": {}, "merges": []}}))
    with pytest.raises(ValueError, match="model 'BPE' is not supported"):
        load_fast_tokenizer(tmp_path)
    with pytest.raises(FileNotFoundError):
        load_fast_tokenizer(tmp_path / "missing")
