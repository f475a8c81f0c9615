"""chiaswarm_tpu_torch's Kandinsky 2.1 decoder against the JAX package's, a
whole job on the CPU in f32, from one synthetic 2.1 repo on disk.

The repo (`kandinsky-community/kandinsky-2-1` under a temporary model
root) is the port's seeded tiny text_image decoder written by
`chip_smoke.write_kandinsky`: unet/ (TextImageTimeEmbedding and
TextImageProjection keys, which make both packages infer "text_image"),
movq/ (TINY_MOVQ, its config.json), text_encoder/ (MCLIP: an XLM-R trunk
and LinearTransformation, config.json in MultilingualCLIP's keys) and
tokenizer/tokenizer.json (a Unigram tokenizer in XLM-R's layout, which
JAX reads through `transformers.AutoTokenizer` and the port through its
own reader). JAX converts the same files (its MoVQ config patched to the
tiny one, as JAX's own 2.1 test does: JAX reads no movq/config.json).

- A split-embeds txt2img job (the prior's embeddings given, as JAX's own
  2.1 test runs it), JAX's noise injected: the uint8 images within 2/255.
- The MCLIP conditioning: token ids and mask equal the `transformers`
  tokenizer's; the text states and pooled projection within 1e-5.
- A 2.1 repo without tokenizer/ raises MissingWeightsError in both
  packages, as does one without text_encoder/ in the port.
"""

import importlib.util
import shutil
import unittest.mock as mock
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.models import movq as jax_movq
from chiaswarm_tpu.pipelines import kandinsky as jax_kandinsky
from chiaswarm_tpu.weights import MissingWeightsError as JaxMissingWeightsError
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.pipelines.kandinsky import KandinskyPipeline
from chiaswarm_tpu_torch.weights import MissingWeightsError

REPO = Path(__file__).resolve().parents[1]
K21 = "kandinsky-community/kandinsky-2-1"
SIZE, LAT = 64, 32


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    smoke = chip_smoke()
    root = tmp_path_factory.mktemp("k21-models")
    seeded = smoke.seeded_decoder(K21, "cpu", torch.float32, cfgs.TINY_K21_UNET, seed=21,
                                  movq_cfg=cfgs.TINY_MOVQ)
    smoke.write_kandinsky(seeded, root / K21)
    return root


@pytest.fixture(scope="module")
def pipes(repo):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CHIASWARM_MODEL_ROOT_DIR", str(repo))
        with mock.patch.object(jax_movq, "MoVQConfig", lambda: jax_movq.TINY_MOVQ), \
                mock.patch.object(jax_kandinsky, "MoVQConfig", lambda: jax_movq.TINY_MOVQ):
            jpipe = jax_kandinsky.KandinskyPipeline(K21)
    port = KandinskyPipeline(K21, device="cpu", model_root_dir=str(repo))
    return jpipe, port


def test_k21_job_matches_jax(pipes):
    jpipe, port = pipes
    assert jpipe.text_image and port.text_image and port.weights_source == "checkpoint"
    rng = np.random.default_rng(42)
    embeds = rng.standard_normal((1, 32)).astype(np.float32)
    neg = rng.standard_normal((1, 32)).astype(np.float32)
    kw = dict(prompt="a red fox in fresh snow", negative_prompt="blurry", height=SIZE,
              width=SIZE, num_inference_steps=3, image_embeds=embeds,
              negative_image_embeds=neg, pipeline_type="KandinskyPipeline")
    want, jcfg = jpipe.run(rng=jax.random.key(7), **kw)
    _, _, dec_rng = jax.random.split(jax.random.key(7), 3)
    shape = (1, LAT, LAT, 4)

    def normal(key):
        return np.asarray(jax.random.normal(key, shape, jnp.float32)).transpose(0, 3, 1, 2)

    got, cfg = port.run(**kw, latents=normal(dec_rng),
                        noise_fn=lambda i, s: normal(jax.random.fold_in(dec_rng, i)))
    for w, g in zip(want, got):
        w = np.asarray(w).astype(np.int16)
        assert int(np.abs(g.astype(np.int16) - w).max()) <= 2
        assert w.std() > 1.0
    assert cfg["conditioning"] == "text_image" and cfg["mode"] == jcfg["mode"] == "txt2img"
    assert "text_encode_s" in cfg["timings"]


def test_mclip_conditioning_matches_jax(pipes):
    jpipe, port = pipes
    texts = ["blurry", "a red fox in fresh snow"]
    tok = jpipe.mclip_tokenizer(texts, padding="max_length", truncation=True, max_length=77,
                                return_tensors="np")
    ids, mask = port.mclip_tokenizer(texts, max_length=77)
    np.testing.assert_array_equal(ids, tok["input_ids"])
    np.testing.assert_array_equal(mask, tok["attention_mask"])
    want = jpipe._text_program(jpipe.params["text"], jnp.asarray(ids, jnp.int32),
                               jnp.asarray(mask, jnp.float32))
    with torch.no_grad():
        got = port.mclip(torch.from_numpy(ids), torch.from_numpy(mask))
    for key in ("hidden_states", "pooled_proj"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("missing", ["tokenizer", "text_encoder"])
def test_k21_repo_without_its_text_tower_raises(repo, tmp_path, monkeypatch, missing):
    root = tmp_path / "models"
    shutil.copytree(repo, root)
    shutil.rmtree(root / K21 / missing)
    with pytest.raises(MissingWeightsError, match="MCLIP"):
        KandinskyPipeline(K21, device="cpu", model_root_dir=str(root))
    if missing == "tokenizer":
        monkeypatch.setenv("CHIASWARM_MODEL_ROOT_DIR", str(root))
        with mock.patch.object(jax_movq, "MoVQConfig", lambda: jax_movq.TINY_MOVQ), \
                mock.patch.object(jax_kandinsky, "MoVQConfig", lambda: jax_movq.TINY_MOVQ), \
                pytest.raises(JaxMissingWeightsError, match="MCLIP tokenizer"):
            jax_kandinsky.KandinskyPipeline(K21)
