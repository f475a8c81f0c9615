"""The port's cost plane on the CPU, held against the JAX package (no JAX
jit compile: every function here is arithmetic or host code).

- `models/flops.py`: the port's analytic UNet count equals JAX's exactly
  for the SD 1.5, SD 2.1, SDXL, refiner and tiny configs, at three
  canvases and 1-8 rows, and so does `denoise_flops` at 2 and 3 CFG rows.
- `costs.py`: the H100's peak, the unknown card's and the CPU's (None,
  MFU null), the `BENCH_PEAK_TFLOPS` override, and `pass_cost` /
  `job_cost` / `note_divergence` equal to JAX's for the same inputs.
- The envelopes of tiny jobs (txt2img, pix2pix at 3 rows, img2img at
  strength 0.5, a job resumed at step k, each member of a coalesced pass)
  stamp `unet_tflops` and `cost.flops` by JAX's formula (models/flops.py
  on JAX's own config of the model), `geometry` {"data": 1, "tensor": 1,
  "seq": 1}, and the hive's `accounting.job_usage` bills those flops.
- The pass ledger (programs.py): `torch.utils.flop_counter` on the first
  UNet call of a pass key against the analytic count. Tolerance: within 1%
  on the tiny UNets (the time and added-condition embeddings' linears,
  which the analytic count omits, are 0.07-0.2% of a tiny call), within
  1e-4 at full width (the same linears are 2-5 parts in a million of an
  SD or SDXL call; counted on the meta device, no arithmetic runs).
"""

import types

import pytest
import torch

from chiaswarm_tpu_torch import checkpoint as ckpt
from chiaswarm_tpu_torch import costs, programs, telemetry
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.models import flops
from chiaswarm_tpu_torch.pipelines.stable_diffusion import GEOMETRY, SDPipeline

CONFIGS = {"sd15": "SD15_UNET", "sd21": "SD21_UNET", "sdxl": "SDXL_UNET",
           "refiner": "SDXL_REFINER_UNET", "tiny": "TINY_UNET", "tiny_xl": "TINY_XL_UNET"}
# latent canvases (the VAE's 8x) of 512^2, 768^2 and 1024x768
CANVASES = ((64, 64), (96, 96), (128, 96))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_analytic_flops_equal_jax(name):
    from chiaswarm_tpu.models import configs as jax_cfgs
    from chiaswarm_tpu.models import flops as jax_flops

    ours, theirs = getattr(cfgs, CONFIGS[name]), getattr(jax_cfgs, CONFIGS[name])
    for lh, lw in CANVASES:
        for rows in range(1, 9):
            assert flops.unet_call_flops(ours, lh, lw, rows) == jax_flops.unet_call_flops(
                theirs, lh, lw, rows)
        for cfg_rows in (2, 3):
            assert flops.denoise_flops(ours, lh, lw, 3, 30, cfg_rows=cfg_rows) == (
                jax_flops.denoise_flops(theirs, lh, lw, 3, 30, cfg_rows=cfg_rows))


def test_peak_table_and_override(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    assert costs.peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert costs.peak_tflops("NVIDIA A100-SXM4-80GB") is None
    assert costs.peak_tflops(torch.device("cpu")) is None
    assert costs.peak_tflops(None) is None
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "123.5")
    assert costs.peak_tflops(torch.device("cpu")) == 123.5


def test_cost_figures_equal_jax(monkeypatch):
    from chiaswarm_tpu import costs as jax_costs

    class Kind:
        device_kind = "x"

    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "100")
    mfus = []
    for flops_, span in ((2e12, 4.0), (405.6733e12, 2.5311), (1.5e9, 0.0), (7.0, None)):
        ours = costs.pass_cost(model="m-port", pass_flops=flops_, denoise_s=span, chips=1,
                               device=torch.device("cpu"), geometry="replicated")
        theirs = jax_costs.pass_cost(model="m-jax", pass_flops=flops_, denoise_s=span,
                                     chips=1, device=Kind(), geometry="replicated")
        assert ours == theirs
        assert costs.job_cost(ours, flops_ / 3) == jax_costs.job_cost(theirs, flops_ / 3)
        mfus.append(ours["mfu"])
    assert mfus == [0.005, round(405.6733 / 2.5311 / 100, 4), None, None]
    # the gauge holds the last pass that had an MFU
    gauge = telemetry.REGISTRY.get("swarm_pass_mfu").value(model="m-port",
                                                           geometry="replicated")
    assert gauge == mfus[1]
    assert costs.note_divergence("m-port", 10.0, 10.2) == jax_costs.note_divergence(
        "m-jax", 10.0, 10.2)
    assert costs.note_divergence("m-port", 0, 5) is None


def _jax_unet(model: str):
    from chiaswarm_tpu.pipelines import stable_diffusion as jax_sd

    return jax_sd._family_configs(model)[0]


def _jax_flops(model: str, lh: int, lw: int, n: int, steps: int, cfg_rows: int = 2) -> float:
    from chiaswarm_tpu.models import flops as jax_flops

    return jax_flops.denoise_flops(_jax_unet(model), lh, lw, n, steps, cfg_rows=cfg_rows)


def _usage(envelope: dict) -> dict:
    from chiaswarm_tpu.hive_server.accounting import job_usage

    record = types.SimpleNamespace(state="done", result=envelope, job={"tenant": "t"},
                                   timeline=[])
    return job_usage(record)


def _check_stamp(cfg: dict, want_job: float, want_pass: float) -> None:
    assert cfg["unet_tflops"] == round(want_job / 1e12, 4)
    assert cfg["cost"]["flops"] == int(round(want_job))
    assert cfg["cost"]["pass_flops"] == int(round(want_pass))
    assert cfg["cost"]["mfu"] is None and cfg["cost"]["peak_tflops_per_chip"] is None
    assert cfg["cost"]["chips"] == 1 and cfg["cost"]["tflops_per_s"] > 0
    # the JAX package's denoise_decode_s span; both sides rounded to 0.1 ms
    span = cfg["timings"]["denoise_s"] + cfg["timings"]["decode_s"]
    assert abs(cfg["cost"]["denoise_s"] - span) <= 2e-4
    assert cfg["geometry"] == GEOMETRY == {"data": 1, "tensor": 1, "seq": 1}
    assert _usage({"id": "x", "pipeline_config": cfg})["flops"] == cfg["cost"]["flops"]


@pytest.fixture(scope="module")
def tiny_xl():
    return SDPipeline("test/tiny-xl", device="cpu")


def test_txt2img_and_img2img_stamps_follow_jax(tiny_xl, monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    lh = 64 // tiny_xl.latent_factor
    _, cfg = tiny_xl.run("a cat", num_inference_steps=3, height=64, width=64, seed=1,
                         num_images_per_prompt=2)
    want = _jax_flops("test/tiny-xl", lh, lh, 2, 3)
    _check_stamp(cfg, want, want)
    from PIL import Image

    image = Image.new("RGB", (64, 64), (120, 30, 200))
    _, cfg = tiny_xl.run("a dog", num_inference_steps=4, height=64, width=64, seed=2,
                         image=image, strength=0.5)
    assert cfg["mode"] == "img2img" and cfg["t_start"] == 2
    want = _jax_flops("test/tiny-xl", lh, lh, 1, 4 - 2)
    _check_stamp(cfg, want, want)


def test_pix2pix_stamps_three_cfg_rows():
    from PIL import Image

    pipe = SDPipeline("test/tiny-pix2pix", device="cpu")
    lh = 64 // pipe.latent_factor
    _, cfg = pipe.run("make it blue", num_inference_steps=2, height=64, width=64, seed=3,
                      image=Image.new("RGB", (64, 64), (10, 200, 40)))
    assert cfg["mode"] == "pix2pix"
    want = _jax_flops("test/tiny-pix2pix", lh, lh, 1, 2, cfg_rows=3)
    assert want > _jax_flops("test/tiny-pix2pix", lh, lh, 1, 2, cfg_rows=2)
    _check_stamp(cfg, want, want)


def test_resumed_job_bills_the_recomputed_fraction(tiny_xl):
    blobs = {}

    def keep(step, latents, leaves, signature, rng):
        blobs[step] = ckpt.pack(step, latents, leaves, signature, rng)

    args = dict(num_inference_steps=6, height=64, width=64, seed=4, denoise_chunk_steps=2)
    _, full = tiny_xl.run("a resumed cat", checkpoint_every_chunks=1, checkpoint_cb=keep,
                          **args)
    assert sorted(blobs) == [2, 4]
    _, cfg = tiny_xl.run("a resumed cat", resume=ckpt.unpack(blobs[4]), **args)
    assert cfg["resumed"] == {"from_step": 4, "recomputed_steps": 2}
    lh = 64 // tiny_xl.latent_factor
    raw = _jax_flops("test/tiny-xl", lh, lh, 1, 6)
    # JAX's formula: round(pass flops x recomputed steps / (steps - t_start))
    billed = int(round(raw * 2 / 6))
    assert cfg["unet_tflops"] == full["unet_tflops"] == round(raw / 1e12, 4)
    assert cfg["cost"]["flops"] == cfg["cost"]["pass_flops"] == billed
    assert _usage({"id": "r", "pipeline_config": cfg})["flops"] == billed


def test_coalesced_members_carry_their_own_flops(tiny_xl):
    out = tiny_xl.run_batched([{"prompt": "a", "seed": 1},
                               {"prompt": "b", "seed": 2, "num_images_per_prompt": 2}],
                              height=64, width=64, num_inference_steps=2)
    lh = 64 // tiny_xl.latent_factor
    padded = out[0][1]["padded_rows"]
    assert padded == 4
    want_pass = _jax_flops("test/tiny-xl", lh, lh, padded, 2)
    for (_, cfg), n in zip(out, (1, 2)):
        _check_stamp(cfg, _jax_flops("test/tiny-xl", lh, lh, n, 2), want_pass)
    # one pass, one set of pass figures
    assert out[0][1]["cost"]["tflops_per_s"] == out[1][1]["cost"]["tflops_per_s"]


def test_ledger_counts_the_first_unet_call_of_each_key(tiny_xl):
    programs.reset()
    tiny_xl.run("ledger", num_inference_steps=2, height=64, width=64, seed=5)
    tiny_xl.run("ledger again", num_inference_steps=2, height=64, width=64, seed=6)
    [entry] = programs.snapshot()["programs"]
    assert entry["calls"] == 2 and entry["kind"] == "txt2img"
    lh = 64 // tiny_xl.latent_factor
    assert entry["analytic_call_flops"] == flops.unet_call_flops(tiny_xl.unet.config, lh, lh, 2)
    # the tiny UNet's embeddings are a few parts in a thousand of its call
    assert 1.0 <= entry["divergence"] < 1.01
    assert entry["attention_flops"] == 0  # the plain attention is counted as einsums
    gauge = telemetry.REGISTRY.get("swarm_flops_divergence_ratio").value(model="test/tiny-xl")
    assert gauge == entry["divergence"]
    assert programs.snapshot()["divergence"] == {"test/tiny-xl": entry["divergence"]}


@pytest.mark.parametrize("name,size,context,added", [
    ("sdxl", 1024, 2048, (1280, 6)), ("sd15", 512, 768, None), ("tiny", 64, 32, None)])
def test_flop_counter_agrees_with_the_analytic_count(name, size, context, added, monkeypatch):
    """One UNet call counted by torch.utils.flop_counter on the meta device
    (full width costs no arithmetic there) against models/flops.py."""
    from torch.utils.flop_counter import FlopCounterMode

    from chiaswarm_tpu_torch.models import layers
    from chiaswarm_tpu_torch.models.unet2d import UNet2DConditionModel
    from chiaswarm_tpu_torch.ops.flash_attention import reference_attention
    from chiaswarm_tpu_torch.ops.group_norm import reference_group_norm

    # the meta device has no kernel: the plain versions, as on the CPU
    monkeypatch.setattr(layers, "group_norm", lambda x, s, b, *, groups=32, eps=1e-5, act=None:
                        reference_group_norm(x, s, b, groups, eps, act == "silu"))
    monkeypatch.setattr(layers, "dot_product_attention",
                        lambda q, k, v, scale=None: reference_attention(q, k, v, scale))
    config = getattr(cfgs, CONFIGS[name])
    lh = size // 8
    with torch.device("meta"):
        unet = UNet2DConditionModel(config)
        extra = None if added is None else {"text_embeds": torch.empty(2, added[0]),
                                            "time_ids": torch.empty(2, added[1])}
        with FlopCounterMode(display=False) as counter:
            unet(torch.empty(2, 4, lh, lh), torch.empty(2), torch.empty(2, 77, context),
                 added_cond=extra)
    ratio = counter.get_total_flops() / flops.unet_call_flops(config, lh, lh, 2)
    assert 1.0 <= ratio < (1.01 if name == "tiny" else 1.0001), ratio
