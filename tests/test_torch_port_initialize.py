"""chiaswarm_tpu_torch's setup CLI (`initialize.py`) against the JAX
package's, on the CPU.

- `--check`: for every family both packages serve, the port's
  `verify_local_model` gives JAX's verdict and JAX's per-component
  parameter counts on the same tiny diffusers-layout trees (written from
  seeded port pipelines by `chip_smoke.py`'s writers): SD and SDXL, Flux,
  Kandinsky 2.2 (decoder and prior) and 2.1, Kandinsky 3, Stable Cascade
  (prior and decoder), the latent upscaler, the safety checker, DPT,
  ZoeDepth, the Annotators repo, openpose and UperNet. The port builds
  its modules on the meta device; JAX converts and runs `eval_shape`.
  (JAX's Kandinsky 2.x decoder check holds MoVQ to the published
  MoVQConfig, whatever the repo's config.json says: it is pointed at the
  tiny one, as the port's Kandinsky tests do.)
- A family the port does not serve is "skipped" (None).
- A tree with one tensor removed: both packages fail it, the port's
  command exits 1 and names the tensor.
- `--reset`, `--silent` and the prompt; the soft-fail rule for auxiliary
  models the catalog did not name; `fetch_hive_model_list` and
  `aux_model_names` against JAX's; `download_model` with a stub
  `huggingface_hub` in `sys.modules` (nothing is fetched).
"""

import asyncio
import builtins
import importlib.util
import shutil
import sys
import types
from pathlib import Path

import pytest
import torch

from chiaswarm_tpu import initialize as jax_init
from chiaswarm_tpu.models import movq as jax_movq
from chiaswarm_tpu.settings import Settings as JaxSettings
from chiaswarm_tpu_torch import initialize
from chiaswarm_tpu_torch.models import configs as cfgs
from chiaswarm_tpu_torch.settings import Settings

REPO = Path(__file__).resolve().parents[1]
K3 = "kandinsky-community/kandinsky-3"
PRIOR, DECODER = "stabilityai/stable-cascade-prior", "stabilityai/stable-cascade"
DPT = "test/tiny-dpt"


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One model root holding a tiny tree of every family both packages
    check, in the published layouts."""
    from chiaswarm_tpu_torch.models.safety import TINY_SAFETY
    from chiaswarm_tpu_torch.pipelines.cascade import CascadePipeline, CascadePriorPipeline
    from chiaswarm_tpu_torch.pipelines.flux import FluxPipeline
    from chiaswarm_tpu_torch.pipelines.kandinsky import KandinskyPriorPipeline
    from chiaswarm_tpu_torch.pipelines.kandinsky3 import Kandinsky3Pipeline
    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
    from chiaswarm_tpu_torch.pipelines.upscale import LatentUpscalePipeline

    smoke = chip_smoke()
    root = tmp_path_factory.mktemp("models")
    for name in ("test/tiny-sd", "test/tiny-xl"):
        smoke.write_checkpoint(SDPipeline(name, device="cpu"), root / name)
    smoke.write_flux(FluxPipeline("test/tiny-flux", device="cpu"), root / "test/tiny-flux")
    smoke.write_kandinsky(smoke.seeded_decoder("test/tiny-kandinsky", "cpu", torch.float32),
                          root / "test/tiny-kandinsky")
    smoke.write_kandinsky(KandinskyPriorPipeline("test/tiny-kandinsky-prior", device="cpu"),
                          root / "test/tiny-kandinsky-prior")
    smoke.write_kandinsky(smoke.seeded_decoder(smoke.TINY_K21, "cpu", torch.float32,
                                               cfgs.TINY_K21_UNET, seed=4),
                          root / smoke.TINY_K21)
    smoke.write_kandinsky3(Kandinsky3Pipeline("test/tiny-kandinsky3", device="cpu"), root / K3)
    smoke.write_cascade(CascadePriorPipeline("test/tiny-cascade-prior", device="cpu"),
                        root / PRIOR)
    smoke.write_cascade(CascadePipeline("test/tiny-cascade", device="cpu"), root / DECODER)
    smoke.write_upscaler(LatentUpscalePipeline("test/tiny-upscaler", device="cpu"),
                         root / "test/tiny-upscaler", dtype=torch.float32)
    smoke.write_checker(root / "test/tiny-safety-checker", TINY_SAFETY, 3, "cpu")
    smoke.write_detectors(root, 11, tiny=True, depth_model=DPT, pose_model=smoke.POSE_MODEL)
    return root


CHECKED = ("test/tiny-sd", "test/tiny-xl", "test/tiny-flux", "test/tiny-kandinsky",
           "test/tiny-kandinsky-prior", "test/tiny-kandinsky-2-1", K3, PRIOR, DECODER,
           "test/tiny-upscaler", "test/tiny-safety-checker", DPT, "Intel/zoedepth-nyu",
           "lllyasviel/Annotators", "lllyasviel/ControlNet-openpose",
           "openmmlab/upernet-convnext-small")


def _tiny_movq_default(monkeypatch):
    """JAX's `MoVQConfig()` (no fields) gives the tiny MoVQ; with fields it
    is the class itself (`movq_config_from_json`)."""
    real = jax_movq.MoVQConfig
    monkeypatch.setattr(jax_movq, "MoVQConfig",
                        lambda **kw: real(**kw) if kw else jax_movq.TINY_MOVQ)


@pytest.mark.parametrize("name", CHECKED)
def test_check_matches_jax(trees, monkeypatch, name):
    _tiny_movq_default(monkeypatch)
    port = initialize.verify_local_model(name, trees)
    ref = jax_init.verify_local_model(name, trees)
    assert port is not None and ref is not None
    assert port == ref, (port, ref)
    assert all(v > 0 for k, v in port.items() if k != "clip_stats")


@pytest.mark.parametrize("name", [
    "suno/bark", "damo-vilab/text-to-video-ms-1.7b", "DeepFloyd/IF-I-XL-v1.0",
    "guoyww/animatediff-motion-adapter-v1-5-2", "Salesforce/blip-image-captioning-large",
    "cvssp/audioldm2", "stabilityai/stable-video-diffusion-img2vid-xt", "ali-vilab/i2vgen-xl",
    "cerspense/zeroscope_v2_576w"])
def test_unserved_families_are_skipped(tmp_path, name):
    assert initialize.verify_local_model(name, tmp_path) is None


def _env(monkeypatch, root: Path, settings_root: Path):
    monkeypatch.setenv("SDAAS_ROOT", str(settings_root))
    monkeypatch.setenv("CHIASWARM_MODEL_ROOT_DIR", str(root))


def test_removed_tensor_fails_the_check(trees, tmp_path, monkeypatch, capsys):
    """A copy of the Kandinsky 3 tree with one MoVQ tensor removed: JAX's
    check raises, the port's command prints FAILED naming the tensor and
    exits 1; the whole tree still passes."""
    from safetensors.torch import load_file, save_file

    broken = tmp_path / "models"
    shutil.copytree(trees / K3, broken / K3)
    path = next((broken / K3 / "movq").glob("*.safetensors"))
    state = load_file(str(path))
    del state["decoder.conv_out.weight"]
    save_file(state, str(path))
    _tiny_movq_default(monkeypatch)
    with pytest.raises(Exception):
        jax_init.verify_local_model(K3, broken)
    _env(monkeypatch, broken, tmp_path / "sdaas")
    assert initialize.init(["--silent", "--check", "--models", K3]) == 1
    out = capsys.readouterr().out
    assert f"check {K3}: FAILED" in out and "decoder.conv_out.weight" in out
    _env(monkeypatch, trees, tmp_path / "sdaas")
    assert initialize.init(["--silent", "--check", "--models", K3, PRIOR]) == 0
    out = capsys.readouterr().out
    assert f"check {K3}: ok" in out and f"check {PRIOR}: ok" in out


def test_reset_silent_and_prompt(tmp_path, monkeypatch, capsys):
    _env(monkeypatch, tmp_path / "models", tmp_path / "sdaas")
    answers = iter(["tok-1", "http://hive:9511", "w1"])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(answers))
    assert initialize.init([]) == 0  # no settings yet: the prompt fills them
    saved = initialize.load_settings()
    assert (saved.sdaas_token, saved.sdaas_uri, saved.worker_name) == (
        "tok-1", "http://hive:9511", "w1")

    def refuse(prompt=""):
        raise AssertionError("prompted")

    monkeypatch.setattr(builtins, "input", refuse)
    assert initialize.init([]) == 0  # a token is set: no prompt
    assert initialize.init(["--silent"]) == 0
    assert initialize.load_settings().sdaas_token == "tok-1"
    path = initialize.settings_path()
    assert path.is_file()
    assert initialize.init(["--reset"]) == 0
    assert not path.is_file() and f"removed {path}" in capsys.readouterr().out
    assert initialize.init(["--silent"]) == 0  # silent with no settings: defaults, no prompt
    assert initialize.load_settings().sdaas_token == ""


def test_aux_models_soft_fail(trees, tmp_path, monkeypatch, capsys):
    """With the hive's catalog, an auxiliary model the catalog did not name
    and that is absent is a warning; the same name in --models fails the
    run."""
    _env(monkeypatch, trees, tmp_path / "sdaas")
    monkeypatch.setenv("CHIASWARM_SAFETY_CHECKER_MODEL", "CompVis/stable-diffusion-safety-checker")
    monkeypatch.setattr(initialize, "fetch_hive_model_list", lambda settings: [K3])
    assert initialize.init(["--silent", "--check"]) == 0
    out = capsys.readouterr().out
    assert f"check {K3}: ok" in out
    assert "check CompVis/stable-diffusion-safety-checker: FAILED" in out
    assert "(aux model; serving will flag degraded fallbacks)" in out
    assert "check guoyww/animatediff-motion-adapter-v1-5-2: skipped" in out
    assert initialize.init(["--silent", "--check", "--models",
                            "CompVis/stable-diffusion-safety-checker"]) == 1
    monkeypatch.setattr(initialize, "fetch_hive_model_list", lambda settings: [])
    assert initialize.init(["--silent", "--check"]) == 1


def test_catalog_and_aux_names_match_jax(monkeypatch):
    from chiaswarm_tpu_torch import hive

    catalog = [{"id": "a/b"}, {"model_name": "c/d"}, {"name": "e/f"}, {"other": 1}]

    async def jax_models(uri):
        assert uri == "http://hive:1/api"
        return catalog

    def port_models(uri):
        assert uri == "http://hive:1/api"
        return catalog

    monkeypatch.setattr(jax_init, "get_models", jax_models)
    monkeypatch.setattr(hive, "get_models", port_models)
    want = asyncio.run(jax_init.fetch_hive_model_list(JaxSettings(sdaas_uri="http://hive:1/")))
    assert initialize.fetch_hive_model_list(Settings(sdaas_uri="http://hive:1/")) == want
    for kw in ({}, {"depth_model": "", "safety_checker_model": "my/checker"}):
        assert initialize.aux_model_names(Settings(**kw)) == jax_init.aux_model_names(
            JaxSettings(**kw))


def test_download_model_with_a_stub_hub(tmp_path, monkeypatch):
    calls = []
    stub = types.ModuleType("huggingface_hub")

    def snapshot_download(repo_id, local_dir, allow_patterns):
        calls.append((repo_id, local_dir, allow_patterns))
        if repo_id == "bad/repo":
            raise OSError("unreachable")

    stub.snapshot_download = snapshot_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", stub)
    assert initialize.download_model("lllyasviel/Annotators", tmp_path)
    repo_id, local_dir, patterns = calls[-1]
    assert (repo_id, local_dir) == ("lllyasviel/Annotators",
                                    str(tmp_path / "lllyasviel/Annotators"))
    assert "*HED*.pth" in patterns and "*.safetensors" in patterns
    assert initialize.download_model(K3, tmp_path)
    assert "*HED*.pth" not in calls[-1][2]
    assert not initialize.download_model("bad/repo", tmp_path)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # not installed
    assert not initialize.download_model(K3, tmp_path)


def test_download_flag_runs_the_stub_for_every_name(tmp_path, monkeypatch, capsys):
    _env(monkeypatch, tmp_path / "models", tmp_path / "sdaas")
    fetched = []
    monkeypatch.setattr(initialize, "download_model",
                        lambda name, root: fetched.append(name) or name != "x/missing")
    assert initialize.init(["--silent", "--download", "--models", K3, "x/missing"]) == 1
    assert fetched == [K3, "x/missing"]
    out = capsys.readouterr().out
    assert f"download {K3}: ok" in out and "download x/missing: FAILED" in out
