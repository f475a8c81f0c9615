"""Drive chiaswarm_tpu_torch on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is printed as a result then):

1. Device probe: CUDA present, compute capability 9.0, and the card's
   name and power limit from nvidia-smi.
2. Kernel build: every source under chiaswarm_tpu_torch/csrc, one nvcc
   each, in parallel; the build is timed.
3. Kernels against their plain PyTorch versions at the shapes of the SDXL
   1024^2 main path, bf16 and f32, each within its stated bound; and
   attention at the edges of the kernels' tiles: query and KV lengths
   that are not multiples of a tile (Sq 1000 against Skv 77, 1000 and
   4095), a query shorter than one tile (Sq 40), and B*H > 1 at D = 512.
4. Small-input reference: the tiny SDXL-shaped pipeline in f32 on the card
   (kernels) against the same weights and latents on the CPU (plain
   versions); the decoded uint8 images must agree within 2/255.
5. Main path: a fake hive on localhost, the port's worker, and the
   full-width stabilityai/stable-diffusion-xl-base-1.0 pipeline on seeded
   random weights; three 1024^2 30-step DPM++ 2M txt2img jobs and one echo
   job are served. Every envelope is checked (sha256 of the artifact, a
   decodable image that is not constant, finite latents). The kernels'
   launch counts are reset just before and read just after.
6. Each kernel at every shape the main path launched it with: again held
   against its plain version, and timed (CUDA events) beside its plain
   version and one PyTorch library call computing the same function (for
   attention also replayed from a CUDA graph: the device's own time,
   without the host's launch cost), and its bound on the H100 (bytes over
   3.35 TB/s or operations over the peak of their type, whichever is
   larger), with the achieved TFLOP/s and the share of the bound reached.
   A kernel's bound per job is the sum over its shapes of each shape's
   bound times its launches per job.
7. The UNet (one call) and the VAE decode at the main path's shapes in
   bf16 through the kernels, against the same weights in f32 on the plain
   path: the relative RMS error may be at most 1.25x that of the plain
   path in bf16.
8. torch.profiler over a few UNet calls at the main path's shapes: device
   time by kernel category and the device's busy share.

The second-to-last lines are the `kernels` JSON object and the card's
name and power limit; the last line is the `{"ok": true, ...}` object.
`--detail PATH` also writes every measurement (per shape, per job, the
profile) to PATH as JSON.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import hashlib
import io
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SDXL = "stabilityai/stable-diffusion-xl-base-1.0"
N_JOBS = 3
STEPS = 30
SIZE = 1024

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances. Every kernel output is compared with the plain version run
# in f32 on the same inputs (for bf16, the bf16 values cast up).
# - f32: 2e-5, the bound of the JAX package's kernel tests
#   (tests/test_flash_attention.py, tests/test_group_norm.py).
# - bf16 attention, elementwise: the f32 bound plus bf16 roundings of
#   unit roundoff u = 2^-8: P rounded before P.V (at most u * P|v|, with
#   P the softmax weights), the row sum if it adds the rounded terms
#   (u * |o|) and the output's own rounding (u * |o|). On top of that the
#   RMS error must not exceed that of the plain version run in bf16, which
#   rounds at the same places and also rounds its logits: the kernel keeps
#   scores in f32, so it is at least as accurate. A lost or mis-masked KV
#   tile moves outputs by whole softmax terms, far past either line.
# - bf16 GroupNorm: the f32 bound plus one rounding of the output
#   (u * |y|); statistics and affine are f32 in the kernel.
U_BF16 = 2.0 ** -8
F32_TOL = 2e-5
GN_TOL = {torch.float32: (F32_TOL, F32_TOL), torch.bfloat16: (F32_TOL, F32_TOL + U_BF16)}
# the whole UNet / VAE decode in bf16 through the kernels, against the
# same modules in f32 on the plain path: relative RMS error at most this
# many times that of the plain path in bf16 (both round every matmul and
# conv to bf16 alike; the kernels only remove roundings)
E2E_RATIO = 1.25

KERNELS = {
    "flash_attention": {
        "source": "chiaswarm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "chiaswarm_tpu/ops/flash_attention.py:142",
    },
    "group_norm": {
        "source": "chiaswarm_tpu_torch/csrc/group_norm.cu",
        "replaces": "chiaswarm_tpu/ops/group_norm.py:97",
    },
}


def log(*args) -> None:
    print(*args, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --- phase 1 ---

def device_probe() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, the kernels need 9.0 (sm_90a)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[probe] {torch.cuda.get_device_name(0)} capability {cap}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


# --- timing and bounds ---

def time_ms(fn, min_total_ms: float = 30.0, max_iters: int = 50) -> float:
    """Mean device time of fn() over repeated launches (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max_iters, max(3, min_total_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Mean device time of fn() captured `launches` times in a CUDA graph
    and replayed: the kernel's own time, without the host's cost of
    launching it (which time_ms includes when a launch is shorter than the
    host's work per call)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def attention_work(q_shape, k_shape, dtype) -> tuple[float, float]:
    """(flops, bytes): q, k, v read once, the output written once."""
    b, sq, h, d = q_shape
    skv = k_shape[1]
    size = torch.tensor([], dtype=dtype).element_size()
    return 4.0 * b * h * sq * skv * d, size * (2 * b * sq * h * d + 2 * b * skv * h * d)


def gn_work(x_shape, dtype) -> tuple[float, float]:
    """(flops, bytes): about 10 f32 operations an element (statistics,
    normalisation, affine, SiLU); x and y once each, scale and bias."""
    numel = 1
    for s in x_shape:
        numel *= s
    size = torch.tensor([], dtype=dtype).element_size()
    return 10.0 * numel, 2 * numel * size + 2 * x_shape[-1] * size


def bound_fields(flops: float, nbytes: float, peak: float) -> dict:
    """ms for the operations at their type's peak and for the bytes at the
    memory rate; the shape's bound is the larger."""
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / HBM_BYTES_S
    return {"flops": flops, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


# --- the kernels against their plain versions ---

def rand(shape, dtype, gen, scale=1.0, shift=0.0):
    return (torch.randn(shape, device="cuda", generator=gen) * scale + shift).to(dtype)


def rms(t) -> float:
    return t.float().square().mean().sqrt().item()


def attention_case(q_shape, k_shape, dtype, gen, timed: bool) -> dict:
    import torch.nn.functional as F

    from chiaswarm_tpu_torch.ops.flash_attention import flash_attention, reference_attention

    q, k, v = rand(q_shape, dtype, gen), rand(k_shape, dtype, gen), rand(k_shape, dtype, gen)
    out = flash_attention(q, k, v).float()
    torch.cuda.synchronize()
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = reference_attention(qf, kf, vf)
    diff = (out - ref).abs()
    err = diff.max().item()
    row = {"q": list(q_shape), "kv": list(k_shape), "dtype": str(dtype)[6:],
           "max_abs_err": err}
    what = f"flash_attention {q_shape}x{k_shape} {dtype}"
    if dtype == torch.float32:
        row["bound"] = f"{F32_TOL:g}"
        check(err <= F32_TOL, f"{what}: err {err} > {F32_TOL}")
    else:
        bound = F32_TOL + U_BF16 * (2 * ref.abs() + reference_attention(qf, kf, vf.abs()))
        excess = (diff - bound).max().item()
        row["rms_err"], row["plain_rms_err"] = rms(diff), rms(reference_attention(q, k, v) - ref)
        row["bound"] = (f"2e-5 + 2^-8 (2|o| + P|v|), RMS <= plain bf16's "
                        f"{row['plain_rms_err']:.3g}")
        check(excess <= 0, f"{what}: err {err} beyond 2e-5 + 2^-8 (2|o| + P|v|) by {excess}")
        check(row["rms_err"] <= row["plain_rms_err"],
              f"{what}: RMS err {row['rms_err']} > plain bf16's {row['plain_rms_err']}")
    del diff, ref
    if timed:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row.update(
            ms=time_ms(lambda: flash_attention(q, k, v)),
            device_ms=graph_ms(lambda: flash_attention(q, k, v)),
            plain_ms=time_ms(lambda: reference_attention(q, k, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            library_device_ms=graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            **bound_fields(*attention_work(q_shape, k_shape, dtype), PEAK_FLOPS[dtype]))
    return row


def gn_case(x_shape, dtype, silu: bool, gen, timed: bool, eps: float = 1e-5) -> dict:
    import torch.nn.functional as F

    from chiaswarm_tpu_torch.ops.group_norm import fused_group_norm, reference_group_norm

    x = rand(x_shape, dtype, gen, 2.0, 0.3)
    scale, bias = rand(x_shape[-1:], dtype, gen), rand(x_shape[-1:], dtype, gen)
    out = fused_group_norm(x, scale, bias, 32, eps, silu)
    torch.cuda.synchronize()
    # as in the JAX test, the bound is against an f32 reference: the plain
    # version runs in f32 on the same inputs
    ref = reference_group_norm(x.float(), scale.float(), bias.float(), 32, eps, silu)
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    atol, rtol = GN_TOL[dtype]
    excess = (diff - (atol + rtol * ref.abs())).max().item()
    row = {"x": list(x_shape), "dtype": str(dtype)[6:], "silu": silu, "eps": eps,
           "max_abs_err": err, "bound": f"{atol:g} + {rtol:.4g} |y|"}
    check(excess <= 0, f"group_norm {x_shape} {dtype} eps {eps}: err {err} beyond "
                       f"{row['bound']} by {excess}")
    if timed:
        xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC rows

        def library():
            y = F.group_norm(xc, 32, scale, bias, eps)
            return F.silu(y) if silu else y

        row.update(
            ms=time_ms(lambda: fused_group_norm(x, scale, bias, 32, eps, silu)),
            plain_ms=time_ms(lambda: reference_group_norm(x, scale, bias, 32, eps, silu)),
            library_ms=time_ms(library),
            **bound_fields(*gn_work(x_shape, dtype), PEAK_FLOPS[torch.float32]))
    return row


def kernel_checks() -> None:
    """Phase 3: the shapes of the SDXL 1024^2 path (CFG batch 2), bf16,
    plus the JAX tests' f32 shapes and full-size f32 rows."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    attention = [
        ((2, 4096, 10, 64), (2, 4096, 10, 64), bf), ((2, 4096, 10, 64), (2, 77, 10, 64), bf),
        ((2, 1024, 20, 64), (2, 1024, 20, 64), bf), ((2, 1024, 20, 64), (2, 77, 20, 64), bf),
        ((1, 16384, 1, 512), (1, 16384, 1, 512), bf),
        # edges of the tiles (192 query rows and 128 KV rows at D = 64, 64
        # and 64 at D = 512): ragged lengths, a query shorter than a tile,
        # and more than one (batch, head) at D = 512
        ((2, 1000, 10, 64), (2, 77, 10, 64), bf), ((2, 1000, 10, 64), (2, 1000, 10, 64), bf),
        ((2, 1000, 10, 64), (2, 4095, 10, 64), bf), ((2, 40, 10, 64), (2, 77, 10, 64), bf),
        ((2, 40, 10, 64), (2, 4096, 10, 64), bf), ((2, 4096, 1, 512), (2, 4096, 1, 512), bf),
        ((1, 40, 1, 512), (1, 1000, 1, 512), bf),
        ((2, 256, 3, 32), (2, 256, 3, 32), f32), ((2, 256, 3, 32), (2, 77, 3, 32), f32),
        ((2, 130, 3, 32), (2, 256, 3, 32), f32), ((2, 64, 3, 32), (2, 64, 3, 32), f32),
        ((2, 1024, 10, 64), (2, 77, 10, 64), f32), ((1, 1024, 1, 512), (1, 1024, 1, 512), f32),
    ]
    for q_shape, k_shape, dtype in attention:
        row = attention_case(q_shape, k_shape, dtype, gen, timed=False)
        log(f"[check] flash_attention q{q_shape} kv{k_shape} {row['dtype']}: "
            f"max_abs_err {row['max_abs_err']:.3g}"
            + (f", RMS err {row['rms_err']:.3g}" if "rms_err" in row else "")
            + f" (bound {row['bound']})")
    norms = [((2, 128, 128, c), bf, True) for c in (320, 640)]
    norms += [((2, 64, 64, c), bf, True) for c in (640, 960, 1280, 1920)]
    norms += [((2, 32, 32, c), bf, True) for c in (1280, 1920, 2560)]
    norms += [((1, 1024, 1024, 128), bf, True), ((1, 128, 128, 512), bf, False),
              ((2, 8, 8, 64), f32, True), ((1, 16, 16, 96), f32, False),
              ((2, 64, 64, 640), f32, True), ((1, 1024, 1024, 128), f32, True)]
    for x_shape, dtype, silu in norms:
        row = gn_case(x_shape, dtype, silu, gen, timed=False)
        log(f"[check] group_norm x{x_shape} {row['dtype']} silu={silu}: max_abs_err "
            f"{row['max_abs_err']:.3g} (bound {row['bound']})")


# --- phase 4 ---

def tiny_reference_check(device: str = "cuda", size: int = 128) -> None:
    import numpy as np

    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline

    cpu = SDPipeline("test/tiny-xl", device="cpu")
    weights = {
        "unet": cpu.unet.state_dict(),
        "text": [e.state_dict() for e in cpu.text_encoders],
        "vae": cpu.vae.state_dict(),
    }
    card = SDPipeline("test/tiny-xl", device=device, dtype=torch.float32, weights=weights)
    lat = size // cpu.latent_factor
    latents = torch.randn((1, cpu.latent_channels, lat, lat),
                          generator=torch.Generator().manual_seed(7))
    kw = dict(num_inference_steps=4, height=size, width=size, latents=latents)
    want, _ = cpu.run("a red cube", **kw)
    got, config = card.run("a red cube", **kw)
    diff = np.abs(got[0].astype(np.int16) - want[0].astype(np.int16)).max()
    log(f"[tiny] test/tiny-xl {size}^2 f32, card (kernels) vs CPU (plain): max pixel "
        f"diff {diff}/255 (bound 2/255)")
    check(diff <= 2, f"tiny-xl card vs CPU pixel diff {diff} > 2")


# --- phase 5 ---

def decode_artifact(artifact: dict):
    import numpy as np
    from PIL import Image

    blob = base64.b64decode(artifact["blob"])
    check(hashlib.sha256(blob).hexdigest() == artifact["sha256_hash"], "artifact sha256 mismatch")
    image = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
    base64.b64decode(artifact["thumbnail"])
    return image


def serve_main_path(smi: str, device: str = "cuda", model: str = SDXL, size: int = SIZE,
                    steps: int = STEPS):
    from chiaswarm_tpu_torch.fake_hive import FakeHive
    from chiaswarm_tpu_torch.ops.flash_attention import COUNTER as FA_COUNTER
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER
    from chiaswarm_tpu_torch.registry import Registry
    from chiaswarm_tpu_torch.settings import Settings
    from chiaswarm_tpu_torch.worker import Worker

    hive = FakeHive(token="smoke-token")
    try:
        settings = Settings(sdaas_token="smoke-token", sdaas_uri=hive.uri,
                            worker_name="chip-smoke", model_root_dir=str(ROOT / ".no-models"))
        registry = Registry(torch.device(device), settings.model_root_dir)
        t0 = time.perf_counter()
        pipe = registry.get_pipeline(model, allow_random_init=True)
        log(f"[serve] {model} resident in {time.perf_counter() - t0:.1f}s "
            f"(seeded random weights, {pipe.dtype}); "
            f"{torch.cuda.memory_allocated() / 2**30 if device == 'cuda' else 0:.1f} GiB "
            "allocated")
        worker = Worker(settings=settings, device=device, registry=registry, poll_seconds=0.05)
        jobs = [{"id": f"txt2img-{i}", "workflow": "txt2img", "model_name": model,
                 "prompt": f"a lighthouse on a cliff at dusk, study {i}",
                 "negative_prompt": "blurry", "height": size, "width": size,
                 "num_inference_steps": steps, "guidance_scale": 7.0, "seed": 1000 + i,
                 "content_type": "image/png",
                 "parameters": {"scheduler_type": "DPMSolverMultistepScheduler"}}
                for i in range(N_JOBS)]
        jobs.append({"id": "echo-0", "workflow": "echo", "model_name": "none",
                     "prompt": "chip smoke"})
        hive.enqueue(*jobs)

        FA_COUNTER.reset()
        GN_COUNTER.reset()
        t0 = time.perf_counter()
        asyncio.run(worker.run(max_jobs=len(jobs)))
        served_s = time.perf_counter() - t0
        launches = {
            "flash_attention": (FA_COUNTER.launches, dict(FA_COUNTER.shapes)),
            "group_norm": (GN_COUNTER.launches, dict(GN_COUNTER.shapes)),
        }
        results = hive.wait_for_results(len(jobs), timeout=30)
        check(hive.auth_failures == 0, "the hive refused the worker's bearer token")
        poll = hive.polls[0]
        for key in ("worker_version", "worker_name", "gpu", "memory", "chips", "hbm_gb"):
            check(key in poll, f"capability advertisement lacks {key}")
    finally:
        hive.close()

    by_id = {r["id"]: r for r in results}
    served = {"served_s": served_s, "jobs": {}}
    check(set(by_id) == {j["id"] for j in jobs}, f"results for {sorted(by_id)}")
    for job in jobs:
        r = by_id[job["id"]]
        check(not r.get("fatal_error"), f"{job['id']}: fatal envelope {r['pipeline_config']}")
        check("error" not in r["pipeline_config"], f"{job['id']}: {r['pipeline_config']}")
        check(r["worker_version"] and "primary" in r["artifacts"], f"{job['id']}: envelope shape")
        image = decode_artifact(r["artifacts"]["primary"])
        cfg = r["pipeline_config"]
        if job["workflow"] == "echo":
            log(f"[serve] {job['id']}: echo envelope ok, image {image.shape}")
            continue
        check(image.shape == (size, size, 3), f"{job['id']}: image {image.shape}")
        check(int(image.max()) != int(image.min()), f"{job['id']}: constant image")
        check(cfg["latents"]["finite"], f"{job['id']}: non-finite latents")
        t = cfg["timings"]
        served["jobs"][job["id"]] = {"timings": t, "latents": cfg["latents"]}
        log(f"[serve] {job['id']} on {smi}: job {t['job_s']:.3f}s = text_encode "
            f"{t['text_encode_s']:.3f}s + denoise {t['denoise_s']:.3f}s "
            f"(UNet step {t['unet_step_ms']:.1f} ms at CFG batch 2) + decode "
            f"{t['decode_s']:.3f}s + artifacts {t['encode_artifacts_s']:.3f}s; "
            f"latents |max| {cfg['latents']['absmax']:.3g}; pixels "
            f"{int(image.min())}..{int(image.max())} mean {float(image.mean()):.1f}")
    counts = {k: v[0] for k, v in launches.items()}
    log(f"[serve] {len(jobs)} jobs served in {served_s:.1f}s; kernel launches during "
        f"the served jobs: {json.dumps(counts)}")
    for name, count in counts.items():
        check(count > 0, f"{name} was never launched on the main path")
    return launches, served, pipe


# --- phase 6 ---

def measure(launches: dict) -> tuple[list[dict], dict]:
    gen = torch.Generator(device="cuda").manual_seed(1)
    detail, summary = {}, []
    for name, (count, shapes) in launches.items():
        rows = []
        for key, n in sorted(shapes.items(), key=lambda kv: -kv[1]):
            if name == "flash_attention":
                q_shape, k_shape, dtype = key
                row = attention_case(tuple(q_shape), tuple(k_shape), dtype, gen, timed=True)
            else:
                x_shape, dtype, silu, eps = key
                row = gn_case(x_shape, getattr(torch, dtype), silu, gen, timed=True, eps=eps)
            row["launches_per_job"] = n / N_JOBS
            rows.append(row)
            row["tflops"] = row["flops"] / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            log(f"[measure] {name} {row.get('q', row.get('x'))}"
                f"{' kv' + str(row['kv']) if 'kv' in row else ''} {row['dtype']}"
                f"{' eps %g' % row['eps'] if 'eps' in row else ''}: "
                f"{n / N_JOBS:g}/job, kernel {row['ms']:.4f} ms"
                + (f" (device {row['device_ms']:.4f})" if "device_ms" in row else "")
                + f", plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms"
                + (f" (device {row['library_device_ms']:.4f})" if "library_device_ms" in row
                   else "")
                + f", bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), {row['tflops']:.1f} TFLOP/s, "
                f"{100 * row['share_of_bound']:.1f}% of bound, err {row['max_abs_err']:.3g}")

        def per_job(field, which=None):
            return sum(r[field] * r["launches_per_job"] for r in rows
                       if which is None or r["bound_by"] == which)

        # each shape's own bound (the larger of its two), summed over the
        # shapes; bound_by names the kind that makes up most of the sum
        by_ops, by_bytes = per_job("bound_ms", "operations"), per_job("bound_ms", "bytes")
        summary.append({
            "name": name, "route": "cuda", **KERNELS[name], "launches": count,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": per_job("ms"), "plain_ms": per_job("plain_ms"),
            "bound_ms": by_ops + by_bytes,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": per_job("library_ms"),
        })
        line = summary[-1]

        def device(field):
            return (f" (device {per_job(field):.1f})" if all(field in r for r in rows)
                    else "")

        log(f"[measure] {name} per job: kernel {line['ms']:.1f} ms{device('device_ms')}, "
            f"plain {line['plain_ms']:.1f} ms, library {line['library_ms']:.1f} ms"
            f"{device('library_device_ms')}, bound {line['bound_ms']:.1f} ms "
            f"({line['bound_by']}), {count / N_JOBS:g} launches")
        detail[name] = rows
    return summary, detail



# --- phases 7 and 8 ---

_CATEGORIES = (
    ("flash_attention kernel", ("flash_fwd",)),
    ("group_norm kernel", ("gn_stats", "gn_finalize", "gn_apply")),
    ("convolution (cuDNN)", ("fprop", "conv", "dgrad", "implicit", "winograd")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


def unet_inputs(pipe, size: int = SIZE, dtype=None, seed: int = 2):
    """(x, t, context, added_cond) for one UNet call at the main path's
    shapes: CFG batch 2, size/8 latents, 77 context tokens."""
    dev, cfg = pipe.device, pipe.unet.config
    dtype = dtype or pipe.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    lat = size // pipe.latent_factor
    x = randn(2, cfg.in_channels, lat, lat).contiguous(memory_format=torch.channels_last)
    t = torch.full((2,), 500.0, device=dev)
    ctx = randn(2, 77, cfg.cross_attention_dim)
    pooled = cfg.addition_embed_dim - 6 * cfg.addition_time_embed_dim
    added = {"text_embeds": randn(2, pooled),
             "time_ids": torch.tensor([[size, size, 0, 0, size, size]] * 2, device=dev,
                                      dtype=torch.float32)}
    return x, t, ctx, added


@contextmanager
def plain_path():
    """Route the UNet's and the VAE's attention and GroupNorm to the plain
    PyTorch versions, on the card, for the duration."""
    from chiaswarm_tpu_torch.models import layers, vae
    from chiaswarm_tpu_torch.ops.flash_attention import reference_attention
    from chiaswarm_tpu_torch.ops.group_norm import reference_group_norm

    def plain_group_norm(x, scale, bias, *, groups=32, eps=1e-5, act=None):
        return reference_group_norm(x, scale, bias, groups, eps, act == "silu")

    saved = layers.dot_product_attention, vae.dot_product_attention, layers.group_norm
    layers.dot_product_attention = vae.dot_product_attention = reference_attention
    layers.group_norm = plain_group_norm
    try:
        yield
    finally:
        layers.dot_product_attention, vae.dot_product_attention, layers.group_norm = saved


def end_to_end_bf16_check(pipe, size: int = SIZE) -> dict:
    """One UNet call and one VAE decode at the main path's shapes, in bf16
    through the kernels, against the same weights in f32 on the plain
    path; the plain path in bf16 gives the error bf16 itself makes."""
    import copy

    from chiaswarm_tpu_torch.device import synchronize

    check(pipe.dtype == torch.bfloat16, f"the main path runs {pipe.dtype}, not bf16")
    lat = size // pipe.latent_factor
    x, t, ctx, added = unet_inputs(pipe, size)
    z = torch.randn((1, pipe.latent_channels, lat, lat), device=pipe.device,
                    generator=torch.Generator(device=pipe.device).manual_seed(3))
    z = z.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    # the f32 reference sees the same bf16 input values, cast up
    up = {"text_embeds": added["text_embeds"].float(), "time_ids": added["time_ids"]}
    calls = (
        ("unet", pipe.unet, lambda m: m(x, t, ctx, added),
         lambda m: m(x.float(), t, ctx.float(), up)),
        ("vae_decode", pipe.vae, lambda m: m.decode(z), lambda m: m.decode(z.float())))
    result = {}
    for name, module, call, call_f32 in calls:
        with torch.inference_mode():
            kernels = call(module).float()
            with plain_path():
                plain = call(module).float()
                wide = copy.deepcopy(module).float()
                exact = call_f32(wide)
                del wide
            synchronize(pipe.device)
        scale = rms(exact)
        row = {"rel_rms_err": rms(kernels - exact) / scale,
               "plain_bf16_rel_rms_err": rms(plain - exact) / scale,
               "finite": bool(torch.isfinite(kernels).all())}
        del kernels, plain, exact
        torch.cuda.empty_cache()
        result[name] = row
        log(f"[e2e] {name} bf16 through the kernels vs f32 plain path: relative RMS err "
            f"{row['rel_rms_err']:.4g}; plain path in bf16: {row['plain_bf16_rel_rms_err']:.4g} "
            f"(bound {E2E_RATIO}x that)")
        check(row["finite"], f"{name}: non-finite output through the kernels")
        check(row["rel_rms_err"] <= E2E_RATIO * row["plain_bf16_rel_rms_err"],
              f"{name}: bf16 kernel path error {row['rel_rms_err']} > {E2E_RATIO} x the plain "
              f"bf16 path's {row['plain_bf16_rel_rms_err']}")
    return result


def profile_unet_step(pipe, size: int = SIZE, steps: int = 3) -> dict:
    """torch.profiler over a few UNet calls at the main path's shapes (CFG
    batch 2, size/8 latents): device time by kernel category and the
    device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from chiaswarm_tpu_torch.device import synchronize

    dev = pipe.device
    x, t, ctx, added = unet_inputs(pipe, size)
    with torch.inference_mode():
        pipe.unet(x, t, ctx, added_cond=added)
        synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                pipe.unet(x, t, ctx, added_cond=added)
            synchronize(dev)
            wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    by_kernel = {}
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(event, "self_cuda_time_total", 0)
        if device_us > 0 and getattr(event, "device_type", None) != torch.autograd.DeviceType.CPU:
            by_kernel[event.key] = by_kernel.get(event.key, 0.0) + device_us / 1e3 / steps
    categories = {name: 0.0 for name, _ in _CATEGORIES}
    categories["other (elementwise, norms, copies)"] = 0.0
    for name, ms in by_kernel.items():
        low = name.lower()
        for label, marks in _CATEGORIES:
            if any(m in low for m in marks):
                categories[label] += ms
                break
        else:
            categories["other (elementwise, norms, copies)"] += ms
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "categories_ms": categories, "top_kernels_ms": top}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--detail", help="write every measurement to this JSON file")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs the card",
              file=sys.stderr)
        return 1
    try:
        smi = device_probe()
        from chiaswarm_tpu_torch.device import set_precision
        from chiaswarm_tpu_torch.ops import _build

        set_precision()
        t0 = time.perf_counter()
        paths = _build.build()
        log(f"[build] {len(paths)} kernel libraries in {time.perf_counter() - t0:.1f}s: "
            + ", ".join(p.name for p in paths.values()))
        for name in paths:
            regs = [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
            log(f"[build] {name}: " + " | ".join(regs))
        kernel_checks()
        tiny_reference_check()
        launches, served, pipe = serve_main_path(smi)
        summary, shapes = measure(launches)
        e2e = end_to_end_bf16_check(pipe)
        step = profile_unet_step(pipe)
        if step["device_ms_per_step"] > 0:
            log(f"[profile] UNet step (CFG batch 2, {SIZE}^2) on {smi}: wall "
                f"{step['wall_ms_per_step']:.2f} ms, device busy "
                f"{step['device_ms_per_step']:.2f} ms ({100 * step['busy_share']:.1f}%)")
            for label, ms in step["categories_ms"].items():
                log(f"[profile]   {label}: {ms:.2f} ms")
            for name, ms in step["top_kernels_ms"]:
                log(f"[profile]   top kernel {ms:.3f} ms: {name[:110]}")
        else:
            log("[profile] the profiler saw no device kernels; device time not measured")
        if opts.detail:
            path = Path(opts.detail)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(
                {"card": smi, "served": served, "kernels": summary, "shapes": shapes,
                 "end_to_end_bf16": e2e, "unet_step_profile": step}, indent=1))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": summary}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
