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
   GroupNorm at the edges of its launch plan: rows that do not divide
   among the CTAs, B = 1 against B = 2 at the same N*C, groups that
   straddle an 8-channel vector (C = 320), every main-path call too large
   to stay on chip in bf16 and f32, eps 1e-6, a mean ten times the spread
   (held against the plain version evaluated in float64), and one input
   run 20 times with bit-identical outputs. The VAE encoder's calls that
   the decoder never makes, (1,512,512,128) and (1,256,256,256), and its
   attention, in bf16 and f32. Every attention and GroupNorm shape of the
   SD 1.x 512^2 and SD 2.x 768^2 UNet calls and of their VAE at those
   canvases (attention in bf16 and f32), and the tile edges at D = 40, 80
   and 160 (Sq 1000 against Skv 77, 1000 and 4095, Sq 40, B*H of 1). Every
   bf16 attention call at D = 40, 64, 80, 160 or 512 must report the
   tensor-core route, not the FMA kernel.
4. Small-input reference: the tiny SDXL-shaped pipeline in f32 on the card
   (kernels) against the same weights and latents on the CPU (plain
   versions); the decoded uint8 images must agree within 2/255. At 64^2:
   tiny-xl img2img, 4-channel inpaint and test/tiny-xl-inpaint (9
   channels), and one 4-step inpaint job for every ported solver wire
   name, with the same injected noise on both sides. For 4-channel
   inpaint on the card, the latents that reach the decode must equal the
   encoded clean latents bit for bit where the mask keeps the image.
   test/tiny-sd (SD 1.x / 2.x structure) and a tiny SD model whose
   scheduler config says v_prediction, card against CPU within 2/255.
5. Main path: a fake hive on localhost, the port's worker, and the
   full-width stabilityai/stable-diffusion-xl-base-1.0 pipeline on seeded
   random weights; three 1024^2 30-step DPM++ 2M txt2img jobs and one echo
   job are served. Every envelope is checked (sha256 of the artifact, a
   decodable image that is not constant, finite latents). The kernels'
   launch counts are reset just before and read just after.
   Then the image path: the counts are reset again, the 9-channel
   diffusers/stable-diffusion-xl-1.0-inpainting-0.1 is built beside the
   base model, and three 1024^2 30-step jobs whose start image (a smooth
   JPEG under the 3 MiB input cap) and half mask the fake hive serves:
   img2img (strength 0.75, Euler ancestral), 4-channel inpaint (strength
   1.0, DDIM) and 9-channel inpaint (UniPC). Each envelope is checked as
   above and for its mode; each job's launches are counted and held to
   its UNet calls times the UNet's launches per call (from the txt2img
   jobs) plus one VAE encode and one decode.
   Then the SD path, counted the same way (32 attention and 61 GroupNorm
   launches per UNet call): runwayml/stable-diffusion-v1-5 txt2img (DPM++
   2M) and img2img (Euler ancestral, strength 0.75) at 512^2, the
   9-channel runwayml/stable-diffusion-inpainting (UniPC) at 512^2, and
   stabilityai/stable-diffusion-2-1 txt2img at 768^2 with v-prediction
   (DPM++ 2M), all 30 steps on seeded random weights. No served bf16
   attention may take the FMA kernel.
6. Each kernel at every shape any path launched it with: again held
   against its plain version, and timed (CUDA events) beside its plain
   version and one PyTorch library call computing the same function, each
   also replayed from a CUDA graph (the device's own time, without the
   host's launch cost), the wrapper's host time per call (launched back
   to back, unsynchronised), and its bound on the H100 (bytes over
   3.35 TB/s or operations over the peak of their type, whichever is
   larger), with the achieved TFLOP/s and the share of the bound reached.
   A kernel's bound per job is the sum over its shapes of each shape's
   bound times its launches per job, for each kind of job.
7. The UNet (one call), the VAE decode and the VAE encode at the main
   path's shapes in bf16 through the kernels, against the same weights in
   f32 on the plain path: the relative RMS error may be at most 1.25x
   that of the plain path in bf16. The same for one SD 1.5 UNet call at
   512^2 and one SD 2.1 UNet call at 768^2.
8. A few UNet calls, one VAE decode and one VAE encode at the main path's
   shapes, and a few SD 1.5 and SD 2.1 UNet calls at theirs, timed by the
   host's clock and then under torch.profiler: device time and launches
   by kernel category (attention's share of the device time), the
   GroupNorm kernels one by one, and the device's busy share. Each
   GroupNorm call must be exactly one kernel launch.

The second-to-last lines are the `kernels` JSON object (per txt2img job,
as before; `launches` over every served job; `by_job` per job of each
kind) and the card's name and power limit; the last line is the
`{"ok": true, ...}` object.
`--detail PATH` also writes every measurement (per shape, per job, the
profile) to PATH as JSON. `--group-norm-only` runs phases 1 and 2, then
GroupNorm alone at the shapes of one UNet call and one VAE decode (its
launches per job counted from those calls: STEPS UNet calls and one
decode), and phase 8 without its one-launch check; it compares one tree's
GroupNorm kernel with another's in one call, and prints no result line.
`--attention-only` is its counterpart for attention: phases 1 and 2 (the
attention library alone), phase 3's attention checks, then phase 6 at
the shapes of one UNet call and one VAE decode of SDXL, SD 1.5 and SD
2.1 (per job: STEPS UNet calls and one decode); it runs on trees whose
wrapper reports no routes too.
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
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SDXL = "stabilityai/stable-diffusion-xl-base-1.0"
SDXL_INPAINT = "diffusers/stable-diffusion-xl-1.0-inpainting-0.1"
SD15 = "runwayml/stable-diffusion-v1-5"
SD15_INPAINT = "runwayml/stable-diffusion-inpainting"
SD21 = "stabilityai/stable-diffusion-2-1"
# a tiny SD model whose scheduler config (written by phase 4) says v_prediction
TINY_V = "test/tiny-sd-v"
# SD 1.x and SD 2.x at their canvases (phases 7 and 8)
SD_CANVASES = ((SD15, 512), (SD21, 768))
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


def host_ms(fn, calls: int = 200) -> float:
    """Mean host time of one call of fn, launched back to back with no
    synchronisation (fewer calls than the launch queue holds, so the host
    never waits for the card): the wrapper's own cost per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * elapsed / calls


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
    out, route = with_route(lambda: flash_attention(q, k, v))
    out = out.float()
    torch.cuda.synchronize()
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = reference_attention(qf, kf, vf)
    diff = (out - ref).abs()
    err = diff.max().item()
    row = {"q": list(q_shape), "kv": list(k_shape), "dtype": str(dtype)[6:],
           "max_abs_err": err, "route": route}
    what = f"flash_attention {q_shape}x{k_shape} {dtype}"
    check_tensor_core_route(route, dtype, q_shape[-1], what)
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
            host_ms=host_ms(lambda: flash_attention(q, k, v)),
            plain_ms=time_ms(lambda: reference_attention(q, k, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            library_device_ms=graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            **bound_fields(*attention_work(q_shape, k_shape, dtype), PEAK_FLOPS[dtype]))
    return row


def with_route(call) -> tuple:
    """(call(), the route that the kernel reported for that one launch),
    the route None for a tree whose wrapper does not report routes
    (`--attention-only` also measures such a tree, for comparison)."""
    from chiaswarm_tpu_torch.ops.flash_attention import COUNTER

    routes = getattr(COUNTER, "routes", None)
    if routes is None:
        return call(), None
    before = Counter(routes)
    out = call()
    new = Counter(routes) - before
    check(sum(new.values()) == 1, f"one call reported routes {dict(new)}")
    return out, next(iter(new))[0]


def check_tensor_core_route(route: str | None, dtype, d: int, what: str) -> None:
    """bf16 at a tensor-core head width must not take the FMA kernel."""
    from chiaswarm_tpu_torch.ops import flash_attention as fa

    if route is None:
        return
    if dtype == torch.bfloat16 and d in fa.TENSOR_CORE_WIDTHS:
        check(route == f"wgmma-d{d}", f"{what}: route {route}, not the tensor-core kernel")


def gn_plan_fields(x, silu: bool) -> dict:
    """The launch plan the wrapper takes for x: whether the call stays on
    chip (x read once) or reads part of x again. Empty for a tree whose
    wrapper has no plan (`--group-norm-only` also measures such a tree, the
    three-launch kernel, for comparison)."""
    import importlib

    # (the package's `group_norm` attribute is the function, not the module)
    gn = importlib.import_module("chiaswarm_tpu_torch.ops.group_norm")
    plan_of = getattr(gn, "launch_plan", None)
    if plan_of is None:
        return {}
    plan = plan_of(x, 32, silu)
    return {"on_chip": plan.on_chip, "grid": plan.grid, "rows_per_cta": plan.rows_per_cta,
            "keep_rows": plan.keep_rows, "smem_bytes": plan.smem_bytes}


def gn_case(x_shape, dtype, silu: bool, gen, timed: bool, eps: float = 1e-5,
            shift: float = 0.3, spread: float = 2.0, exact: bool = False) -> dict:
    """The kernel on x = shift + spread * randn against the plain version,
    which runs in f32 on the same inputs as in the JAX test (in float64
    with `exact`, for inputs whose f32 statistics the plain version itself
    loses to cancellation)."""
    import torch.nn.functional as F

    from chiaswarm_tpu_torch.ops.group_norm import fused_group_norm, reference_group_norm

    x = rand(x_shape, dtype, gen, spread, shift)
    scale, bias = rand(x_shape[-1:], dtype, gen), rand(x_shape[-1:], dtype, gen)
    out = fused_group_norm(x, scale, bias, 32, eps, silu)
    torch.cuda.synchronize()
    wide = torch.float64 if exact else torch.float32
    ref = reference_group_norm(x.to(wide), scale.to(wide), bias.to(wide), 32, eps, silu)
    diff = (out.to(wide) - ref).abs()
    err = diff.max().item()
    atol, rtol = GN_TOL[dtype]
    excess = (diff - (atol + rtol * ref.abs())).max().item()
    del diff, ref
    row = {"x": list(x_shape), "dtype": str(dtype)[6:], "silu": silu, "eps": eps,
           "max_abs_err": err, "bound": f"{atol:g} + {rtol:.4g} |y|",
           **gn_plan_fields(x, silu)}
    check(excess <= 0, f"group_norm {x_shape} {dtype} eps {eps}: err {err} beyond "
                       f"{row['bound']} by {excess}")
    if timed:
        xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC rows

        def kernel():
            return fused_group_norm(x, scale, bias, 32, eps, silu)

        def library():
            y = F.group_norm(xc, 32, scale, bias, eps)
            return F.silu(y) if silu else y

        row.update(
            ms=time_ms(kernel), device_ms=graph_ms(kernel), host_ms=host_ms(kernel),
            plain_ms=time_ms(lambda: reference_group_norm(x, scale, bias, 32, eps, silu)),
            library_ms=time_ms(library), library_device_ms=graph_ms(library),
            **bound_fields(*gn_work(x_shape, dtype), PEAK_FLOPS[torch.float32]))
    return row


def gn_repeat_check(x_shape, dtype, gen, runs: int = 20) -> None:
    """One input through the kernel `runs` times: the outputs must be equal
    bit for bit (a racy grid barrier, or a reduction whose order moves from
    call to call, shows here)."""
    from chiaswarm_tpu_torch.ops.group_norm import fused_group_norm

    x = rand(x_shape, dtype, gen, 2.0, 0.3)
    scale, bias = rand(x_shape[-1:], dtype, gen), rand(x_shape[-1:], dtype, gen)
    first = fused_group_norm(x, scale, bias, 32, 1e-5, True)
    differ = sum(not torch.equal(fused_group_norm(x, scale, bias, 32, 1e-5, True), first)
                 for _ in range(runs - 1))
    log(f"[check] group_norm x{x_shape} {str(dtype)[6:]}: {runs} runs of one input, "
        f"{differ} differ from the first bit for bit {gn_plan_fields(x, True)}")
    check(differ == 0, f"group_norm {x_shape} {dtype}: {differ} of {runs} runs differ")


# The attention of each served model's UNet, by level: (channels,
# transformer layers, heads) per level, the mid block's layers, and the
# canvas. Plain numbers, not the package's configs, so that
# `--attention-only` runs on trees that lack a model.
UNET_ATTENTION = {
    "sdxl": ((320, 640, 1280), (0, 2, 10), (5, 10, 20), 10, 1024),
    "sd15": ((320, 640, 1280, 1280), (1, 1, 1, 0), (8, 8, 8, 8), 1, 512),
    "sd21": ((320, 640, 1280, 1280), (1, 1, 1, 0), (5, 10, 20, 20), 1, 768),
}


def attention_shapes(model: str) -> Counter:
    """{(q shape, kv shape, dtype): launches} of one bf16 UNet call of
    `model` (CFG batch 2, 77 context tokens, two resnets a down block and
    three an up block, each with its transformer, every transformer layer
    one self- and one cross-attention)."""
    channels, layers, heads, mid, size = UNET_ATTENTION[model]
    shapes = Counter()
    side = size // 8
    for level, (ch, n, h) in enumerate(zip(channels, layers, heads)):
        q = (2, (side >> level) ** 2, h, ch // h)
        calls = n * 5 + (mid if level == len(channels) - 1 else 0)
        if calls:
            shapes[(q, q, torch.bfloat16)] += calls
            shapes[(q, (2, 77, h, ch // h), torch.bfloat16)] += calls
    return shapes


def vae_attention_shape(model: str) -> tuple:
    """The VAE mid block's single 512-wide head at `model`'s canvas."""
    q = (1, (UNET_ATTENTION[model][-1] // 8) ** 2, 1, 512)
    return q, q, torch.bfloat16


# every GroupNorm call of the SD 1.x 512^2 UNet, the SD 2.x 768^2 UNet and
# their VAE's decoder and encoder at 512^2 and 768^2: (x, silu, eps)
SD_NORMS = [
    ((2, s, s, c), True, 1e-5) for s, c in (
        (64, 320), (32, 320), (32, 640), (16, 640), (16, 1280), (8, 1280), (8, 2560),
        (16, 2560), (16, 1920), (32, 1920), (32, 1280), (32, 960), (64, 960), (64, 640),
        (96, 320), (48, 320), (48, 640), (24, 640), (24, 1280), (12, 1280), (12, 2560),
        (24, 2560), (24, 1920), (48, 1920), (48, 1280), (48, 960), (96, 960), (96, 640))
] + [
    ((2, s, s, c), False, 1e-6) for s, c in (
        (64, 320), (32, 640), (16, 1280), (8, 1280), (96, 320), (48, 640), (24, 1280),
        (12, 1280))
] + [
    ((1, s, s, c), True, 1e-6) for s, c in (
        (64, 512), (128, 512), (256, 512), (256, 256), (512, 256), (512, 128), (256, 128),
        (128, 256), (96, 512), (192, 512), (384, 512), (384, 256), (768, 256), (768, 128),
        (384, 128), (192, 256))
] + [((1, 64, 64, 512), False, 1e-6), ((1, 96, 96, 512), False, 1e-6)]


def attention_checks(gen) -> None:
    """Phase 3 for attention: the shapes of the SDXL 1024^2 path (CFG
    batch 2), bf16, plus the JAX tests' f32 shapes and full-size f32 rows;
    every shape of the SD 1.x 512^2 and SD 2.x 768^2 UNet calls and VAE
    decodes in bf16 and f32; and the edges of the tiles at every
    tensor-core head width. Each bf16 call at such a width must report the
    tensor-core route."""
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
        # the VAE encoder's mid-block attention (the decoder's shape) in f32
        ((1, 16384, 1, 512), (1, 16384, 1, 512), f32),
        ((2, 256, 3, 32), (2, 256, 3, 32), f32), ((2, 256, 3, 32), (2, 77, 3, 32), f32),
        ((2, 130, 3, 32), (2, 256, 3, 32), f32), ((2, 64, 3, 32), (2, 64, 3, 32), f32),
        ((2, 1024, 10, 64), (2, 77, 10, 64), f32), ((1, 1024, 1, 512), (1, 1024, 1, 512), f32),
    ]
    for model in ("sd15", "sd21"):
        for q_shape, k_shape, _ in (*attention_shapes(model), vae_attention_shape(model)):
            attention += [(q_shape, k_shape, bf), (q_shape, k_shape, f32)]
    # edges at D = 40, 80 and 160 (192 query rows and 128 KV rows at 40, 128
    # and 128 at 80, 128 and 64 at 160): query and KV lengths that are not
    # multiples of a tile, 77 KV rows, a query shorter than 64 rows, and
    # B*H of 1
    for d in (40, 80, 160):
        attention += [((2, 1000, 8, d), (2, 77, 8, d), bf), ((2, 1000, 8, d), (2, 1000, 8, d), bf),
                      ((2, 1000, 8, d), (2, 4095, 8, d), bf), ((2, 40, 8, d), (2, 77, 8, d), bf),
                      ((2, 40, 8, d), (2, 4096, 8, d), bf), ((1, 40, 1, d), (1, 1000, 1, d), bf),
                      ((1, 200, 1, d), (1, 77, 1, d), f32)]
    for q_shape, k_shape, dtype in attention:
        row = attention_case(q_shape, k_shape, dtype, gen, timed=False)
        log(f"[check] flash_attention q{q_shape} kv{k_shape} {row['dtype']} route {row['route']}: "
            f"max_abs_err {row['max_abs_err']:.3g}"
            + (f", RMS err {row['rms_err']:.3g}" if "rms_err" in row else "")
            + f" (bound {row['bound']})")


def kernel_checks() -> None:
    """Phase 3: attention (attention_checks), and GroupNorm at the shapes
    of the served paths and the edges of its launch plan."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    attention_checks(gen)
    norms = [((2, 128, 128, c), bf, True) for c in (320, 640)]
    norms += [((2, 64, 64, c), bf, True) for c in (640, 960, 1280, 1920)]
    norms += [((2, 32, 32, c), bf, True) for c in (1280, 1920, 2560)]
    norms += [((1, 1024, 1024, 128), bf, True), ((1, 128, 128, 512), bf, False),
              ((2, 8, 8, 64), f32, True), ((1, 16, 16, 96), f32, False),
              ((2, 64, 64, 640), f32, True), ((1, 1024, 1024, 128), f32, True)]
    norms = [(*n, 1e-5) for n in norms]
    # edges of the launch plan: rows that do not divide among the CTAs; B = 1
    # against B = 2 at the same N*C (a CTA's rows straddle two batch rows
    # only in the second); groups straddling an 8-channel vector in f32;
    # the main-path calls too large to stay on chip, in bf16 and f32; eps 1e-6
    norms += [((2, 33, 31, 640), bf, True, 1e-5), ((2, 33, 31, 640), f32, False, 1e-5),
              ((1, 64, 128, 640), bf, True, 1e-5), ((2, 64, 64, 640), bf, True, 1e-5),
              ((2, 40, 40, 320), f32, True, 1e-5), ((2, 32, 32, 2560), f32, True, 1e-5),
              ((2, 64, 64, 1920), f32, True, 1e-5), ((2, 128, 128, 960), bf, True, 1e-5),
              ((2, 128, 128, 960), f32, True, 1e-5), ((2, 128, 128, 320), f32, True, 1e-5),
              ((2, 64, 64, 640), bf, False, 1e-6), ((1, 256, 256, 512), bf, True, 1e-6)]
    # the VAE encoder's calls that the decoder never makes (both too large
    # to stay on chip)
    norms += [(shape, dtype, True, 1e-6) for shape in ((1, 512, 512, 128), (1, 256, 256, 256))
              for dtype in (bf, f32)]
    # every call of the SD 1.x 512^2 and SD 2.x 768^2 UNets (CFG batch 2) and
    # of their VAE's decoder and encoder at those canvases, in bf16; in f32
    # the one UNet call too large to stay on chip and two VAE calls
    norms += [(shape, bf, silu, eps) for shape, silu, eps in SD_NORMS]
    norms += [((2, 96, 96, 960), f32, True, 1e-5), ((1, 768, 768, 128), f32, True, 1e-6),
              ((1, 96, 96, 512), f32, False, 1e-6)]
    for x_shape, dtype, silu, eps in norms:
        row = gn_case(x_shape, dtype, silu, gen, timed=False, eps=eps)
        log(f"[check] group_norm x{x_shape} {row['dtype']} silu={silu} eps {eps:g}: max_abs_err "
            f"{row['max_abs_err']:.3g} (bound {row['bound']})"
            + (f", on chip: {row['on_chip']}" if "on_chip" in row else ""))
    # a mean ten times the spread: E[x^2] - mean^2 cancels two digits, and an
    # f32 sum of the CTAs' partials would leave the bound; the kernel's
    # double finalize holds it. (At 500 times, as x = 50 + 0.1 randn, the
    # f32 statistics that the function keeps lose the variance in any
    # order of summation, so no f32 version, the plain one included, can
    # be held to the bound there.)
    row = gn_case((1, 512, 512, 256), f32, True, gen, timed=False, shift=10.0, spread=1.0,
                  exact=True)
    log(f"[check] group_norm x(1, 512, 512, 256) f32 = 10 + randn against the plain version "
        f"in float64: max_abs_err {row['max_abs_err']:.3g} (bound {row['bound']})")
    gn_repeat_check((2, 64, 64, 640), bf, gen)
    gn_repeat_check((2, 128, 128, 640), bf, gen)


# --- phase 4 ---

def tiny_reference_check(device: str = "cuda", size: int = 128, model: str = "test/tiny-xl",
                         model_root_dir: str | None = None,
                         prediction_type: str = "epsilon") -> int:
    """Phase 4: `model` in f32 on `device` (the kernels on the card)
    against the same weights and latents on the CPU (plain versions),
    both reading the scheduler config under `model_root_dir`; the
    pipelines must denoise with `prediction_type`. -> max pixel diff."""
    import numpy as np

    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline

    cpu = SDPipeline(model, device="cpu", model_root_dir=model_root_dir)
    weights = {
        "unet": cpu.unet.state_dict(),
        "text": [e.state_dict() for e in cpu.text_encoders],
        "vae": cpu.vae.state_dict(),
    }
    card = SDPipeline(model, device=device, dtype=torch.float32, weights=weights,
                      model_root_dir=model_root_dir)
    check(cpu.prediction_type == card.prediction_type == prediction_type,
          f"{model}: prediction types {cpu.prediction_type}, {card.prediction_type}, not "
          f"{prediction_type}")
    lat = size // cpu.latent_factor
    latents = torch.randn((1, cpu.latent_channels, lat, lat),
                          generator=torch.Generator().manual_seed(7))
    kw = dict(num_inference_steps=4, height=size, width=size, latents=latents)
    want, _ = cpu.run("a red cube", **kw)
    got, config = card.run("a red cube", **kw)
    diff = int(np.abs(got[0].astype(np.int16) - want[0].astype(np.int16)).max())
    log(f"[tiny] {model} ({prediction_type}) {size}^2 f32, card (kernels) vs CPU (plain): "
        f"max pixel diff {diff}/255 (bound 2/255)")
    check(diff <= 2, f"{model} card vs CPU pixel diff {diff} > 2")
    return diff


def tiny_sd_checks(device: str = "cuda", size: int = 128) -> dict:
    """Phase 4 for SD 1.x / 2.x structure: test/tiny-sd, and a tiny SD model
    whose checkpoint's scheduler config says v_prediction (written to a
    temporary model root), each on `device` against the CPU."""
    import tempfile

    result = {"test/tiny-sd": tiny_reference_check(device, size, "test/tiny-sd")}
    with tempfile.TemporaryDirectory() as root:
        config = Path(root) / TINY_V / "scheduler"
        config.mkdir(parents=True)
        (config / "scheduler_config.json").write_text('{"prediction_type": "v_prediction"}')
        result[TINY_V] = tiny_reference_check(device, size, TINY_V, root, "v_prediction")
    return result


def start_image(size: int):
    """A smooth procedural RGB image (compresses far under the 3 MiB input
    cap at 1024^2, unlike noise)."""
    import numpy as np
    from PIL import Image

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    rgb = np.stack([0.5 + 0.5 * np.sin(6.0 * xx + 2.0 * yy),
                    0.5 + 0.5 * np.cos(4.0 * yy - 3.0 * xx),
                    0.25 + 0.5 * xx * yy], axis=-1)
    return Image.fromarray((255 * rgb).astype(np.uint8))


def half_mask(size: int):
    """White (repaint) over the right half, black (keep) over the left."""
    from PIL import Image

    mask = Image.new("L", (size, size), 0)
    mask.paste(255, (size // 2, 0, size, size))
    return mask


def image_bytes(image, fmt: str) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def tiny_image_checks(device: str = "cuda", size: int = 64, steps: int = 4) -> dict:
    """Phase 4 for the image modes: the tiny pipelines in f32 on `device`
    against the same weights on the CPU, with the same initial latents and
    injected step and keep noise; every ported solver wire name runs one
    4-channel inpaint job. On `device`, each 4-channel inpaint job's
    latents that reach the decode must equal the encoded clean latents bit
    for bit where the mask keeps the image (captured by wrapping the
    pipeline's encode_image and decode)."""
    import numpy as np

    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline, _mask_to_latent_array
    from chiaswarm_tpu_torch.schedulers import SCHEDULERS

    pairs = {}
    for model in ("test/tiny-xl", "test/tiny-xl-inpaint"):
        cpu = SDPipeline(model, device="cpu")
        weights = {"unet": cpu.unet.state_dict(),
                   "text": [e.state_dict() for e in cpu.text_encoders],
                   "vae": cpu.vae.state_dict()}
        pairs[model] = (cpu, SDPipeline(model, device=device, dtype=torch.float32,
                                        weights=weights))
    lat = size // pairs["test/tiny-xl"][0].latent_factor
    latents = torch.randn((1, 4, lat, lat), generator=torch.Generator().manual_seed(7))

    def noise_fn(kind, i, shape):
        seed = 1000 * (kind == "keep") + i
        return torch.randn(shape, generator=torch.Generator().manual_seed(seed))

    image, mask = start_image(size), half_mask(size)
    common = dict(prompt="a red cube", num_inference_steps=steps, latents=latents,
                  noise_fn=noise_fn, image=image)
    jobs = [("img2img", "test/tiny-xl",
             dict(scheduler_type="EulerAncestralDiscreteScheduler", strength=0.75)),
            ("inpaint", "test/tiny-xl",
             dict(scheduler_type="DPMSolverMultistepScheduler", mask_image=mask)),
            ("inpaint9", "test/tiny-xl-inpaint",
             dict(scheduler_type="UniPCMultistepScheduler", mask_image=mask))]
    jobs += [("inpaint", "test/tiny-xl", dict(scheduler_type=name, mask_image=mask,
                                              strength=0.6))
             for name in SCHEDULERS]
    captured = {}

    def capture(name, fn):
        """fn, recording what it returns ("clean") or its input ("final")."""
        def wrapped(*args):
            out = fn(*args)
            captured[name] = out if name == "clean" else args[0]
            return out
        return wrapped

    result = {}
    for mode, model, job in jobs:
        cpu, card = pairs[model]
        captured.clear()
        if mode == "inpaint":
            card.encode_image = capture("clean", card.encode_image)
            card.decode = capture("final", card.decode)
        try:
            want, _ = cpu.run(**common, **job)
            got, config = card.run(**common, **job)
        finally:
            card.__dict__.pop("encode_image", None)
            card.__dict__.pop("decode", None)
        what = f"{model} {mode} {job['scheduler_type']} strength {job.get('strength', 0.75)}"
        diff = int(np.abs(got[0].astype(np.int16) - want[0].astype(np.int16)).max())
        row = {"mode": config["mode"], "max_pixel_diff": diff}
        check(config["mode"] == mode, f"{what}: mode {config['mode']}")
        check(diff <= 2, f"{what}: card vs CPU pixel diff {diff} > 2")
        if mode == "inpaint":
            clean, final = captured["clean"].expand_as(captured["final"]), captured["final"]
            factor = size // lat
            keep = torch.from_numpy(_mask_to_latent_array(mask, size, size, factor)[..., 0] == 0)
            keep = keep.to(final.device).expand_as(final)
            row["kept_equal"] = bool(torch.equal(final[keep], clean[keep]))
            row["kept_values"] = int(keep.sum())
            check(row["kept_values"] > 0 and row["kept_equal"],
                  f"{what}: the kept latents differ from the clean latents on {device}")
            check(not torch.equal(final[~keep], clean[~keep]),
                  f"{what}: the repainted latents equal the clean latents")
        result[what] = row
        log(f"[tiny] {what} {size}^2 f32, {device} vs CPU: max pixel diff {diff}/255 "
            f"(bound 2/255)" + (f"; kept latents equal the clean latents bit for bit "
                                f"({row['kept_values']} values)" if "kept_equal" in row else ""))
    return result


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
                    steps: int = STEPS, registry=None):
    """The txt2img jobs and the echo job -> ({kernel: (launches, {shape:
    launches})}, served, registry)."""
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
        registry = registry or Registry(torch.device(device), settings.model_root_dir)
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
        routes = dict(FA_COUNTER.routes)
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
    fma = {k: n for k, n in routes.items() if k[0] == "fma" and k[1] == torch.bfloat16}
    check(not fma, f"bf16 attention took the FMA kernel on the main path: {fma}")
    return launches, served, registry


# kernel launches of one VAE encode and one VAE decode (one attention
# call and 22 or 30 GroupNorm calls each, at any canvas)
ENCODE_LAUNCHES = {"flash_attention": 1, "group_norm": 22}
DECODE_LAUNCHES = {"flash_attention": 1, "group_norm": 30}


def _snapshot(counters: dict) -> dict:
    return {name: (c.launches, Counter(c.shapes)) for name, c in counters.items()}


def serve_counted(smi: str, registry, jobs: list, per_call: dict, device: str = "cuda",
                  tag: str = "image", where: str = "image path") -> tuple[dict, dict]:
    """Serve `jobs` [(kind, mode, job)] one at a time through the worker;
    a job's `start_image_uri` / `mask_image_uri` of "start" / "mask" is
    replaced by the smooth start image / half mask at the job's size,
    served by the fake hive. Each job's kernel launches are counted and
    held to its UNet calls x `per_call`[its model] {kernel: launches per
    UNet call} plus one VAE encode (a job with a start image) and one
    decode; no bf16 attention may take the FMA kernel ->
    ({kind: (1, {kernel: (launches, {shape: launches})})}, served)."""
    from chiaswarm_tpu_torch.external_resources import LIMITS
    from chiaswarm_tpu_torch.fake_hive import FakeHive
    from chiaswarm_tpu_torch.ops.flash_attention import COUNTER as FA_COUNTER
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER
    from chiaswarm_tpu_torch.settings import Settings
    from chiaswarm_tpu_torch.worker import Worker

    counters = {"flash_attention": FA_COUNTER, "group_norm": GN_COUNTER}
    hive = FakeHive(token="smoke-token")
    try:
        served_files = {}

        def served_uri(which: str, size: int) -> str:
            if (which, size) not in served_files:
                if which == "start":
                    data = image_bytes(start_image(size), "JPEG")
                    check(len(data) < LIMITS.max_bytes,
                          f"start image {len(data)} bytes over the input cap")
                    uri = hive.enqueue_file(f"start-{size}.jpg", data, "image/jpeg")
                else:
                    uri = hive.enqueue_file(f"mask-{size}.png",
                                            image_bytes(half_mask(size), "PNG"), "image/png")
                served_files[(which, size)] = uri
            return served_files[(which, size)]

        settings = Settings(sdaas_token="smoke-token", sdaas_uri=hive.uri,
                            worker_name="chip-smoke", model_root_dir=registry.model_root_dir)
        worker = Worker(settings=settings, device=device, registry=registry, poll_seconds=0.05)
        FA_COUNTER.reset()
        GN_COUNTER.reset()
        paths, before = {}, _snapshot(counters)
        t0 = time.perf_counter()
        for k, (kind, _, job) in enumerate(jobs):
            job = dict(job)
            for key in ("start_image_uri", "mask_image_uri"):
                if key in job:
                    job[key] = served_uri(job[key], job["height"])
            hive.enqueue(job)
            asyncio.run(worker.run(max_jobs=k + 1))
            after = _snapshot(counters)
            paths[kind] = (1, {name: (after[name][0] - before[name][0],
                                      after[name][1] - before[name][1]) for name in counters})
            before = after
        served_s = time.perf_counter() - t0
        routes = dict(getattr(FA_COUNTER, "routes", {}))
        results = hive.wait_for_results(len(jobs), timeout=30)
        check(hive.auth_failures == 0, "the hive refused the worker's bearer token")
    finally:
        hive.close()

    by_id = {r["id"]: r for r in results}
    served = {"served_s": served_s, "jobs": {}, "routes": {str(k): n for k, n in routes.items()}}
    for kind, mode, job in jobs:
        r = by_id[job["id"]]
        check(not r.get("fatal_error"), f"{job['id']}: fatal envelope {r['pipeline_config']}")
        check("error" not in r["pipeline_config"], f"{job['id']}: {r['pipeline_config']}")
        image = decode_artifact(r["artifacts"]["primary"])
        cfg, t = r["pipeline_config"], r["pipeline_config"]["timings"]
        size = job["height"]
        check(cfg["mode"] == mode, f"{job['id']}: mode {cfg['mode']}, not {mode}")
        check(image.shape == (size, size, 3), f"{job['id']}: image {image.shape}")
        check(int(image.max()) != int(image.min()), f"{job['id']}: constant image")
        check(cfg["latents"]["finite"], f"{job['id']}: non-finite latents")
        unet_calls = job["num_inference_steps"] - cfg.get("t_start", 0)
        counted = {name: launches for name, (launches, _) in paths[kind][1].items()}
        encodes = int("start_image_uri" in job)
        predicted = {name: unet_calls * per_call[job["model_name"]][name]
                     + encodes * ENCODE_LAUNCHES[name] + DECODE_LAUNCHES[name]
                     for name in counted}
        served["jobs"][job["id"]] = {"kind": kind, "mode": cfg["mode"], "model": cfg["model"],
                                     "size": size, "timings": t, "latents": cfg["latents"],
                                     "unet_calls": unet_calls, "launches": counted,
                                     "predicted_launches": predicted}
        log(f"[{tag}] {job['id']} ({cfg['mode']}, {cfg['scheduler']}, {cfg['model']}, "
            f"{size}^2) on {smi}: job {t['job_s']:.3f}s = text_encode "
            f"{t['text_encode_s']:.3f}s"
            + (f" + image_encode {t['image_encode_s']:.3f}s" if "image_encode_s" in t else "")
            + f" + denoise {t['denoise_s']:.3f}s ({unet_calls} UNet calls, step "
            f"{t['unet_step_ms']:.1f} ms at CFG batch 2) + decode {t['decode_s']:.3f}s + "
            f"artifacts {t['encode_artifacts_s']:.3f}s; latents |max| "
            f"{cfg['latents']['absmax']:.3g}; pixels {int(image.min())}..{int(image.max())} "
            f"mean {float(image.mean()):.1f}")
        log(f"[{tag}] {job['id']} kernel launches: counted {json.dumps(counted)}, predicted "
            f"{json.dumps(predicted)} ({unet_calls} UNet calls x "
            f"{json.dumps(per_call[job['model_name']])}"
            + (" + one encode" if encodes else "") + " + one decode)")
    log(f"[{tag}] {len(jobs)} jobs served in {served_s:.1f}s; attention routes "
        + json.dumps({f"{r} {str(dt)[6:]} D={d}": n for (r, dt, d), n in routes.items()}))
    for job_id, job in served["jobs"].items():
        for name, count in job["launches"].items():
            check(count > 0, f"{name} was never launched on the {where}")
        check(job["launches"] == job["predicted_launches"],
              f"{job_id}: launches {job['launches']} != predicted {job['predicted_launches']}")
    fma = {k: n for k, n in routes.items() if k[0] == "fma" and k[1] == torch.bfloat16}
    check(not fma, f"bf16 attention took the FMA kernel on the {where}: {fma}")
    return paths, served


def serve_image_path(smi: str, registry, unet_launches: dict, device: str = "cuda",
                     model: str = SDXL, inpaint_model: str = SDXL_INPAINT, size: int = SIZE,
                     steps: int = STEPS) -> tuple[dict, dict]:
    """Phase 5, image path: img2img, 4-channel inpaint and 9-channel inpaint
    through the worker, their start image and mask served by the fake hive.
    `unet_launches` {kernel: launches per UNet call} predicts each job's
    launches -> ({job kind: (1, {kernel: (launches, {shape: launches})})},
    served)."""
    t0 = time.perf_counter()
    registry.get_pipeline(inpaint_model, allow_random_init=True)
    log(f"[image] {inpaint_model} resident in {time.perf_counter() - t0:.1f}s beside "
        f"{model}; {torch.cuda.memory_allocated() / 2**30 if device == 'cuda' else 0:.1f} "
        "GiB allocated")
    common = {"prompt": "a lighthouse on a cliff at dusk, repainted",
              "negative_prompt": "blurry", "height": size, "width": size,
              "num_inference_steps": steps, "guidance_scale": 7.0,
              "content_type": "image/png", "start_image_uri": "start"}
    jobs = [
        ("img2img", "img2img", {**common, "id": "img2img-0", "workflow": "img2img",
                                "model_name": model, "strength": 0.75, "seed": 2000,
                                "parameters": {"scheduler_type": "EulerAncestralDiscreteScheduler",
                                               "large_model": True}}),
        ("inpaint", "inpaint", {**common, "id": "inpaint-0", "workflow": "inpaint",
                                "model_name": model, "strength": 1.0, "seed": 2001,
                                "mask_image_uri": "mask",
                                "parameters": {"scheduler_type": "DDIMScheduler",
                                               "large_model": True}}),
        ("inpaint9", "inpaint9", {**common, "id": "inpaint9-0", "workflow": "inpaint",
                                  "model_name": inpaint_model, "seed": 2002,
                                  "mask_image_uri": "mask",
                                  "parameters": {"scheduler_type": "UniPCMultistepScheduler",
                                                 "large_model": True}}),
    ]
    return serve_counted(smi, registry, jobs, {model: unet_launches,
                                               inpaint_model: unet_launches}, device)


# kernel launches of one SD 1.x or SD 2.x UNet call: 32 attention (16
# transformer layers, one self- and one cross-attention each) and 61
# GroupNorm
SD_UNET_LAUNCHES = {"flash_attention": 32, "group_norm": 61}


def serve_sd_path(smi: str, registry, device: str = "cuda", sd15: str = SD15,
                  sd15_inpaint: str = SD15_INPAINT, sd21: str = SD21, size15: int = 512,
                  size21: int = 768, steps: int = STEPS) -> tuple[dict, dict]:
    """Phase 5, SD 1.x and SD 2.x at their published widths and canvases:
    SD 1.5 txt2img (DPM++ 2M) and img2img (Euler ancestral, strength
    0.75), the 9-channel SD 1.5 inpainting checkpoint (UniPC), and SD 2.1
    txt2img at 768^2 with v-prediction (DPM++ 2M), each through the worker
    with its launches counted (SD_UNET_LAUNCHES per UNet call)."""
    t0 = time.perf_counter()
    for model in (sd15, sd15_inpaint, sd21):
        registry.get_pipeline(model, allow_random_init=True)
    pipe21 = registry.get_pipeline(sd21)
    log(f"[sd] {sd15}, {sd15_inpaint} and {sd21} resident in {time.perf_counter() - t0:.1f}s "
        f"(seeded random weights, {pipe21.dtype}); "
        f"{torch.cuda.memory_allocated() / 2**30 if device == 'cuda' else 0:.1f} GiB allocated")
    check(pipe21.prediction_type == "v_prediction",
          f"{sd21}: prediction type {pipe21.prediction_type}, not v_prediction")
    common = {"negative_prompt": "blurry", "num_inference_steps": steps, "guidance_scale": 7.0,
              "content_type": "image/png"}
    at15 = {**common, "height": size15, "width": size15}
    jobs = [
        ("sd15_txt2img", "txt2img", {**at15, "id": "sd15-txt2img-0", "workflow": "txt2img",
                                     "model_name": sd15, "seed": 3000,
                                     "prompt": "a lighthouse on a cliff at dusk",
                                     "parameters": {"scheduler_type":
                                                    "DPMSolverMultistepScheduler"}}),
        ("sd15_img2img", "img2img", {**at15, "id": "sd15-img2img-0", "workflow": "img2img",
                                     "model_name": sd15, "seed": 3001, "strength": 0.75,
                                     "prompt": "a lighthouse on a cliff, repainted",
                                     "start_image_uri": "start",
                                     "parameters": {"scheduler_type":
                                                    "EulerAncestralDiscreteScheduler"}}),
        ("sd15_inpaint9", "inpaint9", {**at15, "id": "sd15-inpaint9-0", "workflow": "inpaint",
                                       "model_name": sd15_inpaint, "seed": 3002,
                                       "prompt": "a lighthouse on a cliff, repainted",
                                       "start_image_uri": "start", "mask_image_uri": "mask",
                                       "parameters": {"scheduler_type":
                                                      "UniPCMultistepScheduler"}}),
        ("sd21_txt2img", "txt2img", {**common, "height": size21, "width": size21,
                                     "id": "sd21-txt2img-0", "workflow": "txt2img",
                                     "model_name": sd21, "seed": 3003,
                                     "prompt": "a lighthouse on a cliff at dusk",
                                     "parameters": {"scheduler_type":
                                                    "DPMSolverMultistepScheduler"}}),
    ]
    return serve_counted(smi, registry, jobs, {m: SD_UNET_LAUNCHES for m in (sd15, sd15_inpaint,
                                                                             sd21)},
                         device, tag="sd", where="SD path")


# --- phase 6 ---

def measure(paths: dict, main: str = "txt2img") -> tuple[list[dict], dict]:
    """Phase 6 for {job kind: (jobs, {kernel: (launches, {shape key:
    launches})})} counted over `jobs` jobs of each kind: every shape that
    any kind launched is checked and timed once; each kernel's times and
    bound per job are summed over its shapes for each kind. The summary
    reports the `main` kind's job at the top level, as before, and every
    kind under `by_job`; `launches` counts every served job."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    detail, summary = {}, []
    names = list(next(iter(paths.values()))[1])
    for name in names:
        shapes = Counter()
        for _, launches in paths.values():
            shapes.update(launches[name][1])
        rows = []
        for key, _ in sorted(shapes.items(), key=lambda kv: -kv[1]):
            if name == "flash_attention":
                q_shape, k_shape, dtype = key
                row = attention_case(tuple(q_shape), tuple(k_shape), dtype, gen, timed=True)
            else:
                x_shape, dtype, silu, eps = key
                row = gn_case(x_shape, getattr(torch, dtype), silu, gen, timed=True, eps=eps)
            row["launches_per_job"] = {kind: launches[name][1].get(key, 0) / jobs
                                       for kind, (jobs, launches) in paths.items()}
            rows.append(row)
            row["tflops"] = row["flops"] / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            per_kind = ", ".join(f"{kind} {n:g}" for kind, n in row["launches_per_job"].items()
                                 if n)
            log(f"[measure] {name} {row.get('q', row.get('x'))}"
                f"{' kv' + str(row['kv']) if 'kv' in row else ''} {row['dtype']}"
                f"{' eps %g' % row['eps'] if 'eps' in row else ''}"
                f"{' on chip: %s' % row['on_chip'] if 'on_chip' in row else ''}"
                f"{' route ' + row['route'] if row.get('route') else ''}: "
                f"per job {per_kind}; kernel {row['ms']:.4f} ms"
                + f" (device {row['device_ms']:.4f}, host {row['host_ms']:.4f})"
                + f", plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms"
                + (f" (device {row['library_device_ms']:.4f})" if "library_device_ms" in row
                   else "")
                + f", bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), {row['tflops']:.1f} TFLOP/s, "
                f"{100 * row['share_of_bound']:.1f}% of bound, err {row['max_abs_err']:.3g}")

        def per_job(field, kind, which=None):
            return sum(r[field] * r["launches_per_job"][kind] for r in rows
                       if which is None or r["bound_by"] == which)

        # each shape's own bound (the larger of its two), summed over the
        # shapes; bound_by names the kind that makes up most of the sum
        by_job = {}
        for kind, (jobs, launches) in paths.items():
            by_ops = per_job("bound_ms", kind, "operations")
            by_bytes = per_job("bound_ms", kind, "bytes")
            by_job[kind] = {
                "launches": launches[name][0] / jobs, "ms": per_job("ms", kind),
                "device_ms": per_job("device_ms", kind), "host_ms": per_job("host_ms", kind),
                "plain_ms": per_job("plain_ms", kind), "bound_ms": by_ops + by_bytes,
                "bound_by": "operations" if by_ops >= by_bytes else "bytes",
                "library_ms": per_job("library_ms", kind),
                "library_device_ms": per_job("library_device_ms", kind)}
            j = by_job[kind]
            log(f"[measure] {name} per {kind} job: kernel {j['ms']:.1f} ms (device "
                f"{j['device_ms']:.1f}, host {j['host_ms']:.1f}), plain {j['plain_ms']:.1f} ms, "
                f"library {j['library_ms']:.1f} ms (device {j['library_device_ms']:.1f}), bound "
                f"{j['bound_ms']:.1f} ms ({j['bound_by']}), {j['launches']:g} launches")
        top = {k: v for k, v in by_job[main].items() if k not in ("launches", "library_device_ms")}
        summary.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": sum(launches[name][0] for _, launches in paths.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows), **top, "by_job": by_job,
        })
        detail[name] = rows
    return summary, detail


# --- phases 7 and 8 ---

# kernel-name marks of each category; the GroupNorm names of the
# three-launch kernel (stats, finalize, apply) stay so that
# `--group-norm-only` can profile such a tree beside the one-launch kernel
_GN_MARKS = ("gn_fused", "gn_stats", "gn_finalize", "gn_apply")
_CATEGORIES = (
    ("flash_attention kernel", ("flash_fwd",)),
    ("group_norm kernel", _GN_MARKS),
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
    if not cfg.addition_embed_dim:
        return x, t, ctx, None
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


def encode_input(pipe, size: int = SIZE):
    """The served start image as the VAE encoder's input: [1, 3, size,
    size] in [-1, 1], the pipeline's dtype, channels_last."""
    import numpy as np

    px = np.asarray(start_image(size), np.float32) / 127.5 - 1.0
    px = torch.from_numpy(px.transpose(2, 0, 1)[None].copy()).to(pipe.device, pipe.dtype)
    return px.contiguous(memory_format=torch.channels_last)


def end_to_end_bf16_check(pipe, size: int = SIZE,
                          parts=("unet", "vae_decode", "vae_encode")) -> dict:
    """One UNet call, one VAE decode and one VAE encode (the named parts)
    at the shapes of `pipe`'s path at `size`, in bf16 through the kernels,
    against the same weights in f32 on the plain path; the plain path in
    bf16 gives the error bf16 itself makes."""
    import copy

    from chiaswarm_tpu_torch.device import synchronize

    check(pipe.dtype == torch.bfloat16, f"the main path runs {pipe.dtype}, not bf16")
    lat = size // pipe.latent_factor
    x, t, ctx, added = unet_inputs(pipe, size)
    z = torch.randn((1, pipe.latent_channels, lat, lat), device=pipe.device,
                    generator=torch.Generator(device=pipe.device).manual_seed(3))
    z = z.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    # the f32 reference sees the same bf16 input values, cast up
    up = added and {"text_embeds": added["text_embeds"].float(), "time_ids": added["time_ids"]}
    px = encode_input(pipe, size)
    calls = (
        ("unet", pipe.unet, lambda m: m(x, t, ctx, added),
         lambda m: m(x.float(), t, ctx.float(), up)),
        ("vae_decode", pipe.vae, lambda m: m.decode(z), lambda m: m.decode(z.float())),
        ("vae_encode", pipe.vae, lambda m: m.encode(px), lambda m: m.encode(px.float())))
    result = {}
    for name, module, call, call_f32 in calls:
        if name not in parts:
            continue
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
        log(f"[e2e] {pipe.model_name} {name} at {size}^2, bf16 through the kernels vs f32 plain "
            f"path: relative RMS err "
            f"{row['rel_rms_err']:.4g}; plain path in bf16: {row['plain_bf16_rel_rms_err']:.4g} "
            f"(bound {E2E_RATIO}x that)")
        check(row["finite"], f"{name}: non-finite output through the kernels")
        check(row["rel_rms_err"] <= E2E_RATIO * row["plain_bf16_rel_rms_err"],
              f"{name}: bf16 kernel path error {row['rel_rms_err']} > {E2E_RATIO} x the plain "
              f"bf16 path's {row['plain_bf16_rel_rms_err']}")
    return result


def profiled(fn, calls: int, device) -> tuple[dict, float, float, int]:
    """`calls` calls of fn after one warm-up call, timed by the host's clock
    and then again under torch.profiler: ({kernel name: (device ms per
    call, launches per call)}, wall ms per call unprofiled, the same under
    the profiler, GroupNorm wrapper calls per call)."""
    from torch.profiler import ProfilerActivity, profile

    from chiaswarm_tpu_torch.device import synchronize
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER

    with torch.inference_mode():
        fn()
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        synchronize(device)
        plain_wall_ms = 1e3 * (time.perf_counter() - t0) / calls
        GN_COUNTER.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            synchronize(device)
            wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    kernels = {}
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(event, "self_cuda_time_total", 0)
        if device_us > 0 and getattr(event, "device_type", None) != torch.autograd.DeviceType.CPU:
            ms, n = kernels.get(event.key, (0.0, 0.0))
            kernels[event.key] = (ms + device_us / 1e3 / calls, n + event.count / calls)
    return kernels, plain_wall_ms, wall_ms, GN_COUNTER.launches // calls


def profile_main_path(pipe, size: int = SIZE, steps: int = 3,
                      parts=("unet", "vae_decode", "vae_encode")) -> dict:
    """Phase 8: torch.profiler over a few UNet calls (CFG batch 2, size/8
    latents), one VAE decode and one VAE encode (the named parts) of
    `pipe` at `size`: device time and launches by kernel category, each
    GroupNorm kernel by name, GroupNorm wrapper calls, and the device's
    busy share of the wall time."""
    x, t, ctx, added = unet_inputs(pipe, size)
    lat = size // pipe.latent_factor
    z = torch.randn((1, pipe.latent_channels, lat, lat), device=pipe.device,
                    generator=torch.Generator(device=pipe.device).manual_seed(3))
    z = z.to(pipe.dtype).contiguous(memory_format=torch.channels_last)
    px = encode_input(pipe, size)
    result = {}
    for name, fn, calls in (("unet", lambda: pipe.unet(x, t, ctx, added_cond=added), steps),
                            ("vae_decode", lambda: pipe.vae.decode(z), 1),
                            ("vae_encode", lambda: pipe.vae.encode(px), 1)):
        if name not in parts:
            continue
        kernels, plain_wall_ms, wall_ms, gn_calls = profiled(fn, calls, pipe.device)
        categories = {label: [0.0, 0.0] for label, _ in _CATEGORIES}
        categories["other (elementwise, norms, copies)"] = [0.0, 0.0]
        for kernel, (ms, n) in kernels.items():
            low = kernel.lower()
            label = next((label for label, marks in _CATEGORIES
                          if any(m in low for m in marks)),
                         "other (elementwise, norms, copies)")
            categories[label][0] += ms
            categories[label][1] += n
        device_ms = sum(ms for ms, _ in kernels.values())
        result[name] = {
            "model": pipe.model_name, "size": size,
            "calls": calls, "unprofiled_wall_ms_per_call": plain_wall_ms,
            "wall_ms_per_call": wall_ms, "device_ms_per_call": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "categories_ms_launches": categories,
            "group_norm_kernels": {k: v for k, v in kernels.items()
                                   if any(m in k.lower() for m in _GN_MARKS)},
            "group_norm_calls": gn_calls,
            "top_kernels_ms": sorted(((k, ms) for k, (ms, _) in kernels.items()),
                                     key=lambda kv: -kv[1])[:8]}
    return result


def log_profile(profile: dict, smi: str) -> None:
    for name, p in profile.items():
        if p["device_ms_per_call"] <= 0:
            log(f"[profile] {name}: the profiler saw no device kernels; device time not measured")
            continue
        attention_ms = p["categories_ms_launches"]["flash_attention kernel"][0]
        log(f"[profile] {p['model']} {name} ({p['size']}^2"
            f"{', CFG batch 2' if name == 'unet' else ''}) on {smi}: "
            f"wall {p['wall_ms_per_call']:.2f} ms per call ({p['unprofiled_wall_ms_per_call']:.2f} "
            f"unprofiled), device busy {p['device_ms_per_call']:.2f} ms "
            f"({100 * p['busy_share']:.1f}% of the profiled wall); attention "
            f"{100 * attention_ms / p['device_ms_per_call']:.1f}% of the device time")
        for label, (ms, n) in p["categories_ms_launches"].items():
            log(f"[profile]   {label}: {ms:.3f} ms, {n:g} launches")
        log(f"[profile]   group_norm: {p['group_norm_calls']} wrapper calls per call")
        for kernel, (ms, n) in p["group_norm_kernels"].items():
            log(f"[profile]   group_norm kernel {ms:.3f} ms, {n:g} launches: {kernel[:90]}")
        for kernel, ms in p["top_kernels_ms"]:
            log(f"[profile]   top kernel {ms:.3f} ms: {kernel[:110]}")


def check_one_launch_per_call(profile: dict) -> None:
    """Every GroupNorm wrapper call is exactly one kernel launch."""
    for name, p in profile.items():
        launches = p["categories_ms_launches"]["group_norm kernel"][1]
        check(launches == p["group_norm_calls"],
              f"{name}: {launches:g} GroupNorm kernel launches for {p['group_norm_calls']} calls")


def group_norm_only(smi: str, detail: str | None) -> None:
    """GroupNorm alone: phase 6 at the shapes of one UNet call and one VAE
    decode (per job: STEPS UNet calls and one decode), then phase 8."""
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER
    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline

    pipe = SDPipeline(SDXL, device="cuda", allow_random_init=True)
    x, t, ctx, added = unet_inputs(pipe)
    lat = SIZE // pipe.latent_factor
    z = torch.zeros((1, pipe.latent_channels, lat, lat), device="cuda", dtype=pipe.dtype)
    z = z.contiguous(memory_format=torch.channels_last)
    per_job = {}
    with torch.inference_mode():
        for fn, times in ((lambda: pipe.unet(x, t, ctx, added_cond=added), STEPS),
                          (lambda: pipe.vae.decode(z), 1)):
            GN_COUNTER.reset()
            fn()
            for key, n in GN_COUNTER.shapes.items():
                per_job[key] = per_job.get(key, 0) + n * times
    summary, shapes = measure({"txt2img": (1, {"group_norm": (sum(per_job.values()),
                                                              per_job)})})
    profile = profile_main_path(pipe)
    log_profile(profile, smi)
    if detail:
        path = Path(detail)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"card": smi, "kernels": summary, "shapes": shapes,
                                    "profile": profile}, indent=1))


def attention_only(smi: str, detail: str | None) -> None:
    """Attention alone: the checks of phase 3, then phase 6 at the shapes
    of one UNet call and one VAE decode of each model in UNET_ATTENTION
    (per job: STEPS UNet calls and one decode)."""
    attention_checks(torch.Generator(device="cuda").manual_seed(0))
    paths = {}
    for model in UNET_ATTENTION:
        per_job = Counter({key: n * STEPS for key, n in attention_shapes(model).items()})
        per_job[vae_attention_shape(model)] += 1
        paths[f"{model} txt2img"] = (1, {"flash_attention": (sum(per_job.values()),
                                                             dict(per_job))})
    summary, shapes = measure(paths, main="sdxl txt2img")
    if detail:
        path = Path(detail)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"card": smi, "kernels": summary, "shapes": shapes},
                                   indent=1, default=str))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--detail", help="write every measurement to this JSON file")
    parser.add_argument("--group-norm-only", action="store_true",
                        help="phases 1, 2, 6 and 8 for GroupNorm alone (no result line)")
    parser.add_argument("--attention-only", action="store_true",
                        help="phases 1, 2, 3 and 6 for attention alone (no result line)")
    opts = parser.parse_args(argv)
    started = time.perf_counter()
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
        paths = _build.build(("flash_attention",) if opts.attention_only else _build.SOURCES)
        log(f"[build] {len(paths)} kernel libraries in {time.perf_counter() - t0:.1f}s: "
            + ", ".join(p.name for p in paths.values()))
        for name in paths:
            regs = [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
            log(f"[build] {name}: " + " | ".join(regs))
        if opts.group_norm_only:
            group_norm_only(smi, opts.detail)
            return 0
        if opts.attention_only:
            attention_only(smi, opts.detail)
            return 0
        kernel_checks()
        tiny_reference_check()
        tiny_sd = tiny_sd_checks()
        tiny_image = tiny_image_checks()
        launches, served, registry = serve_main_path(smi)
        unet_launches = {name: (count / N_JOBS - DECODE_LAUNCHES[name]) / STEPS
                         for name, (count, _) in launches.items()}
        image_paths, image_served = serve_image_path(smi, registry, unet_launches)
        sd_paths, sd_served = serve_sd_path(smi, registry)
        summary, shapes = measure({"txt2img": (N_JOBS, launches), **image_paths, **sd_paths})
        pipe = registry.get_pipeline(SDXL)
        e2e = {SDXL: end_to_end_bf16_check(pipe)}
        for model, size in SD_CANVASES:
            e2e[model] = end_to_end_bf16_check(registry.get_pipeline(model), size,
                                               parts=("unet",))
        profile = {SDXL: profile_main_path(pipe)}
        for model, size in SD_CANVASES:
            profile[model] = profile_main_path(registry.get_pipeline(model), size,
                                               parts=("unet",))
        for part in profile.values():
            log_profile(part, smi)
            check_one_launch_per_call(part)
        if opts.detail:
            path = Path(opts.detail)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(
                {"card": smi, "tiny_sd": tiny_sd, "tiny_image": tiny_image, "served": served,
                 "image_served": image_served, "sd_served": sd_served, "kernels": summary,
                 "shapes": shapes, "end_to_end_bf16": e2e, "profile": profile}, indent=1,
                default=str))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[smoke] every phase passed in {time.perf_counter() - started:.1f}s")
    print(json.dumps({"kernels": summary}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
