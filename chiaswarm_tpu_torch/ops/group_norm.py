"""GroupNorm (+ fused SiLU): the Hopper kernel (csrc/group_norm.cu), its
wrapper and its plain PyTorch version.

Replaces the Pallas kernel of chiaswarm_tpu/ops/group_norm.py
(`_gn_kernel`, launched by `_fused_group_norm`). Layout as there: x is
channel-last [B, ..., C], scale/bias [C]. On the H100 it is bound by
bytes (3.35 TB/s); the source says what its design does about that.

`group_norm` routes by where x lies: a CUDA tensor goes to the kernel
(`fused_group_norm`, which launches or raises), a CPU tensor to the plain
version `reference_group_norm`.

Each call is one cooperative launch. `plan_launch` works out, from the
shape and the card's limits alone, its grid and how many rows of each
CTA's slab stay in shared memory (all of them when the call fits on
chip: x is then read from device memory once). The wrapper keeps, per
(shape, dtype, groups, eps, SiLU, device), the plan and the C struct it
passes, so a call costs the checks, one dictionary lookup, the output's
allocation and one ctypes call. The partial sums go to a scratch buffer
kept per device and used by one stream at a time (the port runs one
stream per device): two streams running the kernel at once on one device
would share it. A buffer that has been handed out is never freed, so a
CUDA graph that captured the kernel stays valid.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from ._launch import (
    DTYPE_CODES,
    FLOAT,
    INT,
    PTR,
    LaunchCounter,
    bind,
    check_launch,
    current_stream,
    require_cuda_tensor,
)

COUNTER = LaunchCounter()

MAX_CHANNELS = 4096
# the kernel's constants (csrc/group_norm.cu): threads per CTA at most,
# TMA stages, bytes of mbarriers ahead of the rest of shared memory
MAX_THREADS = 512
STAGES = 8
BARRIER_BYTES = STAGES * 8


def reference_group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                         silu: bool = False):
    """Plain GroupNorm over the last axis with f32 statistics and the fast
    variance E[x^2] - mean^2, as chiaswarm_tpu's `_reference_group_norm`.
    A float64 x is computed in float64 (the same function, exactly enough
    to hold an f32 kernel against where f32 statistics cancel)."""
    shape = x.shape
    c = shape[-1]
    wide = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(wide).reshape(*shape[:-1], groups, c // groups)
    red = tuple(range(1, xf.ndim - 2)) + (xf.ndim - 1,)
    mean = xf.mean(dim=red, keepdim=True)
    var = (xf * xf).mean(dim=red, keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(shape)
    y = y * scale.to(wide) + bias.to(wide)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


# --- the launch plan (pure arithmetic; the CPU tests check it) ---

def threads_for(c: int) -> int:
    """Threads per CTA: rows_par rows of C/8 threads (8 channels each)."""
    v = c // 8
    return (1 if v >= MAX_THREADS else MAX_THREADS // v) * v


def fold_slots_for(c: int, groups: int) -> int:
    """The most groups that one thread's 8 consecutive channels touch."""
    cg = c // groups
    return max((8 * v + 7) // cg - 8 * v // cg + 1 for v in range(c // 8))


def smem_offsets(threads: int, groups: int, fold_slots: int) -> tuple[int, int]:
    """(fold, slab) byte offsets in shared memory, as csrc/group_norm.cu
    lays it out: mbarriers, per-group statistics, the fold buffer, then
    the slab of kept rows."""
    fold = -(-(BARRIER_BYTES + groups * 8) // 16) * 16
    slab = -(-(fold + threads * fold_slots * 8) // 128) * 128
    return fold, slab


@dataclass(frozen=True)
class LaunchPlan:
    """How one GroupNorm call runs: `chunks` CTAs per batch row, all
    resident, each owning `rows_per_cta` consecutive rows of its batch row
    (the last one fewer), of which the first `keep_rows` are held in
    shared memory."""

    batch: int
    rows: int  # N, rows per batch row
    channels: int
    groups: int
    chunks: int
    threads: int
    rows_per_cta: int
    keep_rows: int
    fold_slots: int
    smem_bytes: int

    @property
    def grid(self) -> int:
        return self.batch * self.chunks

    @property
    def on_chip(self) -> bool:
        """Every row stays in shared memory: x is read once."""
        return self.keep_rows >= self.rows_per_cta

    @property
    def scratch_bytes(self) -> int:
        """The partial sums: [grid][groups] pairs of f32."""
        return self.grid * self.groups * 8


def plan_launch(b: int, n: int, c: int, groups: int, elem_size: int, sms: int,
                smem_per_block: int, blocks_per_sm: int) -> LaunchPlan:
    """The plan for x = [b, n, c] of `elem_size`-byte elements on a card of
    `sms` SMs, where a CTA may have `smem_per_block` bytes of shared memory
    and `blocks_per_sm` CTAs of this configuration fit on an SM at that
    size. Each batch row's rows are spread over an equal share of the
    resident CTAs; each CTA keeps as many of its rows in shared memory as
    fit."""
    if c % 8 or c > MAX_CHANNELS or c % groups:
        raise ValueError(f"channels {c} not supported (multiple of 8 and of "
                         f"groups={groups}, <= {MAX_CHANNELS})")
    threads = threads_for(c)
    if groups > threads:
        raise ValueError(f"groups={groups} > {threads} threads per CTA")
    if n < 1 or n >= 2 ** 31:
        raise ValueError(f"GroupNorm input [{b}, {n}, {c}]: rows per batch row must "
                         "number 1 to 2^31 - 1")
    resident = sms * blocks_per_sm
    if not 1 <= b <= resident:
        raise ValueError(f"batch {b}: the kernel takes 1 to {resident} batch rows (one "
                         "resident CTA each at least)")
    rows_per_cta = -(-n // min(n, resident // b))
    chunks = -(-n // rows_per_cta)
    fold_slots = fold_slots_for(c, groups)
    _, slab = smem_offsets(threads, groups, fold_slots)
    row_bytes = c * elem_size
    keep = max(0, min(rows_per_cta, (smem_per_block - slab) // row_bytes))
    return LaunchPlan(b, n, c, groups, chunks, threads, rows_per_cta, keep, fold_slots,
                      slab + keep * row_bytes)


def max_batch_rows(sms: int, smem_per_block: int, blocks_per_sm: int = 1) -> int:
    """The most batch rows `plan_launch` accepts on a card of `sms` SMs
    (each batch row needs one resident CTA at least): what caps the rows of
    a coalesced UNet pass (capacity.py)."""
    rows = 0
    while True:
        try:
            plan_launch(rows + 1, 1, 320, 32, 2, sms, smem_per_block, blocks_per_sm)
        except ValueError:
            return rows
        rows += 1


# --- the kernel on the card ---

class _PlanArgs(ctypes.Structure):
    """csrc/group_norm.cu `GnPlan`, field for field."""

    _fields_ = [("scratch", ctypes.c_void_p), ("B", INT), ("N", INT), ("C", INT), ("G", INT),
                ("chunks", INT), ("threads", INT), ("rows_per_cta", INT), ("keep_rows", INT),
                ("fold_slots", INT), ("smem_bytes", INT), ("dtype", INT), ("silu", INT),
                ("eps", FLOAT)]


class _Library:
    """The C entry points, bound once when the library first loads."""

    def __init__(self):
        self.lib = _build.load("group_norm")
        self.forward = bind(self.lib, "gn_forward", [PTR, PTR, PTR, PTR, PTR, PTR])
        self.limits = bind(self.lib, "gn_limits", [INT, PTR])
        self.occupancy = bind(self.lib, "gn_occupancy", [INT, INT, INT, INT, INT, PTR])

    def check(self, err: int) -> None:
        check_launch(self.lib, "gn_error_string", err, "group_norm")


class _Device:
    """Per CUDA device: its limits, the CTAs per SM of each kernel
    configuration (asked once), and the scratch for the partial sums."""

    def __init__(self, lib: _Library, index: int):
        self.lib, self.index = lib, index
        limits = (ctypes.c_int * 2)()
        lib.check(lib.limits(index, ctypes.addressof(limits)))
        self.sms, self.smem_per_block = limits[0], limits[1]
        self.blocks: dict[tuple, int] = {}
        self.scratch: list[torch.Tensor] = []

    def blocks_per_sm(self, dtype: int, silu: bool, threads: int) -> int:
        """CTAs per SM when each asks for all the shared memory a CTA may
        have (a plan never asks for more, so its grid is always resident)."""
        key = (dtype, silu, threads)
        if key not in self.blocks:
            out = ctypes.c_int(0)
            with torch.cuda.device(self.index):
                self.lib.check(self.lib.occupancy(dtype, int(silu), threads, self.smem_per_block,
                                                  self.smem_per_block, ctypes.addressof(out)))
            self.blocks[key] = out.value
        return self.blocks[key]

    def scratch_ptr(self, nbytes: int) -> int:
        if not self.scratch or self.scratch[-1].numel() < nbytes:
            size = max(nbytes, 2 * self.scratch[-1].numel() if self.scratch else 1 << 18)
            self.scratch.append(torch.empty(size, dtype=torch.uint8,
                                            device=torch.device("cuda", self.index)))
        return self.scratch[-1].data_ptr()


class _Launch:
    """A cached call: its plan, the C struct gn_forward reads, the launch
    counter's key."""

    __slots__ = ("plan", "args", "address", "device", "channels", "key")

    def __init__(self, plan, args, device, key):
        self.plan, self.args, self.device, self.key = plan, args, device, key
        self.address = ctypes.addressof(args)
        self.channels = (plan.channels,)


_lib: _Library | None = None
_devices: dict[int, _Device] = {}
_launches: dict[tuple, _Launch] = {}


def _new_launch(x, groups: int, eps: float, silu: bool, key: tuple) -> _Launch:
    global _lib
    if x.ndim < 3:
        raise ValueError(f"expected x [B, ..., C], got {tuple(x.shape)}")
    _lib = _lib or _Library()
    index = x.get_device()
    device = _devices.get(index) or _devices.setdefault(index, _Device(_lib, index))
    b, c = x.shape[0], x.shape[-1]
    n = x.numel() // max(1, b * c)
    dtype = DTYPE_CODES[x.dtype]
    plan = plan_launch(b, n, c, groups, x.element_size(), device.sms, device.smem_per_block,
                       device.blocks_per_sm(dtype, silu, threads_for(c)))
    args = _PlanArgs(device.scratch_ptr(plan.scratch_bytes), b, n, c, groups, plan.chunks,
                     plan.threads, plan.rows_per_cta, plan.keep_rows, plan.fold_slots,
                     plan.smem_bytes, dtype, int(silu), eps)
    counter_key = (tuple(x.shape), str(x.dtype).replace("torch.", ""), bool(silu), float(eps))
    launch = _Launch(plan, args, index, counter_key)
    _launches[key] = launch
    return launch


def launch_plan(x, groups: int = 32, silu: bool = False, eps: float = 1e-5) -> LaunchPlan:
    """The plan the kernel runs x (a CUDA tensor) with."""
    require_cuda_tensor("x", x)
    key = (x.shape, x.dtype, groups, eps, silu, x.get_device())
    return (_launches.get(key) or _new_launch(x, groups, eps, silu, key)).plan


def fused_group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                     silu: bool = False):
    """The kernel: x contiguous channel-last [B, ..., C] on the card."""
    require_cuda_tensor("x", x)
    require_cuda_tensor("scale", scale, x.dtype)
    require_cuda_tensor("bias", bias, x.dtype)
    key = (x.shape, x.dtype, groups, eps, silu, x.get_device())
    launch = _launches.get(key) or _new_launch(x, groups, eps, silu, key)
    if scale.shape != launch.channels or bias.shape != launch.channels:
        raise ValueError(f"scale/bias must be [{launch.channels[0]}]")
    out = torch.empty_like(x)
    err = _lib.forward(x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                       launch.address, current_stream(launch.device))
    if err:
        _lib.check(err)
    COUNTER.note(launch.key)
    return out


def group_norm(x, scale, bias, *, groups: int = 32, eps: float = 1e-5,
               act: str | None = None):
    """GroupNorm over the channel-last axis with optional fused SiLU.

    x: [B, ..., C]; scale/bias: [C]. The kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    silu = act == "silu"
    if x.device.type == "cuda":
        return fused_group_norm(x, scale, bias, groups, eps, silu)
    if x.device.type == "cpu":
        return reference_group_norm(x, scale, bias, groups, eps, silu)
    raise ValueError(f"group_norm: no kernel for device {x.device}")
