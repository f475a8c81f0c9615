"""What every kernel wrapper shares: its launch counter, the ctypes
signature of its C entry point, and the raise on a refused launch."""

from __future__ import annotations

import ctypes
import threading
from collections import Counter

import torch

# C argument types for the entry points in csrc/
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """Launches of one kernel: `launches` counts every launch, `shapes`
    counts them by a key of the arguments' shapes and types (what a
    benchmark replays), `routes` by the route the kernel reported, where
    it has more than one. Wrappers run on several threads (the device
    thread and the worker's stage lane), so a launch is noted under a lock."""

    def __init__(self):
        self.launches = 0
        self.shapes: Counter = Counter()
        self.routes: Counter = Counter()
        self._lock = threading.Lock()

    def reset(self) -> None:
        self.launches = 0
        self.shapes.clear()
        self.routes.clear()

    def note(self, key, route=None) -> None:
        with self._lock:
            self.launches += 1
            self.shapes[key] += 1
            if route is not None:
                self.routes[route] += 1


def bind(lib: ctypes.CDLL, name: str, argtypes: list):
    """A C entry point with its argument types declared (ctypes would pass
    pointers as 32-bit ints without them) and an int result. Wrappers bind
    once, when their library first loads, and keep the function."""
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = INT
    return fn


def current_stream(device: int) -> int:
    """The raw handle of PyTorch's current stream on CUDA device number
    `device` (`tensor.get_device()`), without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(device)


def check_launch(lib: ctypes.CDLL, error_fn: str, err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err:
        fn = getattr(lib, error_fn)
        fn.argtypes = [INT]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err}: {fn(err).decode()}")


def require_cuda_tensor(name: str, x: torch.Tensor, dtype: torch.dtype | None = None) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if dtype is not None and x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
