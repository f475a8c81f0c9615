"""Build the CUDA sources under `chiaswarm_tpu_torch/csrc/` at first use.

Each source compiles with `nvcc` by hand into its own shared library with
a plain C interface, loaded through `ctypes`; no source includes
PyTorch's headers, which keeps the build short. Every source gets its own `nvcc`
process and all of them start together. Libraries land in
`chiaswarm_tpu_torch/_build/` (listed in `.gitignore`) under a name that
hashes the source and the flags, so a changed source rebuilds and an
unchanged one loads from the previous build. The compiler's log (with
`-Xptxas -v`: registers, shared memory and spills per kernel) is kept
next to each library. The hash covers every header under `csrc/` that a
source includes (directly or through another header) and the include
flags, so a change to a shared `.cuh` rebuilds every library that uses it.

A failed build raises `KernelBuildError`; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("flash_attention", "group_norm")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found (looked in {candidate} and on PATH); the CUDA "
            "kernels of chiaswarm_tpu_torch need the CUDA toolkit")
    return found


def include_flags() -> list[str]:
    return [f"-I{CSRC}"]


def local_headers(source: Path) -> list[Path]:
    """Every file under csrc/ that `source` includes with quotes, directly
    or through another such header, in a fixed order."""
    found: dict[Path, None] = {}
    pending = [source]
    while pending:
        for name in _INCLUDE.findall(pending.pop().read_text()):
            header = (CSRC / name).resolve()
            if header.is_file() and header not in found:
                found[header] = None
                pending.append(header)
    return sorted(found)


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for part in (source, *local_headers(source)):
        digest.update(part.name.encode() + b"\0" + part.read_bytes() + b"\0")
    digest.update(" ".join((*NVCC_FLAGS, *include_flags())).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no up-to-date library, one
    `nvcc` each, all in parallel. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    pending = {}
    nvcc = None
    for name, out in paths.items():
        if out.is_file():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *include_flags(), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        pending[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failures = []
    for name, (proc, tmp) in pending.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failures:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failures))
    return paths


def build_log(name: str) -> str:
    """The compiler output of the current build of `name` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use (a
    loaded library is returned without taking the build lock)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
