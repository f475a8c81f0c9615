"""Denoise checkpoint blobs: the wire format of a pass cut at a chunk
boundary, the counterpart of chiaswarm_tpu/checkpoint.py.

A checkpoint-armed chunked denoise ships its live state at chunk
boundaries (the current latents, the scheduler-state leaves and the step
index), so that a redelivered job resumes at step K on another worker
instead of running the whole pass again. The port's blob carries one more
array, `rng`: the state of the job's `torch.Generator`, which draws the
initial latents and every later draw (ancestral and DDPM step noise,
inpaint's keep noise) in sequence. Restoring it makes a resumed pass draw
what the undisturbed one would have drawn after step K.

The format is the JAX package's, byte for byte: the 8-byte magic
`CSWCKPT1`, a little-endian u32 header length, a JSON header (version,
step, signature, leaf count, and each array's name, dtype and shape),
then the arrays' raw bytes in header order. A dtype travels by name.
`bfloat16`, which numpy lacks, is read back through torch (a uint16 view,
then `torch.bfloat16`), so a bfloat16 leaf comes back as a torch tensor
and every other array as a numpy array.

`program_signature` pins compatibility. A resume offer is honoured only
when the redelivered job resolves to the same backend, latent layout,
model, bucket key, dtype and geometry that the checkpoint was cut under;
anything else would feed the latents to a pass with another meaning of
"step K". The port's signature hashes its backend ("torch") and layout
("NCHW"), so an offer cut by a JAX worker (NHWC latents, JAX scheduler
leaves) never matches it and falls back to the full pass. A mismatch is
never an error.
"""

from __future__ import annotations

import hashlib
import json
import struct

import numpy as np
import torch

MAGIC = b"CSWCKPT1"
FORMAT_VERSION = 1
BACKEND = "torch"
LAYOUT = "NCHW"


def program_signature(model_name: str, key, dtype, geo=None) -> str:
    """A short stable id of the pass family a checkpoint belongs to: the
    backend and latent layout, the model, the pass's bucket key (what
    fixes the meaning of step K), the dtype and the geometry."""
    raw = repr((BACKEND, LAYOUT, str(model_name), key, str(dtype),
                tuple(geo) if geo else None))
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def _host_array(x) -> tuple[str, np.ndarray]:
    """(dtype name, numpy array holding the raw bytes) of a tensor or an
    array-like."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().view(np.uint16)
        return str(x.numpy().dtype), x.numpy()
    a = np.asarray(x)
    return str(a.dtype), a


def _read_array(chunk: bytes, dtype_name: str, shape: tuple):
    if dtype_name == "bfloat16":
        raw = np.frombuffer(chunk, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return np.frombuffer(chunk, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _itemsize(dtype_name: str) -> int:
    if dtype_name == "bfloat16":
        return 2
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise ValueError(f"unsupported checkpoint dtype {dtype_name}") from e
    if dtype.kind not in "biufc":
        raise ValueError(f"unsupported checkpoint dtype {dtype_name}")
    return dtype.itemsize


def pack(step: int, latents, state_leaves, signature: str, rng=None) -> bytes:
    """Serialise one checkpoint. `latents`, each of `state_leaves` (in the
    scheduler's `state_leaves` order) and `rng` (a generator state, uint8)
    are tensors or array-likes."""
    arrays = [("latents", *_host_array(latents))]
    for i, leaf in enumerate(state_leaves):
        arrays.append((f"leaf{i}", *_host_array(leaf)))
    if rng is not None:
        arrays.append(("rng", *_host_array(rng)))
    header = {
        "v": FORMAT_VERSION,
        "step": int(step),
        "signature": str(signature),
        "leaves": len(state_leaves),
        "arrays": [{"name": name, "dtype": dtype, "shape": list(a.shape)}
                   for name, dtype, a in arrays],
    }
    head = json.dumps(header, separators=(",", ":")).encode()
    parts = [MAGIC, struct.pack("<I", len(head)), head]
    parts += [np.ascontiguousarray(a).tobytes() for _, _, a in arrays]
    return b"".join(parts)


def unpack(blob: bytes) -> dict:
    """A checkpoint blob -> {"step", "signature", "latents", "state_leaves",
    and "rng" where the blob has one}. Raises ValueError on anything
    malformed; the caller then runs the full pass."""
    if len(blob) < len(MAGIC) + 4 or blob[:len(MAGIC)] != MAGIC:
        raise ValueError("not a checkpoint blob")
    head_len = struct.unpack_from("<I", blob, len(MAGIC))[0]
    start = len(MAGIC) + 4
    if start + head_len > len(blob):
        raise ValueError("truncated checkpoint header")
    try:
        header = json.loads(blob[start:start + head_len].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"corrupt checkpoint header: {e}") from e
    if not isinstance(header, dict):
        raise ValueError("checkpoint header is not an object")
    if header.get("v") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {header.get('v')!r}")
    try:
        specs = [(str(spec["name"]), str(spec["dtype"]), tuple(int(d) for d in spec["shape"]))
                 for spec in header.get("arrays", [])]
        step, leaves = int(header.get("step", 0)), int(header.get("leaves", 0))
    except (AttributeError, KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed checkpoint header: {e!r}") from e
    offset = start + head_len
    out: dict = {}
    for name, dtype_name, shape in specs:
        if any(d < 0 for d in shape):
            raise ValueError(f"negative shape {shape} in checkpoint header")
        nbytes = int(np.prod(shape, dtype=np.int64)) * _itemsize(dtype_name)
        chunk = blob[offset:offset + nbytes]
        if len(chunk) != nbytes:
            raise ValueError("truncated checkpoint blob")
        out[name] = _read_array(chunk, dtype_name, shape)
        offset += nbytes
    if "latents" not in out:
        raise ValueError("checkpoint blob has no latents")
    if any(f"leaf{i}" not in out for i in range(leaves)):
        raise ValueError("checkpoint blob lacks a scheduler leaf")
    state = {
        "step": step,
        "signature": str(header.get("signature", "")),
        "latents": out["latents"],
        "state_leaves": [out[f"leaf{i}"] for i in range(leaves)],
    }
    if "rng" in out:
        state["rng"] = out["rng"]
    return state
