"""LoRA adapter files -> raw low-rank factors, matched onto the port's
Linear modules; the counterpart of chiaswarm_tpu/models/lora.py.

An adapter is a safetensors file of per-module factors `A [r, in]`,
`B [out, r]` and an optional `alpha`, in one of two layouts:

- diffusers / PEFT: `unet.down_blocks.0....to_q.lora_A.weight` / `lora_B`,
  `text_encoder[_2].text_model.encoder.layers.0....q_proj.lora_A.weight`;
- kohya: `lora_unet_down_blocks_0_..._to_q.lora_down.weight` / `lora_up`,
  `lora_te[1|2]_text_model_encoder_layers_0_..._q_proj.lora_down.weight`,
  each module with an optional `.alpha` tensor.

Every name becomes one flat key in the JAX package's spelling: the UNet's
diffusers path with `.` -> `_` (`to_out.0` -> `to_out_0`, `ff.net.0.proj`
-> `ff_net_0_proj`), a text encoder's under `te{i}:` (encoder i of the
pipeline's list) with transformers' `text_model.encoder.` levels dropped
and `mlp.fc1` -> `fc1`. The port's modules keep diffusers / transformers
names, so the same normalisation of `named_modules()` names gives the
index a factor is looked up in.

The match is shape-exact and 2-D only: `A [r, in]`, `B [out, r]` against a
Linear `weight [out, in]`. A conv-shaped factor (SD 1.x's 1x1 `proj_in` /
`proj_out` as `[r, in, 1, 1]`, a resnet's 3x3 conv), a factor whose shape
differs from its module's and a name that no module has are unmatched:
counted, never reshaped, as the JAX package's delta path counts them
(its merged route, which it takes for such adapters, skips the 2-D ones
and fails on the 4-D ones: ROADMAP.md §3).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from torch import nn


def load_lora_state(path: str | Path, weight_name: str | None = None,
                    subfolder: str | None = None) -> dict:
    """Flat {name: np.ndarray} from a LoRA safetensors file: `path` itself,
    or `weight_name` (else the first *.safetensors, sorted) in the
    directory `path[/subfolder]`."""
    from safetensors import safe_open

    root = Path(path).expanduser()
    if subfolder:
        root = root / subfolder
    if root.is_dir():
        candidates = [root / weight_name] if weight_name else sorted(root.glob("*.safetensors"))
        if not candidates or not candidates[0].is_file():
            raise FileNotFoundError(f"no LoRA weights under {root}")
        root = candidates[0]
    with safe_open(str(root), framework="np") as sf:
        return {key: sf.get_tensor(key) for key in sf.keys()}


def _normalise(base: str, te_ns: str | None) -> str:
    """A module path (dotted, or kohya's underscores) -> its flat key."""
    base = (base.replace(".processor.", ".").replace("_lora", "")
            .replace("to_out.0", "to_out_0").replace(".", "_"))
    if te_ns is None:
        return base
    for strip in ("text_model_encoder_", "text_model_"):
        if base.startswith(strip):
            base = base[len(strip):]
            break
    return te_ns + base.replace("_mlp_fc", "_fc")


def _module_path(name: str) -> tuple[str, str] | None:
    """A LoRA tensor name -> (module key, "A" | "B" | "alpha"), or None for a
    tensor that is not a factor (or a text-encoder name of no known
    encoder)."""
    if name.endswith(".alpha"):
        base, kind = name[: -len(".alpha")], "alpha"
    elif name.endswith((".lora_A.weight", ".lora_down.weight")):
        base, kind = name.rsplit(".lora_", 1)[0], "A"
    elif name.endswith((".lora_B.weight", ".lora_up.weight")):
        base, kind = name.rsplit(".lora_", 1)[0], "B"
    else:
        return None
    if base.startswith("lora_unet_"):
        return base[len("lora_unet_"):], kind
    te_ns = None
    for prefix, ns in (("lora_te1_", "te0:"), ("lora_te2_", "te1:"), ("lora_te_", "te0:")):
        if base.startswith(prefix):
            te_ns, base = ns, base[len(prefix):]
            break
    if te_ns is None:
        if base.startswith("unet."):
            base = base[len("unet."):]
        elif base.startswith("text_encoder_2."):
            te_ns, base = "te1:", base[len("text_encoder_2."):]
        elif base.startswith("text_encoder."):
            te_ns, base = "te0:", base[len("text_encoder."):]
        elif base.startswith("text_encoder"):
            return None
    return _normalise(base, te_ns), kind


def collect_lora_deltas(state: dict) -> dict[str, tuple]:
    """Tensors -> {module key: (A [r, in], B [out, r], alpha or None)};
    a module without both factors is left out."""
    mods: dict[str, dict] = {}
    for name, tensor in state.items():
        parsed = _module_path(name)
        if parsed is not None:
            mods.setdefault(parsed[0], {})[parsed[1]] = tensor
    return {base: (parts["A"], parts["B"],
                   float(parts["alpha"]) if "alpha" in parts else None)
            for base, parts in mods.items() if "A" in parts and "B" in parts}


def factors_nbytes(factors: dict[str, tuple]) -> int:
    """Host bytes of one adapter's raw factors."""
    return sum(int(np.asarray(a).nbytes) + int(np.asarray(b).nbytes)
               for a, b, _ in factors.values())


def load_factors(lora: dict, model_name: str, model_root_dir: str | None) -> dict[str, tuple]:
    """A resolved adapter reference -> its raw factors. The reference's
    `lora` is tried as a path, then under `model_root_dir`. A file that
    cannot be read, or that holds no factor, raises ValueError (a fatal job
    error, with the JAX package's messages)."""
    candidates = [Path(str(lora.get("lora"))).expanduser()]
    if model_root_dir:
        candidates.append(Path(model_root_dir).expanduser() / str(lora.get("lora")))
    errors = []
    for root in candidates:
        try:
            state = load_lora_state(root, lora.get("weight_name"), lora.get("subfolder"))
            break
        except OSError as e:  # FileNotFoundError, unreadable file
            errors.append(str(e))
    else:
        raise ValueError(f"Could not load lora {lora}. It might be incompatible with "
                         f"{model_name}: {'; '.join(errors)}")
    factors = collect_lora_deltas(state)
    if not factors:
        raise ValueError(f"Could not load lora {lora}: no LoRA modules found in its "
                         f"safetensors (incompatible with {model_name})")
    return factors


def linear_index(module: nn.Module, te_ns: str | None = None) -> dict[str, nn.Linear]:
    """{module key: Linear} of a UNet (`te_ns` None) or of one text
    encoder (`te_ns` "te{i}:")."""
    return {_normalise(name, te_ns): m for name, m in module.named_modules()
            if isinstance(m, nn.Linear)}


def match_factors(factors: dict[str, tuple], index: dict[str, nn.Linear]
                  ) -> tuple[dict[str, tuple], int]:
    """Factors against an index (the UNet's and every text encoder's keys
    in one dict) -> ({key: (A, B, alpha)} of the 2-D shape-exact matches,
    the number of factors that matched nothing)."""
    matched, unmatched = {}, 0
    for key, (a, b, alpha) in factors.items():
        module = index.get(key)
        a_arr, b_arr = np.asarray(a), np.asarray(b)
        if (module is None or a_arr.ndim != 2 or b_arr.ndim != 2
                or tuple(module.weight.shape) != (b_arr.shape[0], a_arr.shape[1])
                or a_arr.shape[0] != b_arr.shape[1]):
            unmatched += 1
            continue
        matched[key] = (a_arr, b_arr, alpha)
    return matched, unmatched
