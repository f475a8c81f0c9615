"""LoRA reference resolution, a copy of chiaswarm_tpu/loras.py.

Parses a job's `lora` string into {lora, weight_name, subfolder}:

  "name"                              -> the file `name` under lora_root_dir
  "publisher/repo"                    -> a repo's default weights
  "publisher/repo/file.safetensors"   -> a repo's weight file
  "publisher/repo/sub/dirs/file.st"   -> a repo's file in a nested subfolder

Nothing is downloaded: a repo reference resolves under the model root
(models/lora.py `load_factors`), as in the JAX package.
"""

from __future__ import annotations

import os


def resolve_lora(lora: str, lora_root_dir: str) -> dict:
    parts = [p for p in lora.split("/") if p]
    if len(parts) == 1:
        return {"lora": os.path.expanduser(lora_root_dir), "weight_name": parts[0],
                "subfolder": None}
    if len(parts) == 2:
        return {"lora": f"{parts[0]}/{parts[1]}", "weight_name": None, "subfolder": None}
    if len(parts) == 3:
        return {"lora": f"{parts[0]}/{parts[1]}", "weight_name": parts[2], "subfolder": None}
    return {"lora": f"{parts[0]}/{parts[1]}", "weight_name": parts[-1],
            "subfolder": "/".join(parts[2:-1])}
