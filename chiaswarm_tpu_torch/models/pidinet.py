"""PiDiNet soft-edge detector (table5_pidinet, the 'carv4' config), the
counterpart of chiaswarm_tpu/models/pidinet.py: `soft edge`'s first
choice.

Four stages of pixel-difference blocks (depthwise conv, ReLU, pointwise,
residual; a 2x2 max-pool and a 1x1 shortcut where a stage starts), each
stage refined by a dilation module (four dilated 3x3) and spatial
attention, reduced to one logit map, upsampled to the input and fused by
a 1x1 classifier; the fused map leaves through a sigmoid.

Parameter names are the published checkpoint's (`init_block`,
`blockS_J.conv1`, `dilations.I.conv2_D`, `attentions.I`, `conv_reduces.I.conv`,
`classifier`). The checkpoint stores raw pixel-difference kernels;
`reparameterize` turns them into the plain kernels this graph runs (the
authors' `convert_pdc`, as the JAX converter does: the 'rd' kernels grow
to 5x5), and `is_raw` tells the two forms apart by those kernels' size.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .resize import resize_bilinear

# the pixel-difference op of each of the 16 layers: (cd, ad, rd, cv) x 4
CARV4 = ("cd", "ad", "rd", "cv") * 4
STAGE_PLANES = (60, 120, 240, 240)
DIL = 24


def _blocks():
    """(name, layer index, stage, stride) of every PDC block."""
    for s in range(4):
        for j in range(3 if s == 0 else 4):
            layer = j + 1 if s == 0 else s * 4 + j
            yield f"block{s + 1}_{j + 1}", layer, s, 2 if (s > 0 and j == 0) else 1


class PDCBlock(nn.Module):
    def __init__(self, pdc: str, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.stride = stride
        k = 5 if pdc == "rd" else 3
        self.conv1 = nn.Conv2d(in_ch, in_ch, k, padding=k // 2, groups=in_ch, bias=False)
        self.conv2 = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        if stride > 1:
            self.shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        if self.stride > 1:
            x = F.max_pool2d(x, 2, 2)
        y = self.conv2(F.relu(self.conv1(x)))
        if self.stride > 1:
            x = self.shortcut(x)
        return y + x


class CDCM(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 1)
        for i, d in enumerate((5, 7, 9, 11)):
            self.add_module(f"conv2_{i + 1}", nn.Conv2d(out_ch, out_ch, 3, padding=d,
                                                        dilation=d, bias=False))

    def forward(self, x):
        x = self.conv1(F.relu(x))
        return sum(getattr(self, f"conv2_{i}")(x) for i in range(1, 5))


class CSAM(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, 4, 1)
        self.conv2 = nn.Conv2d(4, 1, 3, padding=1, bias=False)

    def forward(self, x):
        return x * torch.sigmoid(self.conv2(self.conv1(F.relu(x))))


class MapReduce(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, 1, 1)

    def forward(self, x):
        return self.conv(x)


class PiDiNet(nn.Module):
    """[B, 3, H, W] in [0, 1] -> [B, 1, H, W] fused edge probability."""

    def __init__(self):
        super().__init__()
        self.init_block = nn.Conv2d(3, STAGE_PLANES[0], 3, padding=1, bias=False)
        prev = STAGE_PLANES[0]
        for name, layer, s, stride in _blocks():
            self.add_module(name, PDCBlock(CARV4[layer], prev, STAGE_PLANES[s], stride))
            prev = STAGE_PLANES[s]
        self.dilations = nn.ModuleList([CDCM(c, DIL) for c in STAGE_PLANES])
        self.attentions = nn.ModuleList([CSAM(DIL) for _ in STAGE_PLANES])
        self.conv_reduces = nn.ModuleList([MapReduce(DIL) for _ in STAGE_PLANES])
        self.classifier = nn.Conv2d(4, 1, 1)

    def forward(self, x):
        h, w = x.shape[-2:]
        x = self.init_block(x)
        stage_outs = []
        for name, _, s, _ in _blocks():
            x = getattr(self, name)(x)
            if name.endswith("_3" if s == 0 else "_4"):
                stage_outs.append(x)
        logits = []
        for i, xi in enumerate(stage_outs):
            y = self.conv_reduces[i](self.attentions[i](self.dilations[i](xi)))
            logits.append(resize_bilinear(y.float(), h, w))
        fused = self.classifier(torch.cat(logits, dim=1).to(x.dtype))
        return torch.sigmoid(fused.float())


def _convert_pdc(op: str, w: np.ndarray) -> np.ndarray:
    """A raw pixel-difference kernel [O, I, 3, 3] -> the plain kernel of the
    same response (cd and ad stay 3x3, rd becomes 5x5)."""
    if op == "cv":
        return w
    o, i = w.shape[:2]
    flat = w.reshape(o, i, -1).copy()
    if op == "cd":
        flat[:, :, 4] = flat[:, :, 4] - w.sum(axis=(2, 3))
        return flat.reshape(w.shape)
    if op == "ad":
        return (flat - flat[:, :, [3, 0, 1, 6, 4, 2, 7, 8, 5]]).reshape(w.shape)
    if op == "rd":
        buffer = np.zeros((o, i, 25), w.dtype)
        buffer[:, :, [0, 2, 4, 10, 14, 20, 22, 24]] = flat[:, :, 1:]
        buffer[:, :, [6, 7, 8, 11, 13, 16, 17, 18]] = -flat[:, :, 1:]
        return buffer.reshape(o, i, 5, 5)
    raise ValueError(f"unknown pdc op {op}")


def is_raw(state: dict) -> bool:
    """True for the published form (raw 3x3 'rd' kernels)."""
    return tuple(state["block1_2.conv1.weight"].shape[-2:]) == (3, 3)


def reparameterize(state: dict) -> dict:
    """The published checkpoint's state (a `state_dict` wrapper and
    DataParallel's `module.` prefix allowed) -> this module's."""
    if "state_dict" in state and not any(k.startswith(("init_block", "block")) for k in state):
        state = state["state_dict"]
    state = {k.removeprefix("module."): v for k, v in state.items()}
    if not is_raw(state):
        return state
    ops = {"init_block": CARV4[0], **{name: CARV4[layer] for name, layer, _, _ in _blocks()}}
    out = dict(state)
    for name, op in ops.items():
        key = f"{name}.weight" if name == "init_block" else f"{name}.conv1.weight"
        w = np.asarray(state[key], np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(_convert_pdc(op, w)))
    return out
