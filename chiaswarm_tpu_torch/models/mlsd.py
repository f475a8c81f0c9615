"""M-LSD line-segment detector (MobileV2_MLSD_Large), the counterpart of
chiaswarm_tpu/models/mlsd.py: the model behind `mlsd`.

A 4-channel MobileNetV2 trunk (its first 14 feature blocks, ReLU6,
inverted residuals) whose five taps feed A/B/C fusion blocks (1x1 fuse
with a corner-aligned 2x upsample, 3x3 residual refine, a dilated head);
the last 9 of the 16 output channels, at half the input's size, are the
TP map (centre logit, then start and end displacements) that the host
decodes into segments.

Parameter names are the published checkpoint's (`backbone.features.N.conv...`,
`blockN.convM.0`), each conv with a bias: `fold_batchnorms` folds the
checkpoint's BatchNorms (eval-mode statistics) into the conv before them,
as the JAX converter does, and leaves a folded state as it is. The
padding is the JAX module's (symmetric, also at stride 2).
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from .resize import resize_align_corners

# the trunk's inverted-residual plan: (expansion, channels, repeats, stride)
MBV2_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1))
FPN_TAPS = (1, 3, 6, 10, 13)
STEM = 32
HEAD = 64
OUT = 16
BN_EPS = 1e-5


def _conv(cin, cout, k, stride=1, groups=1, dilation=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k - 1) // 2,
                     groups=groups, dilation=dilation)


def relu6(x):
    return F.hardtanh(x, 0.0, 6.0)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int):
        super().__init__()
        hidden = round(cin * expand)
        self.residual = stride == 1 and cin == cout
        self.expand = expand
        if expand == 1:
            self.conv = nn.ModuleList([nn.ModuleList([_conv(hidden, hidden, 3, stride, hidden)]),
                                       _conv(hidden, cout, 1)])
        else:
            self.conv = nn.ModuleList([nn.ModuleList([_conv(cin, hidden, 1)]),
                                       nn.ModuleList([_conv(hidden, hidden, 3, stride, hidden)]),
                                       _conv(hidden, cout, 1)])

    def forward(self, x):
        h = x
        if self.expand != 1:
            h = relu6(self.conv[0][0](h))
            h = self.conv[2](relu6(self.conv[1][0](h)))
        else:
            h = self.conv[1](relu6(self.conv[0][0](h)))
        return x + h if self.residual else h


class BlockA(nn.Module):
    """1x1 fuse of a lateral tap and the carried map (optionally upsampled 2x)."""

    def __init__(self, lateral: int, carried: int, out: int, upscale: bool = True):
        super().__init__()
        self.upscale = upscale
        self.conv1 = nn.ModuleList([_conv(carried, out, 1)])
        self.conv2 = nn.ModuleList([_conv(lateral, out, 1)])

    def forward(self, lateral, carried):
        b = F.relu(self.conv1[0](carried))
        a = F.relu(self.conv2[0](lateral))
        if self.upscale:
            b = resize_align_corners(b, 2 * b.shape[-2], 2 * b.shape[-1])
        return torch.cat([a, b], dim=1)


class BlockB(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.ModuleList([_conv(cin, cin, 3)])
        self.conv2 = nn.ModuleList([_conv(cin, cout, 3)])

    def forward(self, x):
        x = F.relu(self.conv1[0](x)) + x
        return F.relu(self.conv2[0](x))


class BlockC(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.ModuleList([_conv(cin, cin, 3, dilation=5)])
        self.conv2 = nn.ModuleList([_conv(cin, cin, 3)])
        self.conv3 = _conv(cin, cout, 1)

    def forward(self, x):
        x = F.relu(self.conv1[0](x))
        x = F.relu(self.conv2[0](x))
        return self.conv3(x)


class MLSDNet(nn.Module):
    """[B, 4, H, W] in [-1, 1] -> [B, 9, H/2, W/2] TP map."""

    def __init__(self):
        super().__init__()
        features = [nn.ModuleList([_conv(4, STEM, 3, 2)])]
        cin = STEM
        widths = {}
        for t, c, n, s in MBV2_SETTING:
            for i in range(n):
                features.append(InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
                widths[len(features) - 1] = c
        self.backbone = nn.Module()
        self.backbone.features = nn.ModuleList(features)
        c1, c2, c3, c4, c5 = (widths[i] for i in FPN_TAPS)
        self.block15 = BlockA(c4, c5, HEAD, upscale=False)
        self.block16 = BlockB(2 * HEAD, HEAD)
        self.block17 = BlockA(c3, HEAD, HEAD)
        self.block18 = BlockB(2 * HEAD, HEAD)
        self.block19 = BlockA(c2, HEAD, HEAD)
        self.block20 = BlockB(2 * HEAD, HEAD)
        self.block21 = BlockA(c1, HEAD, HEAD)
        self.block22 = BlockB(2 * HEAD, HEAD)
        self.block23 = BlockC(HEAD, OUT)

    def forward(self, x):
        feats = self.backbone.features
        x = relu6(feats[0][0](x))
        taps = {}
        for idx in range(1, len(feats)):
            x = feats[idx](x)
            if idx in FPN_TAPS:
                taps[idx] = x
        c1, c2, c3, c4, c5 = (taps[i] for i in FPN_TAPS)
        x = self.block16(self.block15(c4, c5))
        x = self.block18(self.block17(c3, x))
        x = self.block20(self.block19(c2, x))
        x = self.block22(self.block21(c1, x))
        return self.block23(x)[:, 7:]


def fold_batchnorms(state: dict) -> dict:
    """The published state (conv, then BatchNorm at the next index;
    DataParallel's `module.` prefix allowed) -> this module's, every
    BatchNorm folded into its conv's weight and bias."""
    state = {k.removeprefix("module."): torch.as_tensor(v).float() for k, v in state.items()}
    out = {}
    for key, w in state.items():
        if not key.endswith(".weight") or w.ndim != 4:
            continue
        conv = key[:-len(".weight")]
        m = re.match(r"(.*\.)(\d+)$", conv)
        bn = f"{m.group(1)}{int(m.group(2)) + 1}" if m else None
        b = state.get(f"{conv}.bias")
        if bn is not None and f"{bn}.running_var" in state:
            scale = state[f"{bn}.weight"] / torch.sqrt(state[f"{bn}.running_var"] + BN_EPS)
            w = w * scale[:, None, None, None]
            b = state[f"{bn}.bias"] + ((0.0 if b is None else b) - state[f"{bn}.running_mean"]) * scale
        out[key] = w
        out[f"{conv}.bias"] = torch.zeros(w.shape[0]) if b is None else b
    return out
