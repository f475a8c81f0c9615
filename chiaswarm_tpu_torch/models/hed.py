"""HED edge detector (lllyasviel's ControlNetHED), the counterpart of
chiaswarm_tpu/models/hed.py: the model behind `scribble` and `soft
edge`'s second choice.

A VGG-style backbone of five stages; each stage's 1x1 projection gives a
one-channel edge logit map. Parameter names are the checkpoint's (`norm`,
`blockN.convs.M`, `blockN.projection`), so ControlNetHED.pth loads as
published.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class HEDConfig:
    channels: tuple[int, ...] = (64, 128, 256, 512, 512)
    layers: tuple[int, ...] = (2, 2, 3, 3, 3)


TINY_HED = HEDConfig(channels=(8, 16), layers=(1, 1))


class HEDBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_convs: int):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels if i == 0 else out_channels, out_channels, 3, padding=1)
            for i in range(n_convs)])
        self.projection = nn.Conv2d(out_channels, 1, 1)

    def forward(self, x):
        for conv in self.convs:
            x = F.relu(conv(x))
        return x, self.projection(x)


class HEDNet(nn.Module):
    """[B, 3, H, W] RGB in 0..255 -> per-stage edge logits [B, 1, H/2^i, W/2^i]."""

    def __init__(self, config: HEDConfig = HEDConfig()):
        super().__init__()
        self.config = config
        self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1))
        prev = 3
        for i, (ch, n) in enumerate(zip(config.channels, config.layers)):
            self.add_module(f"block{i + 1}", HEDBlock(prev, ch, n))
            prev = ch

    def forward(self, pixels):
        x = pixels - self.norm
        projections = []
        for i in range(len(self.config.channels)):
            if i > 0:
                x = F.max_pool2d(x, 2, 2)
            x, proj = getattr(self, f"block{i + 1}")(x)
            projections.append(proj)
        return projections
