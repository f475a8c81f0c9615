"""LineArt generator (informative-drawings `Generator`), the counterpart of
chiaswarm_tpu/models/lineart.py: the model behind `lineart`.

A reflect-padded 7x7 stem, two stride-2 convs, residual blocks, two
transposed convs and a 7x7 head with a sigmoid; every norm an affine-free
InstanceNorm (biased variance, eps 1e-5). Built as the published module
is, out of `nn.Sequential`s, so sk_model.pth's keys (`model0.1`,
`model1.0`, `model2.N.conv_block.1`, `model3.0`, `model4.1`) load as
they are; the JAX package's input-dilated convs are the transposed convs
here.
"""

from __future__ import annotations

import dataclasses
import re

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class LineartConfig:
    base_channels: int = 64
    n_residual_blocks: int = 3


TINY_LINEART = LineartConfig(base_channels=8, n_residual_blocks=1)


class ResidualBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(channels, channels, 3),
            nn.InstanceNorm2d(channels), nn.ReLU(),
            nn.ReflectionPad2d(1), nn.Conv2d(channels, channels, 3),
            nn.InstanceNorm2d(channels))

    def forward(self, x):
        return x + self.conv_block(x)


class LineartGenerator(nn.Module):
    """[B, 3, H, W] in [0, 1] -> [B, 1, H, W] sketch (dark strokes near 0)."""

    def __init__(self, config: LineartConfig = LineartConfig()):
        super().__init__()
        self.config = config
        c = config.base_channels
        self.model0 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(3, c, 7),
                                    nn.InstanceNorm2d(c), nn.ReLU())
        self.model1 = nn.Sequential(
            nn.Conv2d(c, 2 * c, 3, stride=2, padding=1), nn.InstanceNorm2d(2 * c), nn.ReLU(),
            nn.Conv2d(2 * c, 4 * c, 3, stride=2, padding=1), nn.InstanceNorm2d(4 * c),
            nn.ReLU())
        self.model2 = nn.Sequential(*[ResidualBlock(4 * c)
                                      for _ in range(config.n_residual_blocks)])
        self.model3 = nn.Sequential(
            nn.ConvTranspose2d(4 * c, 2 * c, 3, stride=2, padding=1, output_padding=1),
            nn.InstanceNorm2d(2 * c), nn.ReLU(),
            nn.ConvTranspose2d(2 * c, c, 3, stride=2, padding=1, output_padding=1),
            nn.InstanceNorm2d(c), nn.ReLU())
        self.model4 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(c, 1, 7), nn.Sigmoid())

    def forward(self, x):
        return self.model4(self.model3(self.model2(self.model1(self.model0(x)))))


def config_from_state(state: dict) -> LineartConfig:
    """The generator's widths from a checkpoint (as the JAX package's
    `infer_lineart_config`)."""
    blocks = [int(m.group(1)) for k in state
              if (m := re.match(r"model2\.(\d+)\.conv_block\.1\.weight", k))]
    return LineartConfig(base_channels=int(torch.as_tensor(state["model0.1.weight"]).shape[0]),
                         n_residual_blocks=max(blocks) + 1 if blocks else 0)
