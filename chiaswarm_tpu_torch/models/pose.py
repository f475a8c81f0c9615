"""Body-pose networks of the `openpose` preprocessor, the counterparts of
chiaswarm_tpu/models/pose.py:

- `OpenposeBody`: the CMU 6-stage body network (a VGG-19 trunk, then a
  PAF branch and a heatmap branch per stage) of lllyasviel's
  `body_pose_model.pth`, with pytorch-openpose's names (`model0.conv1_1`,
  `model1_1.conv5_1_CPM_L1`, `model2_1.Mconv1_stage2_L1`, ...);
  `prefixed` gives the published file's flat keys their module prefix;
- `PoseNet`: the compact heatmap network the JAX package serves for test
  model names (random weights), with flax's padding ("SAME": a stride-2
  conv pads the bottom and right edge only).
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F
from torch import nn

N_KEYPOINTS = 18
# keypoint pairs of the stick figure
LIMBS = (
    (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 8),
    (8, 9), (9, 10), (1, 11), (11, 12), (12, 13), (0, 14), (14, 16),
    (0, 15), (15, 17),
)
# openpose's grouping tables: limb keypoint pairs and their PAF channels
LIMB_SEQ = (
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
    (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
    (0, 15), (15, 17), (2, 16), (5, 17),
)
PAF_IDX = (
    (12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31),
    (34, 35), (32, 33), (36, 37), (18, 19), (26, 27),
)


@dataclasses.dataclass(frozen=True)
class PoseConfig:
    image_size: int = 368
    widths: tuple[int, ...] = (64, 128, 256)
    trunk_blocks: int = 4
    n_keypoints: int = N_KEYPOINTS


TINY_POSE = PoseConfig(image_size=64, widths=(8, 16), trunk_blocks=1)


def same_conv(x, conv: nn.Conv2d):
    """flax's "SAME" padding for a 3x3 conv: 1 each side at stride 1, the
    bottom and right edge only at stride 2 on an even input."""
    stride = conv.stride[0]
    k = conv.kernel_size[0]
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, pads))


class PoseResBlock(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv2d(width, width, 3) for _ in range(2)])

    def forward(self, x):
        h = F.relu(same_conv(x, self.conv[0]))
        return F.relu(x + same_conv(h, self.conv[1]))


class PoseNet(nn.Module):
    """[B, 3, S, S] in [-1, 1] -> heatmaps [B, K, S/2^n, S/2^n] (sigmoid)."""

    def __init__(self, config: PoseConfig = TINY_POSE):
        super().__init__()
        self.config = config
        widths = (3,) + config.widths
        self.conv = nn.ModuleList([nn.Conv2d(a, b, 3, stride=2)
                                   for a, b in zip(widths, widths[1:])])
        self.res = nn.ModuleList([PoseResBlock(config.widths[-1])
                                  for _ in range(config.trunk_blocks)])
        self.heatmaps = nn.Conv2d(config.widths[-1], config.n_keypoints, 1)

    def forward(self, x):
        for conv in self.conv:
            x = F.relu(same_conv(x, conv))
        for block in self.res:
            x = block(x)
        return torch.sigmoid(self.heatmaps(x))


def _vgg() -> list:
    layers = []
    plan = (((3, 64, "conv1_1"), (64, 64, "conv1_2")),
            ((64, 128, "conv2_1"), (128, 128, "conv2_2")),
            ((128, 256, "conv3_1"), (256, 256, "conv3_2"), (256, 256, "conv3_3"),
             (256, 256, "conv3_4")),
            ((256, 512, "conv4_1"), (512, 512, "conv4_2"), (512, 256, "conv4_3_CPM"),
             (256, 128, "conv4_4_CPM")))
    for i, stage in enumerate(plan):
        if i:
            layers.append(("pool", None))
        for cin, cout, name in stage:
            layers += [(name, nn.Conv2d(cin, cout, 3, padding=1)), ("relu", None)]
    return layers


def _stage1(branch: int, out: int) -> list:
    layers = []
    for i, cin in ((1, 128), (2, 128), (3, 128)):
        layers += [(f"conv5_{i}_CPM_L{branch}", nn.Conv2d(cin, 128, 3, padding=1)),
                   ("relu", None)]
    return layers + [(f"conv5_4_CPM_L{branch}", nn.Conv2d(128, 512, 1)), ("relu", None),
                     (f"conv5_5_CPM_L{branch}", nn.Conv2d(512, out, 1))]


def _stage(t: int, branch: int, out: int) -> list:
    layers = []
    for i in range(1, 6):
        cin = 185 if i == 1 else 128
        layers += [(f"Mconv{i}_stage{t}_L{branch}", nn.Conv2d(cin, 128, 7, padding=3)),
                   ("relu", None)]
    return layers + [(f"Mconv6_stage{t}_L{branch}", nn.Conv2d(128, 128, 1)), ("relu", None),
                     (f"Mconv7_stage{t}_L{branch}", nn.Conv2d(128, out, 1))]


class _Chain(nn.Module):
    """Named convs with ReLUs and 2x2 max-pools between them."""

    def __init__(self, layers: list):
        super().__init__()
        self.order = []
        for name, module in layers:
            if module is not None:
                self.add_module(name, module)
            self.order.append(name)

    def forward(self, x):
        for name in self.order:
            if name == "relu":
                x = F.relu(x)
            elif name == "pool":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = getattr(self, name)(x)
        return x


class OpenposeBody(nn.Module):
    """[B, 3, H, W] (x/256 - 0.5) -> (paf [B, 38, H/8, W/8], heatmap [B, 19, H/8, W/8])."""

    def __init__(self):
        super().__init__()
        self.model0 = _Chain(_vgg())
        self.model1_1 = _Chain(_stage1(1, 38))
        self.model1_2 = _Chain(_stage1(2, 19))
        for t in range(2, 7):
            self.add_module(f"model{t}_1", _Chain(_stage(t, 1, 38)))
            self.add_module(f"model{t}_2", _Chain(_stage(t, 2, 19)))

    def forward(self, pixels):
        feats = self.model0(pixels)
        paf, heat = self.model1_1(feats), self.model1_2(feats)
        for t in range(2, 7):
            x = torch.cat([paf, heat, feats], dim=1)
            paf = getattr(self, f"model{t}_1")(x)
            heat = getattr(self, f"model{t}_2")(x)
        return paf, heat


def prefixed(state: dict) -> dict:
    """The published file's flat caffe-style keys (`conv1_1.weight`,
    `Mconv1_stage2_L1.weight`) with the module prefix pytorch-openpose
    gives them; a prefixed dict passes through."""
    if any(k.startswith("model") for k in state):
        return state

    def prefix(name: str) -> str:
        if m := re.match(r"Mconv\d+_stage(\d+)_L([12])\.", name):
            return f"model{m.group(1)}_{m.group(2)}."
        if m := re.match(r"conv5_\d+_CPM_L([12])\.", name):
            return f"model1_{m.group(1)}."
        return "model0."

    return {prefix(k) + k: v for k, v in state.items()}
