"""ResNet18 frame encoder in the torchvision layout, eval mode.

Counterpart of the JAX package's `models/resnet.py`.  The reference wraps
torchvision `resnet18` minus its FC head in an `nn.Sequential`
(`src/models/video.py:21-23`), so the keys are `0.*` (conv1), `1.*` (bn1)
and `4.0.*` ... `7.1.*` (layer1..layer4).  NCHW; the convolutions are
`F.conv2d` (the JAX package left them to XLA too, not to Pallas).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["BasicBlock", "EvalBatchNorm2d", "ResNet18Backbone"]


class EvalBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with running statistics only (eps 1e-5): the scale and
    shift are formed in float32 from the stored statistics and applied in
    the input's dtype, so a bf16 model keeps float32 statistics' accuracy."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        shape = (1, -1, 1, 1)
        mean = self.running_mean.to(x.dtype).view(shape)
        return (x - mean) * mul.to(x.dtype).view(shape) + self.bias.to(x.dtype).view(shape)


def _conv(cin: int, cout: int, kernel: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=False)


class BasicBlock(nn.Module):
    """torchvision BasicBlock (children conv1/bn1/conv2/bn2/downsample.{0,1})."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride)
        self.bn1 = EvalBatchNorm2d(cout)
        self.conv2 = _conv(cout, cout, 3, 1)
        self.bn2 = EvalBatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), EvalBatchNorm2d(cout)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet18Backbone(nn.Sequential):
    """torchvision resnet18 children[:-1]: [N, 3, H, W] -> [N, 512]
    (global average pooled)."""

    def __init__(self):
        layers = [
            nn.Conv2d(3, 64, 7, 2, padding=3, bias=False),
            EvalBatchNorm2d(64),
            nn.ReLU(),
            nn.MaxPool2d(3, 2, padding=1),
        ]
        cin = 64
        for stage, cout in enumerate((64, 128, 256, 512)):
            stride = 1 if stage == 0 else 2
            layers.append(
                nn.Sequential(BasicBlock(cin, cout, stride), BasicBlock(cout, cout, 1))
            )
            cin = cout
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).mean(dim=(2, 3))  # AdaptiveAvgPool2d(1)
