"""ResNet18 frame encoder in the torchvision layout, eval and train mode.

Counterpart of the JAX package's `models/resnet.py`.  The reference wraps
torchvision `resnet18` minus its FC head in an `nn.Sequential`
(`src/models/video.py:21-23`), so the keys are `0.*` (conv1), `1.*` (bn1)
and `4.0.*` ... `7.1.*` (layer1..layer4).  NCHW; the convolutions are
`F.conv2d` (the JAX package left them to XLA too, not to Pallas).

Train-mode BatchNorm follows Flax's `nn.BatchNorm` (momentum 0.9 there, 0.1
in torch's convention), which the JAX package trains with, and not stock
`torch.nn.BatchNorm2d`: the running variance is updated with the biased
batch variance (torch uses the unbiased one), and the statistics are taken
in float32 as E[x^2] - E[x]^2.  `train=True` reaches every BatchNorm of the
tower, frozen blocks included, as in the JAX model.  Inside a data-parallel
step (`parallel.distributed.batch_shard`) the statistics are the GLOBAL
batch's, as JAX's jit over a sharded batch takes them: the per-channel sum,
sum of squares and element count are summed over the ranks (the sums
differentiably), so every rank normalises alike and its running statistics
move identically.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodalemotionrecognition_torch.parallel.distributed import current_shard

__all__ = ["BasicBlock", "EvalBatchNorm2d", "ResNet18Backbone"]


class EvalBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5).  Eval: running statistics only; the scale and
    shift are formed in float32 from the stored statistics and applied in
    the input's dtype, so a bf16 model keeps float32 statistics' accuracy.
    `train=True`: batch statistics in float32, and the running statistics
    move by `momentum` towards the batch mean and the biased batch variance
    (Flax's rule), in place."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if train:
            xf = x.float()
            count = torch.full_like(xf[0, :, 0, 0], xf.numel() // xf.shape[1])
            sums = current_shard().sum(
                torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count]))
            mean = sums[0] / sums[2]
            var = (sums[1] / sums[2] - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
                self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
                self.num_batches_tracked += 1
            mul = torch.rsqrt(var + self.eps) * self.weight.float()
            y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)
            return y.to(x.dtype)
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](self.downsample[0](x), train)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, EvalBatchNorm2d):
                x = layer(x, train)
            elif isinstance(layer, nn.Sequential):
                for block in layer:
                    x = block(x, train)
            else:
                x = layer(x)
        return x.mean(dim=(2, 3))  # AdaptiveAvgPool2d(1)
