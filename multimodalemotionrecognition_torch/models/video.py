"""Video branch: per-frame ResNet18.

Counterpart of the JAX package's `models/video.py`.  Only `encode_frames`,
the part the cross-attention fusion taps, is ported: the xattn forward never
creates `VideoNet.classifier` or `temporal_pool`, so they are not declared
here either (they come with the late/concat/gated modes).
"""

from __future__ import annotations

import torch
from torch import nn

from multimodalemotionrecognition_torch.models.resnet import ResNet18Backbone

__all__ = ["VideoNet"]


class VideoNet(nn.Module):
    embedding_dim = 512

    def __init__(self):
        super().__init__()
        self.backbone = ResNet18Backbone()

    def encode_frames(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, 3, H, W] -> per-frame features [B, T, 512]; frames are
        folded into the batch for one backbone pass."""
        b, t, c, h, w = x.shape
        feats = self.backbone(x.reshape(b * t, c, h, w))
        return feats.view(b, t, self.embedding_dim)
