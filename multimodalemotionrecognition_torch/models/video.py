"""Video branch: per-frame ResNet18 + temporal pooling.

Counterpart of the JAX package's `models/video.py` (reference
`src/models/video.py:10-44`).  Frames are folded into the batch for one
backbone pass.  `head` says how much is declared, as the JAX module creates
only what a fusion mode calls: "none" the backbone alone (the
cross-attention modes tap `encode_frames`), "pool" with the temporal pooler
(concat and gated read `encode`), "full" with the classifier too (video,
late).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodalemotionrecognition_torch.models.resnet import ResNet18Backbone
from multimodalemotionrecognition_torch.models.temporal import TemporalPooler, check_head
from multimodalemotionrecognition_torch.ops.stochastic import RngStreams

__all__ = ["VideoNet"]


class VideoNet(nn.Module):
    embedding_dim = 512

    def __init__(
        self, num_classes: int = 8, temporal_pooling: str = "mean",
        temporal_num_heads: int = 4, temporal_num_layers: int = 1,
        temporal_dropout: float = 0.1, head: str = "none",
    ):
        super().__init__()
        check_head(head)
        self.backbone = ResNet18Backbone()
        if head != "none":
            self.temporal_pool = TemporalPooler(
                self.embedding_dim, temporal_pooling, temporal_dropout,
                num_heads=temporal_num_heads, num_layers=temporal_num_layers,
            )
        if head == "full":
            self.classifier = nn.Linear(self.embedding_dim, num_classes)

    def encode_frames(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, T, 3, H, W] -> per-frame features [B, T, 512]; frames are
        folded into the batch for one backbone pass.  `train` puts every
        BatchNorm in batch-statistics mode (`models/resnet.py`)."""
        b, t, c, h, w = x.shape
        feats = self.backbone(x.reshape(b * t, c, h, w), train)
        return feats.view(b, t, self.embedding_dim)

    def encode(
        self, x: torch.Tensor, train: bool = False, rng: Optional[RngStreams] = None
    ) -> torch.Tensor:
        gen = rng.device("dropout") if train and rng is not None else None
        return self.temporal_pool(self.encode_frames(x, train), gen)

    def forward(
        self, x: torch.Tensor, train: bool = False, rng: Optional[RngStreams] = None
    ) -> torch.Tensor:
        return self.classifier(self.encode(x, train, rng))
