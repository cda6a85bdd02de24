"""Mel-spectrogram audio encoders.

Counterpart of the JAX package's `models/audio.py` (reference
`src/models/audio.py`): `AudioCNN` (lightweight), `AudioResNet18` (the
reference's "ResNet"-style stack whose blocks have NO residual adds,
`src/models/audio.py:93-100`, kept for checkpoint parity) and the `AudioNet`
wrapper with the encoder contract the fusion model reads (`embedding_dim`,
`sequence_dim`, `encode`, `encode_sequence`).

Inputs are [B, 1, n_mels, T]; the convolutions are NCHW `F.conv2d` (outside
any Pallas kernel in the JAX package too).  The module attributes are the
reference's state-dict keys (`encoder.features.0`, `encoder.layer2.1.3`, ...).
BatchNorm follows the Flax rule of `models/resnet.py` (Flax momentum 0.9 is
torch's 0.1).  `train` is an argument of the forward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodalemotionrecognition_torch.models.resnet import EvalBatchNorm2d
from multimodalemotionrecognition_torch.models.temporal import TemporalPooler, check_head as _check_head
from multimodalemotionrecognition_torch.ops.image import adaptive_avg_pool_2d
from multimodalemotionrecognition_torch.ops.stochastic import RngStreams, spec_augment

__all__ = ["AudioCNN", "AudioNet", "AudioResNet18"]


def _sequence_pool(x: torch.Tensor, temporal_bins: int) -> torch.Tensor:
    """AdaptiveAvgPool2d((1, temporal_bins)) + squeeze + transpose
    (`src/models/audio.py:113,149`): [B, C, H, W] -> [B, temporal_bins, C]."""
    return adaptive_avg_pool_2d(x, (1, temporal_bins))[:, :, 0, :].transpose(1, 2)


def _run(seq: nn.Sequential, x: torch.Tensor, train: bool) -> torch.Tensor:
    """An `nn.Sequential` whose BatchNorms take `train`."""
    for layer in seq:
        x = layer(x, train) if isinstance(layer, EvalBatchNorm2d) else layer(x)
    return x


class AudioCNN(nn.Module):
    """Lightweight 3-conv mel encoder (`src/models/audio.py:122-154`):
    [B, 1, n_mels, T] -> sequence features [B, temporal_bins, embedding_dim]."""

    def __init__(self, embedding_dim: int = 128, temporal_bins: int = 16):
        super().__init__()
        self.temporal_bins = temporal_bins
        layers, cin = [], 1
        for i, cout in enumerate((16, 32, 64)):
            layers += [nn.Conv2d(cin, cout, 3, padding=1), EvalBatchNorm2d(cout), nn.ReLU()]
            # Indices 3 and 7 are the reference's max pools; its last slot
            # (the adaptive pool, done in `_sequence_pool`) holds no state.
            layers.append(nn.MaxPool2d(2, 2) if i < 2 else nn.Identity())
            cin = cout
        self.features = nn.Sequential(*layers)
        self.proj = nn.Sequential(nn.Linear(64, embedding_dim), nn.ReLU())

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.proj(_sequence_pool(_run(self.features, x, train), self.temporal_bins))


def _block(cin: int, cout: int) -> nn.Sequential:
    """conv-bn-relu-conv-bn, applied in sequence: no skip, no ReLU after the
    second norm (`_make_block`, `src/models/audio.py:93-100`)."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, 3, padding=1, bias=False), EvalBatchNorm2d(cout), nn.ReLU(),
        nn.Conv2d(cout, cout, 3, padding=1, bias=False), EvalBatchNorm2d(cout),
    )


class AudioResNet18(nn.Module):
    """The reference's ResNet18-style mel encoder (`src/models/audio.py:55-119`),
    faithfully NON-residual; a stage transition is a conv1x1 + bn applied as a
    plain stage (`layerN.0`), followed by two blocks (`layerN.1`, `layerN.2`)."""

    def __init__(self, embedding_dim: int = 128, temporal_bins: int = 16):
        super().__init__()
        self.temporal_bins = temporal_bins
        self.conv1 = nn.Conv2d(1, 64, 7, 2, padding=3, bias=False)
        self.bn1 = EvalBatchNorm2d(64)
        self.layer1 = nn.Sequential(_block(64, 64), _block(64, 64))
        cin = 64
        for idx, cout in ((2, 128), (3, 256), (4, 512)):
            downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, 2, bias=False), EvalBatchNorm2d(cout)
            )
            setattr(self, f"layer{idx}", nn.Sequential(
                downsample, _block(cout, cout), _block(cout, cout)
            ))
            cin = cout
        self.fc = nn.Linear(512, embedding_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x), train))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for stage in layer:
                h = _run(stage, h, train)
        return self.fc(_sequence_pool(h, self.temporal_bins))


class AudioNet(nn.Module):
    """Audio branch wrapper (`src/models/audio.py:157-206`): encode_sequence
    -> [B, 16, D]; encode -> [B, D] (temporal pooled); forward -> logits.
    SpecAugment runs in train mode only, with the reference's parameters,
    from the "specaugment" stream.

    `head` says how much is declared, as the JAX modules create only what a
    fusion mode calls: "none" the encoder alone (the cross-attention modes
    read `encode_sequence`), "pool" with the temporal pooler (concat and
    gated read `encode`), "full" with the classifier too (audio, late)."""

    def __init__(
        self, num_classes: int, embedding_dim: int = 128, use_resnet: bool = True,
        spec_augment: bool = True, temporal_pooling: str = "mean",
        temporal_num_heads: int = 4, temporal_num_layers: int = 1,
        temporal_dropout: float = 0.1, head: str = "full",
    ):
        super().__init__()
        _check_head(head)
        self.embedding_dim = embedding_dim
        self.spec_augment = spec_augment
        self.encoder = (AudioResNet18 if use_resnet else AudioCNN)(embedding_dim)
        if head != "none":
            self.temporal_pool = TemporalPooler(
                embedding_dim, temporal_pooling, temporal_dropout,
                num_heads=temporal_num_heads, num_layers=temporal_num_layers,
            )
        if head == "full":
            self.classifier = nn.Linear(embedding_dim, num_classes)

    @property
    def sequence_dim(self) -> int:
        return self.embedding_dim

    def encode_sequence(
        self, x: torch.Tensor, train: bool = False, rng: Optional[RngStreams] = None
    ) -> torch.Tensor:
        if self.spec_augment and train:
            if rng is None:
                raise ValueError("a train-mode forward needs rng (RngStreams)")
            x = spec_augment(rng.device("specaugment"), x)
        return self.encoder(x, train)

    def encode(
        self, x: torch.Tensor, train: bool = False, rng: Optional[RngStreams] = None
    ) -> torch.Tensor:
        gen = rng.device("dropout") if train and rng is not None else None
        return self.temporal_pool(self.encode_sequence(x, train, rng), gen)

    def forward(
        self, x: torch.Tensor, train: bool = False, rng: Optional[RngStreams] = None
    ) -> torch.Tensor:
        return self.classifier(self.encode(x, train, rng))
