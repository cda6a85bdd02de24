"""Library entry: the flagship forward with its example arguments.

Counterpart of the JAX package's `__graft_entry__.py::entry`: the flagship
(bidirectional cross-attention fusion, WavLM audio branch, ResNet18 video
branch, raw waveform in) at batch 1, for a single-card start-up check.
Runs on the card unless the caller passes `device="cpu"`; raises without one.
"""

from __future__ import annotations

import torch

from multimodalemotionrecognition_torch.config import ModelConfig
from multimodalemotionrecognition_torch.models.factory import build_model

__all__ = ["entry"]


def entry(device="cuda", **config_overrides):
    """-> (forward, (model, video, audio)); forward(model, video, audio)
    gives the probabilities [1, 8]."""
    config = ModelConfig(**{**dict(
        fusion="xattn",
        use_wavlm=True,
        num_classes=8,
        xattn_attn_dropout=0.0,
        xattn_stochastic_depth=0.0,
    ), **config_overrides})
    model = build_model(config, device=device)
    device = next(model.parameters()).device
    video = torch.zeros(1, 8, 3, 112, 112, device=device)
    audio = torch.zeros(1, 1, 48000, device=device)

    def forward(model, video, audio):
        with torch.no_grad():
            return torch.softmax(model(video, audio), dim=1)

    return forward, (model, video, audio)
