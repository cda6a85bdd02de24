"""Temporal aggregation: mean or learnable attention pooling.

Counterpart of the JAX package's `models/temporal.py` (reference
`src/models/temporal.py:9-110`), with the same state-dict paths
(`pool.score.{0,1,4}.*`).  The transformer pooler is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["TemporalAttentionPooling", "TemporalPooler"]


class TemporalAttentionPooling(nn.Module):
    """Softmax attention pooling over time:
    score = Linear(h,1) . Dropout . GELU . Linear(d,h) . LayerNorm, h = d//2."""

    def __init__(self, dim: int, dropout: float = 0.1):
        super().__init__()
        hidden = max(1, dim // 2)
        self.score = nn.Sequential(
            nn.LayerNorm(dim, eps=1e-5),
            nn.Linear(dim, hidden),
            nn.GELU(),
            nn.Dropout(dropout),
            nn.Linear(hidden, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = torch.softmax(self.score(x).squeeze(-1).float(), dim=1)
        return torch.sum(x * attn.to(x.dtype)[..., None], dim=1)


class TemporalPooler(nn.Module):
    """[B, T, D] -> [B, D] by `mode` ("mean" or "attn")."""

    def __init__(self, dim: int, mode: str = "mean", dropout: float = 0.1):
        super().__init__()
        if mode == "transformer":
            raise NotImplementedError(
                "temporal_pooling='transformer' is not ported yet (ROADMAP queue 1, item 4)"
            )
        if mode not in ("mean", "attn"):
            raise ValueError(f"Unsupported temporal pooling mode: {mode}")
        self.mode = mode
        if mode == "attn":
            self.pool = TemporalAttentionPooling(dim, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 3:
            raise ValueError(f"TemporalPooler expects [B, T, D], got shape={tuple(x.shape)}")
        if self.mode == "mean":
            return x.mean(dim=1)
        return self.pool(x)
