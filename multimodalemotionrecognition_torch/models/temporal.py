"""Temporal aggregation: mean, learnable attention, or transformer pooling.

Counterpart of the JAX package's `models/temporal.py` (reference
`src/models/temporal.py:9-110`), with the same state-dict paths
(`pool.score.{0,1,4}.*`, `pool.encoder.layers.0.self_attn.*`).  The mean and
attn modes also run inside the whole-fusion-block kernel
(`kernels/fused_block.py`) when the runner is built with `fused=True`; the
transformer pooler's products go to torch's library calls, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from multimodalemotionrecognition_torch.ops.attention import TorchMultiHeadAttention
from multimodalemotionrecognition_torch.ops.stochastic import dropout

__all__ = [
    "TemporalAttentionPooling",
    "TemporalPooler",
    "TemporalTransformerPooling",
    "TorchTransformerEncoderLayer",
    "check_head",
    "sinusoidal_positional_encoding",
]

ENCODER_HEADS = ("none", "pool", "full")


def check_head(head: str) -> None:
    """`head` of an encoder wrapper (`VideoNet`, `AudioNet`,
    `WavLMAudioEncoder`): how much beside the backbone it declares."""
    if head not in ENCODER_HEADS:
        raise ValueError(f"head={head!r} not in {ENCODER_HEADS}")


def sinusoidal_positional_encoding(length: int, dim: int) -> np.ndarray:
    """Sinusoidal PE table [length, dim], float32
    (reference `src/models/temporal.py:29-43`)."""
    position = np.arange(length, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, dim, 2, dtype=np.float64) * (-math.log(10000.0) / max(1, dim))
    )
    pe = np.zeros((length, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    if dim > 1:
        n_odd = pe[:, 1::2].shape[1]
        pe[:, 1::2] = np.cos(position * div_term[:n_odd])
    return pe.astype(np.float32)


class TemporalAttentionPooling(nn.Module):
    """Softmax attention pooling over time:
    score = Linear(h,1) . Dropout . GELU . Linear(d,h) . LayerNorm, h = d//2."""

    def __init__(self, dim: int, dropout: float = 0.1):
        super().__init__()
        hidden = max(1, dim // 2)
        self.dropout = dropout
        self.score = nn.Sequential(
            nn.LayerNorm(dim, eps=1e-5),
            nn.Linear(dim, hidden),
            nn.GELU(),
            nn.Dropout(dropout),
            nn.Linear(hidden, 1),
        )

    def forward(
        self, x: torch.Tensor, dropout_generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """A generator turns the dropout after the GELU on (training; the
        `nn.Dropout` at index 3 only keeps the state-dict indices)."""
        s = self.score[2](self.score[1](self.score[0](x)))
        if dropout_generator is not None:
            s = dropout(s, self.dropout, dropout_generator)
        attn = torch.softmax(self.score[4](s).squeeze(-1).float(), dim=1)
        return torch.sum(x * attn.to(x.dtype)[..., None], dim=1)


class TorchTransformerEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer(norm_first=True, activation="gelu"),
    written out: x += drop(attn(norm1(x))); x += drop(linear2(drop(gelu(
    linear1(norm2(x)))))), exact-erf GELU.  A generator turns the three
    dropouts and the attention's own on (training)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = TorchMultiHeadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(
        self, x: torch.Tensor, dropout_generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        def drop(t):
            return t if dropout_generator is None else dropout(t, self.dropout, dropout_generator)

        h = self.norm1(x)
        x = x + drop(self.self_attn(h, h, h, dropout_generator=dropout_generator))
        h = drop(F.gelu(self.linear1(self.norm2(x))))
        return x + drop(self.linear2(h))


class TemporalTransformerPooling(nn.Module):
    """Sinusoidal PE + pre-norm transformer encoder + attention pooling
    (reference `src/models/temporal.py:46-75`); ffn = max(2d, 4d)."""

    def __init__(self, dim: int, num_heads: int = 4, num_layers: int = 1,
                 dropout: float = 0.1, mlp_ratio: float = 4.0):
        super().__init__()
        self.dim = dim
        ffn_dim = max(dim * 2, int(dim * mlp_ratio))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            TorchTransformerEncoderLayer(dim, num_heads, ffn_dim, dropout)
            for _ in range(num_layers)
        )
        self.pool = TemporalAttentionPooling(dim, dropout)
        self._pe = {}  # (length, device, dtype) -> table: one host->device copy each

    def forward(
        self, x: torch.Tensor, dropout_generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        key = (x.shape[1], x.device, x.dtype)
        if key not in self._pe:
            table = torch.from_numpy(sinusoidal_positional_encoding(x.shape[1], self.dim))
            self._pe[key] = table.to(x.device, x.dtype)
        x = x + self._pe[key][None]
        for layer in self.encoder.layers:
            x = layer(x, dropout_generator)
        return self.pool(x, dropout_generator)


class TemporalPooler(nn.Module):
    """[B, T, D] -> [B, D] by `mode` ("mean", "attn" or "transformer")."""

    def __init__(self, dim: int, mode: str = "mean", dropout: float = 0.1,
                 num_heads: int = 4, num_layers: int = 1):
        super().__init__()
        if mode not in ("mean", "attn", "transformer"):
            raise ValueError(f"Unsupported temporal pooling mode: {mode}")
        self.mode = mode
        if mode == "attn":
            self.pool = TemporalAttentionPooling(dim, dropout)
        elif mode == "transformer":
            self.pool = TemporalTransformerPooling(dim, num_heads, num_layers, dropout)

    def forward(
        self, x: torch.Tensor, dropout_generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        if x.ndim != 3:
            raise ValueError(f"TemporalPooler expects [B, T, D], got shape={tuple(x.shape)}")
        if self.mode == "mean":
            return x.mean(dim=1)
        return self.pool(x, dropout_generator)
