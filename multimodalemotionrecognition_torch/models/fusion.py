"""Bidirectional cross-attention fusion (the xattn mode), eval forward.

Counterpart of the xattn branch of the JAX package's `models/fusion.py`
(reference `src/models/fusion.py:187-437`) and of its
`EmotionPriorBiasAdapter` (`:153-184`).  Kept from the reference:

  * a2v attends over the post-LayerNorm video tokens (the v2a output), not
    over the projected ones;
  * the concat head is `xattn_mlp` (Linear, ReLU, Dropout, Linear); the
    gated head computes g*video + (1-g)*audio with `xattn_gate` and
    `xattn_classifier`.

The late/concat/gated modes and `ClipStyleAlignment` are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from multimodalemotionrecognition_torch.models.temporal import TemporalPooler
from multimodalemotionrecognition_torch.ops.attention import TorchMultiHeadAttention

__all__ = ["EmotionPriorBiasAdapter", "FusionModel"]


class EmotionPriorBiasAdapter(nn.Module):
    """Global emotion prior -> token-wise additive attention bias:
    prior = MLP(mean(v_tokens) ++ mean(a_tokens));
    bias(q, k) = tanh(score_q(q, prior) (+) score_k(k, prior)) * bias_scale."""

    def __init__(self, token_dim: int, prior_dim: int, hidden_dim: int, dropout: float = 0.1):
        super().__init__()
        self.prior_dim = prior_dim
        self.prior_net = nn.Sequential(
            nn.Linear(2 * token_dim, hidden_dim),
            nn.ReLU(),
            nn.Dropout(dropout),
            nn.Linear(hidden_dim, prior_dim),
        )
        self.v_query_bias = nn.Linear(token_dim + prior_dim, 1)
        self.a_key_bias = nn.Linear(token_dim + prior_dim, 1)
        self.a_query_bias = nn.Linear(token_dim + prior_dim, 1)
        self.v_key_bias = nn.Linear(token_dim + prior_dim, 1)
        self.bias_scale = nn.Parameter(torch.ones(()))

    def forward(
        self, video_tokens: torch.Tensor, audio_tokens: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        prior = self.prior_net(
            torch.cat([video_tokens.mean(dim=1), audio_tokens.mean(dim=1)], dim=-1)
        )

        def token_bias(query, key, q_lin, k_lin):
            def scores(x, lin):
                p = prior[:, None, :].expand(x.shape[0], x.shape[1], self.prior_dim)
                return lin(torch.cat([x, p], dim=-1))[..., 0]

            bias = scores(query, q_lin)[..., :, None] + scores(key, k_lin)[..., None, :]
            return torch.tanh(bias) * self.bias_scale

        v2a = token_bias(video_tokens, audio_tokens, self.v_query_bias, self.a_key_bias)
        a2v = token_bias(audio_tokens, video_tokens, self.a_query_bias, self.v_key_bias)
        return prior, v2a, a2v


class FusionModel(nn.Module):
    """xattn fusion: forward(video [B,T,3,H,W], audio waveform) -> logits."""

    def __init__(
        self,
        audio_model: nn.Module,
        video_model: nn.Module,
        num_classes: int,
        xattn_head: str = "concat",
        common_dim: int = 256,
        d_model: int = 128,
        num_heads: int = 4,
        temporal_pooling: str = "mean",
        temporal_dropout: float = 0.1,
        xattn_use_emotion_prior: bool = False,
        xattn_emotion_prior_dim: int = 8,
        xattn_emotion_prior_hidden_dim: int = 64,
        xattn_emotion_prior_dropout: float = 0.1,
    ):
        super().__init__()
        if xattn_head not in ("concat", "gated"):
            raise ValueError(f"Unknown xattn head: {xattn_head}")
        self.audio_model = audio_model
        self.video_model = video_model
        self.xattn_head = xattn_head
        d = d_model
        self.v_in_proj = nn.Linear(video_model.embedding_dim, d)
        self.audio_seq_proj = nn.Linear(audio_model.sequence_dim, d)
        self.a_in_proj = nn.Linear(d, d)
        self.emotion_prior_bias: Optional[EmotionPriorBiasAdapter] = None
        if xattn_use_emotion_prior:
            self.emotion_prior_bias = EmotionPriorBiasAdapter(
                d, xattn_emotion_prior_dim, xattn_emotion_prior_hidden_dim,
                xattn_emotion_prior_dropout,
            )
        self.v2a_attn = TorchMultiHeadAttention(d, num_heads)
        self.v_norm = nn.LayerNorm(d, eps=1e-5)
        self.a2v_attn = TorchMultiHeadAttention(d, num_heads)
        self.a_norm = nn.LayerNorm(d, eps=1e-5)
        self.v_temporal_pool = TemporalPooler(d, temporal_pooling, temporal_dropout)
        self.a_temporal_pool = TemporalPooler(d, temporal_pooling, temporal_dropout)
        if xattn_head == "concat":
            self.xattn_mlp = nn.Sequential(
                nn.Linear(2 * d, common_dim), nn.ReLU(), nn.Dropout(0.2),
                nn.Linear(common_dim, num_classes),
            )
        else:
            self.xattn_gate = nn.Sequential(
                nn.Linear(2 * d, d), nn.ReLU(), nn.Dropout(0.2), nn.Linear(d, 1),
            )
            self.xattn_classifier = nn.Linear(d, num_classes)

    def forward(self, video: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        v = self.v_in_proj(self.video_model.encode_frames(video))
        a = self.a_in_proj(self.audio_seq_proj(self.audio_model.encode_sequence(audio)))

        v2a_bias = a2v_bias = None
        if self.emotion_prior_bias is not None:
            _, v2a_bias, a2v_bias = self.emotion_prior_bias(v, a)

        v = self.v_norm(v + self.v2a_attn(v, a, a, bias=v2a_bias))
        a = self.a_norm(a + self.a2v_attn(a, v, v, bias=a2v_bias))

        v_emb = self.v_temporal_pool(v)
        a_emb = self.a_temporal_pool(a)
        both = torch.cat([v_emb, a_emb], dim=1)
        if self.xattn_head == "concat":
            return self.xattn_mlp(both)
        gate = torch.sigmoid(self.xattn_gate(both))
        return self.xattn_classifier(gate * v_emb + (1.0 - gate) * a_emb)
