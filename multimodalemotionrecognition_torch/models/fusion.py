"""Multimodal fusion heads: late / concat / gated / bidirectional
cross-attention, eval and train forward.

Counterpart of the JAX package's `models/fusion.py` (reference
`src/models/fusion.py:187-437`), with its `ClipStyleAlignment` (`:127-150`)
and `EmotionPriorBiasAdapter` (`:153-184`).  Kept from the reference:

  * late fusion returns PROBABILITIES, 0.5 * (softmax + softmax), not
    logits: a consumer must not softmax them again;
  * the gated mode computes g*audio + (1-g)*video while the xattn gated head
    computes g*video + (1-g)*audio; both gate MLPs start with a bias of -1.0
    on BOTH linears (`models/factory.py::init_parameters`);
  * a2v attends over the post-LayerNorm video tokens (the v2a output), not
    over the projected ones;
  * the xattn concat head is `xattn_mlp` (Linear, ReLU, Dropout, Linear);
  * `audio_time_conv`, the mel fallback of the xattn modes, exists only when
    the audio encoder has no `encode_sequence`; both built-in encoders have
    one, so like the reference this path is dormant.

Training (`forward(..., train=True, rng=RngStreams)`): dropout on both
attentions' probabilities, stochastic depth (`drop_path`) on both residual
branches, dropout 0.2 in the head and gate MLPs, the emotion prior's and the
attention pooler's dropouts, and `train` handed down to both towers.  The
`nn.Dropout` entries of the `nn.Sequential`s only keep the state-dict
indices: every draw goes through `ops/stochastic.py` with a named generator.

The forward returns the output alone, or `(output, aux)` with
`aux["alignment_loss"]` (a scalar for `fusion_align_mode="clip"` in the
concat and gated modes, else None) when called with `return_aux=True`;
inside a data-parallel step it is this rank's share of the global loss.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from multimodalemotionrecognition_torch.models.temporal import TemporalPooler
from multimodalemotionrecognition_torch.parallel.distributed import current_shard
from multimodalemotionrecognition_torch.ops.attention import TorchMultiHeadAttention
from multimodalemotionrecognition_torch.ops.stochastic import (
    RngStreams,
    drop_path,
    dropout,
    modality_dropout_mask,
)

__all__ = ["ClipStyleAlignment", "EmotionPriorBiasAdapter", "FusionModel"]

_XATTN_MODES = ("xattn", "xattn_concat", "xattn_gated")
_MODES = ("late", "concat", "gated") + _XATTN_MODES


def _mlp(seq: nn.Sequential, x: torch.Tensor, rate: float,
         generator: Optional[torch.Generator]) -> torch.Tensor:
    """(Linear, ReLU, Dropout, Linear) with the dropout drawn from `generator`
    (None: eval, no dropout)."""
    x = torch.relu(seq[0](x))
    if generator is not None:
        x = dropout(x, rate, generator)
    return seq[3](x)


class ClipStyleAlignment(nn.Module):
    """CLIP-style shared-space alignment with symmetric InfoNCE (reference
    `src/models/fusion.py:127-150`) -> (audio aligned, video aligned, loss).

    Inside a data-parallel step the normalised embeddings of every rank are
    gathered (with their gradient), so InfoNCE takes the global batch's
    negatives as JAX's global step does; each rank then returns its share,
    the terms of its own rows over the global batch size, and the ranks'
    shares sum to the global batch's loss."""

    def __init__(self, audio_dim: int, video_dim: int, align_dim: int,
                 init_temperature: float = 0.07):
        super().__init__()
        self.audio_proj = nn.Linear(audio_dim, align_dim)
        self.video_proj = nn.Linear(video_dim, align_dim)
        self.init_logit_scale = math.log(1.0 / max(float(init_temperature), 1e-3))
        self.logit_scale = nn.Parameter(torch.tensor(self.init_logit_scale))

    def forward(
        self, audio_emb: torch.Tensor, video_emb: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        a_aligned = self.audio_proj(audio_emb)
        v_aligned = self.video_proj(video_emb)
        a_norm = a_aligned / a_aligned.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        v_norm = v_aligned / v_aligned.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        scale = self.logit_scale.exp().clamp_max(100.0)
        shard = current_shard()
        n = a_norm.shape[0]
        own = torch.arange(shard.rank * n, (shard.rank + 1) * n, device=a_norm.device)[:, None]

        def rows_share(queries, keys):
            """This rank's rows of one direction's InfoNCE, over the global size."""
            logits = scale * (queries @ shard.gather(keys).T)
            return -torch.log_softmax(logits, dim=-1).gather(1, own).sum() / (n * shard.world)

        return a_aligned, v_aligned, 0.5 * (rows_share(a_norm, v_norm) + rows_share(v_norm, a_norm))


class EmotionPriorBiasAdapter(nn.Module):
    """Global emotion prior -> token-wise additive attention bias:
    prior = MLP(mean(v_tokens) ++ mean(a_tokens));
    bias(q, k) = tanh(score_q(q, prior) (+) score_k(k, prior)) * bias_scale."""

    def __init__(self, token_dim: int, prior_dim: int, hidden_dim: int, dropout: float = 0.1):
        super().__init__()
        self.prior_dim = prior_dim
        self.dropout = dropout
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
        self, video_tokens: torch.Tensor, audio_tokens: torch.Tensor,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        prior = _mlp(
            self.prior_net,
            torch.cat([video_tokens.mean(dim=1), audio_tokens.mean(dim=1)], dim=-1),
            self.dropout, dropout_generator,
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
    """Four-mode audio-visual fusion: forward(video [B,T,3,H,W], audio) ->
    logits for every mode except "late" (probabilities)."""

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
        xattn_attn_dropout: float = 0.1,
        xattn_stochastic_depth: float = 0.1,
        xattn_use_emotion_prior: bool = False,
        xattn_emotion_prior_dim: int = 8,
        xattn_emotion_prior_hidden_dim: int = 64,
        xattn_emotion_prior_dropout: float = 0.1,
        mode: str = "xattn",
        audio_n_mels: int = 64,
        temporal_num_heads: int = 4,
        temporal_num_layers: int = 1,
        fusion_align_mode: str = "none",
        fusion_align_dim: int = 256,
        fusion_align_temperature: float = 0.07,
        modality_dropout_audio: float = 0.2,
        modality_dropout_video: float = 0.2,
    ):
        super().__init__()
        if mode not in _MODES:
            raise ValueError(f"Unknown fusion mode: {mode}")
        if mode == "xattn_concat":
            xattn_head = "concat"
        elif mode == "xattn_gated":
            xattn_head = "gated"
        if xattn_head not in ("concat", "gated"):
            raise ValueError(f"Unknown xattn head: {xattn_head}")
        self.audio_model = audio_model
        self.video_model = video_model
        self.mode = "xattn" if mode in _XATTN_MODES else mode
        self.xattn_head = xattn_head
        self.xattn_stochastic_depth = xattn_stochastic_depth
        self.modality_dropout = (modality_dropout_audio, modality_dropout_video)
        self.emotion_prior_bias: Optional[EmotionPriorBiasAdapter] = None
        self.semantic_alignment: Optional[ClipStyleAlignment] = None
        if self.mode == "late":
            return
        if self.mode == "xattn":
            self._declare_xattn(
                d_model, num_heads, num_classes, common_dim, audio_n_mels, temporal_pooling,
                temporal_dropout, temporal_num_heads, temporal_num_layers, xattn_attn_dropout,
                xattn_use_emotion_prior, xattn_emotion_prior_dim,
                xattn_emotion_prior_hidden_dim, xattn_emotion_prior_dropout,
            )
            return
        a_dim, v_dim = audio_model.embedding_dim, video_model.embedding_dim
        if fusion_align_mode == "clip":
            self.semantic_alignment = ClipStyleAlignment(
                a_dim, v_dim, fusion_align_dim, fusion_align_temperature
            )
            a_dim = v_dim = fusion_align_dim
        self.audio_proj = nn.Linear(a_dim, common_dim)
        self.video_proj = nn.Linear(v_dim, common_dim)
        if self.mode == "concat":
            self.fusion = nn.Sequential(
                nn.Linear(2 * common_dim, common_dim), nn.ReLU(), nn.Dropout(0.2),
                nn.Linear(common_dim, num_classes),
            )
        else:
            self.gate = nn.Sequential(
                nn.Linear(2 * common_dim, common_dim), nn.ReLU(), nn.Dropout(0.2),
                nn.Linear(common_dim, 1),
            )
            self.classifier = nn.Linear(common_dim, num_classes)

    def _declare_xattn(self, d, num_heads, num_classes, common_dim, audio_n_mels, pooling,
                       pool_dropout, pool_heads, pool_layers, attn_dropout, use_prior,
                       prior_dim, prior_hidden, prior_dropout):
        self.v_in_proj = nn.Linear(self.video_model.embedding_dim, d)
        if hasattr(self.audio_model, "encode_sequence"):
            self.audio_seq_proj = nn.Linear(self.audio_model.sequence_dim, d)
        else:
            # Mel fallback: [B, 1, n_mels, Ta] -> Conv1d over time -> [B, Ta, d].
            self.audio_time_conv = nn.Conv1d(audio_n_mels, d, 3, padding=1)
        self.a_in_proj = nn.Linear(d, d)
        if use_prior:
            self.emotion_prior_bias = EmotionPriorBiasAdapter(
                d, prior_dim, prior_hidden, prior_dropout
            )
        self.v2a_attn = TorchMultiHeadAttention(d, num_heads, attn_dropout)
        self.v_norm = nn.LayerNorm(d, eps=1e-5)
        self.a2v_attn = TorchMultiHeadAttention(d, num_heads, attn_dropout)
        self.a_norm = nn.LayerNorm(d, eps=1e-5)
        pool = dict(num_heads=pool_heads, num_layers=pool_layers)
        self.v_temporal_pool = TemporalPooler(d, pooling, pool_dropout, **pool)
        self.a_temporal_pool = TemporalPooler(d, pooling, pool_dropout, **pool)
        if self.xattn_head == "concat":
            self.xattn_mlp = nn.Sequential(
                nn.Linear(2 * d, common_dim), nn.ReLU(), nn.Dropout(0.2),
                nn.Linear(common_dim, num_classes),
            )
        else:
            self.xattn_gate = nn.Sequential(
                nn.Linear(2 * d, d), nn.ReLU(), nn.Dropout(0.2), nn.Linear(d, 1),
            )
            self.xattn_classifier = nn.Linear(d, num_classes)

    def forward(
        self, video: torch.Tensor, audio: torch.Tensor, train: bool = False,
        rng: Optional[RngStreams] = None, return_aux: bool = False,
    ):
        if train and rng is None:
            raise ValueError("a train-mode forward needs rng (RngStreams)")
        aux = {"alignment_loss": None}
        if self.mode == "late":
            a_logits = self.audio_model(audio, train, rng)
            v_logits = self.video_model(video, train, rng)
            out = 0.5 * (torch.softmax(a_logits, dim=1) + torch.softmax(v_logits, dim=1))
        elif self.mode == "xattn":
            out = self._forward_xattn(video, audio, train, rng)
        else:
            out = self._forward_embeddings(video, audio, train, rng, aux)
        return (out, aux) if return_aux else out

    def _forward_embeddings(self, video, audio, train, rng, aux) -> torch.Tensor:
        """The concat and gated modes, on the two pooled embeddings."""
        gen = rng.device("dropout") if train else None
        a_emb = self.audio_model.encode(audio, train, rng)
        v_emb = self.video_model.encode(video, train, rng)
        if self.semantic_alignment is not None:
            a_emb, v_emb, aux["alignment_loss"] = self.semantic_alignment(a_emb, v_emb)
        a_emb, v_emb = self.audio_proj(a_emb), self.video_proj(v_emb)
        if self.mode == "concat":
            return _mlp(self.fusion, torch.cat([a_emb, v_emb], dim=1), 0.2, gen)
        if train:
            keep_a, keep_v = modality_dropout_mask(rng.device("modality"), *self.modality_dropout)
            a_emb, v_emb = a_emb * keep_a.to(a_emb.dtype), v_emb * keep_v.to(v_emb.dtype)
        g = torch.sigmoid(_mlp(self.gate, torch.cat([a_emb, v_emb], dim=1), 0.2, gen))
        return self.classifier(g * a_emb + (1.0 - g) * v_emb)

    def _forward_xattn(self, video, audio, train, rng) -> torch.Tensor:
        gen = rng.device("dropout") if train else None
        path_gen = rng.device("droppath") if train else None
        depth = self.xattn_stochastic_depth

        v = self.v_in_proj(self.video_model.encode_frames(video, train))
        if hasattr(self, "audio_seq_proj"):
            a_seq = self.audio_seq_proj(self.audio_model.encode_sequence(audio, train, rng))
        else:
            a_seq = self.audio_time_conv(audio[:, 0]).transpose(1, 2)
        a = self.a_in_proj(a_seq)

        v2a_bias = a2v_bias = None
        if self.emotion_prior_bias is not None:
            _, v2a_bias, a2v_bias = self.emotion_prior_bias(v, a, gen)

        v2 = self.v2a_attn(v, a, a, bias=v2a_bias, dropout_generator=gen)
        v = self.v_norm(v + drop_path(v2, depth, train, path_gen))
        a2 = self.a2v_attn(a, v, v, bias=a2v_bias, dropout_generator=gen)
        a = self.a_norm(a + drop_path(a2, depth, train, path_gen))

        v_emb = self.v_temporal_pool(v, gen)
        a_emb = self.a_temporal_pool(a, gen)
        both = torch.cat([v_emb, a_emb], dim=1)
        if self.xattn_head == "concat":
            return _mlp(self.xattn_mlp, both, 0.2, gen)
        gate = torch.sigmoid(_mlp(self.xattn_gate, both, 0.2, gen))
        return self.xattn_classifier(gate * v_emb + (1.0 - gate) * a_emb)
