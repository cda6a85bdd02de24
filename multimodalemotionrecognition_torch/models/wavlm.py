"""WavLM-base speech encoder, eval forward.

Counterpart of the JAX package's `models/wavlm.py` (HF `WavLMModel`): a
7-layer conv feature extractor (GroupNorm on the first layer), feature
projection, a weight-normed positional conv (merged into a plain weight at
load), and post-norm transformer layers with WavLM's gated relative
position bias.  Module paths are the HF/reference state-dict keys.

Two hand-written kernels sit on this path, chosen by
`WavLMConfig.fused_attention` / `fused_conv` ("auto": when the activations
are on CUDA):

  * K1 `kernels/wavlm_attn.py` runs each encoder layer's attention sublayer
    after the q/k/v projections (scores + gated bias, softmax, context,
    out-projection, residual, post-LayerNorm);
  * K3 `kernels/conv_fe.py` runs conv layers L1..L6 with their GELU.

L0 (k=10, stride 5, one input channel) and its GroupNorm stay `F.conv1d`
plus float32 statistics, as they were plain XLA in the JAX package.  The
JAX package's TPU workarounds are not carried over: the kernels take
logical lengths, so the waveform is not padded to a multiple of the stride
product and the sequence is not padded 149 -> 160.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from multimodalemotionrecognition_torch.config import WavLMConfig
from multimodalemotionrecognition_torch.kernels.conv_fe import fused_conv_layer
from multimodalemotionrecognition_torch.kernels.wavlm_attn import (
    wavlm_attention_sublayer,
)

__all__ = ["WavLMAudioEncoder", "WavLMAttentionSelf", "WavLMEncoderLayer", "WavLMModel"]


def _relative_position_buckets(
    query_length: int, key_length: int, num_buckets: int, max_distance: int
) -> np.ndarray:
    """T5-style bidirectional relative position bucketing
    (HF `WavLMAttention._relative_positions_bucket`)."""
    context = np.arange(query_length)[:, None]
    memory = np.arange(key_length)[None, :]
    relative = memory - context

    nb = num_buckets // 2
    buckets = (relative > 0).astype(np.int64) * nb
    rel_abs = np.abs(relative)

    max_exact = nb // 2
    is_small = rel_abs < max_exact
    with np.errstate(divide="ignore"):
        rel_large = np.log(np.maximum(rel_abs, 1).astype(np.float64) / max_exact)
    rel_large = rel_large / math.log(max_distance / max_exact)
    rel_large = (max_exact + rel_large * (nb - max_exact)).astype(np.int64)
    rel_large = np.minimum(rel_large, nb - 1)

    buckets += np.where(is_small, rel_abs, rel_large)
    return buckets


def _use_kernel(flag, x: torch.Tensor) -> bool:
    """"auto" -> the kernel path when x is on CUDA; True/False force it."""
    if flag == "auto":
        return x.is_cuda
    return bool(flag)


class WavLMAttentionSelf(nn.Module):
    """WavLM self-attention with gated relative position bias."""

    def __init__(self, config: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        e, h = config.hidden_size, config.num_attention_heads
        self.config = config
        self.num_heads = h
        self.q_proj = nn.Linear(e, e)
        self.k_proj = nn.Linear(e, e)
        self.v_proj = nn.Linear(e, e)
        self.out_proj = nn.Linear(e, e)
        self.gru_rel_pos_linear = nn.Linear(e // h, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
        if has_relative_position_bias:
            self.rel_attn_embed = nn.Embedding(config.num_buckets, h)

    def relative_position_bias(self, t: int, device) -> torch.Tensor:
        """[H, T, T] bucketed relative bias (layer 0 owns the embedding)."""
        if not hasattr(self, "rel_attn_embed"):
            raise ValueError("First layer must compute the position bias.")
        cfg = self.config
        buckets = _relative_position_buckets(t, t, cfg.num_buckets, cfg.max_bucket_distance)
        values = self.rel_attn_embed(torch.from_numpy(buckets).to(device))  # [T, T, H]
        return values.permute(2, 0, 1)

    def projections(self, hidden: torch.Tensor):
        """-> (q * dh^-0.5, k, v) in [B, T, E] and the gate [B, H, T, 1]
        (HF WavLMAttention: a per-head scalar per query position computed
        from the raw layer input)."""
        b, t, e = hidden.shape
        h = self.num_heads
        dh = e // h
        proj = self.gru_rel_pos_linear(hidden.view(b, t, h, dh).transpose(1, 2))
        gates = torch.sigmoid(proj.view(b, h, t, 2, 4).sum(-1))
        gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
        gate = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0
        q = self.q_proj(hidden) * (dh**-0.5)
        return q, self.k_proj(hidden), self.v_proj(hidden), gate

    def forward(self, hidden: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        """Modular path: -> attention output [B, T, E] (before the residual)."""
        b, t, e = hidden.shape
        h = self.num_heads
        dh = e // h
        q, k, v, gate = self.projections(hidden)

        def heads(x):
            return x.view(b, t, h, dh).transpose(1, 2)

        scores = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2))
        scores = scores + (gate * position_bias[None].to(gate.dtype)).float()
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(attn, heads(v)).transpose(1, 2).reshape(b, t, e)
        return self.out_proj(out)


class _FeedForward(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(config.hidden_size, config.intermediate_size)
        self.output_dense = nn.Linear(config.intermediate_size, config.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class WavLMEncoderLayer(nn.Module):
    """Post-norm transformer layer (HF WavLMEncoderLayer, base variant)."""

    def __init__(self, config: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        e = config.hidden_size
        self.config = config
        self.attention = WavLMAttentionSelf(config, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(e, eps=config.layer_norm_eps)
        self.feed_forward = _FeedForward(config)
        self.final_layer_norm = nn.LayerNorm(e, eps=config.layer_norm_eps)

    def forward(
        self, hidden: torch.Tensor, position_bias: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, e = hidden.shape
        if position_bias is None:
            position_bias = self.attention.relative_position_bias(t, hidden.device)
        if _use_kernel(self.config.fused_attention, hidden):
            attn = self.attention
            q, k, v, gate = attn.projections(hidden)
            h = attn.num_heads
            hidden = wavlm_attention_sublayer(
                hidden, q, k, v,
                gate.float().reshape(b, h * t, 1),
                position_bias.float().reshape(h * t, t),
                attn.out_proj.weight.t().contiguous(),
                attn.out_proj.bias.float().view(1, e),
                self.layer_norm.weight.float().view(1, e),
                self.layer_norm.bias.float().view(1, e),
                num_heads=h,
                seq_len=t,
                eps=self.config.layer_norm_eps,
            )
        else:
            hidden = self.layer_norm(hidden + self.attention(hidden, position_bias))
        hidden = self.final_layer_norm(hidden + self.feed_forward(hidden))
        return hidden, position_bias


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int, group_norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride, bias=False)
        if group_norm:
            self.layer_norm = nn.GroupNorm(cout, cout, eps=1e-5)


class _FeatureExtractor(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        dims = (1,) + tuple(config.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, group_norm=(i == 0))
            for i, (k, s) in enumerate(zip(config.conv_kernel, config.conv_stride))
        )


class _FeatureProjection(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(config.conv_dim[-1], eps=config.layer_norm_eps)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size)


class _PosConvEmbed(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        k = config.num_conv_pos_embeddings
        self.conv = nn.Conv1d(
            config.hidden_size, config.hidden_size, k, padding=k // 2,
            groups=config.num_conv_pos_embedding_groups,
        )


class _Encoder(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = _PosConvEmbed(config)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(
            WavLMEncoderLayer(config, has_relative_position_bias=(i == 0))
            for i in range(config.num_hidden_layers)
        )


def _rows_multiple_of(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Contiguous [B, T', C] with T' the next multiple of `multiple`, so the
    stride-reshaped view exists.  Rows past T stay unset: K3 is given the
    logical length and never reads them."""
    b, t, c = x.shape
    rows = -(-t // multiple) * multiple
    if rows == t and x.is_contiguous():
        return x
    out = x.new_empty(b, rows, c)
    out[:, :t] = x
    return out


class WavLMModel(nn.Module):
    """HF WavLMModel equivalent: waveform [B, T_samples] -> hidden [B, T, E]."""

    def __init__(self, config: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.config = config
        self.feature_extractor = _FeatureExtractor(config)
        self.feature_projection = _FeatureProjection(config)
        self.masked_spec_embed = nn.Parameter(torch.empty(config.hidden_size))
        self.encoder = _Encoder(config)

    def _conv_features(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T_samples] -> conv features [B, T, C] (NWC)."""
        cfg = self.config
        layers = self.feature_extractor.conv_layers
        l0 = layers[0]
        x = F.conv1d(wav[:, None, :], l0.conv.weight, stride=cfg.conv_stride[0])
        # GroupNorm(groups=channels): per-channel statistics over time in
        # float32 (bf16 sums drift over ~10k steps), then the exact GELU.
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        xf = (xf - mean) * torch.rsqrt(var + 1e-5)
        xf = xf * l0.layer_norm.weight.float()[:, None] + l0.layer_norm.bias.float()[:, None]
        x = F.gelu(xf).to(wav.dtype)

        if not _use_kernel(cfg.fused_conv, x):
            for layer, s in zip(layers[1:], cfg.conv_stride[1:]):
                x = F.gelu(F.conv1d(x, layer.conv.weight, stride=s))
            return x.transpose(1, 2)

        x = x.transpose(1, 2)  # NWC [B, T, C]
        b, t_log = x.shape[0], x.shape[1]
        for layer, k, s in zip(layers[1:], cfg.conv_kernel[1:], cfg.conv_stride[1:]):
            cin = x.shape[2]
            x = _rows_multiple_of(x, s)
            w = layer.conv.weight  # [cout, cin, k] -> tap-major [k*cin, cout]
            w_flat = w.permute(2, 1, 0).reshape(k * cin, w.shape[0])
            x = fused_conv_layer(
                x.view(b, x.shape[1] // s, s * cin), w_flat, k=k, stride=s,
                cin=cin, gelu_output=True, t_in=t_log,
            )
            t_log = (t_log - k) // s + 1
        return x[:, :t_log]

    def forward(self, input_values: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self._conv_features(input_values)
        x = self.feature_projection.projection(self.feature_projection.layer_norm(x))

        conv = self.encoder.pos_conv_embed.conv
        pos = conv(x.transpose(1, 2))
        if cfg.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :, :-1]
        x = x + F.gelu(pos).transpose(1, 2)
        x = self.encoder.layer_norm(x)

        position_bias = None
        for layer in self.encoder.layers:
            x, position_bias = layer(x, position_bias)
        return x


class WavLMAudioEncoder(nn.Module):
    """Reference `WavLMAudioEncoder` (`src/models/wavlm_audio.py:13-183`),
    the part the cross-attention fusion taps: `encode_sequence`.  Its pooler
    and classifier head are not created by the xattn forward and are not
    declared here."""

    def __init__(self, wavlm_config: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.wavlm = WavLMModel(wavlm_config)

    @property
    def sequence_dim(self) -> int:
        return self.wavlm.config.hidden_size

    def encode_sequence(self, x: torch.Tensor) -> torch.Tensor:
        """Raw waveform [B, 1, T] or [B, T] -> hidden states [B, T', E]."""
        if x.ndim == 3:
            x = x[:, 0, :]
        return self.wavlm(x)
