"""Model factory: ModelConfig -> the port's module graph, with seeded init.

Counterpart of the JAX package's `models/factory.py`, for the same modes:
`audio`, `video`, `late`, `concat`, `gated` and the three cross-attention
modes, with the WavLM or the mel audio branch and the three temporal poolers.
An unknown mode raises `ValueError`.

The encoders declare only what the mode calls (their `head` argument), as
the JAX modules create only those leaves: a model's state-dict keys are the
keys of the JAX package's checkpoint for the same config.

`build_model` builds on the card unless the caller passes `device="cpu"`,
and raises when asked for a card that is not there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from multimodalemotionrecognition_torch.config import ModelConfig, WavLMConfig
from multimodalemotionrecognition_torch.models.audio import AudioNet
from multimodalemotionrecognition_torch.models.fusion import ClipStyleAlignment, FusionModel
from multimodalemotionrecognition_torch.models.video import VideoNet
from multimodalemotionrecognition_torch.models.wavlm import WavLMAudioEncoder
from multimodalemotionrecognition_torch.utils.device import require_device

__all__ = ["build_audio_encoder", "build_model", "build_video_encoder", "init_parameters"]

_FUSION_MODES = {
    "audio", "video", "late", "concat", "gated", "xattn", "xattn_concat", "xattn_gated",
}
_GATE_BIASES = ("gate.0.bias", "gate.3.bias", "xattn_gate.0.bias", "xattn_gate.3.bias")


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Random init drawn from `generator` (on the CPU, then copied), by the
    JAX package's initialisers: LeCun-normal matrices and kernels, zero
    biases but -1.0 on both linears of a gate MLP, unit norm scales and
    `bias_scale`, `logit_scale` = log(1 / temperature), U(0, 1) for
    `masked_spec_embed`, identity BatchNorm statistics."""
    logit_scales = {
        f"{name}.logit_scale" if name else "logit_scale": m.init_logit_scale
        for name, m in model.named_modules() if isinstance(m, ClipStyleAlignment)
    }
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim >= 2 and leaf != "gru_rel_pos_const":
            fan_in = p[0].numel()
            value = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
        elif leaf == "masked_spec_embed":
            value = torch.rand(p.shape, generator=generator)
        elif name in logit_scales:
            value = torch.full(p.shape, logit_scales[name])
        elif name in _GATE_BIASES:
            value = torch.full(p.shape, -1.0)
        elif leaf in ("bias", "in_proj_bias"):
            value = torch.zeros(p.shape)
        else:
            value = torch.ones(p.shape)
        p.copy_(value)
    for name, buf in model.named_buffers():
        buf.copy_(torch.ones(buf.shape) if name.endswith("running_var") else torch.zeros(buf.shape))


def _check_dtype(config: ModelConfig) -> None:
    if config.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"Unsupported compute dtype: {config.compute_dtype}")


def _temporal(config: ModelConfig) -> dict:
    return dict(
        temporal_pooling=config.temporal_pooling,
        temporal_num_heads=config.temporal_num_heads,
        temporal_num_layers=config.temporal_num_layers,
        temporal_dropout=config.temporal_dropout,
    )


def build_audio_encoder(config: ModelConfig, head: str = "full") -> nn.Module:
    """The audio branch (uninitialised): WavLM, or the mel encoders."""
    _check_dtype(config)
    if config.use_wavlm:
        geometry = dict(config.wavlm_geometry or {})
        geometry.setdefault("fused_train_layers", config.wavlm_fused_train_layers)
        geometry.setdefault("fused_train_conv", config.wavlm_fused_train_conv)
        wavlm_config = WavLMConfig(**geometry)
        return WavLMAudioEncoder(
            wavlm_config, num_classes=config.num_classes, head=head, **_temporal(config)
        )
    return AudioNet(
        num_classes=config.num_classes, embedding_dim=config.audio_embedding_dim,
        use_resnet=config.use_resnet_audio, spec_augment=config.spec_augment, head=head,
        **_temporal(config),
    )


def build_video_encoder(config: ModelConfig, head: str = "full") -> nn.Module:
    """The video branch (uninitialised)."""
    _check_dtype(config)
    return VideoNet(num_classes=config.num_classes, head=head, **_temporal(config))


def _build(config: ModelConfig) -> nn.Module:
    if config.fusion == "audio":
        return build_audio_encoder(config)
    if config.fusion == "video":
        return build_video_encoder(config)
    # What the mode calls on its encoders: late the classifiers, concat and
    # gated the pooled embeddings, the cross-attention modes the sequences.
    head = {"late": "full", "concat": "pool", "gated": "pool"}.get(config.canonical_fusion, "none")
    return FusionModel(
        audio_model=build_audio_encoder(config, head),
        video_model=build_video_encoder(config, head),
        num_classes=config.num_classes,
        mode=config.canonical_fusion,
        xattn_head=config.resolved_xattn_head,
        common_dim=config.common_dim,
        d_model=config.xattn_d_model,
        num_heads=config.xattn_heads,
        audio_n_mels=config.effective_audio_n_mels,
        temporal_pooling=config.temporal_pooling,
        temporal_num_heads=config.temporal_num_heads,
        temporal_num_layers=config.temporal_num_layers,
        temporal_dropout=config.temporal_dropout,
        fusion_align_mode=config.fusion_align_mode,
        fusion_align_dim=config.fusion_align_dim,
        fusion_align_temperature=config.fusion_align_temperature,
        xattn_attn_dropout=config.xattn_attn_dropout,
        xattn_stochastic_depth=config.xattn_stochastic_depth,
        xattn_use_emotion_prior=config.xattn_use_emotion_prior,
        xattn_emotion_prior_dim=config.xattn_emotion_prior_dim,
        xattn_emotion_prior_hidden_dim=config.xattn_emotion_prior_hidden_dim,
        xattn_emotion_prior_dropout=config.xattn_emotion_prior_dropout,
    )


def build_model(
    config: ModelConfig,
    device: torch.device | str = "cuda",
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build the float32 model for `config.fusion` on `device`, initialised
    from `generator` (a fresh one seeded with 0 when None).  Train or eval is
    an argument of the forward, not a state of the modules."""
    if config.fusion not in _FUSION_MODES:
        raise ValueError(f"Unknown fusion mode: {config.fusion}")
    _check_dtype(config)
    device = require_device(device, "build_model")
    # Built on the meta device so no memory is written twice: the module
    # constructors' own init would draw from torch's global generator.
    with torch.device("meta"):
        model = _build(config)
    model.to_empty(device=device)
    init_parameters(model, generator or torch.Generator().manual_seed(0))
    return model.eval()
