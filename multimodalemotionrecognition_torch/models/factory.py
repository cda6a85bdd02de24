"""Model factory: ModelConfig -> the port's module graph, with seeded init.

Counterpart of the JAX package's `models/factory.py`.  Only the serving
slice is ported: `fusion` in {xattn, xattn_concat, xattn_gated} with
`use_wavlm=True`.  Anything else raises `NotImplementedError`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from multimodalemotionrecognition_torch.config import ModelConfig, WavLMConfig
from multimodalemotionrecognition_torch.models.fusion import FusionModel
from multimodalemotionrecognition_torch.models.video import VideoNet
from multimodalemotionrecognition_torch.models.wavlm import WavLMAudioEncoder

__all__ = ["build_model", "init_parameters"]

_XATTN_MODES = {"xattn", "xattn_concat", "xattn_gated"}


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Random init drawn from `generator` (on the CPU, then copied):
    LeCun-normal matrices and kernels, zero biases, unit norm scales and
    gates, U(0, 1) for `masked_spec_embed`, identity BatchNorm statistics."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim >= 2 and leaf != "gru_rel_pos_const":
            fan_in = p[0].numel()
            value = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
        elif leaf == "masked_spec_embed":
            value = torch.rand(p.shape, generator=generator)
        elif leaf in ("bias", "in_proj_bias"):
            value = torch.zeros(p.shape)
        else:
            value = torch.ones(p.shape)
        p.copy_(value)
    for name, buf in model.named_buffers():
        buf.copy_(torch.ones(buf.shape) if name.endswith("running_var") else torch.zeros(buf.shape))


def build_model(
    config: ModelConfig,
    device: torch.device | str = "cpu",
    generator: Optional[torch.Generator] = None,
) -> FusionModel:
    """Build the eval-mode float32 model on `device`, initialised from
    `generator` (a fresh one seeded with 0 when None)."""
    if config.canonical_fusion != "xattn" or not config.use_wavlm:
        raise NotImplementedError(
            f"fusion={config.fusion!r} use_wavlm={config.use_wavlm} is not ported: "
            "the port serves xattn + WavLM only (ROADMAP queue 1, item 5)"
        )
    if config.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"Unsupported compute dtype: {config.compute_dtype}")
    wavlm_config = WavLMConfig(**(config.wavlm_geometry or {}))
    # Built on the meta device so no memory is written twice: the module
    # constructors' own init would draw from torch's global generator.
    with torch.device("meta"):
        model = FusionModel(
            audio_model=WavLMAudioEncoder(wavlm_config),
            video_model=VideoNet(),
            num_classes=config.num_classes,
            xattn_head=config.resolved_xattn_head,
            common_dim=config.common_dim,
            d_model=config.xattn_d_model,
            num_heads=config.xattn_heads,
            temporal_pooling=config.temporal_pooling,
            temporal_dropout=config.temporal_dropout,
            xattn_use_emotion_prior=config.xattn_use_emotion_prior,
            xattn_emotion_prior_dim=config.xattn_emotion_prior_dim,
            xattn_emotion_prior_hidden_dim=config.xattn_emotion_prior_hidden_dim,
            xattn_emotion_prior_dropout=config.xattn_emotion_prior_dropout,
        )
    model.to_empty(device=device)
    init_parameters(model, generator or torch.Generator().manual_seed(0))
    return model.eval()
