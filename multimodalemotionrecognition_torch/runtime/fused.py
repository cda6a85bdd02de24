"""Fused inference forward for xattn checkpoints.

Counterpart of the JAX package's `runtime/fused.py`: the two towers run
through their `nn.Module`s (with K1 and K3 inside), then everything between
the towers and the logits (input projections, bidirectional cross-attention
with the optional emotion-prior bias, residual LayerNorms, mean or attention
pooling, concat or gated head) runs in one call of K4
(`kernels/fused_block.py`).  Used by `TorchModelRunner(fused=True)`.  A
model quantised by `runtime/quant.py` keeps the block's matrices int8; K4
dequantises them in its body.
"""

from __future__ import annotations

from typing import Callable

import torch

from multimodalemotionrecognition_torch.config import ModelConfig
from multimodalemotionrecognition_torch.kernels.fused_block import (
    FusedBlockSpec,
    extract_block_params,
    fused_block,
)

__all__ = ["build_fused_xattn_forward", "supports_fused"]


def supports_fused(model_config: ModelConfig) -> bool:
    """xattn with mean or attention pooling; the kernel does not take the
    transformer pooler."""
    return (
        model_config.canonical_fusion == "xattn"
        and model_config.temporal_pooling in ("mean", "attn")
    )


def build_fused_xattn_forward(
    model, model_config: ModelConfig
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """-> forward(video, audio) -> probabilities [B, C] float32.

    The kernel's parameter list is extracted here, once, from the model's
    state dict as it is now: call this while the block's float weights are
    still float32 (before the model is cast to a 16-bit compute dtype), as
    K4 computes in float32 whatever the towers' dtype.  The towers are read
    from `model` at each call, so a later cast of the model applies to them.
    """
    spec = FusedBlockSpec(
        num_heads=model_config.xattn_heads,
        d_model=model_config.xattn_d_model,
        pooling=model_config.temporal_pooling,
        head=model_config.resolved_xattn_head,
        use_prior=model_config.xattn_use_emotion_prior,
        num_classes=model_config.num_classes,
    )
    device = next(model.parameters()).device
    params = extract_block_params(model.state_dict(), spec, device=device)

    def forward(video: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        v_feat = model.video_model.encode_frames(video).contiguous()
        a_seq = model.audio_model.encode_sequence(audio).contiguous()
        logits = fused_block(v_feat, a_seq, params, spec)
        return torch.softmax(logits, dim=1)

    return forward
