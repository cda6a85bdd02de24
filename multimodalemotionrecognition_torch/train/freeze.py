"""Two-stage finetuning: parameter grouping, trainability and learning rates.

Counterpart of the JAX package's `train/freeze.py` (the reference's
freeze and optimizer policy, `src/train.py:722-902`), over the port's parameter
names (`nn.Module.named_parameters`, which are the reference's state-dict
keys and the Flax trees' dotted paths):

  * parameters split into fusion / audio / video groups by name prefix;
  * stage 1: encoders frozen, the fusion head trains;
  * stage 2: WavLM unfreezes its classifier and last N encoder layers, video
    its last N parameterized backbone blocks and classifier;
  * single-modality WavLM: stage 1 head only, stage 2 adds the last 2 layers.

In PyTorch the policy becomes `requires_grad` per parameter and stage (a
frozen parameter gets no gradient at all) and a learning rate per parameter;
the trainer rebuilds the optimizer state at the stage flip, as the reference
rebuilds `torch.optim.Adam`.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Tuple

from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig

__all__ = [
    "VIDEO_BACKBONE_BLOCK_ORDER",
    "cosine_factor",
    "label_params",
    "lr_tree",
    "trainable_mask",
    "wavlm_frozen_prefix",
]

# Parameterized top-level children of the video backbone in reference
# Sequential order (conv1, bn1, layer1..4); relu/maxpool/avgpool carry no
# parameters (`src/train.py:789-793`).
VIDEO_BACKBONE_BLOCK_ORDER = ("0", "1", "4", "5", "6", "7")


def _group_of(name: str) -> str:
    if name.startswith("audio_model."):
        return "audio"
    if name.startswith("video_model."):
        return "video"
    return "fusion"


def label_params(names: Iterable[str]) -> Dict[str, str]:
    """Group label ('fusion' | 'audio' | 'video') per parameter name."""
    return {name: _group_of(name) for name in names}


def _video_trainable(name: str, unfreeze_blocks: int) -> bool:
    """Last-N parameterized backbone blocks + classifier
    (reference `_set_video_backbone_trainable`)."""
    rest = name[len("video_model."):]
    if rest.startswith("classifier."):
        return unfreeze_blocks > 0
    if rest.startswith("backbone."):
        if unfreeze_blocks <= 0:
            return False
        return rest.split(".")[1] in VIDEO_BACKBONE_BLOCK_ORDER[-unfreeze_blocks:]
    return False  # temporal_pool etc. stay frozen in stage 2


def _wavlm_audio_trainable(name: str, unfreeze_layers: int) -> bool:
    """Classifier + last N WavLM encoder layers (reference `:819-822`)."""
    rest = name[len("audio_model."):]
    if rest.startswith("classifier."):
        return True
    m = re.match(r"wavlm\.encoder\.layers\.(\d+)\.", rest)
    if m and unfreeze_layers > 0:
        return int(m.group(1)) >= 12 - unfreeze_layers
    return False


def wavlm_frozen_prefix(model_config: ModelConfig, train_config: TrainConfig) -> Tuple[int, bool]:
    """(n_prefix_layers, conv_frozen): the WavLM components frozen in every
    stage the run can use, exactly the leaves `trainable_mask` freezes in all
    stages.  Encoder layers unfreeze by absolute index >= 12 - N (the
    reference hardcodes 12), so the frozen prefix is min(num_layers, 12 - N).
    No stage policy ever unfreezes the conv feature extractor or the feature
    projection, so the train step may run the conv kernel, which has no
    backward (`WavLMConfig.fused_train_conv`)."""
    if not model_config.use_wavlm:
        return 0, False
    geometry = model_config.wavlm_geometry or {}
    num_layers = int(geometry.get("num_hidden_layers", 12))
    if model_config.fusion == "audio":
        if train_config.wavlm_stage == 1:
            return num_layers, True  # backbone fully frozen
        return min(num_layers, 10), True  # stage 2 unfreezes the last 2 of 12
    if model_config.fusion == "video":
        return 0, False
    if train_config.two_stage_training:
        n = 12 - max(0, train_config.fusion_unfreeze_wavlm_layers)
        return min(num_layers, max(0, n)), True
    return 0, False  # single-stage fusion training: everything trainable


def trainable_mask(
    names: Iterable[str], model_config: ModelConfig, train_config: TrainConfig, stage: int
) -> Dict[str, bool]:
    """Trainable or frozen per parameter name for the given stage.

    stage 0: everything trainable (single-stage training), except the WavLM
             single-modality protocol (`src/train.py:879-897`).
    stage 1 / 2: two-stage fusion policy.
    """
    fusion = model_config.fusion
    is_fusion_model = fusion not in {"audio", "video"}

    def decide(name: str) -> bool:
        if stage == 0:
            if fusion == "audio" and model_config.use_wavlm:
                if train_config.wavlm_stage == 1:
                    return name.startswith("classifier.")
                # Stage 2 takes every requires_grad parameter; the temporal
                # pool was never frozen, so it rides along.
                return name.startswith("temporal_pool.") or _wavlm_audio_trainable(
                    "audio_model." + name, 2
                )
            return True
        if not is_fusion_model:
            return True
        group = _group_of(name)
        if group == "fusion":
            return True
        if stage == 1:
            return False
        if group == "audio":
            if model_config.use_wavlm:
                return _wavlm_audio_trainable(
                    name, max(0, train_config.fusion_unfreeze_wavlm_layers)
                )
            return bool(train_config.fusion_unfreeze_audio)
        return _video_trainable(name, max(0, train_config.fusion_unfreeze_video_blocks))

    return {name: decide(name) for name in names}


def lr_tree(
    names: Iterable[str], model_config: ModelConfig, train_config: TrainConfig,
    stage: int, scale: Dict[str, float],
) -> Dict[str, float]:
    """Learning rate per parameter name: group base LR x per-group cosine
    factor.  Stage 1 fusion=lr; stage 2 fusion=lr, audio=audio_backbone_lr,
    video=video_backbone_lr (`src/train.py:851-858`); single-stage (0) uses lr
    everywhere except WavLM-audio stage 2's backbone_lr (`:888-896`)."""

    def base_lr(name: str) -> float:
        group = _group_of(name)
        if stage == 2:
            if group == "audio":
                return train_config.audio_backbone_lr
            if group == "video":
                return train_config.video_backbone_lr
            return train_config.lr
        if (
            stage == 0
            and model_config.fusion == "audio"
            and model_config.use_wavlm
            and train_config.wavlm_stage == 2
            and not name.startswith("classifier.")
        ):
            return train_config.backbone_lr
        return train_config.lr

    return {name: base_lr(name) * scale.get(_group_of(name), 1.0) for name in names}


def cosine_factor(epoch_in_stage: int, epochs_in_stage: int) -> float:
    """The reference's per-group cosine LambdaLR factor relative to the base
    LR with eta_min = 0.1 * base (`_build_scheduler`, `src/train.py:736-768`):
    factor(e) = 0.1 + 0.9 * 0.5 * (1 + cos(pi * min(e+1, T) / T))."""
    t_max = max(1, int(epochs_in_stage))
    t = min(epoch_in_stage + 1, t_max)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / t_max))
    return 0.1 + 0.9 * cosine
