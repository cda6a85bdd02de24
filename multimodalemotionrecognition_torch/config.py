"""Configuration for the port.

`ModelConfig`, `ServeConfig`, `labels_for` and the ImageNet constants come
from the JAX package's `config` module, which imports neither jax nor flax.
`WavLMConfig` is copied from `multimodalemotionrecognition_tpu/models/wavlm.py`
(that module imports flax): same field names and defaults, so a checkpoint's
`wavlm_geometry` dict builds either package's model.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from multimodalemotionrecognition_tpu.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ModelConfig,
    ServeConfig,
    labels_for,
)

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "ModelConfig",
    "ServeConfig",
    "WavLMConfig",
    "labels_for",
]


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """microsoft/wavlm-base hyperparameters (HF WavLMConfig defaults).

    `fused_attention` / `fused_conv` select the hand-written kernels
    (`kernels/wavlm_attn.py`, `kernels/conv_fe.py`): "auto" runs them when
    the activations are on CUDA and the modular PyTorch path otherwise; True
    always goes through the kernel wrapper (which runs the kernel's plain
    PyTorch version for CPU tensors); False is the modular path.  The train
    fields are kept for config compatibility; the port serves only (eval).
    """

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    apply_spec_augment: bool = True
    layerdrop: float = 0.1
    fused_attention: object = "auto"
    fused_conv: object = "auto"
    fused_train_layers: int = 0
    fused_train_conv: bool = False
