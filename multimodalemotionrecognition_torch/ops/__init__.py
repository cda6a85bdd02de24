from multimodalemotionrecognition_torch.ops.attention import TorchMultiHeadAttention
from multimodalemotionrecognition_torch.ops.stochastic import (
    RNG_STREAMS,
    RngStreams,
    drop_path,
    dropout,
    modality_dropout_mask,
)

__all__ = [
    "RNG_STREAMS",
    "RngStreams",
    "TorchMultiHeadAttention",
    "drop_path",
    "dropout",
    "modality_dropout_mask",
]
