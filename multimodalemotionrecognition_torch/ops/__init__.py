from multimodalemotionrecognition_torch.ops.attention import TorchMultiHeadAttention
from multimodalemotionrecognition_torch.ops.image import adaptive_avg_pool_2d, uniform_frame_indices
from multimodalemotionrecognition_torch.ops.mel import (
    amplitude_to_db,
    log_mel_spectrogram,
    log_mel_spectrogram_np,
    mel_filterbank,
    mel_spectrogram,
)
from multimodalemotionrecognition_torch.ops.stochastic import (
    RNG_STREAMS,
    RngStreams,
    drop_path,
    dropout,
    modality_dropout_mask,
    spec_augment,
)

__all__ = [
    "RNG_STREAMS",
    "RngStreams",
    "TorchMultiHeadAttention",
    "adaptive_avg_pool_2d",
    "amplitude_to_db",
    "drop_path",
    "dropout",
    "log_mel_spectrogram",
    "log_mel_spectrogram_np",
    "mel_filterbank",
    "mel_spectrogram",
    "modality_dropout_mask",
    "spec_augment",
    "uniform_frame_indices",
]
