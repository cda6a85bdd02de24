from multimodalemotionrecognition_torch.models.audio import AudioCNN, AudioNet, AudioResNet18
from multimodalemotionrecognition_torch.models.factory import (
    build_audio_encoder,
    build_model,
    build_video_encoder,
    init_parameters,
)
from multimodalemotionrecognition_torch.models.fusion import (
    ClipStyleAlignment,
    EmotionPriorBiasAdapter,
    FusionModel,
)
from multimodalemotionrecognition_torch.models.temporal import TemporalPooler
from multimodalemotionrecognition_torch.models.video import VideoNet
from multimodalemotionrecognition_torch.models.wavlm import WavLMAudioEncoder, WavLMModel

__all__ = [
    "AudioCNN",
    "AudioNet",
    "AudioResNet18",
    "ClipStyleAlignment",
    "EmotionPriorBiasAdapter",
    "FusionModel",
    "TemporalPooler",
    "VideoNet",
    "WavLMAudioEncoder",
    "WavLMModel",
    "build_audio_encoder",
    "build_model",
    "build_video_encoder",
    "init_parameters",
]
