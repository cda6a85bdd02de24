from multimodalemotionrecognition_torch.models.factory import build_model, init_parameters
from multimodalemotionrecognition_torch.models.fusion import (
    EmotionPriorBiasAdapter,
    FusionModel,
)
from multimodalemotionrecognition_torch.models.temporal import TemporalPooler
from multimodalemotionrecognition_torch.models.video import VideoNet
from multimodalemotionrecognition_torch.models.wavlm import WavLMAudioEncoder, WavLMModel

__all__ = [
    "EmotionPriorBiasAdapter",
    "FusionModel",
    "TemporalPooler",
    "VideoNet",
    "WavLMAudioEncoder",
    "WavLMModel",
    "build_model",
    "init_parameters",
]
