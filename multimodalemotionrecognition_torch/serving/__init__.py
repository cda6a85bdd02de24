"""Serving stack: preprocessing, predictor, dynamic batcher, streaming
sessions, and the HTTP/WebSocket apps (`server_direct`, `server_queued`),
as in the JAX package's `serving/`."""

from multimodalemotionrecognition_torch.serving.predictor import EmotionPredictor
from multimodalemotionrecognition_torch.serving.preprocess import EmotionPreprocessService
from multimodalemotionrecognition_torch.serving.streaming import (
    StreamingEmotionSession,
    StreamingSessionManager,
    decode_frame_b64,
    decode_pcm16_b64,
)

__all__ = [
    "EmotionPredictor",
    "EmotionPreprocessService",
    "StreamingEmotionSession",
    "StreamingSessionManager",
    "decode_frame_b64",
    "decode_pcm16_b64",
]
