from multimodalemotionrecognition_torch.serving.predictor import EmotionPredictor

__all__ = ["EmotionPredictor"]
