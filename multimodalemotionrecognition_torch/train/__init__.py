from multimodalemotionrecognition_torch.train.trainer import (
    AdamState,
    EmotionTrainer,
    TrainState,
    masked_adam_update,
)

__all__ = ["AdamState", "EmotionTrainer", "TrainState", "masked_adam_update"]
