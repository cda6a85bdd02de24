from multimodalemotionrecognition_torch.utils.metrics import accuracy, macro_f1
from multimodalemotionrecognition_torch.utils.seed import set_seed

__all__ = ["accuracy", "macro_f1", "set_seed"]
