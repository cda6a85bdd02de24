from multimodalemotionrecognition_torch.utils.device import card_line, require_device
from multimodalemotionrecognition_torch.utils.metrics import accuracy, macro_f1
from multimodalemotionrecognition_torch.utils.seed import set_seed

__all__ = ["accuracy", "card_line", "macro_f1", "require_device", "set_seed"]
