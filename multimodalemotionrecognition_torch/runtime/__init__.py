from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

__all__ = ["TorchModelRunner"]
