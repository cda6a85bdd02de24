from multimodalemotionrecognition_torch.ops.attention import TorchMultiHeadAttention

__all__ = ["TorchMultiHeadAttention"]
