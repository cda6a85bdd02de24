"""Hand-written Hopper kernels of the port (CUDA C++ in `csrc/`, built by
`build.py` at first use), each beside its plain PyTorch version."""

from multimodalemotionrecognition_torch.kernels.conv_fe import (
    fused_conv_layer,
    fused_conv_layer_plain,
)
from multimodalemotionrecognition_torch.kernels.wavlm_attn import (
    wavlm_attention_sublayer,
    wavlm_attention_sublayer_plain,
)

__all__ = [
    "fused_conv_layer",
    "fused_conv_layer_plain",
    "wavlm_attention_sublayer",
    "wavlm_attention_sublayer_plain",
]
