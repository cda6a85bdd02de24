"""Hand-written Hopper kernels of the port (CUDA C++ in `csrc/`, built by
`build.py` at first use), each beside its plain PyTorch version."""

from multimodalemotionrecognition_torch.kernels.conv_fe import (
    fused_conv_layer,
    fused_conv_layer_plain,
)
from multimodalemotionrecognition_torch.kernels.fused_block import (
    FusedBlockParams,
    FusedBlockSpec,
    extract_block_params,
    fused_block,
    fused_block_plain,
)
from multimodalemotionrecognition_torch.kernels.wavlm_attn import (
    hash_keep_plain,
    wavlm_attention_sublayer,
    wavlm_attention_sublayer_backward,
    wavlm_attention_sublayer_backward_plain,
    wavlm_attention_sublayer_forward,
    wavlm_attention_sublayer_plain,
)
from multimodalemotionrecognition_torch.kernels.wavlm_attn_tiled import (
    wavlm_attention_sublayer_tiled,
    wavlm_attention_sublayer_tiled_plain,
)
from multimodalemotionrecognition_torch.kernels.xattn import (
    XattnParams,
    fused_bidirectional_xattn,
    fused_bidirectional_xattn_plain,
    xattn_params_from_state_dict,
)

__all__ = [
    "FusedBlockParams",
    "FusedBlockSpec",
    "XattnParams",
    "extract_block_params",
    "fused_bidirectional_xattn",
    "fused_bidirectional_xattn_plain",
    "fused_block",
    "fused_block_plain",
    "fused_conv_layer",
    "fused_conv_layer_plain",
    "hash_keep_plain",
    "wavlm_attention_sublayer",
    "wavlm_attention_sublayer_backward",
    "wavlm_attention_sublayer_backward_plain",
    "wavlm_attention_sublayer_forward",
    "wavlm_attention_sublayer_plain",
    "wavlm_attention_sublayer_tiled",
    "wavlm_attention_sublayer_tiled_plain",
    "xattn_params_from_state_dict",
]
