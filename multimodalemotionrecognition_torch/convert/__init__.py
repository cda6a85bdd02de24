from multimodalemotionrecognition_torch.convert.checkpoint import (
    checkpoint_uses_wavlm,
    infer_model_signature,
    load_reference_checkpoint,
    normalize_torch_state_dict,
)
from multimodalemotionrecognition_torch.convert.params import (
    adam_moments_to_state_dict,
    flax_params_to_state_dict,
)

__all__ = [
    "adam_moments_to_state_dict",
    "checkpoint_uses_wavlm",
    "flax_params_to_state_dict",
    "infer_model_signature",
    "load_reference_checkpoint",
    "normalize_torch_state_dict",
]
