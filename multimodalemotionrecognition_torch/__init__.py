"""PyTorch/CUDA port of the multimodal emotion recognition framework.

Beside `multimodalemotionrecognition_tpu` (the JAX reference), this package
serves the flagship model (`ModelConfig(fusion="xattn", use_wavlm=True)`) on
an NVIDIA Hopper GPU.  The layout mirrors the JAX package, so each module has
a counterpart of the same name there.  The two Pallas kernels of the serving
path are hand-written CUDA C++ (`kernels/csrc/`), each with a plain PyTorch
version beside it that runs for CPU tensors.

The package imports torch and numpy, never jax or flax.  Of the JAX package
it uses only the framework-free `config` module.
"""

from multimodalemotionrecognition_torch.config import (
    ModelConfig,
    ServeConfig,
    WavLMConfig,
    labels_for,
)

__all__ = ["ModelConfig", "ServeConfig", "WavLMConfig", "labels_for"]
