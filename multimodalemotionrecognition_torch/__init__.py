"""PyTorch/CUDA port of the multimodal emotion recognition framework.

Beside `multimodalemotionrecognition_tpu` (the JAX reference), this package
serves and trains the flagship model (`ModelConfig(fusion="xattn",
use_wavlm=True)`) on an NVIDIA Hopper GPU.  The layout mirrors the JAX package, so each module has
a counterpart of the same name there.  The Pallas kernels of the serving
and training paths (the WavLM attention sublayer and its backward, the conv
feature extractor, the whole fusion block of `TorchModelRunner(fused=True)`
and its attention core) are hand-written CUDA C++ (`kernels/csrc/`), each with a plain PyTorch version
beside it that runs for CPU tensors.  Training and serving scale out by
data parallelism over `torch.distributed` (`parallel/`).

The package imports torch and numpy, never jax or flax, and nothing of the
JAX package: `config.py` is its own copy of the configuration classes.
"""

from multimodalemotionrecognition_torch.config import (
    ModelConfig,
    ServeConfig,
    TrainConfig,
    WavLMConfig,
    labels_for,
)

__all__ = ["ModelConfig", "ServeConfig", "TrainConfig", "WavLMConfig", "labels_for"]
