"""Image-side tensor ops the mel audio branch needs.

Counterpart of the JAX package's `ops/image.py::adaptive_avg_pool_2d`, which
builds torch's `AdaptiveAvgPool2d` from two averaging matrices so that it
lowers to matrix products on a TPU.  On a GPU `F.adaptive_avg_pool2d` is that
function itself: output bin i averages inputs floor(i*In/Out) ..
ceil((i+1)*In/Out) - 1, whether or not Out divides In.
`uniform_frame_indices` is the module's host-side frame selection, in numpy,
for the media decode of the serving path.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch.nn import functional as F

__all__ = ["adaptive_avg_pool_2d", "uniform_frame_indices"]


def adaptive_avg_pool_2d(x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    """torch `AdaptiveAvgPool2d` on [..., H, W] -> [..., oh, ow]."""
    lead = x.shape[:-2]
    pooled = F.adaptive_avg_pool2d(x.reshape(-1, 1, *x.shape[-2:]), output_size)
    return pooled.reshape(*lead, *output_size)


def uniform_frame_indices(total: int, num: int) -> List[int]:
    """Uniformly sample `num` indices from `total` frames
    (reference `_uniform_indices`, `src/data/ravdess.py:272-277`)."""
    if total <= 0:
        return [0] * num
    if total >= num:
        return np.linspace(0, total - 1, num=num).round().astype(int).tolist()
    return list(range(total)) + [total - 1] * (num - total)
