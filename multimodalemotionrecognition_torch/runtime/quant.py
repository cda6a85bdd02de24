"""int8 weight-only quantisation of the model's `nn.Linear` layers.

Counterpart of `JaxModelRunner._quantize_dense_int8` / `_dequantize` in the
JAX package's `runtime/runner.py`.  The same matrices are quantised: there
the Flax leaves named `kernel` with two dimensions and `min(shape) >= 8`,
here the `nn.Linear` weights of that size (never the attention's packed
`in_proj_weight`, embeddings, convolutions or the N=1 score layers).  With
one float32 scale per output feature,

    scale = max(max_in |w|, 1e-8) / 127
    q     = clip(round(w / scale), -127, 127)   as int8

The weights stay int8 in device memory.  `Int8Linear.forward` dequantises
`q.float() * scale` and casts to the activation's dtype on each call; the
whole-fusion-block kernel reads the int8 matrices and their scales as they
are (`kernels/fused_block.py`).  Under tensor parallelism
(`parallel/tensor.py`) an `Int8Linear` is split as its float weight would
be: a column piece keeps its rows' scales, a row piece all of them.  The
JAX runner also quantises before it shards.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["Int8Linear", "quantize_linears_int8", "quantize_weight_int8"]

_MIN_DIM = 8


def quantize_weight_int8(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float weight -> (int8 [out, in], float32 scale [out])."""
    w = weight.detach().float()
    scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0].contiguous()


class Int8Linear(nn.Module):
    """`nn.Linear` with an int8 weight and per-output-feature scales.

    State-dict entries: `weight_q` (int8 [out, in]), `scale` (float32
    [out]) and `bias` (the replaced layer's own parameter, not a copy).  The
    scales stay float32 when the module is cast to another floating dtype."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        q, scale = quantize_weight_int8(linear.weight)
        self.register_buffer("weight_q", q)
        self.register_buffer("scale", scale)
        self.bias = linear.bias

    @classmethod
    def from_parts(cls, weight_q: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> "Int8Linear":
        """An `Int8Linear` holding these tensors as they are (a tensor-
        parallel piece: `parallel/tensor.py`)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.out_features, self.in_features = weight_q.shape
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        self.bias = bias
        return self

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        self.scale = scale.to(self.scale.device)  # follows the device, not the dtype
        return self

    @property
    def weight(self) -> torch.Tensor:
        """The dequantised float32 [out, in] weight."""
        return self.weight_q.float() * self.scale[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias)


def quantize_linears_int8(model: nn.Module) -> Dict[str, Int8Linear]:
    """Replace, in place, every `nn.Linear` of `model` whose weight has
    `min(shape) >= 8` by an `Int8Linear`; -> {module path: new module}.
    Call it on float32 weights, before any cast to the compute dtype."""
    replaced: Dict[str, Int8Linear] = {}
    for parent_name, parent in list(model.named_modules()):
        for child_name, child in list(parent.named_children()):
            if isinstance(child, nn.Linear) and min(child.weight.shape) >= _MIN_DIM:
                quantised = Int8Linear(child)
                setattr(parent, child_name, quantised)
                path = f"{parent_name}.{child_name}" if parent_name else child_name
                replaced[path] = quantised
    return replaced
