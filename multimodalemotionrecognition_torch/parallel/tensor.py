"""Tensor parallelism: a replica's WavLM trunk split over its mesh row.

Counterpart of what the JAX package gets from `parallel/mesh.py::
shard_params` and XLA's partitioner: under a (data, model) mesh with
model > 1, the `_TP_RULES` split each WavLM encoder layer's q/k/v
projections and FFN up-projection by output features (column-parallel) and
its attention out-projection and FFN down-projection by input features
(row-parallel); everything else (the video tower, the conv feature
extractor, the feature projection, the positional conv, the LayerNorms,
the gate, the relative-position embedding, fusion and head) is replicated.

The rule here: a mesh row (`Mesh.row(d)`) is one replica.  Its tp devices
hold the trunk's pieces and one host thread drives them, as the runner
drives its data-parallel replicas in one process; a device may repeat in
a row, so `["cuda:0"] * 2` (or `["cpu"] * 2`) runs the whole tensor-
parallel path on one card.  The replicated parts run once per replica, on
the row's first device.  A column-parallel layer takes its input on every
piece's device and leaves piece i's output there; a row-parallel layer
adds the pieces' partial products on the row's first device in model
order 0..tp-1 (`ordered_sum`, deterministic) and adds its bias once.
Autograd sums the gradients of a replicated parameter over the pieces that
read it (the gate and the position bias are read per head group), so no
collective of the model axis is needed, forward or backward.  The data
axis stays where it was: in-process replicas in the runner, one
`torch.distributed` rank per row in the trainer.

Not taken: `torch.distributed.tensor` or Megatron's f/g collectives over
dp x tp ranks.  Both force a process per device, so the runner (one
process, called by the serving stack) would become a process group, and on
one card their collectives would ride on Gloo, which stages every
collective through the host (a data-parallel step on two Gloo ranks of one
card took 207-293 ms against one rank's 46-51 in this port's own runs).

  * `ColumnParallelLinear`, `RowParallelLinear` - an `nn.Linear` (or the
    runner's `Int8Linear`) in pieces, piece i at `<name>.shards.<i>` on the
    row's i-th device; a row-parallel layer keeps its whole bias at
    `<name>.bias`.  These are the names `parallel/mesh.py::shard_params`
    gives a state dict's pieces, so `gather_params` turns the sharded
    module's state dict back into the whole model's.
  * `ordered_sum` - the cross-device sum in a fixed order.
  * `shard_module_(module, row_devices)` - a loaded module moved to the
    row's first device, then each Linear a rule names (and whose axis
    divides by tp) replaced, in place, by its parallel form.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence

import torch
from torch import nn

from multimodalemotionrecognition_torch.parallel.mesh import split_axis

__all__ = [
    "ColumnParallelLinear",
    "RowParallelLinear",
    "ordered_sum",
    "shard_module_",
]


def _device_of(module: nn.Module) -> torch.device:
    return next(itertools.chain(module.parameters(), module.buffers())).device


def _piece_tensor(x: torch.Tensor, axis: int, index: int, tp: int, device) -> torch.Tensor:
    """Piece `index` of `tp` along `axis`, a contiguous tensor of its own on `device`."""
    n = x.shape[axis] // tp
    return x.detach().narrow(axis, index * n, n).to(device).clone(
        memory_format=torch.contiguous_format)


def _linear_piece(linear: nn.Module, axis: int, index: int, tp: int, device) -> nn.Module:
    """Piece `index` of a Linear split along its weight's `axis` (0: output
    features, with that slice of the bias; 1: input features, no bias)."""
    from multimodalemotionrecognition_torch.runtime.quant import Int8Linear

    if isinstance(linear, Int8Linear):
        bias = linear.bias
        if bias is not None and axis == 0:
            bias = nn.Parameter(_piece_tensor(bias, 0, index, tp, device),
                                requires_grad=bias.requires_grad)
        scale = linear.scale if axis == 1 else _piece_tensor(linear.scale, 0, index, tp, device)
        return Int8Linear.from_parts(_piece_tensor(linear.weight_q, axis, index, tp, device),
                                     scale.to(device), bias if axis == 0 else None)
    weight = _piece_tensor(linear.weight, axis, index, tp, device)
    with_bias = linear.bias is not None and axis == 0
    piece = nn.Linear(weight.shape[1], weight.shape[0], bias=with_bias, device="meta")
    piece.weight = nn.Parameter(weight, requires_grad=linear.weight.requires_grad)
    if with_bias:
        piece.bias = nn.Parameter(_piece_tensor(linear.bias, 0, index, tp, device),
                                  requires_grad=linear.bias.requires_grad)
    return piece


def ordered_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """parts[0] + parts[1] + ... in that order, on `device`, in float32
    whatever the parts' dtype (one rounding, by the caller, at the end)."""
    total = parts[0].to(device=device, dtype=torch.float32)
    for part in parts[1:]:
        total = total + part.to(device=device, dtype=torch.float32)
    return total


class ColumnParallelLinear(nn.Module):
    """A Linear split by output features over a mesh row: forward takes
    one input per piece (each on its piece's device) and returns each
    piece's output features there."""

    def __init__(self, linear: nn.Module, devices: Sequence):
        super().__init__()
        tp = len(devices)
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.shards = nn.ModuleList(
            _linear_piece(linear, 0, i, tp, d) for i, d in enumerate(devices))

    @property
    def devices(self) -> List[torch.device]:
        return [_device_of(s) for s in self.shards]

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [shard(x) for shard, x in zip(self.shards, xs)]


class RowParallelLinear(nn.Module):
    """A Linear split by input features over a mesh row: forward takes the
    pieces of its input (piece i on piece i's device) and returns the whole
    output on the row's first device: the partial products added in model
    order, then the bias, once."""

    def __init__(self, linear: nn.Module, devices: Sequence):
        super().__init__()
        tp = len(devices)
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.shards = nn.ModuleList(
            _linear_piece(linear, 1, i, tp, d) for i, d in enumerate(devices))
        bias = linear.bias
        self.bias = None if bias is None else nn.Parameter(
            bias.detach().to(devices[0]).clone(), requires_grad=bias.requires_grad)

    @property
    def devices(self) -> List[torch.device]:
        return [_device_of(s) for s in self.shards]

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        parts = [shard(x) for shard, x in zip(self.shards, xs)]
        total = ordered_sum(parts, parts[0].device)
        if self.bias is not None:
            total = total + self.bias.float()
        return total.to(xs[0].dtype)


def shard_module_(module: nn.Module, devices: Sequence) -> nn.Module:
    """`module` (a loaded model, or a part of one) in its tensor-parallel
    form over the mesh row `devices`, in place: moved to the row's first
    device, then each `nn.Linear` / `Int8Linear` whose weight a rule of
    `param_sharding_rules` names, with its axis divisible by tp, replaced by
    a `ColumnParallelLinear` (rule axis "out") or `RowParallelLinear` ("in").
    A row of one device leaves the module as it is, moved there.  ->
    `module`."""
    from multimodalemotionrecognition_torch.runtime.quant import Int8Linear

    devices = [torch.device(d) for d in devices]
    module.to(devices[0])
    tp = len(devices)
    if tp == 1:
        return module
    for parent_name, parent in list(module.named_modules()):
        for child_name, child in list(parent.named_children()):
            if not isinstance(child, (nn.Linear, Int8Linear)):
                continue
            name = f"{parent_name}.{child_name}" if parent_name else child_name
            shape = child.weight_q.shape if isinstance(child, Int8Linear) else child.weight.shape
            axis = split_axis(f"{name}.weight", shape, tp)
            if axis is not None:
                parallel = ColumnParallelLinear if axis == 0 else RowParallelLinear
                setattr(parent, child_name, parallel(child, devices))
    return module

