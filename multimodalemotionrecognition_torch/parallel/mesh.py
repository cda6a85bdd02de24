"""Device mesh and sharding rules for data and tensor parallelism.

Counterpart of the JAX package's `parallel/mesh.py`.  JAX names a sharding
and lets XLA move the data; here a `Mesh` is a (data, model) grid of
`torch.device`s and the helpers place tensors on it themselves:

  * `make_mesh` - the grid, raising when dp * tp is not the device count.
    A device may appear more than once, so two replicas, or two shards of
    one replica, can share one card (or the CPU).  `Mesh.row(d)` is
    replica d's devices, one per model-axis index.
  * `shard_batch` - each leaf's rows split over "data" when they divide,
    else the whole leaf on every replica (JAX's rule).
  * `replicate` - one copy per data-axis replica.
  * `param_sharding_rules` - JAX's `_TP_RULES` for the port's parameter
    names.  A torch `weight` is [out, in] where Flax's `kernel` is [in, out],
    so the axes of a matrix's spec are swapped.
  * `shard_params` - one copy per replica of a state dict, each tensor a
    rule names split into tp contiguous pieces along its axis, piece i on
    the row's i-th device under the name `<module>.shards.<i>.<leaf>` (the
    names `parallel/tensor.py::shard_module_` gives the sharded modules);
    a leaf whose axis does not divide by tp stays whole on the row's first
    device (JAX's fallback to replication), as does every leaf no rule
    names.  `gather_params` is its exact inverse.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "Mesh",
    "gather_params",
    "make_mesh",
    "param_sharding_rules",
    "replicate",
    "shard_batch",
    "shard_name",
    "shard_params",
    "split_axis",
    "unshard_name",
]


class Mesh:
    """A (data, model) grid of devices; `shape` maps the axis names to their
    sizes as a JAX mesh's does."""

    def __init__(self, devices: Sequence[Sequence[Any]]):
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(torch.device(d) for d in row) for row in devices)
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape: Dict[str, int] = {"data": len(self.devices), "model": widths.pop()}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data-axis index (its first model-axis entry)."""
        return [row[0] for row in self.devices]

    def row(self, d: int) -> Tuple[torch.device, ...]:
        """The devices of data-axis replica `d`, in model-axis order."""
        return self.devices[d]

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, devices={self.devices})"


def _default_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: CUDA is not available (pass the devices, e.g. ['cpu', 'cpu'])")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Mesh over the (data, model) axes; shape None puts every device on
    "data".  `devices` defaults to every CUDA card of this host."""
    devices = list(devices if devices is not None else _default_devices())
    if shape is None:
        shape = (len(devices), 1)
    dp, tp = shape
    if dp * tp != len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} != {len(devices)} devices")
    return Mesh([devices[i * tp:(i + 1) * tp] for i in range(dp)])


def _leaves_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _leaves_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def shard_batch(mesh: Mesh, batch: Any) -> List[Any]:
    """-> one copy of the pytree `batch` per data-axis index, each leaf on
    that replica's device: its rows split over "data" when the leading dim
    divides by the data size, else the whole leaf (JAX's rule)."""
    dp = mesh.shape["data"]

    def part(i):
        device = mesh.data_devices[i]

        def put(x):
            t = _as_tensor(x)
            if t.ndim >= 1 and t.shape[0] % dp == 0:
                n = t.shape[0] // dp
                t = t[i * n:(i + 1) * n]
            return t.to(device)

        return _leaves_map(put, batch)

    return [part(i) for i in range(dp)]


def replicate(mesh: Mesh, tree: Any) -> List[Any]:
    """-> one copy of the pytree `tree` per data-axis replica, on its device."""
    return [_leaves_map(lambda x, d=d: _as_tensor(x).to(d), tree) for d in mesh.data_devices]


# (regex over the parameter's name, spec) - first match wins.  JAX's
# `_TP_RULES` with Flax's `kernel` [in, out] as torch's `weight` [out, in]:
# column-parallel q/k/v and the MLP's up projection ("model", None),
# row-parallel output projections (None, "model"), their biases ("model",).
_TP_RULES = [
    (re.compile(r"wavlm\.encoder\.layers\.\d+\.attention\.[qkv]_proj\.weight$"), ("model", None)),
    (re.compile(r"wavlm\.encoder\.layers\.\d+\.attention\.[qkv]_proj\.bias$"), ("model",)),
    (re.compile(r"wavlm\.encoder\.layers\.\d+\.attention\.out_proj\.weight$"), (None, "model")),
    (re.compile(r"wavlm\.encoder\.layers\.\d+\.feed_forward\.intermediate_dense\.weight$"),
     ("model", None)),
    (re.compile(r"wavlm\.encoder\.layers\.\d+\.feed_forward\.intermediate_dense\.bias$"),
     ("model",)),
    (re.compile(r"wavlm\.encoder\.layers\.\d+\.feed_forward\.output_dense\.weight$"),
     (None, "model")),
]


# `<module>.shards.<i>.<leaf>`: piece i of `<module>.<leaf>` on a model axis.
_SHARD_KEY = re.compile(r"^(.*)\.shards\.(\d+)\.([^.]+)$")


def shard_name(name: str, index: int) -> str:
    """The name of piece `index` of the tensor `name` (`<module>.<leaf>`)."""
    module, _, leaf = name.rpartition(".")
    return f"{module}.shards.{index}.{leaf}"


def unshard_name(name: str) -> str:
    """The whole tensor's name for a piece's name; other names as they are."""
    found = _SHARD_KEY.match(name)
    return f"{found[1]}.{found[3]}" if found else name


def param_sharding_rules(name: str, use_tp: bool) -> Tuple[Optional[str], ...]:
    """The spec of the parameter `name` (or of a piece of it): a tuple
    naming the mesh axis each dim is split over (None: not split); ()
    replicates."""
    if use_tp:
        name = unshard_name(name)
        for rule, spec in _TP_RULES:
            if rule.search(name):
                return spec
    return ()


def split_axis(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The dim of the tensor `name` of `shape` that a model axis of `tp`
    splits, or None: no rule names it, tp is 1, or the dim does not divide
    by tp (JAX's fallback to replication)."""
    spec = param_sharding_rules(name, tp > 1)
    if "model" not in spec:
        return None
    axis = spec.index("model")
    return axis if shape[axis] % tp == 0 else None


def shard_params(mesh: Mesh, tensors: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """-> one copy of the named tensors (a state dict) per data-axis
    replica: with model > 1 each tensor that `split_axis` splits becomes tp
    contiguous pieces, piece i under `shard_name(name, i)` on the replica's
    i-th device; every other tensor stays whole on its first device."""
    tp = mesh.shape["model"]
    out = []
    for d in range(mesh.shape["data"]):
        row = mesh.row(d)
        copy: Dict[str, torch.Tensor] = {}
        for name, x in tensors.items():
            x = _as_tensor(x)
            axis = split_axis(name, x.shape, tp)
            if axis is None:
                copy[name] = x.to(row[0])
                continue
            n = x.shape[axis] // tp
            for i, device in enumerate(row):
                copy[shard_name(name, i)] = x.narrow(axis, i * n, n).to(device)
        out.append(copy)
    return out


def gather_params(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of one replica's `shard_params`: the pieces of each
    tensor joined in model-axis order along their rule's axis, on the first
    piece's device, under the whole tensor's name; other tensors as they
    are.  Keys keep the order of their first appearance."""
    pieces: Dict[str, Dict[int, torch.Tensor]] = {}
    order: Dict[str, None] = {}
    for key, x in tensors.items():
        found = _SHARD_KEY.match(key)
        name = unshard_name(key)
        order.setdefault(name)
        if found:
            pieces.setdefault(name, {})[int(found[2])] = x
    out: Dict[str, torch.Tensor] = {}
    for name in order:
        if name not in pieces:
            out[name] = tensors[name]
            continue
        parts = [pieces[name][i] for i in range(len(pieces[name]))]
        spec = param_sharding_rules(name, True)
        if "model" not in spec:
            raise ValueError(f"gather_params: {name!r} has pieces but no rule names its axis")
        device = parts[0].device
        out[name] = torch.cat([p.to(device) for p in parts], dim=spec.index("model"))
    return out
