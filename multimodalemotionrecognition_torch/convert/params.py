"""Flax parameter trees -> the port's torch state dicts.

Counterpart of `convert/torch_import.py::flax_to_torch_state_dict`, on numpy
only, so weights made by the JAX package load into the port with
`load_state_dict(strict=True)`.  The Flax trees name every module by its
torch state-dict path, so the walk is mechanical:

    kernel (2-D)      -> weight.T                  (nn.Linear)
    kernel (3-D)      -> weight.permute(2, 1, 0)   (nn.Conv1d)
    kernel (4-D)      -> weight.permute(3, 2, 0, 1) (nn.Conv2d)
    scale             -> weight                    (LayerNorm/BatchNorm/GroupNorm)
    in_proj_kernel    -> in_proj_weight.T          (packed MHA q/k/v)
    embedding         -> weight                    (nn.Embedding)
    batch_stats mean  -> running_mean
    batch_stats var   -> running_var

plus a zero `num_batches_tracked` beside each BatchNorm's running stats.
`state_dict_key` is the key map alone, e.g. to hold the JAX runner's int8
leaves and scales against the port's quantised modules.

Training state crosses the same way: the `batch_stats` collection becomes
the running statistics above, and `adam_moments_to_state_dict` lays the
moments of an `optax.ScaleByAdamState` (trees shaped like the parameters)
out under the parameters' state-dict keys, so both trainers can start a
step from the same state.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["adam_moments_to_state_dict", "flax_params_to_state_dict", "state_dict_key"]

_BATCH_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_LEAF_NAMES = {
    "kernel": "weight", "scale": "weight", "embedding": "weight",
    "in_proj_kernel": "in_proj_weight",
}
_KERNEL_PERMUTATIONS = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def state_dict_key(path: Tuple[str, ...]) -> str:
    """(collection, *module path, leaf) -> the port's state-dict key."""
    mod_path, _, leaf_name = ".".join(path[1:]).rpartition(".")
    if path[0] == "batch_stats":
        leaf_name = _BATCH_STAT_LEAVES[leaf_name]
    else:
        leaf_name = _LEAF_NAMES.get(leaf_name, leaf_name)
    return f"{mod_path}.{leaf_name}" if mod_path else leaf_name


def flax_params_to_state_dict(
    flat: Mapping[Tuple[str, ...], np.ndarray],
) -> Dict[str, torch.Tensor]:
    """`flat` maps (collection, *module path, leaf) -> array, as
    `flax.traverse_util.flatten_dict(variables)` gives it."""
    out: Dict[str, torch.Tensor] = {}
    bn_modules = set()
    for path, leaf in flat.items():
        # A path element may itself hold dots ("conv_layers.0.conv.kernel").
        mod_path, _, leaf_name = ".".join(path[1:]).rpartition(".")
        arr = np.asarray(leaf)
        if path[0] == "batch_stats":
            bn_modules.add(mod_path)
        elif leaf_name == "kernel":
            if arr.ndim not in _KERNEL_PERMUTATIONS:
                raise ValueError(f"Unsupported kernel rank {arr.ndim} at {mod_path}")
            arr = arr.transpose(_KERNEL_PERMUTATIONS[arr.ndim])
        elif leaf_name == "in_proj_kernel":
            arr = arr.T
        out[state_dict_key(path)] = torch.tensor(arr)
    for mod in bn_modules:
        out[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def adam_moments_to_state_dict(
    flat: Mapping[Tuple[str, ...], np.ndarray],
) -> Dict[str, torch.Tensor]:
    """One moment tree of an `optax.ScaleByAdamState` (`mu` or `nu`), as
    `flatten_dict` gives it (module path, leaf; no collection), -> tensors
    under the parameters' state-dict keys, laid out like the parameters."""
    return flax_params_to_state_dict({("params", *path): leaf for path, leaf in flat.items()})
