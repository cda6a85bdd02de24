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
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["flax_params_to_state_dict"]

_BATCH_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_KERNEL_PERMUTATIONS = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def flax_params_to_state_dict(
    flat: Mapping[Tuple[str, ...], np.ndarray],
) -> Dict[str, torch.Tensor]:
    """`flat` maps (collection, *module path, leaf) -> array, as
    `flax.traverse_util.flatten_dict(variables)` gives it."""
    out: Dict[str, torch.Tensor] = {}
    bn_modules = set()
    for path, leaf in flat.items():
        collection = path[0]
        mod_path, _, leaf_name = ".".join(path[1:]).rpartition(".")
        arr = np.asarray(leaf)
        if collection == "batch_stats":
            key = f"{mod_path}.{_BATCH_STAT_LEAVES[leaf_name]}"
            bn_modules.add(mod_path)
        elif leaf_name == "kernel":
            if arr.ndim not in _KERNEL_PERMUTATIONS:
                raise ValueError(f"Unsupported kernel rank {arr.ndim} at {mod_path}")
            arr = arr.transpose(_KERNEL_PERMUTATIONS[arr.ndim])
            key = f"{mod_path}.weight"
        elif leaf_name in ("scale", "embedding"):
            key = f"{mod_path}.weight"
        elif leaf_name == "in_proj_kernel":
            arr = arr.T
            key = f"{mod_path}.in_proj_weight"
        else:
            key = f"{mod_path}.{leaf_name}" if mod_path else leaf_name
        out[key] = torch.tensor(arr)
    for mod in bn_modules:
        out[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out
