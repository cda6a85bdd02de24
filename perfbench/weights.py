"""Random weights of a configuration, made on the device from the seed.

One normal draw on the device's generator fills every floating leaf of the
state dict at once; each leaf is then shaped by its kind: matrices and
kernels LeCun-normal (N(0, 1) / sqrt(fan_in)), norm scales and WavLM's gate
constants 1 + 0.1 N, biases 0.02 N, BatchNorm running means 0.1 N and
variances 1 + 0.1 |N|.  The same seed gives the same weights; the program
and the reference are given the same tensors.
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.model import Model


def layout(config: dict) -> Dict[str, torch.Tensor]:
    """The configuration's state dict on the meta device: names, shapes, dtypes."""
    with torch.device("meta"):
        return Model(config).state_dict()


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """-> the state dict (float32 leaves on `device`, counters as zeros)."""
    meta = layout(config)
    floats = {k: v for k, v in meta.items() if v.is_floating_point()}
    total = sum(v.numel() for v in floats.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, start = {}, 0
    for name, v in meta.items():
        if not v.is_floating_point():
            out[name] = torch.zeros(v.shape, dtype=v.dtype, device=device)
            continue
        z = flat[start:start + v.numel()].view(v.shape)
        start += v.numel()
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            z = 1.0 + 0.1 * z.abs()
        elif leaf == "running_mean" or leaf == "masked_spec_embed":
            z = 0.1 * z
        elif v.ndim >= 2 and leaf != "gru_rel_pos_const":
            z = z / v[0].numel() ** 0.5
        elif leaf in ("bias", "in_proj_bias"):
            z = 0.02 * z
        else:
            z = 1.0 + 0.1 * z
        out[name] = z
    return out
