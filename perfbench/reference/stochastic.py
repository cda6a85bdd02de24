"""The random draws of a train step, worked out again from the seed.

A frozen copy of the draw rules the measured program states: one seeded
`torch.Generator` per named stream on the device and a host twin per name,
seeded `(seed * 1000003 + index) % (2**63 - 1)`; elementwise dropout as a
uniform draw of the tensor's shape kept at `>= rate`; stochastic depth as one
uniform per row kept at `< 1 - rate`; the attention kernel's stateless hash
(two murmur3 finalizer rounds) for the attention-probability and projected-
output dropouts of a WavLM layer, seeded by one int32 drawn on the host; and
SpecAugment's shared masks from scalar draws.  Equal seeds and an equal
order of draws give equal masks on the same device; nothing here reads the
program's generators or masks.
"""

from __future__ import annotations

import torch

STREAMS = ("dropout", "droppath", "modality", "specaugment", "wavlm_mask", "layerdrop",
           "videoaug")

_MASK32 = 0xFFFFFFFF
_BATCH_STRIDE, _HEAD_STRIDE, _HIDDEN_OFFSET = 0x632BE59B, 0x9E3779B9, 0x7FEB352D


class Streams:
    """Named generators from one seed, on `device` and on the host."""

    def __init__(self, seed: int, device):
        seed = int(seed)
        self.device_gen, self.host_gen = {}, {}
        for i, name in enumerate(STREAMS):
            self.device_gen[name] = torch.Generator(device=device).manual_seed(
                (seed * 1000003 + 2 * i) % (2**63 - 1))
            self.host_gen[name] = torch.Generator().manual_seed(
                (seed * 1000003 + 2 * i + 1) % (2**63 - 1))

    def uniform(self, name: str) -> float:
        return float(torch.rand((), generator=self.host_gen[name]))

    def kernel_seed(self, name: str = "dropout") -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self.host_gen[name]))


def dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    if gen is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return x * (keep.to(x.dtype) / (1.0 - rate))


def drop_path(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    if gen is None or rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=gen, device=x.device) < keep_prob
    return x * mask.to(x.dtype) / keep_prob


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash_keep(base: torch.Tensor, rows: int, cols: int, threshold: int) -> torch.Tensor:
    base = base & _MASK32
    r = torch.arange(rows, dtype=torch.int64, device=base.device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=base.device)[None, :]
    x = ((r * cols + c) & _MASK32) ^ base[..., None, None]
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= threshold


def _threshold(rate: float) -> int:
    return min(int(round(rate * 2.0**32)), 2**32 - 1)


def sublayer_masks(seed: int, b: int, h: int, t: int, e: int, attn_rate: float,
                   hidden_rate: float, device):
    """-> (keep of the attention probabilities [B, H, T, T], keep of the
    projected output [B, T, E]) for one layer's int32 seed."""
    seed = int(seed) & _MASK32
    batch = (seed + torch.arange(b, dtype=torch.int64, device=device) * _BATCH_STRIDE) & _MASK32
    heads = (torch.arange(1, h + 1, dtype=torch.int64, device=device) * _HEAD_STRIDE) & _MASK32
    attn = _hash_keep(batch[:, None] + heads[None, :], t, t, _threshold(attn_rate))
    hid = _hash_keep(batch + _HIDDEN_OFFSET, t, e, _threshold(hidden_rate))
    return attn, hid


def apply_keep(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))


def spec_augment(gen, x: torch.Tensor, freq_param: int = 20, time_param: int = 40,
                 num_masks: int = 2, p: float = 0.5) -> torch.Tensor:
    """Shared frequency and time masks on [..., n_mels, T], zero fill."""
    n_mels, t = x.shape[-2], x.shape[-1]
    device = x.device

    def uniform():
        return torch.rand((), generator=gen, device=device)

    def randint(high):
        return torch.floor(uniform() * high).long()

    apply = uniform() <= p
    mel_ids = torch.arange(n_mels, device=device)[:, None]
    time_ids = torch.arange(t, device=device)[None, :]
    keep = torch.ones(n_mels, t, dtype=torch.bool, device=device)
    for _ in range(num_masks):
        f_len = randint(freq_param + 1)
        f_start = randint((n_mels - f_len).clamp_min(1))
        keep &= ~((mel_ids >= f_start) & (mel_ids < f_start + f_len))
        t_len = randint(time_param + 1)
        t_start = randint((t - t_len).clamp_min(1))
        keep &= ~((time_ids >= t_start) & (time_ids < t_start + t_len))
    return torch.where(apply & ~keep, torch.zeros((), dtype=x.dtype, device=device), x)
