"""Stochastic train-time regularizers with explicit `torch.Generator`s.

Counterpart of the JAX package's `ops/stochastic.py`, behavioural (not
bitwise) equivalents of its draws: `drop_path` (StochasticDepth, reference
`src/models/fusion.py:11-26`), `modality_dropout_mask` (batch-level modality
zeroing, `:29-55`), and `dropout`, which stands for Flax's `nn.Dropout`
(`F.dropout` takes no generator), and `spec_augment` (SpecAugment masks,
`src/models/audio.py:10-52`).  `mix_noise_snr` comes with the data pipeline.

`RngStreams` stands for the JAX trainer's named PRNG streams: one seeded
generator per name on the compute device, and a host twin for the draws
that steer control flow (LayerDrop) or are passed to a kernel by value (the
attention kernel's dropout seed), so neither waits for the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "RNG_STREAMS", "RngStreams", "drop_path", "dropout", "modality_dropout_mask", "spec_augment",
]

RNG_STREAMS = (
    "dropout", "droppath", "modality", "specaugment", "wavlm_mask", "layerdrop", "videoaug",
)


class RngStreams:
    """Named generators made from one seed; every random draw of a train
    step names the stream it takes from."""

    def __init__(self, seed: int, device: torch.device | str = "cpu"):
        self.seed = int(seed)
        self._device = {}
        self._host = {}
        for i, name in enumerate(RNG_STREAMS):
            self._device[name] = torch.Generator(device=device).manual_seed(self._sub(2 * i))
            self._host[name] = torch.Generator().manual_seed(self._sub(2 * i + 1))

    def _sub(self, index: int) -> int:
        return (self.seed * 1000003 + index) % (2**63 - 1)

    def device(self, name: str) -> torch.Generator:
        """The stream's generator on the compute device (masks, noise)."""
        return self._device[name]

    def host(self, name: str) -> torch.Generator:
        """The stream's CPU generator (scalars the host reads)."""
        return self._host[name]

    def uniform(self, name: str) -> float:
        """One U[0, 1) draw on the host."""
        return float(torch.rand((), generator=self._host[name]))

    def get_state(self) -> dict:
        """Every generator's state (CPU byte tensors), for a resume file."""
        return {"seed": self.seed,
                "device": {k: g.get_state() for k, g in self._device.items()},
                "host": {k: g.get_state() for k, g in self._host.items()}}

    def set_state(self, state: dict) -> None:
        """Restore what `get_state` returned: the draws go on where they stopped."""
        self.seed = int(state["seed"])
        for name in RNG_STREAMS:
            self._device[name].set_state(state["device"][name])
            self._host[name].set_state(state["host"][name])

    def kernel_seed(self, name: str = "dropout") -> int:
        """One int32 in [0, 2^31 - 1), drawn on the host, for a kernel's hash."""
        return int(torch.randint(0, 2**31 - 1, (), generator=self._host[name]))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Elementwise dropout: kept with probability 1 - rate, scaled by 1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * (keep.to(x.dtype) / (1.0 - rate))


def drop_path(
    x: torch.Tensor, drop_prob: float, train: bool, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Per-sample stochastic depth on a residual branch: one Bernoulli(keep)
    per batch element, scaled by 1 / keep, train only."""
    drop_prob = float(min(max(drop_prob, 0.0), 1.0))
    if drop_prob <= 0.0 or not train:
        return x
    keep_prob = 1.0 - drop_prob
    if keep_prob <= 0.0:
        return torch.zeros_like(x)
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep_prob
    return x * mask.to(x.dtype) / keep_prob


def modality_dropout_mask(
    generator: Optional[torch.Generator], audio_p: float, video_p: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-level modality dropout gates: one uniform per batch per modality
    (the reference zeroes the whole batch's embedding, not single samples).
    -> scalar {0, 1} float keep gates for (audio, video)."""
    device = generator.device if generator is not None else "cpu"
    u = torch.rand(2, generator=generator, device=device)
    return (u[0] >= audio_p).float(), (u[1] >= video_p).float()


def spec_augment(
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    freq_mask_param: int = 20,
    time_mask_param: int = 40,
    num_masks: int = 2,
    p: float = 0.5,
) -> torch.Tensor:
    """SpecAugment on [..., n_mels, T]: with probability p, `num_masks`
    rounds of one frequency mask (length ~ U{0..freq_mask_param}) and one
    time mask (length ~ U{0..time_mask_param}), zero fill, the masks shared
    by the batch.  Every draw stays on the generator's device: nothing here
    waits for the host."""
    n_mels, t = x.shape[-2], x.shape[-1]
    device = x.device

    def uniform():
        return torch.rand((), generator=generator, device=device)

    def randint(high):
        """U{0..high-1} for a tensor or int `high` >= 1."""
        return torch.floor(uniform() * high).long()

    apply = uniform() <= p
    mel_ids = torch.arange(n_mels, device=device)[:, None]
    time_ids = torch.arange(t, device=device)[None, :]
    keep = torch.ones(n_mels, t, dtype=torch.bool, device=device)
    for _ in range(num_masks):
        if freq_mask_param > 0:
            f_len = randint(freq_mask_param + 1)
            f_start = randint((n_mels - f_len).clamp_min(1))
            keep &= ~((mel_ids >= f_start) & (mel_ids < f_start + f_len))
        if time_mask_param > 0:
            t_len = randint(time_mask_param + 1)
            t_start = randint((t - t_len).clamp_min(1))
            keep &= ~((time_ids >= t_start) & (time_ids < t_start + t_len))
    return torch.where(apply & ~keep, torch.zeros((), dtype=x.dtype, device=device), x)
