"""Stochastic train-time regularizers with explicit `torch.Generator`s.

Counterpart of the JAX package's `ops/stochastic.py`, behavioural (not
bitwise) equivalents of its draws: `drop_path` (StochasticDepth, reference
`src/models/fusion.py:11-26`), `modality_dropout_mask` (batch-level modality
zeroing, `:29-55`), and `dropout`, which stands for Flax's `nn.Dropout`
(`F.dropout` takes no generator), `spec_augment` (SpecAugment masks,
`src/models/audio.py:10-52`) and `mix_noise_snr` (the noise curriculum on
the device, `src/data/ravdess.py:417-476`; the data pipeline mixes on the
host, `data/media.py::mix_bar_noise`).

`RngStreams` stands for the JAX trainer's named PRNG streams: one seeded
generator per name on the compute device, and a host twin for the draws
that steer control flow (LayerDrop) or are passed to a kernel by value (the
attention kernel's dropout seed), so neither waits for the device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from multimodalemotionrecognition_torch.parallel.distributed import current_shard

__all__ = [
    "RNG_STREAMS", "RngStreams", "draw_rows", "drop_path", "dropout", "dropout_pieces",
    "mix_noise_snr", "modality_dropout_mask", "row_offset", "spec_augment",
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


def draw_rows(draw: Callable[[Tuple[int, ...]], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """draw(shape) for a batch-major `shape`; inside a data-parallel step
    the global batch's shape is drawn (dim 0 times the ranks) and this
    rank's rows are kept."""
    shard, n = current_shard(), shape[0]
    return draw((n * shard.world,) + tuple(shape[1:]))[shard.rows(n)]


def row_offset(rows: int) -> int:
    """The global index of this rank's first row when it holds `rows` rows
    of each batch (0 outside a data-parallel step)."""
    return current_shard().rank * rows


def _keep(shape: Sequence[int], rate: float, generator: torch.Generator, device) -> torch.Tensor:
    """The bool mask of the elements dropout keeps, drawn on `device`."""
    return draw_rows(lambda s: torch.rand(s, generator=generator, device=device), shape) >= rate


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Elementwise dropout: kept with probability 1 - rate, scaled by 1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    return x * (_keep(x.shape, rate, generator, x.device).to(x.dtype) / (1.0 - rate))


def dropout_pieces(
    parts: Sequence[torch.Tensor], dim: int, rate: float, generator: Optional[torch.Generator]
) -> List[torch.Tensor]:
    """`dropout` of the tensor that `parts` (on any devices) concatenate
    along `dim`, without the concatenation: the mask is drawn at the whole
    tensor's shape on the generator's device, as `dropout` of the whole
    draws it there, and each part takes its slice.  The generator advances
    as it would for the whole tensor (tensor parallelism: `models/wavlm.py`)."""
    if rate <= 0.0 or generator is None:
        return list(parts)
    if rate >= 1.0:
        return [torch.zeros_like(p) for p in parts]
    shape = list(parts[0].shape)
    shape[dim] = sum(p.shape[dim] for p in parts)
    keep = _keep(shape, rate, generator, generator.device)
    out, start = [], 0
    for p in parts:
        piece = keep.narrow(dim, start, p.shape[dim]).to(p.device)
        out.append(p * (piece.to(p.dtype) / (1.0 - rate)))
        start += p.shape[dim]
    return out


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
    mask = draw_rows(lambda s: torch.rand(s, generator=generator, device=x.device), shape) < keep_prob
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


def mix_noise_snr(
    generator: Optional[torch.Generator],
    wav: torch.Tensor,
    noise_bank: torch.Tensor,
    clean_prob: float = 0.5,
    heavy_prob: float = 0.1,
    light_snrs: Tuple[float, ...] = (20.0, 15.0, 10.0),
    heavy_snr: float = 5.0,
) -> torch.Tensor:
    """Noise-curriculum mixing for one waveform [T] with a noise bank [N >= T].

    Reference semantics (`src/data/ravdess.py:417-476`): 50% clean; 40% light
    noise at SNR in {20, 15, 10} dB; 10% heavy at 5 dB. The noise segment
    starts at a random offset, is power-scaled so SNR = 10*log10(P_sig /
    P_noise), mixed in the time domain, and the result clamped to [-1, 1].
    Three draws from `generator` on the waveform's device, in the JAX
    function's order (level, light SNR, offset); nothing waits for the host."""
    t = wav.shape[-1]
    if noise_bank.shape[-1] < t:
        raise ValueError(f"noise bank of {noise_bank.shape[-1]} samples for a {t}-sample waveform")
    device = wav.device
    level = torch.rand((), generator=generator, device=device)
    snr_index = torch.randint(0, len(light_snrs), (), generator=generator, device=device)
    start = torch.randint(0, noise_bank.shape[-1] - t + 1, (), generator=generator, device=device)
    return _mix_noise_snr(wav, noise_bank, level, snr_index, start, clean_prob, heavy_prob,
                          light_snrs, heavy_snr)


def _mix_noise_snr(wav, noise_bank, level, snr_index, start, clean_prob, heavy_prob, light_snrs,
                   heavy_snr) -> torch.Tensor:
    """`mix_noise_snr` at given draws (0-d tensors on the waveform's device)."""
    device = wav.device
    snr_light = torch.tensor(light_snrs, dtype=wav.dtype, device=device)[snr_index]
    snr_db = torch.where(level < 1.0 - heavy_prob, snr_light, torch.full_like(snr_light, heavy_snr))
    seg = noise_bank[..., start + torch.arange(wav.shape[-1], device=device)]
    power_sig = (wav**2).mean()
    power_target = power_sig / torch.clamp_min(10.0 ** (snr_db / 10.0), 1e-8)
    power_seg = (seg**2).mean()
    scale = torch.sqrt(power_target / power_seg.clamp_min(1e-8))
    scale = torch.where(power_seg > 1e-8, scale, torch.zeros_like(scale))
    noisy = (wav + seg * scale).clamp(-1.0, 1.0)
    return torch.where(level < clean_prob, wav, noisy)
