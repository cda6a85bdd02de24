"""Mel-spectrogram front end, numerically matching torchaudio.

Counterpart of the JAX package's `ops/mel.py`, with the same constants.  The
reference computes `MelSpectrogram(sr=16k, n_mels=64, win=400, hop=160)` and
`AmplitudeToDB()` per sample on the host (`src/data/ravdess.py:478-485`);
here the front end is batched tensor code that runs on the input's device, so
it can sit inside a model forward.

torchaudio semantics reproduced:
  * Spectrogram: n_fft=400, win_length=400, hop=160, periodic Hann window,
    center=True with reflect padding, power=2, no normalisation, onesided.
  * MelScale: HTK mel, f_min=0, f_max=sr/2, norm=None, triangular banks.
  * AmplitudeToDB(stype="power", top_db=None): 10*log10(clamp(x, 1e-10)).

The DFT is a real matrix product (frames @ [cos | -sin] basis with the window
folded in) and the mel projection another: both go to `torch.matmul`, as the
JAX package leaves them to XLA.  `log_mel_spectrogram_np` is the numpy twin
for host-side preprocessing.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

__all__ = [
    "amplitude_to_db",
    "log_mel_spectrogram",
    "log_mel_spectrogram_np",
    "mel_filterbank",
    "mel_spectrogram",
]


def _hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def _mel_filterbank_np(
    n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int
) -> np.ndarray:
    """Triangular mel filterbank, torchaudio `melscale_fbanks` semantics
    (HTK scale, norm=None).  Shape [n_freqs, n_mels]."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_min = _hz_to_mel_htk(np.array(f_min))
    m_max = _hz_to_mel_htk(np.array(f_max))
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)

    f_diff = f_pts[1:] - f_pts[:-1]  # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_basis_np(n_fft: int, win_length: int) -> np.ndarray:
    """Real-DFT basis with the periodic Hann window folded in:
    [n_fft, 2 * (n_fft // 2 + 1)], columns cos then -sin, so `frames @ basis`
    is [real | imag] of the onesided DFT of the windowed frame.  A window
    shorter than n_fft is centred in the frame, as torch.stft does."""
    n_bins = n_fft // 2 + 1
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    pad_left = (n_fft - win_length) // 2
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_bins, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft  # [n_fft, n_bins]
    full = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)  # [n_fft, 2*n_bins]
    w_full = np.zeros(n_fft, dtype=np.float64)
    w_full[pad_left : pad_left + win_length] = window
    return (full * w_full[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _constants(n_fft, win_length, n_mels, f_min, f_max, sample_rate, device):
    """(DFT basis, mel filterbank) as float32 tensors on `device`."""
    basis = torch.from_numpy(_dft_basis_np(n_fft, win_length)).to(device)
    fb = torch.from_numpy(
        _mel_filterbank_np(n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate)
    ).to(device)
    return basis, fb


def mel_filterbank(
    n_freqs: int = 201, f_min: float = 0.0, f_max: float = 8000.0, n_mels: int = 64,
    sample_rate: int = 16000, device=None,
) -> torch.Tensor:
    fb = _mel_filterbank_np(n_freqs, f_min, f_max, n_mels, sample_rate)
    return torch.from_numpy(fb).to(device or "cpu")


def mel_spectrogram(
    wav: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 400,
    win_length: int = 400,
    hop_length: int = 160,
    n_mels: int = 64,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
    power: float = 2.0,
) -> torch.Tensor:
    """Mel power spectrogram of `wav` [..., T] -> [..., n_mels, frames], in
    float32 math, returned in wav's dtype
    (`torchaudio.transforms.MelSpectrogram` with the reference's parameters)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    lead = wav.shape[:-1]
    x = wav.float().reshape(-1, wav.shape[-1])
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    frames = x.unfold(-1, n_fft, hop_length)  # [N, frames, n_fft], a view
    basis, fb = _constants(
        n_fft, win_length, n_mels, float(f_min), float(f_max), sample_rate, wav.device
    )
    spec_ri = torch.matmul(frames, basis)  # [N, frames, 2*n_bins]
    n_bins = n_fft // 2 + 1
    re, im = spec_ri[..., :n_bins], spec_ri[..., n_bins:]
    mag2 = re * re + im * im
    if power != 2.0:
        mag2 = mag2.clamp_min(0.0).pow(power / 2.0)
    mel = torch.matmul(mag2, fb).transpose(-1, -2)  # [N, n_mels, frames]
    return mel.reshape(*lead, n_mels, mel.shape[-1]).to(wav.dtype)


def amplitude_to_db(
    x: torch.Tensor, stype: str = "power", top_db: Optional[float] = None,
    amin: float = 1e-10, ref: float = 1.0,
) -> torch.Tensor:
    """`torchaudio.transforms.AmplitudeToDB` (the reference uses its
    defaults: power, top_db=None)."""
    multiplier = 10.0 if stype == "power" else 20.0
    db = multiplier * torch.log10(x.clamp_min(amin))
    db = db - multiplier * math.log10(max(amin, ref))
    if top_db is not None:
        db = torch.maximum(db, db.max() - top_db)  # relative to the tensor's max
    return db


def log_mel_spectrogram(
    wav: torch.Tensor, sample_rate: int = 16000, n_fft: int = 400, win_length: int = 400,
    hop_length: int = 160, n_mels: int = 64,
) -> torch.Tensor:
    """The reference's audio front end, MelSpectrogram + AmplitudeToDB:
    [..., T] waveform -> [..., n_mels, frames] log-mel (dB); 48,000 samples
    give 301 frames."""
    return amplitude_to_db(mel_spectrogram(
        wav, sample_rate=sample_rate, n_fft=n_fft, win_length=win_length,
        hop_length=hop_length, n_mels=n_mels,
    ))


def log_mel_spectrogram_np(
    wav, sample_rate: int = 16000, n_fft: int = 400, win_length: int = 400,
    hop_length: int = 160, n_mels: int = 64, f_min: float = 0.0,
    f_max: Optional[float] = None,
) -> np.ndarray:
    """Numpy twin of `log_mel_spectrogram` for host-side preprocessing: the
    same constants and the same two products, no device involved."""
    if f_max is None:
        f_max = sample_rate / 2.0
    x = np.asarray(wav, dtype=np.float32)
    pad = n_fft // 2
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    num_frames = 1 + (x.shape[-1] - n_fft) // hop_length
    idx = (np.arange(num_frames) * hop_length)[:, None] + np.arange(n_fft)[None, :]
    spec_ri = x[..., idx] @ _dft_basis_np(n_fft, win_length)
    n_bins = n_fft // 2 + 1
    re, im = spec_ri[..., :n_bins], spec_ri[..., n_bins:]
    fb = _mel_filterbank_np(n_bins, f_min, f_max, n_mels, sample_rate)
    mel = np.swapaxes((re * re + im * im) @ fb, -1, -2)
    return (10.0 * np.log10(np.maximum(mel, 1e-10))).astype(np.float32)
