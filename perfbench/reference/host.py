"""The serving host path of a `.wav` upload, in numpy: RIFF decode, polyphase
resampling to 16 kHz, head-crop or zero-pad to 3 s, and the int16 wire.

The resampler is the polyphase FIR of the published definition (a Kaiser
window of beta 5, cut-off at 1 / max(up, down), 10 * max(up, down) taps
each side, gain `up`, computed in float64), evaluated directly per output
sample instead of upsampling, filtering and downsampling.
"""

from __future__ import annotations

import math
import struct

import numpy as np

TARGET_RATE = 16000
TARGET_LEN = 48000


def decode_wav(data: bytes):
    """16-bit PCM RIFF/WAVE bytes -> (float32 samples in [-1, 1), the mean
    of the channels, sample rate)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, rate, channels, bits, samples = 12, None, 1, 16, None
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if tag == b"fmt ":
            _, channels, rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
        elif tag == b"data":
            samples = np.frombuffer(body, dtype="<i2")
        pos += 8 + size + (size & 1)
    if samples is None or rate is None or bits != 16:
        raise ValueError("expected a 16-bit PCM data chunk")
    wav = samples.reshape(-1, channels).astype(np.float32) / 32768.0
    return (wav[:, 0] if channels == 1 else wav.mean(axis=1)), int(rate)


def _fir(up: int, down: int) -> np.ndarray:
    max_rate = max(up, down)
    half = 10 * max_rate
    n = 2 * half + 1
    m = np.arange(n, dtype=np.float64) - half
    h = np.sinc(m / max_rate) / max_rate * np.kaiser(n, 5.0)
    return h / h.sum() * up


def resample(x: np.ndarray, rate: int, target: int = TARGET_RATE,
             n_out: int | None = None) -> np.ndarray:
    """Polyphase resampling of float64 `x` from `rate` to `target`; the first
    `n_out` outputs (all by default)."""
    g = math.gcd(rate, target)
    up, down = target // g, rate // g
    if up == down == 1:
        return np.asarray(x, np.float64)
    x = np.asarray(x, np.float64)
    h = _fir(up, down)
    half = (len(h) - 1) // 2
    total = -(-len(x) * up // down)
    n_out = total if n_out is None else min(n_out, total)
    # y[n] = sum_j x[j] h[half + n*down - j*up]: for each output the taps
    # k = half + n*down - j*up that lie in [0, len(h)).
    base = half + np.arange(n_out, dtype=np.int64) * down
    j_hi = base // up
    taps = -(-len(h) // up) + 1
    j = j_hi[:, None] - np.arange(taps)[None, :]
    k = base[:, None] - j * up
    ok = (k >= 0) & (k < len(h)) & (j >= 0) & (j < len(x))
    vals = np.where(ok, h[np.clip(k, 0, len(h) - 1)] * x[np.clip(j, 0, len(x) - 1)], 0.0)
    return vals.sum(axis=1)


def upload_to_wire(data: bytes) -> np.ndarray:
    """An upload's bytes -> the int16 waveform [1, 48000] the card receives."""
    wav, rate = decode_wav(data)
    if rate != TARGET_RATE:
        wav = resample(wav, rate, TARGET_RATE, TARGET_LEN).astype(np.float32)
    wav = wav[:TARGET_LEN]
    if wav.size < TARGET_LEN:
        wav = np.pad(wav, (0, TARGET_LEN - wav.size))
    return np.clip(wav[None, :] * 32768.0, -32768, 32767).astype(np.int16)
