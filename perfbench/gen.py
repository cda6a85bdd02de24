"""The one traffic generator: everything a cell sends, made from its traffic
file's parameters and the run's seed.

Every seed makes the same sizes and arrivals: the uploads cycle through the
mix's kinds in turn, the Poisson arrivals are one fixed schedule at the
rate (the exponential distribution's quantiles at a fixed count, in one
fixed shuffled order), and the train batches have fixed shapes.  The
contents (noise, pixels, labels, augmentation parameters) change with the
seed.
"""

from __future__ import annotations

import struct

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def wav_bytes(pcm: np.ndarray, rate: int) -> bytes:
    """16-bit mono PCM -> RIFF/WAVE bytes."""
    data = np.asarray(pcm, dtype="<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, rate, rate * 2, 2, 16)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", len(body)) + body


def uploads(params: dict, seed: int) -> list:
    """`params["pool"]` distinct `.wav` uploads of noise at `params["level"]`
    (int16 units), the kinds `params["kinds"]` ([rate, seconds] each) in turn
    -> [(filename, bytes)]."""
    g = rng(seed, 1)
    kinds = params["kinds"]
    out = []
    for i in range(params["pool"]):
        rate, seconds = kinds[i % len(kinds)]
        pcm = np.clip(g.standard_normal(int(rate * seconds)) * params["level"], -32768, 32767)
        out.append((f"clip{i}_{rate}.wav", wav_bytes(pcm.astype(np.int16), int(rate))))
    return out


def poisson_offsets(rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson stream of `rate`
    per second over `seconds`: the N = rate * seconds gaps are the
    exponential quantiles (i + 0.5) / N, in one fixed random order."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return np.cumsum(rng(0, 2).permutation(gaps))


class Batch:
    """A host batch as the trainer's loaders make them."""

    def __init__(self, video, audio, labels, aug):
        self.video, self.audio, self.labels, self.aug = video, audio, labels, aug
        self.valid = np.ones(len(labels), bool)
        self.size = len(labels)


def train_batches(params: dict, seed: int) -> list:
    """`params["pool"]` batches of `params["batch"]` clips: uint8 video
    [B, frames, 3, size, size], float32 audio [B, 1, samples] (noise at
    `audio_level`), int64 labels over `classes`, and augmentation rows
    (brightness factor in [0.8, 1.2], noise sigma in [0, 0.03])."""
    g = rng(seed, 3)
    b, frames, size = params["batch"], params["frames"], params["size"]
    out = []
    for _ in range(params["pool"]):
        aug = np.stack([g.uniform(0.8, 1.2, b), g.uniform(0.0, 0.03, b)], axis=1)
        out.append(Batch(
            g.integers(0, 256, (b, frames, 3, size, size), dtype=np.uint8),
            (g.standard_normal((b, 1, params["samples"])) * params["audio_level"]).astype(
                np.float32),
            g.integers(0, params["classes"], b).astype(np.int64),
            aug.astype(np.float32),
        ))
    return out
