"""Throughput of the flagship cross-attention forward: 3-second clips a minute.

Counterpart of the JAX package's `bench.py::measure` and `run_single`: raw
waveform in (through WavLM, or through the log-mel front end on the device
inside the timed forward), 8 frames of 112 x 112 through ResNet18,
bidirectional cross-attention fusion, float32 softmax.  The model is built by
`build_model` on the card with random weights from a seed; the time is CUDA
events around `iters` forwards queued after a warm-up, best of 3.

    python -m multimodalemotionrecognition_torch.bench.forward

Env knobs: BENCH_BATCH (default 128), BENCH_WAVLM (default 1), BENCH_DTYPE
(bfloat16|float32, default bfloat16), BENCH_ITERS (default 40).  Prints one
JSON line.  Runs on the card; raises without one.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from multimodalemotionrecognition_torch.bench import card_line, events_ms, require_device
from multimodalemotionrecognition_torch.config import ModelConfig
from multimodalemotionrecognition_torch.models.factory import build_model
from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_step(
    batch: int, use_wavlm: bool, dtype: str, device="cuda", *,
    frames: int = 8, frame_size: int = 112, samples: int = 48000, **config_overrides,
):
    """The measured forward as a closure -> step() gives the probabilities
    [batch, 8] in float32.  Model (random weights from seed 0) and inputs
    (numpy `RandomState(0)`) are the same on every call, so two steps built
    with different `config_overrides` can be compared.  The keyword sizes
    and config overrides are for a rehearsal at small widths on the CPU."""
    device = require_device(device, "bench.forward")
    config = ModelConfig(**{**dict(
        fusion="xattn",
        use_wavlm=use_wavlm,
        num_classes=8,
        xattn_attn_dropout=0.0,
        xattn_stochastic_depth=0.0,
        compute_dtype=dtype,
        spec_augment=False,
    ), **config_overrides})
    model = build_model(config, device=device).to(_DTYPES[dtype])
    if use_wavlm:
        model.audio_model.wavlm.cache_kernel_operands()  # constant weights, as in serving

    rng = np.random.RandomState(0)
    video = torch.from_numpy(
        rng.randn(batch, frames, 3, frame_size, frame_size).astype(np.float32)
    ).to(device, _DTYPES[dtype])
    audio = torch.from_numpy(
        rng.randn(batch, 1, samples).astype(np.float32) * np.float32(0.1)
    ).to(device)

    @torch.no_grad()
    def step():
        if use_wavlm:
            a = audio.to(_DTYPES[dtype])
        else:
            a = log_mel_spectrogram(audio[:, 0, :])[:, None, :, :].to(_DTYPES[dtype])
        return torch.softmax(model(video, a).float(), dim=1)

    return step


def measure(
    batch: int, use_wavlm: bool, dtype: str, iters: int, device="cuda", **sizes
) -> float:
    """Per-forward time at one batch size -> clips/min."""
    device = require_device(device, "bench.forward")
    step = make_step(batch, use_wavlm, dtype, device, **sizes)
    probs = step()  # warm-up: kernel build, cuDNN's algorithm choice
    if probs.shape != (batch, 8) or not torch.isfinite(probs).all():
        raise AssertionError(f"bad forward output {tuple(probs.shape)}")
    events_ms(step, 2, device)
    ms = min(events_ms(step, iters, device) for _ in range(3))
    return batch / ms * 60e3


def run_single(device="cuda", **sizes) -> dict:
    """One measurement at BENCH_BATCH; prints and returns the JSON line."""
    batch = int(os.environ.get("BENCH_BATCH", "128"))
    use_wavlm = os.environ.get("BENCH_WAVLM", "1") == "1"
    dtype = os.environ.get("BENCH_DTYPE", "bfloat16")
    iters = int(os.environ.get("BENCH_ITERS", "40"))
    if dtype not in _DTYPES:
        raise ValueError(f"BENCH_DTYPE={dtype!r} not in {sorted(_DTYPES)}")

    device = require_device(device, "bench.forward")
    clips_per_min = measure(batch, use_wavlm, dtype, iters, device, **sizes)
    report = {
        "metric": f"torch_xattn{'_wavlm' if use_wavlm else ''}_fwd_throughput_b{batch}_{dtype}",
        "value": round(clips_per_min, 1),
        "unit": "3s_clips_per_min",
        "method": "cuda_events_min3" if device.type == "cuda" else "host_clock_min3",
        "card": card_line(device),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    run_single()
