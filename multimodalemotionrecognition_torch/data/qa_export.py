"""Augmented-sample QA exporter (reference
`src/export_augmented_examples.py:178-271`).

The port's copy of the JAX package's `data/qa_export.py`, on the port's
media decode (`data/media.py`: video through the native libav loader when
it is available, cv2 otherwise) and RAVDESS pairing.

Exports human-inspectable artifacts of the training augmentations: the
augmented frames as PNGs (or an .mp4 when OpenCV has an encoder), the
noise-mixed waveform as a WAV, and a meta JSON describing the sample.  Also
supports the reference's "visual mode": high-res degradation preview
(downsample 2/3 + upsample + noise + brightness) for eyeballing the low-light
augmentation at native resolution.

Usage:
  python -m multimodalemotionrecognition_torch qa-export \
      --data_root data --out qa_out [--visual]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from multimodalemotionrecognition_torch.data.media import (
    augment_video_frames,
    load_audio_wav,
    load_noise_bank,
    load_video_frames,
)
from multimodalemotionrecognition_torch.data.ravdess import build_pairs
from multimodalemotionrecognition_torch.data.synthetic import _write_wav

__all__ = ["export_augmented_example", "main"]


def _visual_degrade(frames01: np.ndarray, rng=None) -> np.ndarray:
    """Hi-res degradation preview (reference `_load_video_frames_visual`,
    `src/export_augmented_examples.py:76-130`): 2/3 downsample -> upsample,
    noise, brightness drop."""
    import cv2

    r = rng or np.random
    factor = float(r.uniform(0.2, 0.6))
    out = np.empty_like(frames01)
    for i, f in enumerate(frames01):
        h, w = f.shape[:2]
        small = cv2.resize(f, (max(1, w * 2 // 3), max(1, h * 2 // 3)))
        up = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
        noisy = up * factor + r.normal(0, 0.003, up.shape).astype(np.float32)
        out[i] = np.clip(noisy, 0.0, 1.0)
    return out


def export_augmented_example(
    data_root: str,
    out_dir: str,
    index: int = 0,
    visual: bool = False,
    seed: int = 0,
) -> Path:
    import cv2

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    pairs = build_pairs(data_root)
    if not pairs:
        raise RuntimeError(f"No pairs found under {data_root}")
    pair = pairs[index % len(pairs)]
    rng = np.random.RandomState(seed)

    # Frames without normalization so they are viewable; augment explicitly.
    frames = load_video_frames(
        pair.video_path, augment=False, use_face_crop=True, normalize=False
    )  # [T, 3, H, W]
    frames01 = frames.transpose(0, 2, 3, 1)
    aug = (
        _visual_degrade(frames01, rng=rng)
        if visual
        else augment_video_frames(frames01, rng=rng)
    )
    for i, f in enumerate(aug):
        cv2.imwrite(
            str(out / f"frame_{i:02d}.png"),
            cv2.cvtColor((f * 255).astype(np.uint8), cv2.COLOR_RGB2BGR),
        )

    noise = load_noise_bank()
    wav = load_audio_wav(pair.audio_path, augment=True, noise_bank=noise, rng=rng)
    _write_wav(out / "audio_augmented.wav", wav[0], 16000)

    meta = {
        "video_path": str(pair.video_path),
        "audio_path": str(pair.audio_path),
        "emotion": pair.emotion,
        "intensity": pair.intensity,
        "actor": pair.actor,
        "visual_mode": visual,
        "seed": seed,
        "noise_bank_available": noise is not None,
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=2), encoding="utf-8")
    print(f"[qa_export] wrote {len(aug)} frames + audio + meta to {out}")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="qa-export")
    p.add_argument("--data_root", required=True)
    p.add_argument("--out", default="qa_out")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--visual", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    export_augmented_example(
        args.data_root, args.out, index=args.index, visual=args.visual, seed=args.seed
    )


if __name__ == "__main__":
    main()
