"""Synthetic convergence regression gate of the port.

The counterpart of the JAX package's `tools/convergence_gate.py`, with its
protocol and flags: the gated fusion model trained end to end (decode ->
augment -> train) on a generated strong-signal RAVDESS-style corpus with a
FIXED seed, asserting that the actor-held-out test accuracy reaches the
target.  A silent training-quality regression (optimizer, augmentation,
data pipeline, model) shows up as a miss.

Corpus: 8 actors x 8 emotions x 4 clips = 256 pairs of 1 s at 10 fps
(`data/synthetic.py` with `strong_signal=True`, seed 7, `signal_strength`
0.4 by default).  Train actors 1-6, val 7, test 8; 12 epochs, batch 16, 4
frames of 64 px, no face crop, no early stopping, seed 42; `pairs.csv` and
the checkpoints land inside the corpus root.  The report carries margin
metrics that move before pass/fail does: the mean test top-1 softmax margin
(p1 - p2), val F1 at epoch 3, and the first epoch to reach 0.8 val
accuracy.  The video wire is the CLI's `auto`: uint8 on the card, float32
on the CPU.  The run uses PyTorch's deterministic algorithms (cuDNN's
included), so that the fixed seed fixes the reading on the card as it does
on the CPU; the previous settings come back afterwards.

Usage: python -m multimodalemotionrecognition_torch.bench.convergence_gate \\
         [--epochs 12] [--target 0.70] [--signal_strength 0.4] [--device cpu] [--root DIR]
Prints one JSON line; exit code 1 below the target.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["build_arg_parser", "deterministic_algorithms", "gate", "main", "write_corpus"]


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="convergence_gate")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--target", type=float, default=0.70)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--img_size", type=int, default=64)
    ap.add_argument("--device", choices=["default", "cpu"], default="default",
                    help="default: the card")
    ap.add_argument("--root", default="", help="reuse an existing corpus dir")
    ap.add_argument("--fusion", default="gated")
    ap.add_argument(
        "--signal_strength",
        type=float,
        default=0.4,
        help="corpus separability in [0,1]; 1.0 = a corpus every healthy run "
        "saturates; the JAX package's calibration read 0.8125 test accuracy "
        "at 0.4 (benchmarks/gate_r05_calibration.json)",
    )
    return ap


def write_corpus(root: Path | str, signal_strength: float) -> int:
    """The gate's corpus under `root`; -> the number of pairs (256)."""
    from multimodalemotionrecognition_torch.data.synthetic import generate_synthetic_ravdess

    return generate_synthetic_ravdess(
        root,
        actors=range(1, 9),
        emotions=range(1, 9),
        seconds=1.0,
        fps=10,
        seed=7,
        clips_per_pair=4,
        strong_signal=True,
        signal_strength=signal_strength,
    )


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms and cuDNN's deterministic, untimed
    choice of convolution while the block is open; an op without a
    deterministic implementation warns.  Restores the previous settings."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:]


def gate(argv=None) -> dict:
    """Run the gate; prints and returns its JSON report."""
    args = build_arg_parser().parse_args(argv)
    with deterministic_algorithms():
        return _gate(args)


def _gate(args) -> dict:
    from multimodalemotionrecognition_torch.data.pipeline import build_loaders
    from multimodalemotionrecognition_torch.train.cli import (
        build_arg_parser as cli_parser,
        configs_from_args,
        resolve_video_wire,
    )
    from multimodalemotionrecognition_torch.train.trainer import EmotionTrainer
    from multimodalemotionrecognition_torch.utils.device import require_device

    device = require_device("cpu" if args.device == "cpu" else "cuda", "convergence_gate")
    if args.root:
        root = Path(args.root)
        root.mkdir(parents=True, exist_ok=True)
    else:
        root = Path(tempfile.mkdtemp(prefix="convergence_gate_"))
    if not any(root.rglob("*.mp4")):
        t0 = time.time()
        n = write_corpus(root, args.signal_strength)
        print(f"[gate] wrote {n} pairs (s={args.signal_strength}) in "
              f"{time.time() - t0:.1f}s at {root}")

    out_dir = root / "outputs"
    cli = cli_parser().parse_args(
        [
            "--data_root", str(root),
            "--fusion", args.fusion,
            "--epochs", str(args.epochs),
            "--batch_size", str(args.batch_size),
            "--frames", str(args.frames),
            "--img_size", str(args.img_size),
            "--split_mode", "actor",
            "--train_actors", "1,2,3,4,5,6",
            "--val_actors", "7",
            "--test_actors", "8",
            "--early_stopping_patience", "0",
            "--seed", "42",
            "--output_dir", str(out_dir),
            "--no_face_crop",
        ]
    )
    model_cfg, train_cfg, data_cfg = configs_from_args(cli)
    wire = resolve_video_wire(train_cfg.video_wire, device)

    cwd = os.getcwd()
    os.chdir(root)  # pairs.csv lands here, not in the repo
    try:
        train_loader, val_loader, test_loader = build_loaders(
            data_cfg, args.batch_size, wire=wire
        )
        print(f"[gate] train {train_loader.num_samples} / val {val_loader.num_samples} / "
              f"test {test_loader.num_samples} ({wire} video wire)")
        trainer = EmotionTrainer(model_cfg, train_cfg, device=device)
        t0 = time.time()
        state, result = trainer.fit(train_loader, val_loader, test_loader)
        train_s = time.time() - t0
    finally:
        os.chdir(cwd)

    test_acc = float(result["test"]["acc"])
    test_f1 = float(result["test"]["f1"])
    ok = test_acc >= args.target

    # ---- continuous resolution metrics (move before pass/fail does) ----
    @torch.no_grad()
    def _probs(video, audio_wav, aug):
        v = trainer._device_video(video, aug, None)
        out, _ = trainer._apply(v, trainer._audio_features(audio_wav), False, None)
        if args.fusion == "late":
            # Late fusion already returns probabilities: a second softmax
            # would compress the margins toward uniform.
            return out
        return torch.softmax(out, dim=-1)

    margins = []
    for batch in test_loader:
        aug = None if batch.aug is None else torch.from_numpy(batch.aug).to(device)
        p = _probs(torch.from_numpy(batch.video).to(device),
                   torch.from_numpy(batch.audio).to(device), aug).cpu().numpy()[batch.valid]
        top2 = np.sort(p, axis=1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
    mean_margin = float(np.concatenate(margins).mean()) if margins else None

    history = result["history"]
    val_f1_at_3 = round(float(history[2]["val/f1"]), 4) if len(history) >= 3 else None
    epochs_to_08 = next((row["epoch"] for row in history if row["val/acc"] >= 0.8), None)

    report = {
        "metric": "synthetic_convergence_gate",
        "value": round(test_acc, 4),
        "unit": "actor_heldout_test_acc",
        "target": args.target,
        "pass": ok,
        "signal_strength": args.signal_strength,
        "test_f1": round(test_f1, 4),
        "best_val_f1": round(float(result["best_val_f1"]), 4),
        "mean_top1_margin": round(mean_margin, 4) if mean_margin is not None else None,
        "val_f1_at_epoch3": val_f1_at_3,
        "epochs_to_val_acc_0.8": epochs_to_08,
        "epochs": args.epochs,
        "fusion": args.fusion,
        "train_seconds": round(train_s, 1),
        "backend": device.type,
    }
    print(json.dumps(report))
    return report


def main(argv=None) -> None:
    sys.exit(0 if gate(argv)["pass"] else 1)


if __name__ == "__main__":
    main()
