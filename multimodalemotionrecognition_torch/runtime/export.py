"""Model export (reference `src/export_optimized_model.py:26-104`).

Counterpart of the JAX package's `runtime/export.py`, which serialises the
jitted forward as StableHLO.  Here the runner's forward (`ProbsForward`:
cast, model, softmax) is traced by `torch.export` once per batch bucket,
with the weights inside, and each `ExportedProgram` is saved with
`torch.export.save`.  The container is the JAX package's: an `.npz` of
byte arrays keyed by batch size, `<output>.npz`, beside the sidecar
`<output>.npz.meta.json` with the same keys ({fusion, num_classes,
use_wavlm, labels, ...}), `"format": "torch.export"` and one more key,
`"device"`: the program holds its weights on the device it was exported
on, and runs there only.

The hand-written kernels on the path, K1 (`torch.ops.emo.wavlm_attention_sublayer`)
and K3 (`torch.ops.emo.fused_conv_layer`), are registered operators: the
graph records each as one node, and a loaded program launches them.  So
loading imports the port's kernel modules before `torch.export.load`.  The
K4 fusion block has no operator and the export no `fused` option (nor has
the JAX export).

No fallback: exporting for the card, or loading an artifact made there,
raises without one; a kernel that does not build raises.

Usage:
  python -m multimodalemotionrecognition_torch export \\
      --checkpoint outputs/best_xattn.pt --output exports/best_xattn [--int8] [--batch-sizes 1,8]
"""

from __future__ import annotations

import argparse
import io
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from multimodalemotionrecognition_torch.utils.device import require_device

__all__ = ["ExportedRunner", "export_program", "kernel_nodes", "load_exported", "main"]

# The operators of the hand-written kernels an exported graph may hold.
KERNEL_OPS = ("emo.wavlm_attention_sublayer", "emo.fused_conv_layer")


def kernel_nodes(program) -> Dict[str, int]:
    """Count of each kernel operator's nodes in an `ExportedProgram`'s graph."""
    counts = dict.fromkeys(KERNEL_OPS, 0)
    for node in program.graph.nodes:
        if node.op == "call_function" and hasattr(node.target, "name"):
            name = node.target.name().replace("::", ".").split(".default")[0]
            if name in counts:
                counts[name] += 1
    return counts


def export_program(
    checkpoint_path: str | Path,
    output_path: str | Path,
    batch_sizes: Sequence[int] = (1, 8),
    quantize_int8: bool = False,
    num_classes: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> Path:
    """Export the checkpoint's forward per batch bucket -> the `.npz` path
    (the meta sidecar beside it)."""
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

    device = require_device(device, "export_program")
    runner = TorchModelRunner(
        checkpoint_path, num_classes=num_classes, quantize_int8=quantize_int8, device=device
    )
    # No gradient is recorded: the kernels' operators are called directly,
    # not through the training `autograd.Function`.
    module = runner.forward_module.eval().requires_grad_(False)
    artifacts = {}
    for b in batch_sizes:
        inputs = tuple(torch.from_numpy(a).to(device) for a in runner._example_inputs(b))
        program = torch.export.export(module, inputs)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        artifacts[str(b)] = buf.getvalue()

    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **{k: np.frombuffer(v, dtype=np.uint8) for k, v in artifacts.items()})
    final = out if out.suffix == ".npz" else Path(str(out) + ".npz")

    meta = {
        "format": "torch.export",
        "fusion": runner.fusion_mode,
        "num_classes": runner.num_classes,
        "use_wavlm": runner.use_wavlm,
        "labels": runner.labels,
        "batch_sizes": list(batch_sizes),
        "quantized_int8": quantize_int8,
        "input_layout": {
            "video": "[B, T=8, 3, 112, 112] float32 (ImageNet-normalized)",
            "audio": "[B, 1, 48000] float32"
            if runner.use_wavlm
            else f"[B, 1, {runner.model_config.audio_n_mels}, 301] float32 (log-mel dB)",
        },
        "output": "[B, num_classes] probabilities",
        "device": device.type,
    }
    meta_path = Path(str(final) + ".meta.json")
    meta_path.write_text(json.dumps(meta, indent=2), encoding="utf-8")
    print(f"[export] wrote {final} + {meta_path}")
    return final


class ExportedRunner:
    """Load and run an export (OnnxModelRunner analog,
    `src/optimized_runtime.py:111-143`) on the device it was exported on."""

    def __init__(self, path: str | Path):
        # The graph calls the kernels' operators: register them first.
        import multimodalemotionrecognition_torch.kernels  # noqa: F401

        p = Path(path)
        if p.suffix != ".npz":
            p = Path(str(p) + ".npz")
        meta_path = Path(str(p) + ".meta.json")
        if not p.exists():
            raise FileNotFoundError(f"Export not found: {p}")
        if not meta_path.exists():
            raise FileNotFoundError(f"Export metadata file not found: {meta_path}")
        self.meta = json.loads(meta_path.read_text(encoding="utf-8"))
        self.fusion_mode = str(self.meta["fusion"])
        self.num_classes = int(self.meta["num_classes"])
        self.labels = list(self.meta["labels"])
        self.device = require_device(self.meta["device"], "ExportedRunner")
        data = np.load(p)
        self.programs = {
            int(k): torch.export.load(io.BytesIO(data[k].tobytes())) for k in data.files
        }
        self._fns = {b: program.module() for b, program in self.programs.items()}
        self._buckets = sorted(self._fns)

    def predict_probs(self, videos: np.ndarray, audios: np.ndarray) -> np.ndarray:
        n = len(videos)
        max_bucket = self._buckets[-1]
        if n > max_bucket:
            # Chunk oversized requests through the largest exported bucket
            # (the reference's ONNX path has a dynamic batch axis, so it
            # never truncates, `src/optimized_runtime.py:133-143`).
            outs = [
                self.predict_probs(videos[i : i + max_bucket], audios[i : i + max_bucket])
                for i in range(0, n, max_bucket)
            ]
            return np.concatenate(outs, axis=0)
        bucket = next(b for b in self._buckets if b >= n)
        videos = np.asarray(videos, np.float32)
        audios = np.asarray(audios, np.float32)
        pad = bucket - n
        if pad > 0:
            videos = np.concatenate([videos, np.zeros((pad,) + videos.shape[1:], np.float32)])
            audios = np.concatenate([audios, np.zeros((pad,) + audios.shape[1:], np.float32)])
        with torch.inference_mode():
            out = self._fns[bucket](self._put(videos), self._put(audios))
            return out.cpu().numpy()[:n]

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor, through pinned memory on a card (as
        `TorchModelRunner` stages a batch)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t


def load_exported(path: str | Path) -> ExportedRunner:
    return ExportedRunner(path)


def main(argv=None, device: str = "cuda") -> Path:
    """Export from the command line on `device` (the card unless the caller
    passes "cpu")."""
    p = argparse.ArgumentParser(prog="export")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--batch-sizes", default="1,8")
    p.add_argument("--num_classes", type=int, default=None)
    args = p.parse_args(argv)
    return export_program(
        args.checkpoint,
        args.output,
        batch_sizes=[int(x) for x in args.batch_sizes.split(",")],
        quantize_int8=args.int8,
        num_classes=args.num_classes,
        device=device,
    )


if __name__ == "__main__":
    main()
