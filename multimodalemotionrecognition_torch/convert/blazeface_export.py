"""Export BlazeFace weights to the `.npz` read by `data/face.py`.

Counterpart of the JAX package's `convert/blazeface_export.py`.  The
reference gets its face detector from MediaPipe (`src/utils/face_crop.py:40-148`);
here the detector is `models/blazeface.py` and the weights are a deploy-time
asset.  This converter takes the widely mirrored PyTorch port of the
official short-range tflite weights (state-dict keys `backbone1.0.weight`,
`backbone1.2.convs.0.weight`, `classifier_8.*` ...) and writes a validated
`.npz` in the same torch OIHW layout, which `BlazeFace.load_state_dict`
takes as it is.

Usage:
    python -m multimodalemotionrecognition_torch.convert.blazeface_export \\
        blazeface.pth blazeface.npz
    EMO_BLAZEFACE_WEIGHTS=blazeface.npz python -m multimodalemotionrecognition_torch serve-direct
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from multimodalemotionrecognition_torch.models.blazeface import _spec

__all__ = ["export_blazeface", "main", "validate_blazeface_state_dict"]


def validate_blazeface_state_dict(state_dict: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Check the key set and shapes against the architecture table; returns
    float32 numpy arrays.  Raises ValueError with the full diff on mismatch."""
    arrays = {k: np.asarray(v, dtype=np.float32) for k, v in state_dict.items()}
    kernel = 3
    dw = arrays.get("backbone1.2.convs.0.weight")
    if dw is not None and dw.ndim == 4:
        kernel = int(dw.shape[-1])
    spec = _spec(kernel)
    missing = sorted(set(spec) - set(arrays))
    extra = sorted(set(arrays) - set(spec))
    bad = [
        f"{k}: got {arrays[k].shape}, want {spec[k]}"
        for k in spec
        if k in arrays and tuple(arrays[k].shape) != spec[k]
    ]
    if missing or extra or bad:
        raise ValueError(
            "state dict does not match the BlazeFace short-range layout:\n"
            + "\n".join(
                ["missing: " + ", ".join(missing)] * bool(missing)
                + ["unexpected: " + ", ".join(extra)] * bool(extra)
                + bad
            )
        )
    return arrays


def export_blazeface(src: str | Path, dst: str | Path) -> Path:
    """`.pth` / `.pt` (a state dict or a module) or `.npz` -> validated `.npz`."""
    src, dst = Path(src), Path(dst)
    if src.suffix == ".npz":
        state = dict(np.load(src))
    else:
        import torch

        loaded = torch.load(src, map_location="cpu", weights_only=True)
        if hasattr(loaded, "state_dict"):
            loaded = loaded.state_dict()
        state = {k: v.numpy() for k, v in loaded.items()}
    arrays = validate_blazeface_state_dict(state)
    dst.parent.mkdir(parents=True, exist_ok=True)
    np.savez(dst, **arrays)
    return dst


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="blazeface-export", description=__doc__)
    p.add_argument("src", help=".pth state dict (torch port) or .npz")
    p.add_argument("dst", help="output .npz path")
    args = p.parse_args(argv)
    out = export_blazeface(args.src, args.dst)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
