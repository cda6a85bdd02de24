"""BlazeFace single-shot face detector in PyTorch.

Counterpart of the JAX package's `models/blazeface.py`.  The reference
crops faces with MediaPipe's BlazeFace (`src/utils/face_crop.py:40-148`,
legacy API, `model_selection=1`, `min_detection_confidence=0.5`, first
detection wins); this module is the short-range architecture (128x128
input, 896 SSD anchors over 16x16 + 8x8 feature maps) as an `nn.Module`,
plus MediaPipe's anchor decode and weighted ("blending") non-max
suppression in numpy.

Weights are an `.npz` in the torch OIHW layout of the widely mirrored
PyTorch port of the official tflite weights (state-dict keys
`backbone1.*`, `backbone2.*`, `classifier_8` ...; `convert/blazeface_export.py`
writes it); the module's parameter names are those keys, so
`load_state_dict(strict=True)` takes the file as it is.  The kernel size of
the depthwise convs is read from the weights (3x3 and 5x5 exports load).

Layout: `forward` takes the JAX function's NHWC input (N, 128, 128, 3) in
[-1, 1] and runs NCHW inside.  The convolutions pad as XLA's "SAME" does,
which at stride 2 is asymmetric (the 5x5 stem on 128 px: 1 before, 2
after; a 3x3 depthwise conv: 0 before, 1 after), so the padding is
explicit.  The heads are flattened in NHWC order (row, column, anchor), the
order of `generate_anchors`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

__all__ = [
    "BLAZEFACE_INPUT_SIZE",
    "BLAZEFACE_SPEC",
    "BlazeFace",
    "decode_boxes_np",
    "generate_anchors",
    "load_blazeface",
    "random_blazeface_state_dict",
    "weighted_nms_np",
]

BLAZEFACE_INPUT_SIZE = 128

# (layer index in the torch Sequential, in_channels, out_channels, stride).
# Index 0 is the 5x5 stem conv, index 1 its ReLU; BlazeBlocks start at 2.
_B1_BLOCKS: List[Tuple[int, int, int, int]] = [
    (2, 24, 24, 1),
    (3, 24, 28, 1),
    (4, 28, 32, 2),
    (5, 32, 36, 1),
    (6, 36, 42, 1),
    (7, 42, 48, 2),
    (8, 48, 56, 1),
    (9, 56, 64, 1),
    (10, 64, 72, 1),
    (11, 72, 80, 1),
    (12, 80, 88, 1),
]
_B2_BLOCKS: List[Tuple[int, int, int, int]] = [
    (0, 88, 96, 2),
    (1, 96, 96, 1),
    (2, 96, 96, 1),
    (3, 96, 96, 1),
    (4, 96, 96, 1),
]


def _spec(kernel_size: int = 3) -> Dict[str, Tuple[int, ...]]:
    """Every state-dict key -> shape, with kernel size k for the depthwise
    convs (the public ports use 3)."""
    k = kernel_size
    spec: Dict[str, Tuple[int, ...]] = {
        "backbone1.0.weight": (24, 3, 5, 5),
        "backbone1.0.bias": (24,),
    }
    for idx, cin, cout, _ in _B1_BLOCKS:
        spec[f"backbone1.{idx}.convs.0.weight"] = (cin, 1, k, k)
        spec[f"backbone1.{idx}.convs.0.bias"] = (cin,)
        spec[f"backbone1.{idx}.convs.1.weight"] = (cout, cin, 1, 1)
        spec[f"backbone1.{idx}.convs.1.bias"] = (cout,)
    for idx, cin, cout, _ in _B2_BLOCKS:
        spec[f"backbone2.{idx}.convs.0.weight"] = (cin, 1, k, k)
        spec[f"backbone2.{idx}.convs.0.bias"] = (cin,)
        spec[f"backbone2.{idx}.convs.1.weight"] = (cout, cin, 1, 1)
        spec[f"backbone2.{idx}.convs.1.bias"] = (cout,)
    spec.update(
        {
            "classifier_8.weight": (2, 88, 1, 1),
            "classifier_8.bias": (2,),
            "classifier_16.weight": (6, 96, 1, 1),
            "classifier_16.bias": (6,),
            "regressor_8.weight": (32, 88, 1, 1),
            "regressor_8.bias": (32,),
            "regressor_16.weight": (96, 96, 1, 1),
            "regressor_16.bias": (96,),
        }
    )
    return spec


BLAZEFACE_SPEC = _spec()


def generate_anchors() -> np.ndarray:
    """MediaPipe SSD anchors for the short-range model: (896, 4) rows of
    (x_center, y_center, w, h) in normalized [0,1] coordinates.

    With `fixed_anchor_size=True` every anchor has w = h = 1.0; the SSD
    options (strides [8,16,16,16], aspect_ratios [1.0]) collapse to a 16x16
    grid with 2 anchors per cell followed by an 8x8 grid with 6 per cell.
    """
    rows = []
    for grid, per_cell in ((16, 2), (8, 6)):
        for y in range(grid):
            for x in range(grid):
                cx = (x + 0.5) / grid
                cy = (y + 0.5) / grid
                for _ in range(per_cell):
                    rows.append((cx, cy, 1.0, 1.0))
    return np.asarray(rows, dtype=np.float32)


def _same_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` with XLA's "SAME" padding: ceil(size / stride) outputs, the
    odd pixel of the padding after."""
    k, s = conv.kernel_size[0], conv.stride[0]
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad lists the last dim first
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, pads))


class _BlazeBlock(nn.Module):
    """Depthwise k x k conv, pointwise conv, and the skip: 2x2 max pool at
    stride 2 and zero channels up to the output width; then ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int):
        super().__init__()
        self.stride = stride
        self.convs = nn.Sequential(
            nn.Conv2d(cin, cin, kernel_size, stride, groups=cin),
            nn.Conv2d(cin, cout, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.convs[1](_same_conv(self.convs[0], x))
        skip = F.max_pool2d(x, 2, 2) if self.stride == 2 else x
        pad = h.shape[1] - skip.shape[1]
        if pad > 0:
            skip = F.pad(skip, (0, 0, 0, 0, 0, pad))
        return F.relu(h + skip)


class BlazeFace(nn.Module):
    """Short-range BlazeFace; parameter names are the torch port's keys."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()
        self.backbone1 = nn.Sequential(
            nn.Conv2d(3, 24, 5, 2),
            nn.ReLU(),
            *(_BlazeBlock(cin, cout, kernel_size, s) for _, cin, cout, s in _B1_BLOCKS),
        )
        self.backbone2 = nn.Sequential(
            *(_BlazeBlock(cin, cout, kernel_size, s) for _, cin, cout, s in _B2_BLOCKS)
        )
        self.classifier_8 = nn.Conv2d(88, 2, 1)
        self.classifier_16 = nn.Conv2d(96, 6, 1)
        self.regressor_8 = nn.Conv2d(88, 32, 1)
        self.regressor_16 = nn.Conv2d(96, 96, 1)

    def forward_logits(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (N, 128, 128, 3) in [-1, 1] -> (raw_boxes (N, 896, 16),
        logits (N, 896)): the pre-sigmoid head outputs."""
        h = x.permute(0, 3, 1, 2)
        h = F.relu(_same_conv(self.backbone1[0], h))
        for block in self.backbone1[2:]:
            h = block(h)
        f16 = h  # (N, 88, 16, 16)
        for block in self.backbone2:
            h = block(h)
        f8 = h  # (N, 96, 8, 8)

        def flat(y: torch.Tensor, width: int) -> torch.Tensor:
            # (N, C, H, W) -> (N, H*W*C/width, width) in (row, col, anchor) order
            return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, width)

        n = x.shape[0]
        logits = torch.cat(
            [flat(self.classifier_8(f16), 1), flat(self.classifier_16(f8), 1)], dim=1
        ).reshape(n, -1)
        raw_boxes = torch.cat(
            [flat(self.regressor_8(f16), 16), flat(self.regressor_16(f8), 16)], dim=1
        )
        return raw_boxes, logits

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (N, 128, 128, 3) in [-1, 1] -> (raw_boxes (N, 896, 16), scores
        (N, 896)); scores are sigmoid(clip(logit, +-100)), as MediaPipe's
        tensors-to-detections calculator computes them."""
        raw_boxes, logits = self.forward_logits(x)
        return raw_boxes, torch.sigmoid(torch.clamp(logits, -100.0, 100.0))


def load_blazeface(
    weights: str | Path | Dict[str, np.ndarray], device: str | torch.device = "cpu"
) -> BlazeFace:
    """An `.npz` path or a torch-layout state dict of arrays -> the model on
    `device`, in eval mode (every key and shape checked)."""
    state = dict(np.load(weights)) if isinstance(weights, (str, Path)) else dict(weights)
    kernel = int(np.asarray(state["backbone1.2.convs.0.weight"]).shape[-1])
    model = BlazeFace(kernel)
    model.load_state_dict(
        {k: torch.as_tensor(np.asarray(v, dtype=np.float32)) for k, v in state.items()},
        strict=True,
    )
    return model.to(device).eval()


def decode_boxes_np(
    raw_boxes: np.ndarray, anchors: np.ndarray, scale: float = 128.0
) -> np.ndarray:
    """MediaPipe anchor decode: raw (...,896,16) -> (...,896,4) boxes as
    (ymin, xmin, ymax, xmax) in normalized [0,1] coordinates.

    x/y/w/h scales are all 128 for the short-range model; anchors have
    w = h = 1 so the division reduces to /128 plus the anchor center.
    """
    x_c = raw_boxes[..., 0] / scale * anchors[:, 2] + anchors[:, 0]
    y_c = raw_boxes[..., 1] / scale * anchors[:, 3] + anchors[:, 1]
    w = raw_boxes[..., 2] / scale * anchors[:, 2]
    h = raw_boxes[..., 3] / scale * anchors[:, 3]
    return np.stack(
        [y_c - h / 2.0, x_c - w / 2.0, y_c + h / 2.0, x_c + w / 2.0], axis=-1
    )


def _iou_np(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    y0 = np.maximum(box[0], boxes[:, 0])
    x0 = np.maximum(box[1], boxes[:, 1])
    y1 = np.minimum(box[2], boxes[:, 2])
    x1 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(y1 - y0, 0, None) * np.clip(x1 - x0, 0, None)

    def area(b):
        return np.clip(b[..., 2] - b[..., 0], 0, None) * np.clip(b[..., 3] - b[..., 1], 0, None)

    union = area(box) + area(boxes) - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def weighted_nms_np(
    boxes: np.ndarray,
    scores: np.ndarray,
    min_score: float = 0.5,
    iou_threshold: float = 0.3,
) -> Optional[Tuple[np.ndarray, float]]:
    """MediaPipe's blending NMS, reduced to the single best detection (the
    reference only consumes `detections[0]`): take the highest-scoring
    candidate and average the boxes of all candidates overlapping it with
    IoU >= threshold, weighted by their scores.  Returns (box(y0,x0,y1,x1),
    score) or None when nothing clears `min_score`.
    """
    keep = scores >= min_score
    if not np.any(keep):
        return None
    b, s = boxes[keep], scores[keep]
    top = int(np.argmax(s))
    sel = _iou_np(b[top], b) >= iou_threshold
    sel[top] = True  # a degenerate top box has IoU 0 even with itself
    w = s[sel][:, None]
    blended = (b[sel] * w).sum(axis=0) / w.sum()
    return blended.astype(np.float32), float(s[top])


def random_blazeface_state_dict(seed: int = 0, kernel_size: int = 3) -> Dict[str, np.ndarray]:
    """Correctly-shaped random torch-layout state dict (tests, smoke runs)."""
    rng = np.random.default_rng(seed)
    return {
        k: rng.normal(0.0, 0.05, size=shape).astype(np.float32)
        for k, shape in _spec(kernel_size).items()
    }
