"""Face detection and cropping for the serving path.

Counterpart of the JAX package's `data/face.py`.  The reference uses
MediaPipe's BlazeFace (`src/utils/face_crop.py:40-148`) with crop semantics:
detect a pixel bbox on the FIRST sampled frame only, reuse it for the rest,
crop with 30% symmetric padding clipped to the image (`crop_with_padding`,
`:151-184`), and fall back to the full frame when detection finds nothing.

Detectors:

  * `HeuristicFaceDetector` - dependency-free skin-segmentation detector
    (YCrCb chroma gate + box smoothing + trimmed bbox); the default.
  * `HaarFaceDetector` - OpenCV's real-face-trained frontal cascade
    (`EMO_FACE_DETECTOR=haar`), through `cv2.CascadeClassifier` where the
    binding has it, else the numpy evaluator of `data/haar.py`.

The learned BlazeFace detector (`EMO_FACE_DETECTOR=blazeface`,
`EMO_BLAZEFACE_WEIGHTS`) is not ported yet (ROADMAP queue 1, item 8): asking
for it raises `NotImplementedError` instead of serving another detector.  A
`haar` request with no cascade file raises too (the JAX package takes the
heuristic then).
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Optional, Protocol, Tuple
from xml.etree.ElementTree import ParseError as ET_ParseError

import numpy as np

__all__ = [
    "FaceDetector",
    "HaarFaceDetector",
    "HeuristicFaceDetector",
    "crop_with_padding",
    "padded_crop_rect",
    "get_face_detector",
    "set_face_detector",
]

Bbox = Tuple[int, int, int, int]  # x, y, w, h in pixels


class FaceDetector(Protocol):
    def detect_face_bbox(self, image_rgb: np.ndarray) -> Optional[Bbox]: ...


def padded_crop_rect(
    image_hw: Tuple[int, int], bbox: Bbox, pad_ratio: float = 0.3
) -> Optional[Tuple[int, int, int, int]]:
    """(x, y, w, h) of the padded crop, clipped to the image.  None when the
    rect degenerates (the caller keeps the full frame)."""
    h, w = image_hw
    x, y, bw, bh = bbox
    pad_x = int(bw * pad_ratio)
    pad_y = int(bh * pad_ratio)
    x0 = max(0, x - pad_x)
    y0 = max(0, y - pad_y)
    x1 = min(w, x + bw + pad_x)
    y1 = min(h, y + bh + pad_y)
    if x1 <= x0 or y1 <= y0:
        return None
    return (x0, y0, x1 - x0, y1 - y0)


def crop_with_padding(image: np.ndarray, bbox: Bbox, pad_ratio: float = 0.3) -> np.ndarray:
    """Crop bbox with symmetric padding, clipped to the image
    (reference `src/utils/face_crop.py:151-184`)."""
    rect = padded_crop_rect(image.shape[:2], bbox, pad_ratio)
    if rect is None:
        return image
    x0, y0, rw, rh = rect
    return image[y0 : y0 + rh, x0 : x0 + rw]


def _as_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    return np.clip(img * 255.0 if img.max() <= 1.5 else img, 0, 255).astype(np.uint8)


class HeuristicFaceDetector:
    """Skin-chroma face localizer (no learned weights required).

    Gate pixels by YCrCb chroma (the classic Cr in [133,173], Cb in [77,127]
    skin band), box-blur the mask to suppress speckle, then take the tight
    bounding box of the dominant mass.  Returns None when too little skin is
    visible: callers keep the full frame, like the reference does on
    MediaPipe failure (`src/data/ravdess.py:337-339`).
    """

    def __init__(self, min_coverage: float = 0.005, mask_threshold: float = 0.35):
        self.min_coverage = min_coverage
        self.mask_threshold = mask_threshold

    @staticmethod
    def _rgb_to_crcb(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        r = img[..., 0].astype(np.float32)
        g = img[..., 1].astype(np.float32)
        b = img[..., 2].astype(np.float32)
        cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
        cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
        return cr, cb

    @staticmethod
    def _box_blur(mask: np.ndarray, k: int = 15) -> np.ndarray:
        # separable box filter via cumulative sums
        pad = k // 2
        padded = np.pad(mask, ((pad, pad + 1), (0, 0)), mode="edge")
        c = np.cumsum(padded, axis=0)
        out = (c[k:] - c[:-k]) / k
        padded = np.pad(out, ((0, 0), (pad, pad + 1)), mode="edge")
        c = np.cumsum(padded, axis=1)
        return (c[:, k:] - c[:, :-k]) / k

    def detect_face_bbox(self, image_rgb: np.ndarray) -> Optional[Bbox]:
        if image_rgb.ndim != 3 or image_rgb.shape[-1] != 3:
            return None
        cr, cb = self._rgb_to_crcb(_as_uint8(image_rgb))
        mask = ((cr >= 133) & (cr <= 173) & (cb >= 77) & (cb <= 127)).astype(np.float32)
        if mask.mean() < self.min_coverage:
            return None
        strong = self._box_blur(mask) >= self.mask_threshold
        if not strong.any():
            return None
        ys, xs = np.nonzero(strong)
        # Robust bbox: trim 2% tails so stray skin-toned pixels don't inflate it.
        y0, y1 = np.percentile(ys, [2, 98]).astype(int)
        x0, x1 = np.percentile(xs, [2, 98]).astype(int)
        w, h = int(x1 - x0 + 1), int(y1 - y0 + 1)
        if w < 8 or h < 8:
            return None
        return (int(x0), int(y0), w, h)


class HaarFaceDetector:
    """Haar-cascade frontal-face detector over OpenCV's real-face weights.

    Runs through `cv2.CascadeClassifier` when the binding exists; OpenCV 5.x
    removed it from Python, so the other engine is the numpy Viola-Jones
    evaluator (`data/haar.py`) reading the same XML weights."""

    def __init__(self, cascade_path: Optional[str] = None, min_neighbors: int = 3):
        from multimodalemotionrecognition_torch.data.haar import find_cascade_xml

        self.min_neighbors = min_neighbors
        path = Path(cascade_path) if cascade_path else find_cascade_xml()
        self._cv2_cascade = None
        self._np_cascade = None
        if path is None or not Path(path).exists():
            return
        import cv2

        if hasattr(cv2, "CascadeClassifier"):
            cascade = cv2.CascadeClassifier(str(path))
            if not cascade.empty():
                self._cv2_cascade = cascade
                return
        from multimodalemotionrecognition_torch.data.haar import HaarCascade

        try:
            self._np_cascade = HaarCascade(path)
        except (ValueError, ET_ParseError):
            self._np_cascade = None

    @property
    def available(self) -> bool:
        return self._cv2_cascade is not None or self._np_cascade is not None

    def detect_face_bbox(self, image_rgb: np.ndarray) -> Optional[Bbox]:
        if not self.available:
            return None
        if image_rgb.ndim != 3 or image_rgb.shape[-1] != 3:
            return None
        img = _as_uint8(image_rgb)
        # ITU-R BT.601 luma, matching cv2.COLOR_RGB2GRAY.
        gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).astype(np.uint8)
        if self._cv2_cascade is not None:
            faces = self._cv2_cascade.detectMultiScale(
                gray, scaleFactor=1.1, minNeighbors=self.min_neighbors, minSize=(24, 24)
            )
            faces = [tuple(int(v) for v in f) for f in faces]
        else:
            faces = self._np_cascade.detect_multi_scale(
                gray, scale_factor=1.1, min_neighbors=self.min_neighbors, min_size=24
            )
        if not len(faces):
            return None
        # Largest face, like the reference's top detection.
        x, y, w, h = max(faces, key=lambda f: f[2] * f[3])
        return (int(x), int(y), int(w), int(h))


_detector_lock = threading.Lock()
_detector: Optional[FaceDetector] = None
_detector_initialized = False


def _detector_from_env() -> FaceDetector:
    family = os.environ.get("EMO_FACE_DETECTOR", "")
    if family == "blazeface" or os.environ.get("EMO_BLAZEFACE_WEIGHTS", ""):
        raise NotImplementedError(
            "the BlazeFace detector (EMO_FACE_DETECTOR=blazeface, EMO_BLAZEFACE_WEIGHTS) is not "
            "ported yet (ROADMAP queue 1, item 8); use EMO_FACE_DETECTOR=heuristic or haar"
        )
    if family == "haar":
        haar = HaarFaceDetector()
        if not haar.available:
            raise RuntimeError("EMO_FACE_DETECTOR=haar: no Haar cascade XML was found")
        return haar
    return HeuristicFaceDetector()


def get_face_detector() -> Optional[FaceDetector]:
    """Process-wide detector, made once (lock-guarded) from the environment:
    `EMO_FACE_DETECTOR=haar` selects the Haar cascade, anything else but
    `blazeface` the heuristic."""
    global _detector, _detector_initialized
    with _detector_lock:
        if not _detector_initialized:
            _detector = _detector_from_env()
            _detector_initialized = True
        return _detector


def set_face_detector(detector: Optional[FaceDetector]) -> None:
    global _detector, _detector_initialized
    with _detector_lock:
        _detector = detector
        _detector_initialized = True
