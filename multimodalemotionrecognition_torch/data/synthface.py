"""Procedural face scenes + SSD anchor targets for BlazeFace pretraining.

Counterpart of the JAX package's `data/synthface.py`, numpy only, with the
same random draws in the same order: one seed gives the same bytes in
both packages.  The bundled learned detector (`assets/blazeface_synth.npz`)
was pretrained on these scenes: skin-tone ellipse heads with eye/mouth
features over cluttered backgrounds, a distribution shaped like RAVDESS
studio footage (one frontal face, plain backdrop).  The reference's
MediaPipe weights (`src/utils/face_crop.py:40-148`) remain a drop-in
upgrade via `convert/blazeface_export.py`; anchors, decode and weighted
NMS are the same for both weight sources.

Two halves:

  * `make_scene` - one seeded 128x128 RGB scene + ground-truth pixel bbox
    (None for face-free scenes).
  * `anchor_targets` - MediaPipe-anchor SSD supervision: per-anchor class
    labels and raw box regression targets in the units
    `models/blazeface.py::decode_boxes_np` expects (offsets x 128 scale).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from multimodalemotionrecognition_torch.models.blazeface import (
    BLAZEFACE_INPUT_SIZE,
    generate_anchors,
)

__all__ = ["make_scene", "make_dataset", "anchor_targets", "SCENE_SIZE"]

SCENE_SIZE = BLAZEFACE_INPUT_SIZE  # train at detector input resolution

# Skin locus endpoints (light -> dark), lerped per scene.
_SKIN_LIGHT = np.array([232.0, 194.0, 172.0])
_SKIN_DARK = np.array([118.0, 78.0, 56.0])


def _ellipse_mask(h: int, w: int, cx: float, cy: float, rx: float, ry: float):
    yy, xx = np.mgrid[0:h, 0:w]
    return ((xx - cx) / max(rx, 1e-6)) ** 2 + ((yy - cy) / max(ry, 1e-6)) ** 2 <= 1.0


def make_scene(
    rng: np.random.Generator, size: int = SCENE_SIZE, p_face: float = 0.9
) -> Tuple[np.ndarray, Optional[Tuple[int, int, int, int]]]:
    """One synthetic scene.  Returns (uint8 RGB [size,size,3], bbox or None)
    with bbox = (x, y, w, h) in pixels - the tight ellipse bounding box, the
    analog of MediaPipe's face box."""
    h = w = size
    img = np.empty((h, w, 3), np.float32)

    # Background: base color + linear gradient.
    base = rng.uniform(10, 245, size=3)
    gdir = rng.uniform(-1, 1, size=2)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = (gdir[0] * yy / h + gdir[1] * xx / w) * rng.uniform(0, 60)
    img[:] = base[None, None, :] + grad[..., None]

    # Distractor shapes: mostly non-skin colors; occasionally small
    # skin-colored blobs so the net must use shape, not just chroma.
    for _ in range(rng.integers(0, 5)):
        col = rng.uniform(0, 255, size=3)
        skin_like = rng.random() < 0.25
        if skin_like:
            col = _SKIN_LIGHT + (_SKIN_DARK - _SKIN_LIGHT) * rng.random()
        dw = rng.uniform(6, 24 if skin_like else 48)
        dh = rng.uniform(6, 24 if skin_like else 48)
        dx, dy = rng.uniform(0, w), rng.uniform(0, h)
        if rng.random() < 0.5:
            m = _ellipse_mask(h, w, dx, dy, dw / 2, dh / 2)
        else:
            m = np.zeros((h, w), bool)
            x0, y0 = int(max(0, dx - dw / 2)), int(max(0, dy - dh / 2))
            m[y0 : int(min(h, dy + dh / 2)), x0 : int(min(w, dx + dw / 2))] = True
        img[m] = col

    bbox: Optional[Tuple[int, int, int, int]] = None
    if rng.random() < p_face:
        fw = rng.uniform(0.20, 0.68) * size
        fh = fw * rng.uniform(1.12, 1.45)
        fh = min(fh, size - 4.0)
        cx = rng.uniform(fw / 2 + 1, w - fw / 2 - 1)
        cy = rng.uniform(fh / 2 + 1, h - fh / 2 - 1)
        tone = rng.random()
        skin = _SKIN_LIGHT + (_SKIN_DARK - _SKIN_LIGHT) * tone
        skin = skin + rng.uniform(-12, 12, size=3)

        face = _ellipse_mask(h, w, cx, cy, fw / 2, fh / 2)
        shade = 1.0 + (yy - cy) / max(fh, 1.0) * rng.uniform(-0.25, 0.25)
        img[face] = (skin[None, :] * shade[face][:, None]).clip(0, 255)

        # Eyes: dark ellipses, symmetric about the vertical axis.
        eye_dy = cy - 0.18 * fh
        eye_dx = 0.22 * fw
        erx, ery = 0.085 * fw, 0.05 * fh
        eye_col = rng.uniform(15, 75)
        for sx in (-1.0, 1.0):
            m = _ellipse_mask(h, w, cx + sx * eye_dx, eye_dy, erx, ery)
            img[m & face] = eye_col
        # Mouth: dark-red ellipse.
        m = _ellipse_mask(h, w, cx, cy + 0.28 * fh, 0.24 * fw, 0.055 * fh)
        img[m & face] = np.array([rng.uniform(90, 170), 40.0, 45.0])

        x0 = int(np.floor(cx - fw / 2))
        y0 = int(np.floor(cy - fh / 2))
        bbox = (x0, y0, int(np.ceil(fw)), int(np.ceil(fh)))

    noise = rng.normal(0, rng.uniform(0, 7), size=img.shape)
    img = np.clip(img + noise, 0, 255)
    if rng.random() < 0.3:  # cheap 3x3 box blur
        k = np.ones((3, 3), np.float32) / 9.0
        from scipy.signal import convolve2d

        for c in range(3):
            img[..., c] = convolve2d(img[..., c], k, mode="same", boundary="symm")
    return img.astype(np.uint8), bbox


_ANCHORS = None


def _anchors() -> np.ndarray:
    global _ANCHORS
    if _ANCHORS is None:
        _ANCHORS = generate_anchors()
    return _ANCHORS


def anchor_targets(
    bbox: Optional[Tuple[int, int, int, int]],
    size: int = SCENE_SIZE,
    shrink: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """SSD targets for one scene.

    Returns (cls (896,) float32 in {0,1}, box (896,4) float32).  Positive
    anchors are those whose fixed center falls inside the ``shrink``-scaled
    central region of the ground-truth box, plus (always) the single nearest
    anchor on each of the two feature maps so every face has supervision.
    Box targets are the raw-regression units of `decode_boxes_np`:
    ``raw = ((cx-acx)*128, (cy-acy)*128, w*128, h*128)`` - training on these
    makes the exported model consistent with the MediaPipe decode path.
    """
    anchors = _anchors()
    cls = np.zeros(anchors.shape[0], np.float32)
    box = np.zeros((anchors.shape[0], 4), np.float32)
    if bbox is None:
        return cls, box
    x, y, bw, bh = bbox
    cx, cy = (x + bw / 2.0) / size, (y + bh / 2.0) / size
    nw, nh = bw / size, bh / size
    inside = (np.abs(anchors[:, 0] - cx) <= shrink * nw / 2.0) & (
        np.abs(anchors[:, 1] - cy) <= shrink * nh / 2.0
    )
    # Guarantee >=1 positive per feature map (tiny faces can miss all centers).
    d2 = (anchors[:, 0] - cx) ** 2 + (anchors[:, 1] - cy) ** 2
    inside[int(np.argmin(d2[:512]))] = True
    inside[512 + int(np.argmin(d2[512:]))] = True
    cls[inside] = 1.0
    box[inside, 0] = (cx - anchors[inside, 0]) * 128.0
    box[inside, 1] = (cy - anchors[inside, 1]) * 128.0
    box[inside, 2] = nw * 128.0
    box[inside, 3] = nh * 128.0
    return cls, box


def make_dataset(
    n: int, seed: int = 0, p_face: float = 0.9
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """n scenes -> (images uint8 (n,128,128,3), cls (n,896), box (n,896,4))."""
    rng = np.random.default_rng(seed)
    imgs = np.empty((n, SCENE_SIZE, SCENE_SIZE, 3), np.uint8)
    cls = np.empty((n, 896), np.float32)
    box = np.empty((n, 896, 4), np.float32)
    for i in range(n):
        img, bbox = make_scene(rng, p_face=p_face)
        imgs[i] = img
        cls[i], box[i] = anchor_targets(bbox)
    return imgs, cls, box
