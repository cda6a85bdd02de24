"""Viola-Jones Haar-cascade face detection in pure numpy.

The port's copy of the JAX package's `data/haar.py`, line for line: OpenCV
5.x removed `cv2.CascadeClassifier` from the Python bindings, but the
real-face-trained cascade weights still ship with OpenCV
(`haarcascade_frontalface_default.xml`).  This module evaluates those
cascades directly: XML parse -> integral images -> vectorized stage-by-stage
stump evaluation with early rejection over all windows of each scale.  Used
by `data.face.HaarFaceDetector` (`EMO_FACE_DETECTOR=haar`).

Evaluation semantics follow OpenCV's HaarEvaluator (stump-based cascades,
`featureType=HAAR`, `maxCatCount=0`):

  * window variance normalization: sigma = sqrt(E[x^2] - E[x]^2) over the
    window (1 if degenerate);
  * per-stump: f = (sum_i w_i * rectsum_i) / window_area, go left if
    f < threshold * sigma, add the chosen leaf value to the stage sum;
  * reject the window when stage_sum < stage_threshold;
  * rect coordinates scale by the window scale with rounding, and the
    FIRST rect's weight is recomputed so the weighted rect areas still sum
    to zero (OpenCV's rounding-compensation rule).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["HaarCascade", "find_cascade_xml"]

_SEARCH_DIRS = (
    "/usr/share/opencv4/haarcascades",
    "/usr/local/share/opencv4/haarcascades",
    "/usr/share/opencv/haarcascades",
)


def find_cascade_xml(
    name: str = "haarcascade_frontalface_default.xml",
) -> Optional[Path]:
    try:
        import cv2

        dirs = [getattr(cv2.data, "haarcascades", "")] + list(_SEARCH_DIRS)
    except ImportError:
        dirs = list(_SEARCH_DIRS)
    for d in dirs:
        if not d:
            continue
        p = Path(d) / name
        if p.exists():
            return p
    return None


@dataclass
class _Stage:
    threshold: float
    feature_idx: np.ndarray  # [n_stumps] int32
    stump_threshold: np.ndarray  # [n_stumps] f64
    left_val: np.ndarray  # [n_stumps] f64
    right_val: np.ndarray  # [n_stumps] f64


class HaarCascade:
    def __init__(self, xml_path: str | Path):
        root = ET.parse(str(xml_path)).getroot()
        casc = root.find("cascade")
        if casc is None or casc.get("type_id") != "opencv-cascade-classifier":
            raise ValueError(f"not a new-format OpenCV cascade: {xml_path}")
        if (casc.findtext("featureType") or "").strip() != "HAAR":
            raise ValueError("only HAAR featureType cascades are supported")
        self.win_w = int(casc.findtext("width"))
        self.win_h = int(casc.findtext("height"))

        # Features: up to 3 weighted rects each, padded with zero-weight.
        feats = casc.find("features")
        rects: List[List[Tuple[int, int, int, int, float]]] = []
        for f in feats:
            rs = []
            for r in f.find("rects"):
                vals = r.text.split()
                x, y, w, h = (int(v) for v in vals[:4])
                rs.append((x, y, w, h, float(vals[4])))
            rects.append(rs)
        self.max_rects = max(len(r) for r in rects)
        n = len(rects)
        self.rect_xywh = np.zeros((n, self.max_rects, 4), np.int32)
        self.rect_w = np.zeros((n, self.max_rects), np.float64)
        for i, rs in enumerate(rects):
            for j, (x, y, w, h, wt) in enumerate(rs):
                self.rect_xywh[i, j] = (x, y, w, h)
                self.rect_w[i, j] = wt

        self.stages: List[_Stage] = []
        for st in casc.find("stages"):
            thr = float(st.findtext("stageThreshold"))
            fidx, sthr, lv, rv = [], [], [], []
            for weak in st.find("weakClassifiers"):
                nodes = weak.findtext("internalNodes").split()
                leaves = weak.findtext("leafValues").split()
                if len(nodes) != 4:
                    raise ValueError("only stump-based cascades are supported")
                # internalNodes: left right featureIdx threshold
                fidx.append(int(nodes[2]))
                sthr.append(float(nodes[3]))
                lv.append(float(leaves[0]))
                rv.append(float(leaves[1]))
            self.stages.append(
                _Stage(
                    thr,
                    np.asarray(fidx, np.int32),
                    np.asarray(sthr),
                    np.asarray(lv),
                    np.asarray(rv),
                )
            )

    # ------------------------------------------------------------------

    def _scaled_features(self, scale: float, win_w: int, win_h: int):
        """Rect coords scaled + rounded (clamped into the scaled window —
        independent rounding can overshoot it by 1 px); first-rect weight
        recomputed so the weighted areas sum to zero (OpenCV rounding
        compensation)."""
        r = self.rect_xywh.astype(np.float64) * scale
        xy = np.round(r[..., :2]).astype(np.int64)
        wh = np.round(r[..., 2:]).astype(np.int64)
        wh[..., 0] = np.minimum(wh[..., 0], win_w - xy[..., 0])
        wh[..., 1] = np.minimum(wh[..., 1], win_h - xy[..., 1])
        wh = np.maximum(wh, 0)
        area = (wh[..., 0] * wh[..., 1]).astype(np.float64)
        w = self.rect_w.copy()
        # sum over non-first rects of w*area, compensated into rect 0
        tail = (w[:, 1:] * area[:, 1:]).sum(axis=1)
        a0 = np.where(area[:, 0] > 0, area[:, 0], 1.0)
        w[:, 0] = -tail / a0
        return xy, wh, w

    @staticmethod
    def _rect_sums(ii: np.ndarray, ys, xs, x0, y0, w, h):
        """Sum over [y0:y0+h, x0:x0+w] for every window origin (ys, xs)."""
        return (
            ii[ys + y0 + h, xs + x0 + w]
            - ii[ys + y0 + h, xs + x0]
            - ii[ys + y0, xs + x0 + w]
            + ii[ys + y0, xs + x0]
        )

    def detect_multi_scale(
        self,
        gray: np.ndarray,
        scale_factor: float = 1.1,
        min_neighbors: int = 3,
        min_size: int = 24,
        step_frac: float = 0.05,
    ) -> List[Tuple[int, int, int, int]]:
        """Detect on a uint8/float grayscale image.  Returns (x, y, w, h)
        boxes after min-neighbors grouping, largest cluster first."""
        g = gray.astype(np.float64)
        H, W = g.shape
        ii = np.zeros((H + 1, W + 1))
        ii[1:, 1:] = g.cumsum(0).cumsum(1)
        sq = np.zeros((H + 1, W + 1))
        sq[1:, 1:] = (g * g).cumsum(0).cumsum(1)

        raw: List[Tuple[int, int, int, int]] = []
        scale = max(min_size / self.win_w, 1.0)
        while True:
            ww = int(round(self.win_w * scale))
            wh_ = int(round(self.win_h * scale))
            if ww > W or wh_ > H:
                break
            step = max(1, int(round(ww * step_frac)))
            ys0 = np.arange(0, H - wh_ + 1, step)
            xs0 = np.arange(0, W - ww + 1, step)
            ys, xs = np.meshgrid(ys0, xs0, indexing="ij")
            ys, xs = ys.ravel(), xs.ravel()

            inv_area = 1.0 / (ww * wh_)
            s1 = self._rect_sums(ii, ys, xs, 0, 0, ww, wh_)
            s2 = self._rect_sums(sq, ys, xs, 0, 0, ww, wh_)
            mean = s1 * inv_area
            var = s2 * inv_area - mean * mean
            sigma = np.where(var > 0, np.sqrt(np.maximum(var, 0)), 1.0)

            xy, whr, wts = self._scaled_features(scale, ww, wh_)
            alive = np.arange(ys.size)
            for stage in self.stages:
                if alive.size == 0:
                    break
                ssum = np.zeros(alive.size)
                ay, ax = ys[alive], xs[alive]
                for k in range(stage.feature_idx.size):
                    fi = stage.feature_idx[k]
                    fsum = np.zeros(alive.size)
                    for j in range(self.max_rects):
                        wt = wts[fi, j]
                        if wt == 0.0:
                            continue
                        x0, y0 = xy[fi, j]
                        rw, rh = whr[fi, j]
                        fsum += wt * self._rect_sums(ii, ay, ax, x0, y0, rw, rh)
                    go_left = fsum * inv_area < stage.stump_threshold[k] * sigma[alive]
                    ssum += np.where(go_left, stage.left_val[k], stage.right_val[k])
                alive = alive[ssum >= stage.threshold]
            for i in alive:
                raw.append((int(xs[i]), int(ys[i]), ww, wh_))
            scale *= scale_factor

        return _group_rectangles(raw, min_neighbors)


def _group_rectangles(
    rects: List[Tuple[int, int, int, int]], min_neighbors: int
) -> List[Tuple[int, int, int, int]]:
    """OpenCV-groupRectangles-style clustering: rectangles are similar when
    their corners differ by < 0.2 * size; clusters below min_neighbors are
    dropped; each surviving cluster returns its mean rectangle.  Clusters
    sorted by membership (most supported first)."""
    if not rects:
        return []
    n = len(rects)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def similar(a, b):
        delta = 0.2 * (min(a[2], b[2]) + min(a[3], b[3])) * 0.5
        return (
            abs(a[0] - b[0]) <= delta
            and abs(a[1] - b[1]) <= delta
            and abs(a[0] + a[2] - b[0] - b[2]) <= delta
            and abs(a[1] + a[3] - b[1] - b[3]) <= delta
        )

    for i in range(n):
        for j in range(i + 1, n):
            if similar(rects[i], rects[j]):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    clusters: dict = {}
    for i in range(n):
        clusters.setdefault(find(i), []).append(rects[i])
    out = []
    for members in clusters.values():
        if len(members) < max(1, min_neighbors):
            continue
        arr = np.asarray(members, np.float64)
        out.append((len(members), tuple(int(round(v)) for v in arr.mean(0))))
    out.sort(key=lambda t: -t[0])
    return [box for _, box in out]
