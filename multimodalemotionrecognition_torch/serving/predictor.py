"""Direct-backend predictor on preprocessed tensors.

Counterpart of the JAX package's `serving/predictor.py` (reference
`backend/app/infer.py:13-118`), with the same JSON contract:

  * probabilities are returned x100 (percent), with `labels` and `top1`;
  * late fusion's output (already probabilities) is softmaxed once more, as
    the reference direct backend does (`backend/app/infer.py:98-99`).

Unlike the JAX predictor, a runner that fails to build is an error, not a
silent switch to random mock output: that would hide a dead device.  Mock
output is only given when asked for (`mock_mode=True` or `EMO_MOCK=1`).
Decoding media files needs the host-side preprocessing stack, which is not
ported yet; this predictor takes tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from multimodalemotionrecognition_torch.config import ServeConfig, labels_for

__all__ = ["EmotionPredictor"]


class EmotionPredictor:
    def __init__(
        self,
        mock_mode: bool = False,
        checkpoint_path: Optional[str] = None,
        num_classes: int = 8,
        config: Optional[ServeConfig] = None,
        runner: Optional[Any] = None,
        device: str = "cuda",
    ):
        cfg = config or ServeConfig.from_env()
        self.mock_mode = mock_mode or cfg.mock
        self.emotion_labels: List[str] = list(labels_for(num_classes))
        self.use_wavlm = False
        self.runner = None
        if self.mock_mode:
            return
        if runner is None:
            from multimodalemotionrecognition_torch.runtime.runner import (
                TorchModelRunner,
            )

            runner = TorchModelRunner(
                checkpoint_path or cfg.checkpoint_path,
                num_classes=num_classes,
                batch_buckets=cfg.batch_buckets,
                compute_dtype=cfg.compute_dtype,
                mesh=cfg.mesh_shape,
                device=device,
            )
        self.runner = runner
        self.use_wavlm = runner.use_wavlm
        self.emotion_labels = list(runner.labels)

    def predict_tensors(self, video: np.ndarray, audio: np.ndarray) -> Dict[str, Any]:
        """One clip's preprocessed tensors ([1, T, 3, H, W], [1, 1, samples])
        -> the direct backend's JSON dict."""
        if self.mock_mode:
            return self._predict_mock()
        probs = self.runner.predict_probs(video, audio)[0]
        if self.runner.fusion_mode == "late":
            e = np.exp(probs - probs.max())
            probs = e / e.sum()
        return self._format_output(probs)

    def _predict_mock(self) -> Dict[str, Any]:
        probs = np.random.dirichlet(np.ones(len(self.emotion_labels)))
        return self._format_output(probs)

    def _format_output(self, probs: np.ndarray) -> Dict[str, Any]:
        probs_pct = (np.asarray(probs, dtype=np.float64) * 100).tolist()
        top_idx = int(np.argmax(probs))
        return {
            "labels": self.emotion_labels,
            "probs": probs_pct,
            "top1": {"label": self.emotion_labels[top_idx], "prob": probs_pct[top_idx]},
        }
