"""Direct-backend predictor (reference `backend/app/infer.py:13-118`).

Counterpart of the JAX package's `serving/predictor.py`, with the same JSON
contract:

  * probabilities are returned x100 (percent), with `labels` and `top1`;
  * late fusion's output (already probabilities) is softmaxed once more, as
    the reference direct backend does (`backend/app/infer.py:98-99`);
  * a request whose media cannot be preprocessed returns a uniform
    distribution plus an "error" field (`:54-61`).

Unlike the JAX predictor, a runner that fails to build is an error, not a
silent switch to random mock output: that would hide a dead device.  Mock
output is only given when asked for (`mock_mode=True` or `EMO_MOCK=1`).  For
the same reason a failure of the forward itself (a kernel, the device)
raises; only preprocessing failures become the "error" reply.
`predict_waveform` takes a clip's frames and its 16 kHz waveform: for a mel
model the waveform goes through `log_mel_spectrogram_np` on the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from multimodalemotionrecognition_torch.config import ServeConfig, labels_for
from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram_np
from multimodalemotionrecognition_torch.serving.preprocess import EmotionPreprocessService

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
        self.preprocess = EmotionPreprocessService()
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
                mesh=cfg.make_mesh(device),
                device=device,
            )
        self.runner = runner
        self.use_wavlm = runner.use_wavlm
        self.emotion_labels = list(runner.labels)

    def predict(self, video_path: str) -> Dict[str, Any]:
        """A media file (its frames and its audio track) -> the JSON dict."""
        if self.mock_mode:
            return self._predict_mock()
        try:
            video, audio = self.preprocess.preprocess_video_audio(
                video_path, use_face_crop=True, use_wavlm=self.use_wavlm
            )
        except Exception as e:
            return self._error_output(str(e))
        return self.predict_tensors(video, audio)

    def predict_stream(
        self,
        frames: Sequence[np.ndarray],
        waveform: np.ndarray,
        waveform_sample_rate: int,
        use_face_crop: bool = True,
    ) -> Dict[str, Any]:
        """A streaming window (BGR frames, waveform at its rate) -> the JSON dict."""
        if self.mock_mode:
            return self._predict_mock()
        try:
            video, audio = self.preprocess.preprocess_stream_window(
                frames,
                waveform,
                waveform_sample_rate=waveform_sample_rate,
                use_face_crop=use_face_crop,
                use_wavlm=self.use_wavlm,
            )
        except Exception as e:
            return self._error_output(str(e))
        return self.predict_tensors(video, audio)

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

    def predict_waveform(self, video: np.ndarray, waveform: np.ndarray) -> Dict[str, Any]:
        """One clip's frames [1, T, 3, H, W] and its 16 kHz waveform
        [1, 1, samples]: a WavLM model takes the waveform as it is, a mel
        model its log-mel spectrogram [1, 1, n_mels, frames] made on the host."""
        if not self.mock_mode and not self.use_wavlm:
            n_mels = self.runner.model_config.audio_n_mels
            waveform = log_mel_spectrogram_np(np.asarray(waveform)[:, 0, :], n_mels=n_mels)[:, None]
        return self.predict_tensors(video, waveform)

    def _predict_mock(self) -> Dict[str, Any]:
        probs = np.random.dirichlet(np.ones(len(self.emotion_labels)))
        return self._format_output(probs)

    def _error_output(self, message: str) -> Dict[str, Any]:
        n = len(self.emotion_labels)
        uniform = 1.0 / n * 100
        return {
            "error": message,
            "labels": self.emotion_labels,
            "probs": [uniform] * n,
            "top1": {"label": self.emotion_labels[0], "prob": uniform},
        }

    def _format_output(self, probs: np.ndarray) -> Dict[str, Any]:
        probs_pct = (np.asarray(probs, dtype=np.float64) * 100).tolist()
        top_idx = int(np.argmax(probs))
        return {
            "labels": self.emotion_labels,
            "probs": probs_pct,
            "top1": {"label": self.emotion_labels[top_idx], "prob": probs_pct[top_idx]},
        }
