"""Live WebSocket inference sessions.

Counterpart of the JAX package's `serving/streaming.py`, with the same
behaviour as the reference's streaming layer (`backend/app/streaming.py:39-136`):

* Audio is held in one preallocated float32 ring buffer indexed by an
  absolute sample counter; its capacity is the 6 s retention cap, so old
  samples are overwritten, never "pruned".
* Frames are kept as parallel arrays (timestamps + images) in timestamp
  order, trimmed with a binary search.

Observable semantics:

* a prediction window is the most recent 3 s of audio plus all frames whose
  timestamp falls inside the last 3 s (every buffered frame when none do);
* inference is allowed only when >= 3 s of audio and >= 2 frames are
  buffered AND >= 0.5 s has passed since the previous prediction;
* at most 6 s of audio / 6 s of frames are retained, the frames counted
  back from the NEWEST timestamp: after one far-future timestamp every later
  frame is evicted on arrival and the session never holds two frames again
  (F1 in ROADMAP queue 3, kept as the JAX package has it);
* prediction payloads carry session_id / window_seconds /
  num_buffered_frames / num_audio_samples annotations.
"""

from __future__ import annotations

import base64
import binascii
import time
import uuid
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from multimodalemotionrecognition_torch.config import ServeConfig

__all__ = [
    "decode_frame_b64",
    "decode_pcm16_b64",
    "StreamingEmotionSession",
    "StreamingSessionManager",
]

_CFG = ServeConfig()

_PCM16_SCALE = np.float32(1.0 / 32768.0)


def decode_frame_b64(image_b64: str) -> np.ndarray:
    """Decode a base64 (optionally data-URL-prefixed) image to BGR uint8.

    Behavioral twin of reference `backend/app/streaming.py:19-27`.
    """
    import cv2

    # Accept both bare base64 and "data:image/...;base64,<payload>" URLs.
    _, _, payload = image_b64.rpartition(",")
    try:
        raw = base64.b64decode(payload)
    except (binascii.Error, ValueError) as exc:
        raise ValueError(f"Frame payload is not valid base64: {exc}") from exc
    image = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
    if image is None:
        raise ValueError("Frame payload did not decode to an image.")
    return image


def decode_pcm16_b64(pcm_b64: str) -> np.ndarray:
    """Decode base64 little-endian int16 PCM to float32 in [-1, 1].

    Behavioral twin of reference `backend/app/streaming.py:30-36`.
    """
    samples = np.frombuffer(base64.b64decode(pcm_b64), dtype="<i2")
    return samples.astype(np.float32) * _PCM16_SCALE


class _AudioRing:
    """Fixed-capacity float32 ring buffer addressed by absolute sample index.

    `total` counts every sample ever written; the buffer retains the last
    `min(total, capacity)` of them.  `tail(n)` returns the newest `n`
    retained samples in arrival order.
    """

    def __init__(self, capacity: int) -> None:
        self.capacity = max(1, int(capacity))
        self._buf = np.zeros(self.capacity, dtype=np.float32)
        self.total = 0

    @property
    def held(self) -> int:
        return min(self.total, self.capacity)

    def write(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        n = samples.size
        if n >= self.capacity:
            # Chunk alone overflows the ring: only its tail survives.  Lay the
            # tail out rotated so the newest sample sits just before the ring
            # position implied by the advanced counter.
            self.total += n
            end = self.total % self.capacity
            kept = samples[n - self.capacity :]
            self._buf[end:] = kept[: self.capacity - end]
            self._buf[:end] = kept[self.capacity - end :]
            return
        start = self.total % self.capacity
        first = min(n, self.capacity - start)
        self._buf[start : start + first] = samples[:first]
        if first < n:
            self._buf[: n - first] = samples[first:]
        self.total += n

    def tail(self, n: int) -> np.ndarray:
        n = min(int(n), self.held)
        if n <= 0:
            return np.zeros(0, dtype=np.float32)
        end = self.total % self.capacity
        start = (end - n) % self.capacity
        if start < end or end == 0:
            stop = end if end else self.capacity
            return self._buf[start:stop].copy()
        return np.concatenate([self._buf[start:], self._buf[:end]])


class StreamingEmotionSession:
    """One client's rolling A/V buffers plus the inference cadence gate."""

    def __init__(
        self,
        predictor: Any,
        window_seconds: float = _CFG.stream_window_sec,
        step_seconds: float = _CFG.stream_step_sec,
        max_buffer_seconds: float = _CFG.stream_max_buffer_sec,
        session_id: Optional[str] = None,
        use_face_crop: bool = True,
        waveform_sample_rate: int = 16000,
    ) -> None:
        self.predictor = predictor
        self.window_seconds = float(window_seconds)
        self.step_seconds = float(step_seconds)
        self.max_buffer_seconds = float(max_buffer_seconds)
        self.session_id = session_id or uuid.uuid4().hex
        self.use_face_crop = use_face_crop
        self.waveform_sample_rate = int(waveform_sample_rate)
        self._frame_ts: List[float] = []
        self._frame_imgs: List[np.ndarray] = []
        self._ring = self._new_ring()
        self.last_prediction_ts = 0.0

    # -- audio ------------------------------------------------------------

    def _new_ring(self) -> _AudioRing:
        return _AudioRing(round(self.waveform_sample_rate * self.max_buffer_seconds))

    @property
    def audio_sample_count(self) -> int:
        return self._ring.held

    def add_audio_chunk(
        self, chunk: np.ndarray, sample_rate: int, timestamp: Optional[float] = None
    ) -> None:
        # Audio position is tracked by sample count, so the wall-clock
        # timestamp is unused (same as the reference).
        if int(sample_rate) != self.waveform_sample_rate:
            # A rate change invalidates the retained samples' time base;
            # start a fresh ring sized for the new rate.
            self.waveform_sample_rate = int(sample_rate)
            self._ring = self._new_ring()
        self._ring.write(chunk)

    # -- video ------------------------------------------------------------

    @property
    def frames(self) -> List[Tuple[float, np.ndarray]]:
        """(timestamp, image) pairs, oldest first — the reference's buffer shape."""
        return list(zip(self._frame_ts, self._frame_imgs))

    def add_frame(self, frame: np.ndarray, timestamp: Optional[float] = None) -> None:
        ts = float(time.monotonic() if timestamp is None else timestamp)
        # Client-supplied timestamps are not trusted to arrive in order (and
        # a message omitting one falls back to server time): insert in
        # sorted position so the bisect-based window/prune logic stays
        # correct for any arrival order.
        at = bisect_left(self._frame_ts, ts)
        self._frame_ts.insert(at, ts)
        self._frame_imgs.insert(at, frame)
        newest = self._frame_ts[-1]
        keep_from = bisect_left(self._frame_ts, newest - self.max_buffer_seconds)
        if keep_from:
            del self._frame_ts[:keep_from]
            del self._frame_imgs[:keep_from]

    # -- inference --------------------------------------------------------

    def _window_samples(self) -> int:
        return max(1, int(self.waveform_sample_rate * self.window_seconds))

    def ready_for_inference(self, now: Optional[float] = None) -> bool:
        if self.audio_sample_count < int(self.waveform_sample_rate * self.window_seconds):
            return False
        if len(self._frame_ts) < 2:
            return False
        ts = float(time.monotonic() if now is None else now)
        return ts - self.last_prediction_ts >= self.step_seconds

    def build_window(
        self, now: Optional[float] = None
    ) -> Tuple[List[np.ndarray], np.ndarray]:
        ts = float(time.monotonic() if now is None else now)
        first_in_window = bisect_left(self._frame_ts, ts - self.window_seconds)
        images = self._frame_imgs[first_in_window:]
        if not images:
            images = list(self._frame_imgs)
        return images, self._ring.tail(self._window_samples())

    def infer(self, now: Optional[float] = None) -> Dict[str, Any]:
        ts = float(time.monotonic() if now is None else now)
        images, waveform = self.build_window(ts)
        result = self.predictor.predict_stream(
            images,
            waveform,
            waveform_sample_rate=self.waveform_sample_rate,
            use_face_crop=self.use_face_crop,
        )
        self.last_prediction_ts = ts
        result.update(
            session_id=self.session_id,
            window_seconds=self.window_seconds,
            num_buffered_frames=len(images),
            num_audio_samples=int(waveform.size),
        )
        return result


class StreamingSessionManager:
    """Registry of live sessions, keyed by session id."""

    def __init__(self, predictor: Any) -> None:
        self.predictor = predictor
        self.sessions: Dict[str, StreamingEmotionSession] = {}

    def create_session(self, use_face_crop: bool = True) -> StreamingEmotionSession:
        session = StreamingEmotionSession(self.predictor, use_face_crop=use_face_crop)
        self.sessions[session.session_id] = session
        return session

    def close_session(self, session_id: str) -> None:
        self.sessions.pop(session_id, None)
