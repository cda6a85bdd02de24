"""Host-side media decode for the serving path.

Counterpart of the JAX package's `data/media.py`, with the functions that
serving reads (reference `src/data/ravdess.py:280-578`,
`backend/app/preprocess.py`):

  * audio: scipy WAV decode + polyphase resample to 16 kHz mono (librosa's
    load contract: float32 in [-1, 1]), head-crop/zero-pad to 3 s;
  * video: OpenCV decode (FFMPEG backend) with uniform frame sampling,
    first-frame face detection + bbox reuse, 30%-padded crop, bilinear
    resize, ImageNet normalisation or the uint8 wire.

What waits for the data slice (ROADMAP queue 1, item 4) raises instead of
running: the training augmentations (`augment=True`: the low-light video
tail and the bar-noise curriculum), and audio from a non-WAV container
(`.mp4`, `.webm`), which the JAX package decodes through its native libav
loader.  A file whose bytes are a RIFF/WAVE container is decoded as WAV
whatever its name, as libav would (the direct app stores uploads as
`.webm`).  The port has no native decoder, so video always takes the cv2
path (the JAX package's `EMO_NATIVE_DECODE=0`).
"""

from __future__ import annotations

import io
from math import gcd
from pathlib import Path
from typing import Tuple

import numpy as np

from multimodalemotionrecognition_torch.config import IMAGENET_MEAN, IMAGENET_STD
from multimodalemotionrecognition_torch.data.face import crop_with_padding, get_face_detector
from multimodalemotionrecognition_torch.ops.image import uniform_frame_indices

__all__ = [
    "decode_video_frames_u8",
    "decode_wav_bytes",
    "load_audio_file",
    "load_audio_wav",
    "load_video_frames",
    "load_video_frames_u8",
    "resample_waveform",
]

_DATA_SLICE = "is not ported yet (ROADMAP queue 1, item 4: the data slice)"


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a RIFF/WAV container to (float32 mono [-1,1], sample_rate)."""
    from scipy.io import wavfile

    sr, samples = wavfile.read(io.BytesIO(data))
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        wav = samples.astype(np.float32) / 32768.0
    elif samples.dtype == np.int32:
        wav = samples.astype(np.float32) / 2147483648.0
    elif samples.dtype == np.uint8:
        wav = (samples.astype(np.float32) - 128.0) / 128.0
    else:
        wav = samples.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)  # librosa mono=True convention
    return wav, int(sr)


def resample_waveform(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample (scipy) to the target rate."""
    if sr == target_sr:
        return wav.astype(np.float32)
    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    out = resample_poly(wav.astype(np.float64), target_sr // g, sr // g)
    return out.astype(np.float32)


def _is_riff_wave(path: Path) -> bool:
    with open(path, "rb") as f:
        head = f.read(12)
    return head[:4] == b"RIFF" and head[8:12] == b"WAVE"


def load_audio_file(path: Path | str, sample_rate: int = 16000) -> np.ndarray:
    path = Path(path)
    if path.suffix.lower() == ".wav" or _is_riff_wave(path):
        wav, sr = decode_wav_bytes(path.read_bytes())
    else:
        wav, sr = _decode_container_audio(path)
    return resample_waveform(wav, sr, sample_rate)


def _decode_container_audio(path: Path) -> Tuple[np.ndarray, int]:
    """Audio track of a non-WAV container: the JAX package reads it through
    its native libav loader (`native/medialoader.py`), which the port has
    not copied."""
    raise RuntimeError(
        f"Cannot decode audio from {path.suffix} container: the native libav loader "
        f"{_DATA_SLICE}; upload a .wav file"
    )


def load_audio_wav(
    audio_path: Path | str,
    sample_rate: int = 16000,
    duration_sec: float = 3.0,
    augment: bool = False,
) -> np.ndarray:
    """Raw waveform [1, target_len] (reference `load_audio_wav`,
    `src/data/ravdess.py:488-578`): head-crop long audio, zero-pad short."""
    if augment:
        raise NotImplementedError(f"load_audio_wav(augment=True): the noise curriculum {_DATA_SLICE}")
    wav = load_audio_file(audio_path, sample_rate)
    target_len = int(sample_rate * duration_sec)
    if wav.shape[-1] < target_len:
        wav = np.pad(wav, (0, target_len - wav.shape[-1]))
    else:
        wav = wav[:target_len]
    return wav[None, :].astype(np.float32)


def decode_video_frames_u8(
    video_path: Path | str,
    num_frames: int = 8,
    size: int = 112,
    use_face_crop: bool = True,
    bbox=None,
) -> np.ndarray:
    """Decode + sample + face-crop + resize to uint8 [T, size, size, 3] RGB.

    Uniform sampling, bbox detected on the FIRST sampled frame only and
    reused (`src/data/ravdess.py:314-348`), 30%-padded crop, bilinear
    resize.  A detector that fails on a frame leaves it uncropped, like the
    reference; a detector that cannot be made (`get_face_detector`) raises."""
    import cv2

    detector = get_face_detector() if use_face_crop and bbox is None else None
    cap = cv2.VideoCapture(str(video_path))
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    indices = uniform_frame_indices(total, num_frames)
    idx_set = set(indices)
    frames = []
    current = 0
    detected_bbox = bbox

    while True:
        ret, frame = cap.read()
        if not ret:
            break
        if current in idx_set:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if use_face_crop:
                try:
                    if detected_bbox is None and detector is not None:
                        detected_bbox = detector.detect_face_bbox(frame)
                    if detected_bbox is not None:
                        frame = crop_with_padding(frame, detected_bbox, pad_ratio=0.3)
                except Exception:  # full-frame fallback, like the reference
                    pass
            frame = cv2.resize(frame, (size, size), interpolation=cv2.INTER_LINEAR)
            frames.append(frame)
        current += 1
        if len(frames) >= len(indices):
            break
    cap.release()

    if not frames:
        frames = [np.zeros((size, size, 3), dtype=np.uint8)] * num_frames
    if len(frames) < num_frames:
        frames.extend([frames[-1]] * (num_frames - len(frames)))
    return np.stack(frames[:num_frames])  # [T,H,W,3] uint8


def load_video_frames(
    video_path: Path | str,
    num_frames: int = 8,
    size: int = 112,
    augment: bool = False,
    use_face_crop: bool = True,
    bbox=None,
    normalize: bool = True,
) -> np.ndarray:
    """Decode + preprocess video to float32 [T, 3, size, size]
    (reference `load_video_frames`, `src/data/ravdess.py:280-390`):
    `decode_video_frames_u8` then /255 and ImageNet normalisation."""
    if augment:
        raise NotImplementedError(f"load_video_frames(augment=True): the augmentation {_DATA_SLICE}")
    arr = decode_video_frames_u8(video_path, num_frames, size, use_face_crop, bbox).astype(np.float32) / 255.0
    if normalize:
        mean = np.asarray(IMAGENET_MEAN, dtype=np.float32)
        std = np.asarray(IMAGENET_STD, dtype=np.float32)
        arr = (arr - mean) / std
    return arr.transpose(0, 3, 1, 2)  # [T, 3, H, W]


def load_video_frames_u8(
    video_path: Path | str,
    num_frames: int = 8,
    size: int = 112,
    augment: bool = False,
    use_face_crop: bool = True,
    bbox=None,
) -> Tuple[np.ndarray, float, float]:
    """uint8 wire: (frames_u8 [T, 3, size, size], brightness factor 1.0,
    noise sigma 0.0), the eval path of the JAX function (the runner then
    normalises on the device)."""
    if augment:
        raise NotImplementedError(f"load_video_frames_u8(augment=True): the augmentation {_DATA_SLICE}")
    u8 = decode_video_frames_u8(video_path, num_frames, size, use_face_crop, bbox)
    return u8.transpose(0, 3, 1, 2), 1.0, 0.0
