"""Host-side media decode and the training augmentations.

Counterpart of the JAX package's `data/media.py` (reference
`src/data/ravdess.py:280-578`, `backend/app/preprocess.py`):

  * audio: scipy WAV decode + polyphase resample to 16 kHz mono (librosa's
    load contract: float32 in [-1, 1]), head-crop/zero-pad to 3 s, and the
    SNR noise curriculum (50% clean / 40% @ {20,15,10} dB / 10% @ 5 dB) on
    the bar-noise bank, or Gaussian noise when the bank is absent;
  * video: libav (or OpenCV) decode with uniform frame sampling,
    first-frame face detection + bbox reuse, 30%-padded crop, bilinear
    resize, the reference's low-light augmentation, and ImageNet
    normalisation or the uint8 wire.

Each augmentation draws from the caller's `RandomState` in the JAX
package's order (video: factor, noise sigma, kernel size; audio: level,
SNR, offset), so one seed gives one augmentation on either wire and in
either package.

Audio from a non-WAV container (`.mp4`, `.webm`) comes from the native
libav loader (`native/medialoader.py`), as in the JAX package; without
libav it raises with what pkg-config reported.  A file whose bytes are a
RIFF/WAVE container is decoded as WAV whatever its name, as libav would
(the direct app stores uploads as `.webm`).  Video goes through the same
loader when it is available (one demux pass, the crop applied at native
resolution before the resize); `EMO_NATIVE_DECODE=0` forces the cv2 path,
and so does a container libav cannot open.  The two differ only in the
bilinear resize filter (swscale against cv2, under 2/255 a pixel).
"""

from __future__ import annotations

import io
import os
from math import gcd
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from multimodalemotionrecognition_torch.config import IMAGENET_MEAN, IMAGENET_STD
from multimodalemotionrecognition_torch.data.face import (
    crop_with_padding,
    get_face_detector,
    padded_crop_rect,
)
from multimodalemotionrecognition_torch.ops.image import uniform_frame_indices
from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram_np

__all__ = [
    "augment_video_frames",
    "decode_video_frames_u8",
    "decode_wav_bytes",
    "load_audio_file",
    "load_audio_mel",
    "load_audio_wav",
    "load_noise_bank",
    "load_video_frames",
    "load_video_frames_u8",
    "mix_bar_noise",
    "resample_waveform",
]

_noise_cache: dict = {}


def load_noise_bank(
    noise_path: Path | str = Path("data") / "Noise" / "noise.wav",
    sample_rate: int = 16000,
) -> Optional[np.ndarray]:
    """Cached bar-noise waveform (reference `_load_bar_noise`,
    `src/data/ravdess.py:18-39`). None when the asset is absent or cannot
    be read."""
    key = (str(noise_path), sample_rate)
    if key in _noise_cache:
        return _noise_cache[key]
    p = Path(noise_path)
    wav = None
    if p.exists():
        try:
            wav = load_audio_file(p, sample_rate)
        except (OSError, ValueError, RuntimeError):
            wav = None
    _noise_cache[key] = wav
    return wav


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
    """Audio track of a non-WAV container (mp4/webm) through the native libav
    loader; the reference shells out to ffmpeg for this
    (`backend/app/preprocess.py:354-383`)."""
    from multimodalemotionrecognition_torch.native import medialoader

    if medialoader.available():
        return medialoader.decode_audio(str(path))
    from multimodalemotionrecognition_torch.native.build import missing

    raise RuntimeError(
        f"Cannot decode audio from {path.suffix} container: the native libav loader "
        f"is unavailable ({missing() or 'not loaded'}); upload a .wav file"
    )


def mix_bar_noise(
    wav: np.ndarray,
    noise: Optional[np.ndarray],
    rng: np.random.RandomState | np.random.Generator | None = None,
) -> np.ndarray:
    """Train-time noise curriculum, exact reference protocol
    (`src/data/ravdess.py:417-476`): 50% clean; else SNR in {20,15,10} (40%)
    or 5 dB (10%); random noise offset with repeat-if-short; power-matched
    scale; Gaussian fallback when no noise bank; clamp [-1, 1]."""
    r = rng or np.random
    level = float(r.uniform(0.0, 1.0))
    if level < 0.5:
        return wav
    if level < 0.9:
        snr_db = float(r.choice([20.0, 15.0, 10.0]))
    else:
        snr_db = 5.0

    target_len = wav.shape[-1]
    power_sig = float(np.mean(wav**2))
    snr_linear = 10.0 ** (snr_db / 10.0)
    power_noise_target = power_sig / max(snr_linear, 1e-8)

    if noise is not None:
        bank = noise
        if bank.shape[-1] < target_len:
            reps = target_len // bank.shape[-1] + 1
            bank = np.tile(bank, reps)
        max_start = max(0, bank.shape[-1] - target_len)
        start = int(r.randint(0, max_start + 1)) if max_start > 0 else 0
        seg = bank[start : start + target_len]
        power_seg = float(np.mean(seg**2))
        if power_seg > 1e-8:
            seg = seg * np.sqrt(power_noise_target / power_seg)
        out = wav + seg
    else:
        gauss = r.normal(0.0, np.sqrt(power_noise_target), wav.shape).astype(np.float32)
        out = wav + gauss
    return np.clip(out, -1.0, 1.0).astype(np.float32)


def load_audio_wav(
    audio_path: Path | str,
    sample_rate: int = 16000,
    duration_sec: float = 3.0,
    augment: bool = False,
    noise_bank: Optional[np.ndarray] = None,
    rng=None,
) -> np.ndarray:
    """Raw waveform [1, target_len] (reference `load_audio_wav`,
    `src/data/ravdess.py:488-578`): head-crop long audio, zero-pad short;
    with `augment`, the noise curriculum on `noise_bank` (default: the
    cached bank, Gaussian noise without one)."""
    wav = load_audio_file(audio_path, sample_rate)
    target_len = int(sample_rate * duration_sec)
    if wav.shape[-1] < target_len:
        wav = np.pad(wav, (0, target_len - wav.shape[-1]))
    else:
        wav = wav[:target_len]
    if augment:
        bank = noise_bank if noise_bank is not None else load_noise_bank(sample_rate=sample_rate)
        wav = mix_bar_noise(wav, bank, rng=rng)
    return wav[None, :].astype(np.float32)


def load_audio_mel(
    audio_path: Path | str,
    sample_rate: int = 16000,
    duration_sec: float = 3.0,
    n_mels: int = 64,
    win_length: int = 400,
    hop_length: int = 160,
    augment: bool = False,
    noise_bank: Optional[np.ndarray] = None,
    rng=None,
) -> np.ndarray:
    """Log-mel [1, n_mels, frames] (reference `load_audio_mel`,
    `src/data/ravdess.py:393-485`) on the host, through the numpy twin of
    the mel front end; the trainer and the runner make it on the device."""
    wav = load_audio_wav(
        audio_path,
        sample_rate=sample_rate,
        duration_sec=duration_sec,
        augment=augment,
        noise_bank=noise_bank,
        rng=rng,
    )
    return log_mel_spectrogram_np(
        wav, sample_rate=sample_rate, win_length=win_length, hop_length=hop_length, n_mels=n_mels,
    )


def augment_video_frames(frames01: np.ndarray, rng=None) -> np.ndarray:
    """Low-light venue augmentation on [T, H, W, 3] float in [0,1]
    (reference `src/data/ravdess.py:366-384`): Gaussian blur k in {3,5,7},
    brightness x U(0.2, 0.6), Gaussian noise sigma ~ U(0, 5e-4), clip."""
    import cv2

    r = rng or np.random
    factor = float(r.uniform(0.2, 0.6))
    noise_scale = float(r.uniform(0.0, 0.0005))
    ksize = int(r.choice([3, 5, 7]))
    out = np.empty_like(frames01)
    for i in range(frames01.shape[0]):
        img = (frames01[i] * 255.0).astype(np.uint8)
        img = cv2.GaussianBlur(img, (ksize, ksize), 0)
        img = img.astype(np.float32) / 255.0
        img = img * factor
        if noise_scale > 0:
            img = img + r.normal(0, noise_scale, img.shape).astype(np.float32)
        out[i] = np.clip(img, 0.0, 1.0)
    return out


def _native_decode_enabled() -> bool:
    if os.environ.get("EMO_NATIVE_DECODE", "1") != "1":
        return False
    from multimodalemotionrecognition_torch.native import medialoader

    return medialoader.available()


def _load_video_frames_native(
    video_path: Path | str,
    num_frames: int,
    size: int,
    use_face_crop: bool,
    bbox,
) -> Optional[np.ndarray]:
    """libav decode -> uint8 [T, size, size, 3] RGB, or None when libav
    cannot handle the container (the caller takes the cv2 path).

    The cv2 path's semantics: uniform sampling, bbox detected on the FIRST
    sampled frame at native resolution and reused, 30%-padded crop applied
    BEFORE the resize.  A file with no video stream gives zeros, as cv2's
    failed parse does."""
    from multimodalemotionrecognition_torch.native import medialoader

    path = str(video_path)
    try:
        info = medialoader.probe_video(path)
    except RuntimeError:
        return None
    if info["width"] <= 0 or info["height"] <= 0:
        return np.zeros((num_frames, size, size, 3), dtype=np.uint8)
    total = int(info["frames"])
    if total <= 0:
        return None
    indices = [int(i) for i in uniform_frame_indices(total, num_frames)]
    try:
        if not use_face_crop or bbox is not None:
            # bbox known (or no crop): crop + resize inside the decoder, one pass.
            rect = (padded_crop_rect((info["height"], info["width"]), bbox, 0.3)
                    if use_face_crop and bbox is not None else None)
            return medialoader.decode_video_frames(path, indices, size, size, crop=rect)
        # bbox unknown (the common serving case): one decode pass at native
        # resolution, detect on the first sampled frame, then crop + resize
        # with cv2, byte for byte the reference's crop path
        # (`src/data/ravdess.py:337-357`).
        nat = medialoader.decode_video_frames(path, indices, info["width"], info["height"])
    except RuntimeError:
        return None
    import cv2

    detector = get_face_detector()
    det_bbox = None
    if detector is not None:
        try:
            det_bbox = detector.detect_face_bbox(nat[0])
        except Exception:  # full-frame fallback, like the reference
            pass
    out = np.empty((len(nat), size, size, 3), dtype=np.uint8)
    for i, frame in enumerate(nat):
        if det_bbox is not None:
            frame = crop_with_padding(frame, det_bbox, pad_ratio=0.3)
        out[i] = cv2.resize(frame, (size, size), interpolation=cv2.INTER_LINEAR)
    return out


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
    resize.  Through the libav loader when it is available
    (`EMO_NATIVE_DECODE=0` forces cv2), else cv2.  A detector that fails on
    a frame leaves it uncropped, like the reference; a detector that cannot
    be made (`get_face_detector`) raises."""
    if _native_decode_enabled():
        native = _load_video_frames_native(video_path, num_frames, size, use_face_crop, bbox)
        if native is not None:
            return native

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
    rng=None,
    normalize: bool = True,
) -> np.ndarray:
    """Decode + preprocess video to float32 [T, 3, size, size]
    (reference `load_video_frames`, `src/data/ravdess.py:280-390`):
    `decode_video_frames_u8` then /255, the train-time augmentation and
    ImageNet normalisation on the host."""
    arr = decode_video_frames_u8(video_path, num_frames, size, use_face_crop, bbox).astype(np.float32) / 255.0
    if augment:
        arr = augment_video_frames(arr, rng=rng)
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
    rng=None,
) -> Tuple[np.ndarray, float, float]:
    """uint8 wire: (frames_u8 [T, 3, size, size], brightness factor, noise
    sigma), 4x less host->device traffic than the float path.

    The reference augmentation round-trips each frame through uint8 for
    the blur, so the blurred uint8 frames carry the whole augmented signal;
    the rest (brightness x factor, + Gaussian noise, clip, normalise) is
    replayed on the device by the trainer (`EmotionTrainer._device_video`).
    The draws from `rng` come in `augment_video_frames`' order (factor,
    sigma, kernel size).  factor 1.0 and sigma 0.0 without `augment`."""
    u8 = decode_video_frames_u8(video_path, num_frames, size, use_face_crop, bbox)
    factor, sigma = 1.0, 0.0
    if augment:
        import cv2

        r = rng or np.random
        factor = float(r.uniform(0.2, 0.6))
        sigma = float(r.uniform(0.0, 0.0005))
        ksize = int(r.choice([3, 5, 7]))
        # (u8 / 255 * 255).astype(uint8) == u8 for all 256 values, so
        # blurring the decoded uint8 frames is byte-identical to the blur
        # stage of `augment_video_frames`.
        u8 = np.stack([cv2.GaussianBlur(u8[i], (ksize, ksize), 0) for i in range(u8.shape[0])])
    return u8.transpose(0, 3, 1, 2), factor, sigma
