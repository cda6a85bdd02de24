"""Serving-side preprocessing (reference `backend/app/preprocess.py:30-441`).

Counterpart of the JAX package's `serving/preprocess.py`, host numpy only:

  * file path: video decode + face crop + normalisation, audio from the
    same file (`data/media.py`: a `.mp4` or `.webm` through the native libav
    loader, `native/medialoader.py`, video through cv2 under
    `EMO_NATIVE_DECODE=0`; container audio raises where libav is absent);
  * uploaded bytes: a `.wav` upload takes the in-memory path (RIFF decode,
    resample, head-crop/pad, blank video flagged for the batcher); other
    uploads (the browser's `.webm`, `.mp4` clips) go through a temporary
    file and the file path;
  * stream path: in-memory frames + waveform, with the reference's quirk
    kept: streaming TAIL-crops audio (the most recent 3 s, `:320-323`) while
    file audio HEAD-crops.

A mel model's log-mel is made on the host by `ops/mel.py::log_mel_spectrogram_np`.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from multimodalemotionrecognition_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    AudioConfig,
    VideoConfig,
)
from multimodalemotionrecognition_torch.data.face import crop_with_padding, get_face_detector
from multimodalemotionrecognition_torch.data.media import (
    decode_wav_bytes,
    load_audio_wav,
    load_video_frames,
    resample_waveform,
)
from multimodalemotionrecognition_torch.ops.image import uniform_frame_indices
from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram_np

__all__ = ["EmotionPreprocessService"]


class EmotionPreprocessService:
    def __init__(self, audio: AudioConfig = AudioConfig(), video: VideoConfig = VideoConfig()):
        self.audio = audio
        self.video = video

    # ------------------------------------------------------------- video

    def load_video_frames(self, video_path: str | Path, use_face_crop: bool = True) -> np.ndarray:
        """[T, 3, H, W] normalized frames from a container file."""
        return load_video_frames(
            video_path,
            num_frames=self.video.num_frames,
            size=self.video.size,
            use_face_crop=use_face_crop,
        )

    def load_video_frames_from_memory(
        self, frames: Sequence[np.ndarray], use_face_crop: bool = True, frames_are_bgr: bool = True
    ) -> np.ndarray:
        """In-memory frames (browser JPEG decodes are BGR) -> [T, 3, H, W]
        (reference `load_video_frames_from_memory`, `:215-252`)."""
        import cv2

        size = self.video.size
        num_frames = self.video.num_frames
        if not frames:
            return self._normalize(np.zeros((num_frames, size, size, 3), dtype=np.float32))

        selected = [frames[i] for i in uniform_frame_indices(len(frames), num_frames)]
        processed = []
        bbox = None
        for frame in selected:
            if frame.ndim != 3 or frame.shape[2] != 3:
                continue
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB) if frames_are_bgr else frame
            if use_face_crop:
                if bbox is None:
                    detector = get_face_detector()
                    if detector is not None:
                        bbox = detector.detect_face_bbox(rgb)
                if bbox is not None:
                    rgb = crop_with_padding(rgb, bbox, pad_ratio=self.video.face_pad_ratio)
            processed.append(cv2.resize(rgb, (size, size), interpolation=cv2.INTER_LINEAR))

        if not processed:
            processed = [np.zeros((size, size, 3), dtype=np.uint8)] * num_frames
        if len(processed) < num_frames:
            processed.extend([processed[-1]] * (num_frames - len(processed)))
        arr = np.stack(processed[:num_frames]).astype(np.float32) / 255.0
        return self._normalize(arr)

    @staticmethod
    def _normalize(frames_thw3: np.ndarray) -> np.ndarray:
        mean = np.asarray(IMAGENET_MEAN, dtype=np.float32)
        std = np.asarray(IMAGENET_STD, dtype=np.float32)
        return ((frames_thw3 - mean) / std).transpose(0, 3, 1, 2)

    # ------------------------------------------------------------- audio

    def prepare_audio_waveform(self, waveform: np.ndarray, sample_rate: int) -> np.ndarray:
        """In-memory waveform -> [1, target_len]; TAIL-crop (streaming quirk,
        reference `:320-323`) and zero-pad short input."""
        wav = np.asarray(waveform, dtype=np.float32).reshape(-1)
        if wav.size == 0:
            wav = np.zeros(1, dtype=np.float32)
        if sample_rate != self.audio.sample_rate:
            wav = resample_waveform(wav, sample_rate, self.audio.sample_rate)
        target = self.audio.target_len
        if wav.size < target:
            wav = np.pad(wav, (0, target - wav.size))
        elif wav.size > target:
            wav = wav[-target:]
        return wav[None, :].astype(np.float32)

    def _mel(self, wav_1t: np.ndarray) -> np.ndarray:
        return log_mel_spectrogram_np(
            wav_1t,
            sample_rate=self.audio.sample_rate,
            n_fft=self.audio.n_fft,
            win_length=self.audio.win_length,
            hop_length=self.audio.hop_length,
            n_mels=self.audio.n_mels,
        )

    def _audio(self, wav_1t: np.ndarray, use_wavlm: bool) -> np.ndarray:
        """[1, 1, samples] waveform for WavLM, [1, 1, n_mels, frames] log-mel otherwise."""
        audio = wav_1t if use_wavlm else self._mel(wav_1t)
        return audio[None].astype(np.float32)

    # ------------------------------------------------------------- entry points

    def preprocess_video_audio(
        self,
        video_path: str | Path,
        use_face_crop: bool = True,
        use_wavlm: bool = False,
        raw_uint8: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """File -> (video [1,T,3,H,W], audio [1,1,...]).

        raw_uint8=True skips ImageNet normalisation and returns uint8 frames
        (4x less host->device traffic; the runner normalises on the device,
        `TorchModelRunner(device_normalize=True)`)."""
        frames = load_video_frames(
            video_path,
            num_frames=self.video.num_frames,
            size=self.video.size,
            use_face_crop=use_face_crop,
            normalize=not raw_uint8,
        )  # [T,3,H,W]: normalized, or float 0..1
        if raw_uint8:
            video = np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)[None]
        else:
            video = frames[None].astype(np.float32)
        wav = load_audio_wav(
            video_path, sample_rate=self.audio.sample_rate, duration_sec=self.audio.duration_sec
        )  # [1, target]
        return video, self._audio(wav, use_wavlm)

    def preprocess_payload(
        self,
        filename: str,
        payload: bytes,
        use_face_crop: bool = True,
        use_wavlm: bool = False,
        raw_uint8: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Uploaded bytes -> (video [1,T,3,H,W], audio, blank_video).

        Audio-only .wav uploads take an in-memory path: RIFF decode +
        resample + head-crop/pad, the video all blank with blank_video=True
        so the batcher ships no frames.  Other uploads go through a temporary
        file and `preprocess_video_audio`."""
        suffix = Path(filename).suffix.lower()
        if suffix == ".wav":
            wav, sr = decode_wav_bytes(payload)
            if sr != self.audio.sample_rate:
                wav = resample_waveform(wav, sr, self.audio.sample_rate)
            target = self.audio.target_len
            if wav.size < target:  # head-crop/zero-pad (training convention)
                wav = np.pad(wav, (0, target - wav.size))
            else:
                wav = wav[:target]
            audio = self._audio(wav[None, :].astype(np.float32), use_wavlm)
            t, s = self.video.num_frames, self.video.size
            if raw_uint8:
                video = np.zeros((1, t, 3, s, s), dtype=np.uint8)
            else:
                # normalized zeros are (0 - mean) / std, not 0.0
                mean = np.asarray(IMAGENET_MEAN, np.float32).reshape(1, 1, 3, 1, 1)
                std = np.asarray(IMAGENET_STD, np.float32).reshape(1, 1, 3, 1, 1)
                video = np.broadcast_to(-mean / std, (1, t, 3, s, s)).astype(np.float32)
            return video, audio, True

        with tempfile.NamedTemporaryFile(suffix=suffix or ".mp4", delete=False) as tmp:
            tmp.write(payload)
            media_path = Path(tmp.name)
        try:
            video, audio = self.preprocess_video_audio(
                media_path, use_face_crop=use_face_crop, use_wavlm=use_wavlm, raw_uint8=raw_uint8
            )
            return video, audio, False
        finally:
            media_path.unlink(missing_ok=True)

    def preprocess_stream_window(
        self,
        frames: Sequence[np.ndarray],
        waveform: np.ndarray,
        waveform_sample_rate: int,
        use_face_crop: bool = True,
        use_wavlm: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        video = self.load_video_frames_from_memory(frames, use_face_crop=use_face_crop)[None]
        wav = self.prepare_audio_waveform(waveform, waveform_sample_rate)
        return video.astype(np.float32), self._audio(wav, use_wavlm)
