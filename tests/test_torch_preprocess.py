"""The port's `serving/preprocess.py::EmotionPreprocessService` against the
JAX package's, on the same uploads and stream windows.  Arrays are exactly
equal, except a mel model's log-mel: the port makes it with its own numpy
twin (`ops/mel.py::log_mel_spectrogram_np`), held within 1e-5 of the JAX
package's.  Uploads are read through cv2 (`EMO_NATIVE_DECODE=0`) except where
a test runs once on each decoder (the `decoder` fixture of
`tests/torch_native.py`: cv2, and both packages on their libav loaders)."""

import io

import numpy as np
import pytest
from scipy.io import wavfile

from multimodalemotionrecognition_tpu.data import face as jax_face
from multimodalemotionrecognition_tpu.serving.preprocess import (
    EmotionPreprocessService as JaxPreprocess,
)
from multimodalemotionrecognition_torch.data import face
from multimodalemotionrecognition_torch.serving.preprocess import EmotionPreprocessService

from tests.test_data import _synthetic_face_video
from tests.torch_native import decoder, jax_loader_path, skip_without_libav  # noqa: F401  (fixtures)

MEL_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _cv2_decode_and_default_detector(monkeypatch):
    monkeypatch.setenv("EMO_NATIVE_DECODE", "0")
    monkeypatch.delenv("EMO_FACE_DETECTOR", raising=False)
    monkeypatch.delenv("EMO_BLAZEFACE_WEIGHTS", raising=False)
    for module in (face, jax_face):
        monkeypatch.setattr(module, "_detector", None)
        monkeypatch.setattr(module, "_detector_initialized", False)


def _wav(sr, seconds, seed):
    pcm = np.clip(np.random.RandomState(seed).randn(int(sr * seconds)) * 6000, -32768, 32767)
    buf = io.BytesIO()
    wavfile.write(buf, sr, pcm.astype(np.int16))
    return buf.getvalue()


def _assert_audio(got, want, use_wavlm):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if use_wavlm:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)


@pytest.mark.parametrize("use_wavlm", [True, False], ids=["wavlm", "mel"])
@pytest.mark.parametrize("raw_uint8", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("sr, seconds", [(16000, 3.0), (48000, 2.0), (22050, 4.0)],
                         ids=["16k_3s", "48k_2s_padded", "22k_4s_cropped"])
def test_wav_payload_equals_jax(sr, seconds, raw_uint8, use_wavlm):
    data = _wav(sr, seconds, seed=sr)
    kw = dict(use_face_crop=True, use_wavlm=use_wavlm, raw_uint8=raw_uint8)
    video, audio, blank = EmotionPreprocessService().preprocess_payload("clip.wav", data, **kw)
    jvideo, jaudio, jblank = JaxPreprocess().preprocess_payload("clip.wav", data, **kw)
    assert blank is jblank is True
    assert video.dtype == jvideo.dtype == (np.uint8 if raw_uint8 else np.float32)
    assert video.shape == (1, 8, 3, 112, 112)
    np.testing.assert_array_equal(video, jvideo)
    assert audio.shape == ((1, 1, 48000) if use_wavlm else (1, 1, 64, 301))
    _assert_audio(audio, jaudio, use_wavlm)


@pytest.mark.parametrize("loader", ["libav", "unavailable"])
def test_container_payload_raises_in_both(tmp_path, monkeypatch, jax_loader_path, loader):  # noqa: F811
    """A video upload with its audio track: through each package's libav
    loader both give the same arrays (within 1e-6); with the loader
    unavailable both raise."""
    from multimodalemotionrecognition_torch.native import medialoader

    from tests.torch_native import jax_medialoader, use_jax_loader

    skip_without_libav()
    use_jax_loader(monkeypatch, jax_loader_path)
    path = tmp_path / "clip.mp4"
    t = np.arange(48000) / 16000
    medialoader.encode_av(str(path), _synthetic_face_video(n=10), fps=10.0,
                          audio=(0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32))
    data = path.read_bytes()
    if loader == "unavailable":
        monkeypatch.setattr(medialoader, "available", lambda: False)
        monkeypatch.setattr(jax_medialoader, "available", lambda: False)
        with pytest.raises(RuntimeError, match="native libav loader is unavailable"):
            EmotionPreprocessService().preprocess_payload("clip.mp4", data)
        with pytest.raises(RuntimeError):
            JaxPreprocess().preprocess_payload("clip.mp4", data)
        return
    monkeypatch.setenv("EMO_NATIVE_DECODE", "1")
    video, audio, blank = EmotionPreprocessService().preprocess_payload("clip.mp4", data, use_wavlm=True)
    jvideo, jaudio, jblank = JaxPreprocess().preprocess_payload("clip.mp4", data, use_wavlm=True)
    assert blank is jblank is False
    assert video.shape == (1, 8, 3, 112, 112) and audio.shape == (1, 1, 48000)
    np.testing.assert_allclose(video, jvideo, atol=1e-6, rtol=0)
    np.testing.assert_allclose(audio, jaudio, atol=1e-6, rtol=0)


@pytest.mark.parametrize("raw_uint8", [True, False], ids=["uint8", "float"])
def test_file_path_video_and_audio_equal_jax(tmp_path, decoder, raw_uint8):
    """The file path on a WAV (no frames: blank video) and its audio."""
    path = tmp_path / "clip.wav"
    path.write_bytes(_wav(22050, 2.0, seed=5))
    got = EmotionPreprocessService().preprocess_video_audio(path, use_wavlm=True, raw_uint8=raw_uint8)
    want = JaxPreprocess().preprocess_video_audio(path, use_wavlm=True, raw_uint8=raw_uint8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _bgr_frames(n, seed):
    frames = _synthetic_face_video(n=n)[..., ::-1]  # RGB -> BGR, as a browser JPEG decodes
    noise = np.random.RandomState(seed).randint(0, 8, frames.shape)
    return list(np.clip(frames.astype(int) + noise, 0, 255).astype(np.uint8))


@pytest.mark.parametrize(
    "n_frames, samples, sr, use_face_crop, use_wavlm",
    [(12, 64000, 16000, True, True), (3, 20000, 16000, True, False),
     (0, 48000, 16000, False, True), (5, 60000, 48000, False, False), (9, 0, 8000, True, True)],
    ids=["tail_crop", "padded_mel", "no_frames", "resampled_mel", "empty_audio"],
)
def test_stream_window_equals_jax(n_frames, samples, sr, use_face_crop, use_wavlm):
    frames = _bgr_frames(n_frames, seed=n_frames)
    waveform = (0.2 * np.random.RandomState(samples).randn(samples)).astype(np.float32)
    kw = dict(waveform_sample_rate=sr, use_face_crop=use_face_crop, use_wavlm=use_wavlm)
    video, audio = EmotionPreprocessService().preprocess_stream_window(frames, waveform, **kw)
    jvideo, jaudio = JaxPreprocess().preprocess_stream_window(frames, waveform, **kw)
    assert video.shape == (1, 8, 3, 112, 112) and video.dtype == np.float32
    np.testing.assert_array_equal(video, jvideo)
    _assert_audio(audio, jaudio, use_wavlm)
