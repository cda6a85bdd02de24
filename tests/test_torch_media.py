"""The port's media decode and face crop (`data/media.py`, `data/face.py`,
`data/haar.py`, `ops/image.py::uniform_frame_indices`) against the JAX
package's: scipy-written WAVs and cv2-written videos, as
`tests/test_data.py` writes them.  Every output is exactly equal.

The JAX package reads video through its native libav loader when that is
built; these tests pin it to its cv2 path (`EMO_NATIVE_DECODE=0`), the only
path the port has.
"""

import io

import numpy as np
import pytest
from scipy.io import wavfile

from multimodalemotionrecognition_tpu.data import face as jax_face
from multimodalemotionrecognition_tpu.data import media as jax_media
from multimodalemotionrecognition_tpu.ops.image import (
    uniform_frame_indices as jax_uniform_frame_indices,
)
from multimodalemotionrecognition_torch.data import face, media
from multimodalemotionrecognition_torch.ops.image import uniform_frame_indices

from tests.test_data import _synthetic_face_video, _write_video


@pytest.fixture(autouse=True)
def _cv2_decode_and_default_detector(monkeypatch):
    """The JAX package's cv2 video path, and each package's default detector."""
    monkeypatch.setenv("EMO_NATIVE_DECODE", "0")
    monkeypatch.delenv("EMO_FACE_DETECTOR", raising=False)
    monkeypatch.delenv("EMO_BLAZEFACE_WEIGHTS", raising=False)
    for module in (face, jax_face):
        monkeypatch.setattr(module, "_detector", None)
        monkeypatch.setattr(module, "_detector_initialized", False)


def _wav_bytes(sr, channels, dtype, seconds, seed=0):
    rng = np.random.RandomState(seed)
    x = 0.3 * rng.randn(int(sr * seconds), channels)
    if dtype == "int16":
        x = np.clip(x * 32767, -32768, 32767).astype(np.int16)
    else:
        x = x.astype(np.float32)
    buf = io.BytesIO()
    wavfile.write(buf, sr, x[:, 0] if channels == 1 else x)
    return buf.getvalue()


WAVS = [
    (16000, 1, "int16", 3.0),
    (16000, 2, "float32", 1.0),
    (22050, 1, "float32", 4.0),
    (22050, 2, "int16", 2.0),
    (48000, 1, "int16", 2.0),
    (48000, 2, "float32", 3.5),
]


@pytest.mark.parametrize("sr, channels, dtype, seconds", WAVS)
def test_wav_decode_resample_and_load_equal_jax(tmp_path, sr, channels, dtype, seconds):
    data = _wav_bytes(sr, channels, dtype, seconds)
    got, got_sr = media.decode_wav_bytes(data)
    want, want_sr = jax_media.decode_wav_bytes(data)
    assert got_sr == want_sr == sr and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        media.resample_waveform(got, sr, 16000), jax_media.resample_waveform(want, sr, 16000)
    )
    path = tmp_path / "clip.wav"
    path.write_bytes(data)
    out = media.load_audio_wav(path)
    assert out.shape == (1, 48000)
    np.testing.assert_array_equal(out, jax_media.load_audio_wav(path))


def test_a_wav_under_another_name_is_read_as_wav(tmp_path):
    """The direct app stores uploads as .webm: RIFF/WAVE bytes decode as WAV,
    as the JAX package's libav loader would read them."""
    data = _wav_bytes(22050, 1, "int16", 2.0)
    (tmp_path / "clip.wav").write_bytes(data)
    (tmp_path / "upload.webm").write_bytes(data)
    np.testing.assert_array_equal(
        media.load_audio_wav(tmp_path / "upload.webm"), jax_media.load_audio_wav(tmp_path / "clip.wav")
    )


def test_container_audio_and_augmentation_raise(tmp_path):
    """Container audio raises (the libav loader is not ported), with or
    without augmentation; the augmented video loaders run, equal to JAX's."""
    vid = tmp_path / "clip.mp4"
    _write_video(vid, _synthetic_face_video(n=4))
    for augment in (False, True):
        with pytest.raises(RuntimeError, match="ROADMAP queue 1, item 4"):
            media.load_audio_wav(vid, augment=augment)
    with pytest.raises(RuntimeError):  # the JAX package without its libav loader
        jax_media.load_audio_wav(vid)
    for fn, jax_fn in ((media.load_video_frames, jax_media.load_video_frames),
                       (media.load_video_frames_u8, jax_media.load_video_frames_u8)):
        got = fn(vid, augment=True, rng=np.random.RandomState(0))
        want = jax_fn(vid, augment=True, rng=np.random.RandomState(0))
        np.testing.assert_array_equal(got[0] if isinstance(got, tuple) else got,
                                      want[0] if isinstance(want, tuple) else want)


@pytest.mark.parametrize("total, num", [(0, 8), (3, 8), (8, 8), (20, 8), (97, 8), (5, 1)])
def test_uniform_frame_indices_equal_jax(total, num):
    assert uniform_frame_indices(total, num) == list(jax_uniform_frame_indices(total, num))


@pytest.mark.parametrize(
    "shape, bbox, pad",
    [((100, 100), (40, 40, 20, 20), 0.3), ((50, 50), (0, 0, 45, 45), 0.3),
     ((120, 160), (150, 110, 30, 30), 0.5), ((64, 48), (60, 10, 10, 10), 0.3)],
)
def test_crop_with_padding_equals_jax(shape, bbox, pad):
    img = np.arange(np.prod(shape) * 3, dtype=np.int64).reshape(*shape, 3).astype(np.uint8)
    assert face.padded_crop_rect(shape, bbox, pad) == jax_face.padded_crop_rect(shape, bbox, pad)
    np.testing.assert_array_equal(
        face.crop_with_padding(img, bbox, pad), jax_face.crop_with_padding(img, bbox, pad)
    )


def _skin_scenes():
    rng = np.random.RandomState(3)
    blank = np.zeros((120, 160, 3), np.uint8)
    patch = blank.copy()
    patch[30:80, 50:90] = (200, 140, 110)
    noisy = np.clip(patch.astype(int) + rng.randint(-30, 30, patch.shape), 0, 255).astype(np.uint8)
    tiny = blank.copy()
    tiny[10:14, 10:14] = (200, 140, 110)
    return {"blank": blank, "patch": patch, "noisy": noisy, "tiny": tiny,
            "float01": patch.astype(np.float32) / 255.0}


@pytest.mark.parametrize("scene", ["blank", "patch", "noisy", "tiny", "float01"])
def test_heuristic_detector_bbox_equals_jax(scene):
    img = _skin_scenes()[scene]
    got = face.HeuristicFaceDetector().detect_face_bbox(img)
    assert got == jax_face.HeuristicFaceDetector().detect_face_bbox(img)
    assert (got is None) == (scene in ("blank", "tiny"))


def test_haar_detector_equals_jax():
    det, jax_det = face.HaarFaceDetector(), jax_face.HaarFaceDetector()
    if not jax_det.available:
        pytest.skip("no Haar cascade XML on this machine")
    img = np.full((96, 96, 3), 128, np.uint8)
    img[24:72, 28:68] = (190, 150, 120)
    img[38:44, 36:44] = img[38:44, 52:60] = 40  # eyes
    img[58:62, 40:56] = 60  # mouth
    assert det.available
    assert det.detect_face_bbox(img) == jax_det.detect_face_bbox(img)


def test_detector_selection(monkeypatch, tmp_path):
    assert isinstance(face.get_face_detector(), face.HeuristicFaceDetector)
    # The JAX package's selection: the bundled weights for `bundled`, and for
    # `blazeface` with no weights named; a named file is loaded.
    named = tmp_path / "named.npz"
    named.write_bytes(face.BUNDLED_BLAZEFACE_WEIGHTS.read_bytes())
    for env in ({"EMO_FACE_DETECTOR": "blazeface"}, {"EMO_BLAZEFACE_WEIGHTS": "bundled"},
                {"EMO_BLAZEFACE_WEIGHTS": str(named)}):
        monkeypatch.setattr(face, "_detector_initialized", False)
        monkeypatch.setattr(jax_face, "_detector_initialized", False)
        with monkeypatch.context() as m:
            for key, value in env.items():
                m.setenv(key, value)
            det = face.get_face_detector()
            assert isinstance(det, face.BlazeFaceDetector)
            assert det.device.type == "cpu"
            assert isinstance(jax_face.get_face_detector(), jax_face.BlazeFaceDetector)
    # A weights path that does not exist raises (the JAX package serves the
    # heuristic), and so does a detector without weights (JAX: disabled).
    monkeypatch.setattr(face, "_detector_initialized", False)
    with monkeypatch.context() as m:
        m.setenv("EMO_BLAZEFACE_WEIGHTS", str(tmp_path / "missing.npz"))
        with pytest.raises(FileNotFoundError, match="missing.npz"):
            face.get_face_detector()
    with pytest.raises(ValueError, match="weights"):
        face.BlazeFaceDetector(None)
    sentinel = face.HeuristicFaceDetector(min_coverage=0.5)
    face.set_face_detector(sentinel)
    assert face.get_face_detector() is sentinel


@pytest.fixture(scope="module")
def face_video(tmp_path_factory):
    path = tmp_path_factory.mktemp("media") / "02-01-03-01-01-01-01.mp4"
    _write_video(path, _synthetic_face_video(n=20))
    return path


@pytest.mark.parametrize("use_face_crop, bbox", [(False, None), (True, None), (True, (50, 30, 40, 50))],
                         ids=["full_frame", "detected_crop", "injected_bbox"])
def test_video_decode_equals_jax(face_video, use_face_crop, bbox):
    kw = dict(num_frames=8, size=112, use_face_crop=use_face_crop, bbox=bbox)
    u8 = media.decode_video_frames_u8(face_video, **kw)
    assert u8.shape == (8, 112, 112, 3) and u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, jax_media.decode_video_frames_u8(face_video, **kw))
    for normalize in (True, False):
        got = media.load_video_frames(face_video, normalize=normalize, **kw)
        assert got.shape == (8, 3, 112, 112) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_media.load_video_frames(face_video, normalize=normalize, **kw))
    got, factor, sigma = media.load_video_frames_u8(face_video, **kw)
    want, jax_factor, jax_sigma = jax_media.load_video_frames_u8(face_video, **kw)
    np.testing.assert_array_equal(got, want)
    assert (factor, sigma) == (jax_factor, jax_sigma) == (1.0, 0.0)


def test_short_video_and_unreadable_file_equal_jax(tmp_path):
    short = tmp_path / "short.mp4"
    _write_video(short, _synthetic_face_video(n=3))
    garbage = tmp_path / "garbage.mp4"
    garbage.write_bytes(b"not a video at all")
    for path in (short, garbage):
        got = media.load_video_frames(path, num_frames=8, use_face_crop=False)
        np.testing.assert_array_equal(got, jax_media.load_video_frames(path, num_frames=8, use_face_crop=False))
    np.testing.assert_array_equal(got, got[:1].repeat(8, axis=0))  # blank frames, normalised
