"""The port's native libav loader (`native/`) against the JAX package's, on
the CPU, and the media, preprocessing and serving paths it opens.

Both loaders are built from their own sources in this process (the JAX one
outside its package, `tests/torch_native.py`) against the same libav, so
every decoded array and probe is bit-equal; the preprocessed arrays are held
within 1e-6 and the apps' probabilities within the serving tests'
`PROBS_ATOL`.  Clips are made with `encode_av` (h264 + aac in `.mp4`, vp8 +
opus in `.webm`, the browser's upload) and carry a 440 Hz tone.
"""

import asyncio
import shutil
import time

import aiohttp
import numpy as np
import pytest

from multimodalemotionrecognition_tpu import config as jax_config
from multimodalemotionrecognition_tpu.data import face as jax_face
from multimodalemotionrecognition_tpu.data import media as jax_media
from multimodalemotionrecognition_tpu.native import medialoader as jax_medialoader
from multimodalemotionrecognition_tpu.serving import server_direct as jax_direct
from multimodalemotionrecognition_tpu.serving import redis_transport as jax_redis
from multimodalemotionrecognition_tpu.serving import server_queued as jax_queued
from multimodalemotionrecognition_tpu.serving.preprocess import (
    EmotionPreprocessService as JaxPreprocess,
)
from multimodalemotionrecognition_torch import __main__ as hub
from multimodalemotionrecognition_torch import config
from multimodalemotionrecognition_torch.data import face, media
from multimodalemotionrecognition_torch.native import build as native_build
from multimodalemotionrecognition_torch.native import medialoader
from multimodalemotionrecognition_torch.ops.image import uniform_frame_indices
from multimodalemotionrecognition_torch.serving import redis_transport, server_direct, server_queued
from multimodalemotionrecognition_torch.serving.preprocess import EmotionPreprocessService

from tests.test_data import _synthetic_face_video
from tests.test_redis_transport import FakeRedis, _StubRunner
from tests.test_torch_runner import ckpt  # noqa: F401  (the small reference-format checkpoint)
from tests.test_torch_serving import PROBS_ATOL, _serve
from tests.torch_native import jax_loader_path, use_jax_loader  # noqa: F401  (a fixture)

EXTS = ["mp4", "webm"]
TONE_HZ = 440.0
# The five decode settings of the JAX suite (`tests/test_data.py:620-626`).
DECODE_SETTINGS = {
    "legacy": {"EMO_DECODE_SKIP": "0", "EMO_SWS_FULL": "1"},
    "skip": {"EMO_DECODE_SKIP": "1", "EMO_SWS_FULL": "1"},
    "band": {"EMO_DECODE_SKIP": "0", "EMO_SWS_FULL": "0"},
    "both": {"EMO_DECODE_SKIP": "1", "EMO_SWS_FULL": "0"},
    "force": {"EMO_DECODE_SKIP": "2", "EMO_SWS_FULL": "0"},
}
CROP = (30, 20, 60, 70)


@pytest.fixture(scope="module")
def port_loader():
    """The port's loader, built into `native/_build/` (skips without libav)."""
    reason = native_build.missing()
    if reason is not None:
        pytest.skip(reason)
    path = native_build.build()
    assert path.parent == native_build.BUILD_DIR and medialoader.available()
    return path


@pytest.fixture(autouse=True)
def _both_loaders(monkeypatch, port_loader, jax_loader_path):  # noqa: F811
    """Each package on its loader, the default decode settings, and each
    package's default detector."""
    use_jax_loader(monkeypatch, jax_loader_path)
    monkeypatch.setenv("EMO_NATIVE_DECODE", "1")
    for name in ("EMO_DECODE_SKIP", "EMO_SWS_FULL", "EMO_ENCODE_X264OPTS", "EMO_FACE_DETECTOR",
                 "EMO_BLAZEFACE_WEIGHTS", "EMO_MESH_SHAPE"):
        monkeypatch.delenv(name, raising=False)
    for module in (face, jax_face):
        monkeypatch.setattr(module, "_detector", None)
        monkeypatch.setattr(module, "_detector_initialized", False)


def _tone(seconds, sr, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    noise = 0.01 * np.random.RandomState(seed).randn(t.size)
    return (0.3 * np.sin(2 * np.pi * TONE_HZ * t) + noise).astype(np.float32)


def _encode(package, path, n=30, audio_sr=48000):
    """A 3 s clip of `n` frames at 10 fps with the tone, written by `package`."""
    loader = medialoader if package == "port" else jax_medialoader
    loader.encode_av(str(path), _synthetic_face_video(n=n), fps=10.0,
                     audio=_tone(3.0, audio_sr), sample_rate=audio_sr)
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory, port_loader):
    root = tmp_path_factory.mktemp("av")
    return {ext: _encode("port", root / f"clip.{ext}") for ext in EXTS}


def _peak_hz(wav, sr=16000):
    """Peak of the first second's spectrum, in Hz (1 Hz bins)."""
    return float(np.argmax(np.abs(np.fft.rfft(wav[:sr]))))


def _decode_all(loader, path):
    """Everything the bindings read from one file."""
    info = loader.probe_video(str(path))
    idx = uniform_frame_indices(int(info["frames"]), 8)
    return {
        "probe": loader.probe(str(path)),
        "probe_video": info,
        "audio16k": loader.decode_audio(str(path)),
        "audio22k": loader.decode_audio(str(path), 22050),
        "native": loader.decode_video_frames(str(path), idx, info["width"], info["height"]),
        "resized": loader.decode_video_frames(str(path), idx, 112, 112),
        "cropped": loader.decode_video_frames(str(path), idx, 112, 112, crop=CROP),
    }


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for key in got:
        if isinstance(got[key], dict):
            assert got[key] == want[key], key
        elif isinstance(got[key], tuple):
            assert got[key][1] == want[key][1], key
            assert got[key][0].dtype == want[key][0].dtype == np.float32, key
            np.testing.assert_array_equal(got[key][0], want[key][0], err_msg=key)
        else:
            assert got[key].dtype == want[key].dtype == np.uint8, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --------------------------------------------------------------------------- the bindings


@pytest.mark.parametrize("ext", EXTS)
def test_decoded_audio_probes_and_frames_equal_jax(clips, ext):
    got = _decode_all(medialoader, clips[ext])
    _assert_same(got, _decode_all(jax_medialoader, clips[ext]))
    info = got["probe_video"]
    assert info["has_audio"] and (info["width"], info["height"]) == (160, 120)
    assert info["frames"] == 30 and got["native"].shape == (8, 120, 160, 3)
    assert got["cropped"].shape == got["resized"].shape == (8, 112, 112, 3)
    assert abs(got["audio16k"][0].size - 48000) <= 1024
    assert abs(_peak_hz(got["audio16k"][0]) - TONE_HZ) <= 3


@pytest.mark.parametrize("setting", sorted(DECODE_SETTINGS))
@pytest.mark.parametrize("ext", EXTS)
def test_decode_settings_equal_jax_and_legacy(clips, ext, setting, monkeypatch):
    """EMO_DECODE_SKIP x EMO_SWS_FULL: the port reads what JAX reads under
    each setting, and every setting reads what the legacy decode reads."""
    path = str(clips[ext])
    info = medialoader.probe_video(path)
    idx = np.linspace(0, info["frames"] - 1, 8).astype(int).tolist()

    def read(loader, env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        return {"full": loader.decode_video_frames(path, idx, info["width"], info["height"]),
                "crop": loader.decode_video_frames(path, idx, 112, 112, crop=CROP)}

    got = read(medialoader, DECODE_SETTINGS[setting])
    want = read(jax_medialoader, DECODE_SETTINGS[setting])
    legacy = read(medialoader, DECODE_SETTINGS["legacy"])
    for kind in ("full", "crop"):
        np.testing.assert_array_equal(got[kind], want[kind], err_msg=kind)
        np.testing.assert_array_equal(got[kind], legacy[kind], err_msg=kind)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("ext", EXTS)
def test_a_clip_either_package_encodes_decodes_alike(tmp_path, ext, writer):
    path = _encode(writer, tmp_path / f"by_{writer}.{ext}", n=12, audio_sr=16000)
    got = _decode_all(medialoader, path)
    _assert_same(got, _decode_all(jax_medialoader, path))
    # a .webm has no frame count: libav estimates it from the duration (3 s)
    assert got["probe"]["frames"] == (12 if ext == "mp4" else 30) and got["probe"]["has_audio"]


# --------------------------------------------------------------------------- data/media.py


@pytest.mark.parametrize("ext", EXTS)
def test_container_audio_equals_jax(clips, ext):
    path = clips[ext]
    got = media.load_audio_file(path)
    np.testing.assert_array_equal(got, jax_media.load_audio_file(path))
    for augment in (False, True):
        np.testing.assert_array_equal(
            media.load_audio_wav(path, augment=augment, rng=np.random.RandomState(3)),
            jax_media.load_audio_wav(path, augment=augment, rng=np.random.RandomState(3)))
    assert abs(_peak_hz(got) - TONE_HZ) <= 3


@pytest.mark.parametrize("use_face_crop, bbox", [(False, None), (True, None), (True, (50, 30, 40, 50))],
                         ids=["full_frame", "detected_crop", "injected_bbox"])
@pytest.mark.parametrize("ext", EXTS)
def test_video_decode_equals_jax_native_path(clips, ext, use_face_crop, bbox):
    path = clips[ext]
    kw = dict(num_frames=8, size=112, use_face_crop=use_face_crop, bbox=bbox)
    u8 = media.decode_video_frames_u8(path, **kw)
    assert u8.shape == (8, 112, 112, 3) and u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, jax_media.decode_video_frames_u8(path, **kw))
    got = media.load_video_frames(path, augment=True, rng=np.random.RandomState(5), **kw)
    want = jax_media.load_video_frames(path, augment=True, rng=np.random.RandomState(5), **kw)
    np.testing.assert_array_equal(got, want)
    got = media.load_video_frames_u8(path, augment=True, rng=np.random.RandomState(5), **kw)
    want = jax_media.load_video_frames_u8(path, augment=True, rng=np.random.RandomState(5), **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("ext", EXTS)
def test_native_path_against_cv2_within_jax_bounds(clips, ext, monkeypatch):
    """Same decode, same bbox; only the resize filter differs (swscale
    against cv2).  JAX's bounds, in normalised units
    (`tests/test_data.py:552-563`)."""
    native = media.load_video_frames(clips[ext], num_frames=8, size=112, use_face_crop=True)
    monkeypatch.setenv("EMO_NATIVE_DECODE", "0")
    cv2_path = media.load_video_frames(clips[ext], num_frames=8, size=112, use_face_crop=True)
    assert native.shape == cv2_path.shape == (8, 3, 112, 112)
    diff = np.abs(native - cv2_path)
    assert diff.mean() < 0.05, diff.mean()
    assert np.percentile(diff, 99) < 0.6, np.percentile(diff, 99)


def test_files_libav_reads_without_video_or_cannot_open(tmp_path):
    """No video stream (an audio-only .webm, a WAV under a .webm name): zero
    frames without a cv2 attempt; bytes libav cannot open: the cv2 route.
    Both as in JAX."""
    audio_only = tmp_path / "voice.webm"
    medialoader.encode_av(str(audio_only), None, fps=10.0, audio=_tone(1.0, 48000), sample_rate=48000)
    wav_named_webm = tmp_path / "upload.webm"
    from tests.test_data import _write_wav

    _write_wav(wav_named_webm, _tone(1.0, 22050), 22050)
    junk = tmp_path / "junk.mp4"
    junk.write_bytes(np.random.RandomState(0).bytes(4096))
    for path in (audio_only, wav_named_webm, junk):
        got = media.decode_video_frames_u8(path)
        np.testing.assert_array_equal(got, jax_media.decode_video_frames_u8(path))
        assert got.shape == (8, 112, 112, 3) and not got.any()
    assert media._load_video_frames_native(junk, 8, 112, True, None) is None
    assert not medialoader.probe_video(str(audio_only))["width"]
    np.testing.assert_array_equal(media.load_audio_file(audio_only),
                                  jax_media.load_audio_file(audio_only))
    with pytest.raises(RuntimeError, match="audio decode failed"):
        media.load_audio_file(junk)


# --------------------------------------------------------------------------- serving/preprocess.py


@pytest.mark.parametrize("raw_uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("ext", EXTS)
def test_preprocess_equals_jax(clips, ext, raw_uint8):
    """The file path and an upload's bytes, as both apps receive them."""
    path = clips[ext]
    kw = dict(use_face_crop=True, use_wavlm=True, raw_uint8=raw_uint8)
    svc, jax_svc = EmotionPreprocessService(), JaxPreprocess()
    got = svc.preprocess_video_audio(path, **kw)
    want = jax_svc.preprocess_video_audio(path, **kw)
    video, audio, blank = svc.preprocess_payload(f"clip.{ext}", path.read_bytes(), **kw)
    jvideo, jaudio, jblank = jax_svc.preprocess_payload(f"clip.{ext}", path.read_bytes(), **kw)
    assert blank is jblank is False
    assert video.shape == (1, 8, 3, 112, 112) and audio.shape == (1, 1, 48000)
    assert video.dtype == (np.uint8 if raw_uint8 else np.float32)
    for g, w in ((got[0], want[0]), (got[1], want[1]), (video, jvideo), (audio, jaudio)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(video, got[0])
    assert abs(_peak_hz(audio[0, 0]) - TONE_HZ) <= 3


# --------------------------------------------------------------------------- build and hub


def test_build_is_keyed_reused_and_a_broken_source_raises(tmp_path, monkeypatch):
    path = native_build.build()
    stamp = path.stat().st_mtime_ns
    assert native_build.build() == path and path.stat().st_mtime_ns == stamp
    assert path.name.startswith("libmedialoader_") and path.suffix == ".so"
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    broken = tmp_path / "medialoader.cc"
    shutil.copy(native_build.SOURCE, broken)
    broken.write_text(broken.read_text() + "\nint ml_broken( {\n")
    monkeypatch.setattr(native_build, "SOURCE", broken)
    assert native_build.library_path().name != path.name
    with pytest.raises(RuntimeError, match="g[+][+] failed"):
        native_build.build()
    monkeypatch.setattr(medialoader, "_lib", None)
    monkeypatch.setattr(medialoader, "_load_attempted", False)
    with pytest.raises(RuntimeError, match="ml_broken"):  # no quiet retreat to cv2
        medialoader.available()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_without_libav_the_loader_is_absent_and_says_why(tmp_path, monkeypatch, clips):
    monkeypatch.setattr(native_build, "LIBAV", native_build.LIBAV + ("libnosuchlib_emo",))
    monkeypatch.setattr(medialoader, "_lib", None)
    monkeypatch.setattr(medialoader, "_load_attempted", False)
    assert not medialoader.available()
    assert "libnosuchlib_emo" in native_build.missing()
    with pytest.raises(RuntimeError, match="libnosuchlib_emo"):
        medialoader.decode_audio(str(clips["webm"]))
    with pytest.raises(RuntimeError, match="libnosuchlib_emo"):
        media.load_audio_wav(clips["webm"])
    with pytest.raises(RuntimeError, match="libnosuchlib_emo"):
        hub.main(["build-native"])
    monkeypatch.setenv("EMO_NATIVE_DECODE", "0")
    cv2_frames = media.decode_video_frames_u8(clips["mp4"])
    monkeypatch.setenv("EMO_NATIVE_DECODE", "1")  # the loader is absent: cv2 all the same
    np.testing.assert_array_equal(media.decode_video_frames_u8(clips["mp4"]), cv2_frames)


# --------------------------------------------------------------------------- the apps


def _upload(name, data):
    form = aiohttp.FormData()
    form.add_field("file", data, filename=name)
    return form


async def _post(client, name, data):
    r = await client.post("/predict", data=_upload(name, data))
    return r.status, await r.json()


def test_direct_app_answers_a_webm_upload_like_jax(ckpt, clips):  # noqa: F811
    data = clips["webm"].read_bytes()

    async def requests(client):
        return await _post(client, "clip.webm", data)

    async def scenario(app):
        return await _serve(app, requests)

    got = asyncio.run(scenario(server_direct.create_app(
        config=config.ServeConfig(), checkpoint=ckpt, device="cpu")))
    want = asyncio.run(scenario(jax_direct.create_app(
        config=jax_config.ServeConfig(), checkpoint=ckpt)))
    assert got[0] == want[0] == 200, (got, want)
    assert set(got[1]) == set(want[1]) == {"labels", "probs", "top1"}
    # the direct app answers in percent
    np.testing.assert_allclose(got[1]["probs"], want[1]["probs"], atol=100 * PROBS_ATOL, rtol=0)
    assert got[1]["top1"]["label"] == want[1]["top1"]["label"]


def test_queued_app_answers_a_burst_of_container_uploads_like_jax(ckpt, clips):  # noqa: F811
    """Three container uploads at once through the batcher's video route."""
    uploads = [("a.webm", clips["webm"]), ("b.mp4", clips["mp4"]), ("c.webm", clips["webm"])]

    async def requests(client):
        return await asyncio.gather(*(_post(client, name, p.read_bytes()) for name, p in uploads))

    def replies(pkg_config, create_app, **kw):
        cfg = pkg_config.ServeConfig(checkpoint_path=ckpt, batch_size=4, batch_buckets=(4,),
                                     batch_timeout_ms=50)
        return asyncio.run(_serve(create_app(config=cfg, **kw), requests))

    got = replies(config, server_queued.create_app, device="cpu")
    want = replies(jax_config, jax_queued.create_app)
    for (status, body), (jstatus, jbody) in zip(got, want):
        assert status == jstatus == 200, (body, jbody)
        np.testing.assert_allclose(body["probs"], jbody["probs"], atol=PROBS_ATOL, rtol=0)
        assert body["top1"]["label"] == jbody["top1"]["label"]
    np.testing.assert_allclose(got[0][1]["probs"], got[2][1]["probs"], atol=PROBS_ATOL, rtol=0)


class _SpyRunner(_StubRunner):
    use_wavlm = True

    def __init__(self):
        self.seen = []

    def predict_probs(self, videos, audios):
        self.seen.append((videos, audios))
        return super().predict_probs(videos, audios)


def test_redis_worker_reads_container_uploads_like_jax(clips):
    """The worker writes each upload to a temporary file named after it
    and reads it through the loader: the batch it hands its runner equals
    the JAX worker's within 1e-6, and both tasks complete."""
    uploads = [("clip.webm", clips["webm"]), ("upload", clips["mp4"])]  # no suffix: `.mp4`

    def run(module, config_cls):
        cfg = config_cls(batch_size=4, batch_timeout_ms=5)
        fake, runner = FakeRedis(), _SpyRunner()
        worker = module.RedisWorker(runner, config=cfg, client=fake)
        for task_id, (name, path) in zip(("t0", "t1"), uploads):
            fake.hset(f"{cfg.task_prefix}{task_id}",
                      mapping={"status": "queued", "filename": name, "submitted_at": str(time.time())})
            fake.set(f"{cfg.task_prefix}{task_id}:payload", path.read_bytes())
            fake.rpush(cfg.queue_name, task_id)
        worker._process_batch(worker._pop_batch())
        return runner.seen, [fake.hgetall(f"{cfg.task_prefix}{t}")[b"status"] for t in ("t0", "t1")]

    (got,), got_status = run(redis_transport, config.ServeConfig)
    (want,), want_status = run(jax_redis, jax_config.ServeConfig)
    assert got_status == want_status == [b"completed", b"completed"]
    assert got[0].shape == (2, 8, 3, 112, 112) and got[1].shape == (2, 1, 48000)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
