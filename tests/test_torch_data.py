"""The port's training data path against the JAX package's, on the CPU:
RAVDESS pairing and splits (`data/ravdess.py`), the synthetic corpus
(`data/synthetic.py`), the training augmentations of `data/media.py`, the
prefetching loaders (`data/pipeline.py`) and `ops/stochastic.py::
mix_noise_snr`.

Tolerances: everything host-side is exactly equal (the same numpy and cv2
calls on the same `RandomState` draws); `load_audio_mel` within 1e-5 (the
two numpy mel twins sum in another order); `mix_noise_snr` within 1e-6
(torch against XLA float32 arithmetic), its curriculum shares within 3
sigma of 0.5 / 0.4 / 0.1 over 4,000 draws.

Both packages read video through their native libav loaders when those
are built.  These tests pin both to cv2 (`EMO_NATIVE_DECODE=0`), except the
tests that decode video, which run once on each decoder (the `decoder`
fixture of `tests/torch_native.py`: cv2, and both packages on their
loaders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalemotionrecognition_tpu.config import DataConfig as JaxDataConfig
from multimodalemotionrecognition_tpu.config import VideoConfig as JaxVideoConfig
from multimodalemotionrecognition_tpu.data import face as jax_face
from multimodalemotionrecognition_tpu.data import media as jax_media
from multimodalemotionrecognition_tpu.data import pipeline as jax_pipeline
from multimodalemotionrecognition_tpu.data import ravdess as jax_ravdess
from multimodalemotionrecognition_tpu.data import synthetic as jax_synthetic
from multimodalemotionrecognition_tpu.ops import stochastic as jax_stochastic
from multimodalemotionrecognition_torch.config import DataConfig, VideoConfig
from multimodalemotionrecognition_torch.data import face, media, pipeline, ravdess, synthetic
from multimodalemotionrecognition_torch.ops import stochastic

from tests.test_data import _synthetic_face_video, _write_video
from tests.torch_native import decoder, jax_loader_path  # noqa: F401  (fixtures)


@pytest.fixture(autouse=True)
def _cv2_decode_and_default_detector(monkeypatch):
    """The JAX package's cv2 video path, and each package's default detector."""
    monkeypatch.setenv("EMO_NATIVE_DECODE", "0")
    monkeypatch.delenv("EMO_FACE_DETECTOR", raising=False)
    monkeypatch.delenv("EMO_BLAZEFACE_WEIGHTS", raising=False)
    for module in (face, jax_face):
        monkeypatch.setattr(module, "_detector", None)
        monkeypatch.setattr(module, "_detector_initialized", False)


def _records(pairs):
    return [(str(p.video_path), str(p.audio_path), p.emotion, p.intensity, p.statement,
             p.repetition, p.actor) for p in pairs]


# --------------------------------------------------------------------------- (a) ravdess


@pytest.mark.parametrize("name", [
    "02-01-06-01-02-01-12.mp4", "03-01-08-02-02-02-24.wav", "01-02-03-04-05-06-07",
    "not-a-ravdess-file.mp4", "02-01-06-01-02-01.mp4",
])
def test_parse_ravdess_name_equals_jax(name):
    try:
        want = jax_ravdess.parse_ravdess_name(name)
    except ValueError:
        with pytest.raises(ValueError):
            ravdess.parse_ravdess_name(name)
        return
    assert ravdess.parse_ravdess_name(name) == want
    assert ravdess.EMOTION_ID_TO_NAME == jax_ravdess.EMOTION_ID_TO_NAME


def test_pairs_labels_splits_and_csv_equal_jax(tmp_path):
    names = ["Actor_02/junk.txt", "Actor_03/02-02-05-01-01-01-03.mp4",  # wrong vocal channel
             "Actor_03/02-01-04-01-01-01-03.mp4"]  # no audio twin
    for a in range(1, 9):
        for emo in range(1, 9):
            for rep in (1, 2):
                for m, ext in ((2, "mp4"), (3, "wav")):
                    names.append(f"Actor_{a:02d}/0{m}-01-0{emo}-01-01-0{rep}-{a:02d}.{ext}")
    for name in names:
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).touch()
    pairs, want = ravdess.build_pairs(tmp_path), jax_ravdess.build_pairs(tmp_path)
    assert len(pairs) == 128 and _records(pairs) == _records(want)
    for n in (8, 4):
        assert [ravdess.map_emotion_label(e, n) for e in range(1, 9)] == [
            jax_ravdess.map_emotion_label(e, n) for e in range(1, 9)]
    assert all(map(lambda s: _records(s[0]) == _records(s[1]), zip(
        ravdess.split_pairs_by_actor(pairs, [1, 2, 3, 4, 5], [6], [7, 8]),
        jax_ravdess.split_pairs_by_actor(want, [1, 2, 3, 4, 5], [6], [7, 8]))))
    for ratios in ((0.7, 0.15, 0.15), (0.5, 0.25, 0.25)):
        got = ravdess.split_pairs_stratified(list(pairs), *ratios, seed=42)
        ref = jax_ravdess.split_pairs_stratified(list(want), *ratios, seed=42)
        assert [_records(s) for s in got] == [_records(s) for s in ref]
    ravdess.save_pairs_csv(pairs, tmp_path / "port" / "pairs.csv")
    jax_ravdess.save_pairs_csv(want, tmp_path / "jax" / "pairs.csv")
    assert (tmp_path / "port" / "pairs.csv").read_bytes() == (tmp_path / "jax" / "pairs.csv").read_bytes()


# --------------------------------------------------------------------------- (b) synthetic


def _decode_all(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("strong, strength", [(False, 1.0), (True, 0.4), (True, 1.0)],
                         ids=["default", "strong_s0.4", "strong_s1.0"])
def test_synthetic_corpus_equals_jax(tmp_path, strong, strength):
    kwargs = dict(actors=(1, 2), emotions=(3, 5), seconds=0.5, size=48, seed=7,
                  clips_per_pair=2, strong_signal=strong, signal_strength=strength)
    n = synthetic.generate_synthetic_ravdess(tmp_path / "port", **kwargs)
    assert n == jax_synthetic.generate_synthetic_ravdess(tmp_path / "jax", **kwargs) == 8
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.*"))
    assert files == sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.*"))
    assert len(files) == 16
    for rel in files:
        got, want = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.suffix == ".wav":
            assert got.read_bytes() == want.read_bytes()
        else:
            frames = _decode_all(got)
            assert frames.shape == (5, 36, 48, 3)
            np.testing.assert_array_equal(frames, _decode_all(want))


def test_make_data_cli_writes_the_corpus(tmp_path, capsys):
    synthetic.main(["--root", str(tmp_path), "--actors", "1", "--emotions", "2,6",
                    "--seconds", "0.5"])
    assert "wrote 2 pairs" in capsys.readouterr().out
    assert len(ravdess.build_pairs(tmp_path)) == 2


# --------------------------------------------------------------------------- (c) media


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("bank_len", [None, 900, 20000], ids=["gauss", "short_bank", "bank"])
def test_mix_bar_noise_equals_jax(seed, bank_len):
    wav = (0.2 * np.random.RandomState(100 + seed).randn(16000)).astype(np.float32)
    bank = None if bank_len is None else np.random.RandomState(7).randn(bank_len).astype(np.float32)
    got = media.mix_bar_noise(wav, bank, np.random.RandomState(seed))
    want = jax_media.mix_bar_noise(wav, bank, np.random.RandomState(seed))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """A face clip and a 1 s WAV, the files the loaders read."""
    from tests.test_data import _write_wav

    root = tmp_path_factory.mktemp("clips")
    _write_video(root / "clip.mp4", _synthetic_face_video(n=12))
    _write_wav(root / "clip.wav", 0.3 * np.random.RandomState(3).randn(16000), 16000)
    return root


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augmented_loaders_equal_jax(clips, decoder, seed):
    bank = np.random.RandomState(5).randn(30000).astype(np.float32)
    for kwargs in ({}, {"noise_bank": bank}):
        got = media.load_audio_wav(clips / "clip.wav", augment=True,
                                   rng=np.random.RandomState(seed), **kwargs)
        want = jax_media.load_audio_wav(clips / "clip.wav", augment=True,
                                        rng=np.random.RandomState(seed), **kwargs)
        np.testing.assert_array_equal(got, want)
    got = media.load_audio_mel(clips / "clip.wav", augment=True, rng=np.random.RandomState(seed))
    want = jax_media.load_audio_mel(clips / "clip.wav", augment=True, rng=np.random.RandomState(seed))
    assert got.shape == want.shape == (1, 64, 301)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)

    frames01 = np.random.RandomState(seed).rand(3, 20, 24, 3).astype(np.float32)
    np.testing.assert_array_equal(
        media.augment_video_frames(frames01, np.random.RandomState(seed)),
        jax_media.augment_video_frames(frames01, np.random.RandomState(seed)))
    for crop in (True, False):
        got = media.load_video_frames(clips / "clip.mp4", 4, 32, augment=True, use_face_crop=crop,
                                      rng=np.random.RandomState(seed))
        want = jax_media.load_video_frames(clips / "clip.mp4", 4, 32, augment=True,
                                           use_face_crop=crop, rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)
        got = media.load_video_frames_u8(clips / "clip.mp4", 4, 32, augment=True,
                                         use_face_crop=crop, rng=np.random.RandomState(seed))
        want = jax_media.load_video_frames_u8(clips / "clip.mp4", 4, 32, augment=True,
                                              use_face_crop=crop, rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_noise_bank_is_read_and_cached(tmp_path, monkeypatch):
    from tests.test_data import _write_wav

    monkeypatch.setattr(media, "_noise_cache", {})
    assert media.load_noise_bank(tmp_path / "absent.wav") is None
    _write_wav(tmp_path / "noise.wav", 0.1 * np.random.RandomState(1).randn(8000), 8000)
    bank = media.load_noise_bank(tmp_path / "noise.wav")
    np.testing.assert_array_equal(bank, jax_media.load_noise_bank(tmp_path / "noise.wav"))
    assert bank.shape == (16000,) and media.load_noise_bank(tmp_path / "noise.wav") is bank
    (tmp_path / "noise.wav").write_bytes(b"not a wav")
    assert media.load_noise_bank(tmp_path / "noise.wav", 8000) is None


# --------------------------------------------------------------------------- (d) loaders


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    """3 actors x 2 emotions of 0.5 s; actor 3's second audio file is gone,
    so 5 pairs: train actors 1 and 3 (3 pairs, a padded tail at batch 2), val
    actor 2."""
    root = tmp_path_factory.mktemp("tiny")
    synthetic.generate_synthetic_ravdess(root, actors=(1, 2, 3), emotions=(3, 5), seconds=0.5,
                                         size=64, seed=3)
    (root / "Actor_03" / "03-01-05-01-01-01-03.wav").unlink()
    return root


def _batch_fields(batch):
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_loaders_give_jax_batches_over_two_epochs(tiny_corpus, tmp_path, monkeypatch, decoder, wire):
    monkeypatch.chdir(tmp_path)
    common = dict(data_root=str(tiny_corpus), split_mode="actor", train_actors=(1, 3),
                  val_actors=(2,), test_actors=(4,), seed=11)
    port = pipeline.build_loaders(
        DataConfig(**common, video=VideoConfig(num_frames=2, size=32)), 2, num_workers=2,
        wire=wire)
    csv = (tmp_path / "pairs.csv").read_bytes()
    ref = jax_pipeline.build_loaders(
        JaxDataConfig(**common, video=JaxVideoConfig(num_frames=2, size=32)), 2, num_workers=2,
        wire=wire)
    assert (tmp_path / "pairs.csv").read_bytes() == csv
    assert [loader.num_samples for loader in port] == [3, 2, 0]
    for epoch in range(2):
        for got_loader, want_loader in zip(port, ref):
            got, want = list(got_loader), list(want_loader)
            assert len(got) == len(want) == len(got_loader)
            for g, w in zip(got, want):
                g, w = _batch_fields(g), _batch_fields(w)
                assert g.keys() == w.keys()
                for key in g:
                    if key in ("meta",) or g[key] is None:
                        assert g[key] == w[key], key
                    else:
                        assert g[key].dtype == w[key].dtype, key
                        np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    train = list(port[0])  # a third epoch: the padded tail
    assert [b.size for b in train] == [2, 1] and train[1].valid.tolist() == [True, False]
    assert not train[1].video[1].any() and not train[1].audio[1].any()
    if wire == "uint8":
        assert train[0].video.dtype == np.uint8 and train[1].aug[1].tolist() == [1.0, 0.0]


def test_loader_raises_what_a_sample_raised(tiny_corpus):
    cfg = DataConfig(data_root=str(tiny_corpus), video=VideoConfig(num_frames=2, size=32))
    pairs = ravdess.build_pairs(tiny_corpus)
    bad = dataclasses.replace(pairs[1], audio_path=tiny_corpus / "missing.wav")
    loader = pipeline.BatchedLoader([pairs[0], bad], pipeline.EmotionSampleLoader(cfg), 1,
                                    num_threads=2)
    with pytest.raises(FileNotFoundError):
        list(loader)
    assert pipeline.auto_num_threads(3) == 3 and pipeline.auto_num_threads(0) == 1
    assert 2 <= pipeline.auto_num_threads() <= 8


# --------------------------------------------------------------------------- (e) mix_noise_snr


@pytest.mark.parametrize("key", range(8))
def test_mix_noise_snr_equals_jax_on_the_jax_draws(key):
    rs = np.random.RandomState(key)
    wav = (0.1 * rs.randn(1600)).astype(np.float32)
    bank = rs.randn(4000).astype(np.float32)
    rng = jax.random.PRNGKey(key)
    want = np.asarray(jax_stochastic.mix_noise_snr(rng, jnp.asarray(wav), jnp.asarray(bank)))
    # The JAX function's three draws, replayed from its key.
    r_level, r_snr, r_start = jax.random.split(rng, 3)
    draws = [torch.tensor(np.asarray(x)) for x in (
        jax.random.uniform(r_level), jax.random.randint(r_snr, (), 0, 3),
        jax.random.randint(r_start, (), 0, 4000 - 1600 + 1))]
    got = stochastic._mix_noise_snr(torch.from_numpy(wav), torch.from_numpy(bank), *draws,
                                    0.5, 0.1, (20.0, 15.0, 10.0), 5.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_mix_noise_snr_curriculum_shares():
    rs = np.random.RandomState(0)
    wav = torch.from_numpy((0.1 * rs.randn(400)).astype(np.float32))
    bank = torch.from_numpy(rs.randn(1000).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    n, counts = 4000, {"clean": 0, "light": 0, "heavy": 0}
    power = float((wav**2).mean())
    for _ in range(n):
        noise = stochastic.mix_noise_snr(gen, wav, bank) - wav
        if not noise.any():
            counts["clean"] += 1
            continue
        snr = 10 * np.log10(power / float((noise**2).mean()))
        assert min(abs(snr - s) for s in (5, 10, 15, 20)) < 0.01
        counts["heavy" if abs(snr - 5) < 0.01 else "light"] += 1
    for name, p in (("clean", 0.5), ("light", 0.4), ("heavy", 0.1)):
        assert abs(counts[name] / n - p) <= 3 * np.sqrt(p * (1 - p) / n), counts
    with pytest.raises(ValueError, match="noise bank"):
        stochastic.mix_noise_snr(gen, wav, bank[:100])
