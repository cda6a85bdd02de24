"""The traffic generator: deterministic for a seed; the same sizes and gaps
for every seed, in another order."""

from __future__ import annotations

import io

import numpy as np
from scipy.io import wavfile

from perfbench import gen

UPLOADS = {"pool": 6, "level": 4000, "kinds": [[16000, 3.0], [48000, 2.0], [22050, 4.0]]}
BATCHES = {"pool": 2, "batch": 3, "frames": 2, "size": 8, "samples": 100, "audio_level": 0.1,
           "classes": 8}


def test_uploads_repeat_for_a_seed_and_differ_between_seeds():
    a, b, c = gen.uploads(UPLOADS, 2**31 + 11), gen.uploads(UPLOADS, 2**31 + 11), gen.uploads(UPLOADS, 5)
    assert a == b
    assert [x[1] for x in a] != [x[1] for x in c]
    assert [len(x[1]) for x in a] == [len(x[1]) for x in c]


def test_uploads_are_wav_files_of_the_mix():
    for i, (name, data) in enumerate(gen.uploads(UPLOADS, 3)):
        rate, pcm = wavfile.read(io.BytesIO(data))
        want_rate, seconds = UPLOADS["kinds"][i % 3]
        assert rate == want_rate and pcm.dtype == np.int16 and len(pcm) == int(rate * seconds)
        assert name.endswith(".wav")


def test_poisson_schedule_is_fixed_at_its_rate():
    a = gen.poisson_offsets(50.0, 4.0)
    assert np.array_equal(a, gen.poisson_offsets(50.0, 4.0))
    assert len(a) == 200 and np.all(np.diff(a) > 0)
    assert abs(a[-1] - 4.0) < 0.2
    assert abs(np.mean(np.diff(a, prepend=0.0)) - 1 / 50.0) < 1e-3
    gaps = np.diff(a, prepend=0.0)
    assert 0.5 < np.std(gaps) * 50.0 < 1.5  # exponential: the spread of a gap is its mean


def test_train_batches_repeat_for_a_seed():
    a, b, c = (gen.train_batches(BATCHES, s) for s in (9, 9, 10))
    for x, y in zip(a, b):
        assert np.array_equal(x.video, y.video) and np.array_equal(x.audio, y.audio)
        assert np.array_equal(x.labels, y.labels) and np.array_equal(x.aug, y.aug)
    assert not np.array_equal(a[0].video, c[0].video)
    assert a[0].video.dtype == np.uint8 and a[0].video.shape == (3, 2, 3, 8, 8)
    assert a[0].audio.dtype == np.float32 and a[0].valid.all() and a[0].size == 3
    assert ((a[0].aug[:, 0] >= 0.8) & (a[0].aug[:, 0] <= 1.2)).all()
