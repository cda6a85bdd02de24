"""The mel front end, the adaptive pool and SpecAugment of the port against
the JAX package's, on the CPU.

Tolerance of the log-mel spectrogram: 5e-4 dB absolute.  Both sides run the
same two float32 products on the same constants; the sums run in another
order, and 10*log10 turns a relative error of 1e-5 in a power into 4e-5 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalemotionrecognition_tpu.ops import image as jax_image
from multimodalemotionrecognition_tpu.ops import mel as jax_mel
from multimodalemotionrecognition_tpu.ops import stochastic as jax_stochastic
from multimodalemotionrecognition_torch.ops import image, mel, stochastic

DB_ATOL = 5e-4


def _wave(shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32)


def test_constants_equal_the_jax_package():
    np.testing.assert_array_equal(mel._dft_basis_np(400, 400), jax_mel._dft_basis_np(400, 400))
    np.testing.assert_array_equal(mel._dft_basis_np(400, 320), jax_mel._dft_basis_np(400, 320))
    assert mel._dft_basis_np(400, 400).shape == (400, 402)
    args = (201, 0.0, 8000.0, 64, 16000)
    np.testing.assert_array_equal(mel._mel_filterbank_np(*args), jax_mel._mel_filterbank_np(*args))
    np.testing.assert_array_equal(mel.mel_filterbank().numpy(), np.asarray(jax_mel.mel_filterbank()))


@pytest.mark.parametrize("shape", [(2, 48000), (3, 1, 8000), (4000,)], ids=["b2_3s", "b3x1", "one"])
def test_log_mel_matches_jax(shape):
    wav = _wave(shape)
    want = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(wav)))
    got = mel.log_mel_spectrogram(torch.from_numpy(wav))
    assert got.shape == want.shape and got.dtype == torch.float32
    if shape == (2, 48000):
        assert got.shape == (2, 64, 301)
    np.testing.assert_allclose(got.numpy(), want, atol=DB_ATOL, rtol=0)


def test_numpy_twin_matches_jax_and_the_tensor_version():
    wav = _wave((2, 16000), seed=1)
    got = mel.log_mel_spectrogram_np(wav)
    np.testing.assert_allclose(got, jax_mel.log_mel_spectrogram_np(wav), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        got, mel.log_mel_spectrogram(torch.from_numpy(wav)).numpy(), atol=DB_ATOL, rtol=0
    )


@pytest.mark.parametrize("power,n_mels", [(2.0, 64), (1.0, 40)])
def test_mel_spectrogram_options_match_jax(power, n_mels):
    wav = _wave((2, 8000), seed=2)
    kw = dict(n_mels=n_mels, power=power, f_min=50.0, f_max=7000.0)
    want = np.asarray(jax_mel.mel_spectrogram(jnp.asarray(wav), **kw))
    got = mel.mel_spectrogram(torch.from_numpy(wav), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6 * want.max())


@pytest.mark.parametrize("stype,top_db", [("power", None), ("magnitude", 60.0)])
def test_amplitude_to_db_matches_jax(stype, top_db):
    x = np.abs(np.random.RandomState(3).randn(3, 20, 30)).astype(np.float32) ** 4
    want = np.asarray(jax_mel.amplitude_to_db(jnp.asarray(x), stype=stype, top_db=top_db))
    got = mel.amplitude_to_db(torch.from_numpy(x), stype=stype, top_db=top_db).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_silence_hits_the_floor():
    out = mel.log_mel_spectrogram(torch.zeros(1, 4000))
    assert torch.equal(out, torch.full_like(out, -100.0))


@pytest.mark.parametrize(
    "size,out", [((9, 38), (1, 16)), ((7, 16), (3, 5)), ((4, 32), (1, 16))],
    ids=["bins_do_not_divide", "both_axes", "bins_divide"],
)
def test_adaptive_avg_pool_matches_jax(size, out):
    """`F.adaptive_avg_pool2d` has the bins of the JAX package's averaging
    matrices, also where the output size does not divide the input's."""
    x = np.random.RandomState(4).randn(2, 3, *size).astype(np.float32)
    want = np.asarray(jax_image.adaptive_avg_pool_2d(jnp.asarray(x), out))
    got = image.adaptive_avg_pool_2d(torch.from_numpy(x), out)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _mask_stats(masked: np.ndarray):
    """(applied, masked mel rows, masked frames) of one SpecAugment draw on ones."""
    rows = (masked == 0).all(axis=-1).sum()
    cols = (masked == 0).all(axis=-2).sum()
    return bool(rows or cols), int(rows), int(cols)


def test_spec_augment_distribution_matches_jax():
    """Behavioural, not bitwise, equivalence: the share of draws that mask
    anything and the mean masked width per axis, over 400 draws each (the
    share's standard error is 0.025, the widths' under 1)."""
    n, shape = 400, (2, 1, 64, 301)
    ones = np.ones(shape, np.float32)
    jitted = jax.jit(jax_stochastic.spec_augment)
    want = [_mask_stats(np.asarray(jitted(jax.random.PRNGKey(i), jnp.asarray(ones)))[0, 0])
            for i in range(n)]
    gen = torch.Generator().manual_seed(0)
    got = [_mask_stats(stochastic.spec_augment(gen, torch.from_numpy(ones)).numpy()[0, 0])
           for _ in range(n)]
    want, got = np.array(want, float), np.array(got, float)
    assert abs(got[:, 0].mean() - want[:, 0].mean()) < 0.1
    assert abs(got[:, 0].mean() - 0.5) < 0.08
    applied_w, applied_g = want[want[:, 0] > 0], got[got[:, 0] > 0]
    # Two masks of mean length 10 (mel) and 20 (time), less their overlap.
    assert abs(applied_g[:, 1].mean() - applied_w[:, 1].mean()) < 2.5
    assert abs(applied_g[:, 2].mean() - applied_w[:, 2].mean()) < 5.0
    assert got[:, 1].max() <= 40 and got[:, 2].max() <= 80


def test_spec_augment_is_deterministic_batch_shared_and_zero_filled():
    x = torch.from_numpy(np.random.RandomState(5).randn(3, 1, 64, 301).astype(np.float32))
    outs = [stochastic.spec_augment(torch.Generator().manual_seed(7), x) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    gen = torch.Generator().manual_seed(8)
    for _ in range(20):
        y = stochastic.spec_augment(gen, x)
        changed = y != x
        assert torch.equal(changed[0], changed[1]) and torch.equal(changed[0], changed[2])
        assert (y[changed] == 0).all()
    assert torch.equal(stochastic.spec_augment(gen, x, p=0.0), x)  # u <= 0 does not occur
    same = stochastic.spec_augment(gen, x, freq_mask_param=0, time_mask_param=0, p=1.0)
    assert torch.equal(same, x)
