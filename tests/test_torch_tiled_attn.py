"""K6, the batch-tiled WavLM attention sublayer: the port's plain version
against the Pallas kernel `benchmarks/bench_attn_tile.py::_tiled_kernel` in
interpret mode, on the CPU.

The JAX script is loaded by path and its `pallas_call` runs interpreted; its
constants (12 heads, `seq_len` 149, eps 1e-5) are the script's own, so the
small size here is B=4, Tp=160, E=96 (dh = 8).  On the CPU the port's
wrapper runs its plain version.  Tolerances: float32 1e-5 (another sum
order); bfloat16 2e-2 after the LayerNorm (both round the probabilities and
the context rows to bfloat16, at values a float32 rounding apart).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalemotionrecognition_torch.bench import attn_tile
from multimodalemotionrecognition_torch.kernels import (
    wavlm_attention_sublayer_plain,
    wavlm_attention_sublayer_tiled,
    wavlm_attention_sublayer_tiled_plain,
)

B, E = 4, 96
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jax_script():
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "bench_attn_tile.py"
    spec = importlib.util.spec_from_file_location("bench_attn_tile_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpreted(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _operands(dtype: str, seed: int = 0):
    """numpy operands in the script's layout; activations and `wo` are
    rounded to `dtype` first, so both sides start from the same values."""
    rng = np.random.RandomState(seed)
    h, pad = attn_tile.H, attn_tile.PAD
    f32 = np.float32
    ops = [
        rng.randn(B, pad, E).astype(f32), rng.randn(B, pad, E).astype(f32) * f32(0.3),
        rng.randn(B, pad, E).astype(f32) * f32(0.3), rng.randn(B, pad, E).astype(f32) * f32(0.3),
        rng.rand(B, h * pad, 1).astype(f32), rng.randn(h * pad, pad).astype(f32) * f32(0.5),
        rng.randn(E, E).astype(f32) * f32(E**-0.5), rng.randn(1, E).astype(f32) * f32(0.1),
        1.0 + rng.randn(1, E).astype(f32) * f32(0.1), rng.randn(1, E).astype(f32) * f32(0.1),
    ]
    tdt = getattr(torch, dtype)
    tensors = [torch.from_numpy(a) for a in ops]
    for i in (0, 1, 2, 3, 6):
        tensors[i] = tensors[i].to(tdt)
    return tensors


def _to_jax(tensors):
    return [
        jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in tensors
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g_tile", [1, 2, 4])
def test_plain_version_matches_the_pallas_kernel(jax_script, interpreted, dtype, g_tile):
    tensors = _operands(dtype)
    want = jax.jit(functools.partial(jax_script.tiled_call, g_tile))(*_to_jax(tensors))
    got = wavlm_attention_sublayer_tiled(g_tile, *tensors, attn_tile.H, attn_tile.SEQ, attn_tile.EPS)
    assert got.shape == want.shape and got.dtype == tensors[0].dtype
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=0
    )


def test_pallas_kernel_is_the_same_for_every_tile(jax_script, interpreted):
    """The property the experiment asserts before it times anything."""
    tensors = _to_jax(_operands("float32", seed=1))
    ref = np.asarray(jax.jit(functools.partial(jax_script.tiled_call, 1))(*tensors))
    got = np.asarray(jax.jit(functools.partial(jax_script.tiled_call, 2))(*tensors))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g_tile", [2, 4])
def test_plain_version_is_the_same_for_every_tile(dtype, g_tile):
    tensors = _operands(dtype, seed=2)
    args = (*tensors, attn_tile.H, attn_tile.SEQ)
    ref = wavlm_attention_sublayer_tiled_plain(1, *args)
    assert torch.equal(wavlm_attention_sublayer_tiled_plain(g_tile, *args), ref)
    assert torch.equal(wavlm_attention_sublayer_tiled(g_tile, *args), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_k1_plain_below_seq_len(dtype):
    """K1 leaves rows at or past `seq_len` unspecified; below it the two
    plain versions are the same arithmetic (one element at a time against
    the whole batch at once: 1e-6 in float32, one bfloat16 step after the
    LayerNorm)."""
    tensors = _operands(dtype, seed=3)
    seq = attn_tile.SEQ
    got = wavlm_attention_sublayer_tiled_plain(2, *tensors, attn_tile.H, seq)
    want = wavlm_attention_sublayer_plain(*tensors, attn_tile.H, seq)
    atol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        got[:, :seq].float().numpy(), want[:, :seq].float().numpy(), atol=atol, rtol=0
    )


def test_padding_rows_are_computed():
    """All Tp rows are written, as the TPU kernel writes them."""
    tensors = _operands("float32", seed=4)
    out = wavlm_attention_sublayer_tiled(1, *tensors, attn_tile.H, attn_tile.SEQ)
    assert torch.isfinite(out).all()
    assert out[:, attn_tile.SEQ:].abs().max() > 0.1  # LayerNorm rows, not zeros


@pytest.mark.parametrize(
    "dtype,e,heads,seq,takes",
    [
        (torch.bfloat16, 768, 12, 149, True),  # the experiment's shape
        (torch.float32, 768, 12, 160, True),
        (torch.bfloat16, 256, 4, 37, True),
        (torch.float32, 1024, 16, 1, True),
        (torch.bfloat16, 768, 12, 161, False),  # more keys than the route holds
        (torch.float32, 512, 16, 149, False),  # a head width of 32
        (torch.bfloat16, 1152, 18, 16, False),  # E past the LayerNorm's 1024
        (torch.float16, 768, 12, 149, False),
    ],
)
def test_tensor_core_route_takes_the_shapes_it_should(dtype, e, heads, seq, takes):
    """K6's route rule (`wavlm_attn_tiled.tensor_core_route`): K1's
    tensor-core shapes in either dtype; shape logic only."""
    from multimodalemotionrecognition_torch.kernels import wavlm_attn_tiled

    assert wavlm_attn_tiled.tensor_core_route(torch.empty(1, 2, e, dtype=dtype), heads, seq) is takes


def test_refuses_a_tile_that_does_not_divide_the_batch():
    tensors = _operands("float32")
    with pytest.raises(ValueError, match="g_tile"):
        wavlm_attention_sublayer_tiled(3, *tensors, attn_tile.H, attn_tile.SEQ)
    with pytest.raises(ValueError, match="g_tile"):
        wavlm_attention_sublayer_tiled_plain(0, *tensors, attn_tile.H, attn_tile.SEQ)


def test_refuses_a_gradient():
    tensors = _operands("float32")
    tensors[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        wavlm_attention_sublayer_tiled(1, *tensors, attn_tile.H, attn_tile.SEQ)
    with torch.no_grad():
        wavlm_attention_sublayer_tiled(1, *tensors, attn_tile.H, attn_tile.SEQ)


def test_refuses_operands_in_another_layout():
    tensors = _operands("float32")
    tensors[5] = tensors[5].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        wavlm_attention_sublayer_tiled(1, *tensors, attn_tile.H, attn_tile.SEQ)


def test_bench_draws_the_jax_scripts_tensors():
    """`make_tensors` repeats the script's `RandomState(0)` draws in order."""
    hidden, q, _, _, gate, bias, wo, bo, lns, lnb = attn_tile.make_tensors(2, "cpu", e=96)
    rng = np.random.RandomState(0)
    want_hidden = rng.randn(2, attn_tile.PAD, 96).astype(np.float32)
    want_q = rng.randn(2, attn_tile.PAD, 96).astype(np.float32) * 0.1
    np.testing.assert_array_equal(
        hidden.float().numpy(), np.asarray(jnp.asarray(want_hidden, jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(
        q.float().numpy(), np.asarray(jnp.asarray(want_q, jnp.bfloat16), np.float32))
    assert gate.shape == (2, 12 * 160, 1) and gate.dtype == torch.float32
    assert bias.shape == (1920, 160) and wo.dtype == torch.bfloat16 and bo.shape == (1, 96)
    assert torch.equal(lns, torch.ones(1, 96)) and torch.equal(lnb, torch.zeros(1, 96))


def test_bench_main_rehearsed_on_the_cpu(capsys):
    report = attn_tile.main(["--batch", "4", "--tiles", "1,2,4"], device="cpu", e=96, iters=1)
    assert report["metric"] == "wavlm_attn_sublayer_ms_per_layer"
    assert report["unit"] == "ms_b4_bf16" and report["card"] == "cpu"
    assert set(report["results"]) == {"1", "2", "4"} and report["baseline_g1"] == report["results"]["1"]
    assert report["value"] == report["results"][str(report["best_tile"])] and report["k1_ms"] > 0
    assert "numerics identical for G in [1, 2, 4]" in capsys.readouterr().out


def test_bench_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        attn_tile.main(["--batch", "4"])
