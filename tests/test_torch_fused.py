"""The port's fusion-block functions (K4, K5) against the JAX package's
Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the Pallas
kernels run in interpret mode, as `tests/test_pallas_xattn.py` runs them.
Same numpy parameters and inputs on both sides, float32, logits and
embeddings at atol 5e-5.  Small widths: d_model 32, 4 heads, 8 video and 21
audio tokens (odd, as the serving path's 149), tower widths 24 and 40.
"""

import types
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from multimodalemotionrecognition_tpu.config import ModelConfig as JaxModelConfig
from multimodalemotionrecognition_tpu.models.fusion import FusionModel as JaxFusionModel
from multimodalemotionrecognition_tpu.ops import pallas_fused_block, pallas_xattn
from multimodalemotionrecognition_tpu.runtime import fused as jax_fused
from multimodalemotionrecognition_tpu.runtime.runner import JaxModelRunner
from multimodalemotionrecognition_torch.config import ModelConfig
from multimodalemotionrecognition_torch.convert.params import (
    flax_params_to_state_dict,
    state_dict_key,
)
from multimodalemotionrecognition_torch.kernels import (
    FusedBlockSpec,
    extract_block_params,
    fused_bidirectional_xattn,
    fused_bidirectional_xattn_plain,
    fused_block,
    fused_block_plain,
    xattn_params_from_state_dict,
)
from multimodalemotionrecognition_torch.models.fusion import FusionModel
from multimodalemotionrecognition_torch.runtime.fused import supports_fused
from multimodalemotionrecognition_torch.runtime.quant import quantize_linears_int8

B, T, TA, D, H, DV, DS, C = 8, 8, 21, 32, 4, 24, 40, 8
ATOL = 5e-5
VARIANTS = [("mean", "concat", False), ("attn", "gated", False), ("attn", "concat", True)]
VARIANT_IDS = ["mean_concat", "attn_gated", "attn_concat_prior"]


class _FrameStub(nn.Module):
    def encode_frames(self, video, train=False):
        return video


class _SeqStub(nn.Module):
    def encode_sequence(self, audio, train=False):
        return audio


class _Tower(torch.nn.Module):
    def __init__(self, width):
        super().__init__()
        self.embedding_dim = self.sequence_dim = width

    def encode_sequence(self, x, *train):
        return x


def _block(pooling, head, prior, seed=0):
    """-> (JAX variables with every leaf random, inputs, spec, port model)."""
    jmodel = JaxFusionModel(
        audio_model=_SeqStub(), video_model=_FrameStub(), num_classes=C,
        mode="xattn", xattn_head=head, d_model=D, num_heads=H,
        xattn_attn_dropout=0.0, xattn_stochastic_depth=0.0,
        temporal_pooling=pooling, xattn_use_emotion_prior=prior,
    )
    rng = np.random.RandomState(seed)
    v = rng.randn(B, T, DV).astype(np.float32)
    a = rng.randn(B, TA, DS).astype(np.float32)
    template = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(v), jnp.asarray(a))
    flat = {}
    for path, leaf in flatten_dict(template).items():
        value = np.asarray(rng.randn(*leaf.shape), np.float32)
        if leaf.ndim >= 2:
            value = value / np.sqrt(leaf.shape[0])
        elif path[-1] in ("scale", "bias_scale"):
            value = 1.0 + 0.1 * value
        else:
            value = 0.1 * value
        flat[path] = value.astype(np.float32)
    port = FusionModel(
        _Tower(DS), _Tower(DV), num_classes=C, xattn_head=head, d_model=D, num_heads=H,
        temporal_pooling=pooling, xattn_use_emotion_prior=prior,
    ).eval()
    port.load_state_dict(flax_params_to_state_dict(flat), strict=True)
    spec = dict(num_heads=H, d_model=D, pooling=pooling, head=head, use_prior=prior,
                num_classes=C)
    return unflatten_dict(flat), v, a, spec, port


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("samples_per_program", [1, 8])
@pytest.mark.parametrize("pooling,head,prior", VARIANTS, ids=VARIANT_IDS)
def test_fused_block_matches_pallas_kernel(pooling, head, prior, samples_per_program, int8):
    variables, v, a, spec, port = _block(pooling, head, prior)
    scales = {}
    if int8:
        holder = types.SimpleNamespace(_dequant_scales=scales)
        variables = JaxModelRunner._quantize_dense_int8(holder, variables)
        quantised = quantize_linears_int8(port)
        assert {("params", *name.split("."), "kernel") for name in quantised} == {
            tuple(part for element in path for part in element.split(".")) for path in scales
        }
    jspec = pallas_fused_block.FusedBlockSpec(**spec)
    args, layout = pallas_fused_block.extract_block_params(variables["params"], jspec, scales)
    assert any(quantized for _, quantized in layout) == int8
    fn = pallas_fused_block.build_fused_block_fn(
        jspec, layout, interpret=True, samples_per_program=samples_per_program
    )
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(a), *args))

    pspec = FusedBlockSpec(**spec)
    params = extract_block_params(port.state_dict(), pspec)
    assert set(params.scales) == {name for name, quantized in layout if quantized}
    got = fused_block(torch.from_numpy(v), torch.from_numpy(a), params, pspec)
    assert got.shape == (B, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("pooling,head,prior", VARIANTS, ids=VARIANT_IDS)
def test_fused_block_matches_the_modular_fusion_model(pooling, head, prior):
    """K4's plain version == the port's FusionModel on the same weights."""
    _, v, a, spec, port = _block(pooling, head, prior, seed=1)
    port.video_model.encode_frames = lambda x, *train: x
    port.audio_model.encode_sequence = lambda x, *train: x
    with torch.no_grad():
        want = port(torch.from_numpy(v), torch.from_numpy(a))
    pspec = FusedBlockSpec(**spec)
    got = fused_block_plain(
        torch.from_numpy(v), torch.from_numpy(a),
        extract_block_params(port.state_dict(), pspec), pspec,
    )
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_fused_block_takes_bfloat16_towers_and_computes_in_float32():
    _, v, a, spec, port = _block("mean", "concat", False, seed=2)
    pspec = FusedBlockSpec(**spec)
    params = extract_block_params(port.state_dict(), pspec)
    v16, a16 = torch.from_numpy(v).bfloat16(), torch.from_numpy(a).bfloat16()
    got = fused_block(v16, a16, params, pspec)
    assert got.dtype == torch.float32
    torch.testing.assert_close(
        got, fused_block(v16.float(), a16.float(), params, pspec), atol=1e-6, rtol=0
    )


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_xattn_core_matches_pallas_kernel(bias):
    variables, _, _, _, port = _block("mean", "concat", False, seed=3)
    rng = np.random.RandomState(4)
    v = rng.randn(2, T, D).astype(np.float32)
    a = rng.randn(2, TA, D).astype(np.float32)
    biases = (None, None)
    if bias:
        biases = (
            (rng.randn(2, T, TA) * 0.1).astype(np.float32),
            (rng.randn(2, TA, T) * 0.1).astype(np.float32),
        )
    jparams = pallas_xattn.xattn_params_from_variables(
        jax.tree_util.tree_map(jnp.asarray, variables["params"])
    )
    want = pallas_xattn.fused_bidirectional_xattn(
        jparams, jnp.asarray(v), jnp.asarray(a),
        *(None if x is None else jnp.asarray(x) for x in biases),
        num_heads=H, interpret=True,
    )
    params = xattn_params_from_state_dict(port.state_dict())
    got = fused_bidirectional_xattn(
        params, torch.from_numpy(v), torch.from_numpy(a),
        *(None if x is None else torch.from_numpy(x) for x in biases), num_heads=H,
    )
    for g, w in zip(got, want):
        assert g.shape == (2, D)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_fusion_wrappers_run_the_plain_version_on_cpu_without_counting():
    _, v, a, spec, port = _block("attn", "gated", True, seed=5)
    pspec = FusedBlockSpec(**spec)
    params = extract_block_params(port.state_dict(), pspec)
    vt, at = torch.from_numpy(v), torch.from_numpy(a)
    n4, n5 = fused_block.launches, fused_bidirectional_xattn.launches
    torch.testing.assert_close(
        fused_block(vt, at, params, pspec), fused_block_plain(vt, at, params, pspec),
        atol=0, rtol=0,
    )
    xp = xattn_params_from_state_dict(port.state_dict())
    tokens = torch.randn(2, T, D), torch.randn(2, TA, D)
    for g, w in zip(
        fused_bidirectional_xattn(xp, *tokens, num_heads=H),
        fused_bidirectional_xattn_plain(xp, *tokens, num_heads=H),
    ):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert fused_block.launches == n4 and fused_bidirectional_xattn.launches == n5


@pytest.mark.parametrize(
    "change,error",
    [
        (lambda v, a, p, s: (v.double(), a, p, s), TypeError),
        (lambda v, a, p, s: (v, a[:3], p, s), ValueError),
        (lambda v, a, p, s: (v[..., :-1], a, p, s), ValueError),
        (lambda v, a, p, s: (v, a, p, FusedBlockSpec(**{**s.__dict__, "pooling": "transformer"})),
         ValueError),
        (lambda v, a, p, s: (v, a, p, FusedBlockSpec(**{**s.__dict__, "num_heads": 5})),
         ValueError),
    ],
    ids=["dtype", "batch", "tower_width", "pooling", "heads"],
)
def test_fused_block_wrapper_rejects_bad_inputs(change, error):
    _, v, a, spec, port = _block("mean", "concat", False, seed=6)
    pspec = FusedBlockSpec(**spec)
    params = extract_block_params(port.state_dict(), pspec)
    with pytest.raises(error):
        fused_block(*change(torch.from_numpy(v), torch.from_numpy(a), params, pspec))


def test_xattn_wrapper_rejects_bad_inputs():
    port = _block("mean", "concat", False, seed=7)[4]
    params = xattn_params_from_state_dict(port.state_dict())
    v, a = torch.randn(2, T, D), torch.randn(2, TA, D)
    with pytest.raises(ValueError, match="both attention biases"):
        fused_bidirectional_xattn(params, v, a, torch.zeros(2, T, TA), None, num_heads=H)
    with pytest.raises(ValueError, match="bias shapes"):
        fused_bidirectional_xattn(
            params, v, a, torch.zeros(2, T, TA), torch.zeros(2, T, TA), num_heads=H
        )
    with pytest.raises(ValueError, match="does not match"):
        fused_bidirectional_xattn(params, v, a[:, :, :-1], num_heads=H)
    with pytest.raises(ValueError, match="num_heads"):
        fused_bidirectional_xattn(params, v, a, num_heads=5)


@pytest.mark.parametrize(
    "t,ta,d,heads,takes",
    [
        (8, 149, 128, 4, True),  # the serving shapes
        (8, 16, 128, 4, True),
        (16, 1, 32, 8, True),  # the most video tokens and heads, one audio token
        (8, 149, 96, 8, True),  # a head width of 12
        (17, 149, 128, 4, False),  # T past 16
        (8, 149, 48, 4, False),  # d not a multiple of 32
        (8, 149, 160, 4, False),  # d past 128
        (8, 149, 128, 16, False),  # more heads than a cluster holds
        (16, 6000, 128, 4, False),  # the video side's probabilities past shared memory
    ],
)
def test_xattn_tensor_core_route_takes_the_shapes_it_should(t, ta, d, heads, takes):
    """K5's route rule (`xattn.tensor_core_route`): shape logic only."""
    from multimodalemotionrecognition_torch.kernels import xattn

    v, a = torch.empty(2, t, d), torch.empty(2, ta, d)
    assert xattn.tensor_core_route(v, a, heads) is takes
    smem = xattn.tc_smem_bytes(t, ta, d, heads)
    assert set(smem) == {"rows", "video", "audio"}
    assert (max(smem.values()) <= 227 * 1024) or not takes
    # The workspace: K and V, Q of the audio rows; Q of the video rows; K and
    # V of v'; the column sums of a' per 16-row tile (each rounded to 4 floats).
    tiles = -(-ta // 16)
    assert xattn.tc_workspace_floats(2, t, ta, d) == sum(
        -(-n // 4) * 4 for n in (2 * ta * 2 * d, 2 * ta * d, 2 * t * d, 2 * t * 2 * d, 2 * tiles * d))


def test_xattn_tensor_core_mirrors_follow_the_header():
    """`xattn.tc_smem_bytes` and `tc_workspace_floats` against the formulas
    of csrc/xattn_tc.cuh, and the serving shapes' sizes."""
    from multimodalemotionrecognition_torch.kernels import xattn

    src = (Path(xattn.__file__).resolve().parent / "csrc" / "xattn_tc.cuh").read_text()
    assert "return 1024 + kBaseBytes + 4 * (size_t)kRows * x_stride(p.d);" in src
    assert "4 * (size_t)p.T * (3 * x_stride(dh) + x_stride(p.Ta) + 4 * x_stride(p.d));" in src
    assert ("4 * ((size_t)5 * kRows * x_stride(p.d) + (size_t)p.T * (2 * p.d + 4) +\n"
            "              (size_t)kRows * p.H * p.T);") in src
    assert "const size_t sizes[5] = {ra * 2 * d, ra * d, rv * d, rv * 2 * d," in src
    assert "(size_t)p.B * audio_tiles(p.Ta) * d};" in src
    assert xattn.tc_smem_bytes(8, 149, 128, 4) == {"rows": 76_544, "video": 93_696, "audio": 120_704}
    assert xattn.tc_workspace_floats(8, 8, 149, 128) == (
        8 * 149 * 256 + 8 * 149 * 128 + 64 * 128 + 64 * 256 + 8 * 10 * 128)


@pytest.mark.parametrize(
    "overrides,expected",
    [
        ({}, True),
        ({"temporal_pooling": "attn", "xattn_head": "gated"}, True),
        ({"fusion": "xattn_gated"}, True),
        ({"temporal_pooling": "transformer"}, False),
        ({"fusion": "late"}, False),
    ],
    ids=["flagship", "attn_gated", "alias", "transformer_pool", "late"],
)
def test_supports_fused_matches_jax(overrides, expected):
    assert supports_fused(ModelConfig(**overrides)) is expected
    assert jax_fused.supports_fused(JaxModelConfig(**overrides)) is expected


def test_state_dict_key_maps_flax_paths():
    assert state_dict_key(("params", "v2a_attn", "out_proj", "kernel")) == "v2a_attn.out_proj.weight"
    assert state_dict_key(("params", "v2a_attn", "in_proj_kernel")) == "v2a_attn.in_proj_weight"
    assert state_dict_key(("params", "a.b", "bn", "scale")) == "a.b.bn.weight"
    assert state_dict_key(("batch_stats", "bn", "mean")) == "bn.running_mean"
    assert state_dict_key(("params", "bias_scale")) == "bias_scale"
