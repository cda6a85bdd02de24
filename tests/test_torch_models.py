"""The port's modules against the JAX package's, on the CPU in float32.

The JAX side is initialised (`jax.jit(model.init)`), its weights go to the
port through `convert/params.py::flax_params_to_state_dict` (checked against
`convert/torch_import.py::flax_to_torch_state_dict`) and load with
`load_state_dict(strict=True)`; the same numpy inputs go through both.
Small geometry: the `SMALL` WavLM of the JAX suite, d_model 32, 4 frames of
32x32.  On the CPU the port's kernel wrappers run their plain versions; the
JAX kernels run in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from multimodalemotionrecognition_tpu.config import ModelConfig
from multimodalemotionrecognition_tpu.convert.torch_import import (
    flax_to_torch_state_dict,
    torch_state_dict_to_flax,
)
from multimodalemotionrecognition_tpu.models.factory import build_model as jax_build_model
from multimodalemotionrecognition_tpu.models.temporal import TemporalPooler as JaxTemporalPooler
from multimodalemotionrecognition_torch.config import WavLMConfig
from multimodalemotionrecognition_torch.convert.params import flax_params_to_state_dict
from multimodalemotionrecognition_torch.models import (
    TemporalPooler,
    VideoNet,
    WavLMModel,
    build_model,
)

from tests.helpers import randomize_bn_stats
from tests.test_wavlm_fused_attn import SMALL

VIDEO = (2, 4, 3, 32, 32)
AUDIO = (2, 1, 4000)
MODULAR = dict(fused_attention=False, fused_conv=False)


def _config(**overrides) -> ModelConfig:
    base = dict(
        fusion="xattn", use_wavlm=True, spec_augment=False, xattn_d_model=32,
        xattn_attn_dropout=0.0, xattn_stochastic_depth=0.0,
        wavlm_geometry=dict(SMALL, **MODULAR),
    )
    return ModelConfig(**{**base, **overrides})


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    video = rng.randn(*VIDEO).astype(np.float32)
    audio = (rng.randn(*AUDIO) * 0.1).astype(np.float32)
    return video, audio


def _jax_init(model, *inputs):
    return jax.jit(model.init)(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))


def _jax_apply(model, variables, *inputs, method=None):
    fn = jax.jit(lambda v, *xs: model.apply(v, *xs, method=method))
    return fn(variables, *map(jnp.asarray, inputs))


def _sub_state_dict(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def flagship():
    """The flagship (concat head, mean pooling) at small widths:
    (JAX model, JAX variables, port state dict)."""
    cfg = _config()
    model = jax_build_model(cfg)
    variables = _jax_init(model, *_inputs())
    return model, variables, flax_params_to_state_dict(flatten_dict(variables))


def test_params_export_matches_flax_export(flagship):
    _, variables, sd = flagship
    ref = flax_to_torch_state_dict(variables)
    assert sd.keys() == ref.keys()
    for key, value in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize(
    "overrides",
    [{}, {"xattn_head": "gated", "temporal_pooling": "attn", "xattn_use_emotion_prior": True}],
    ids=["flagship", "gated_attn_prior"],
)
def test_state_dict_keys_equal_jax_init_leaves(overrides):
    """The port declares exactly the leaves the JAX init creates."""
    cfg = _config(**overrides)
    template = jax.eval_shape(
        lambda: jax_build_model(cfg).init(
            jax.random.PRNGKey(0), jnp.zeros(VIDEO), jnp.zeros(AUDIO)
        )
    )
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
    assert build_model(cfg, device="cpu").state_dict().keys() == flax_to_torch_state_dict(zeros).keys()


@pytest.mark.parametrize("fused", [False, True], ids=["modular", "kernels"])
def test_wavlm_model_matches_jax(flagship, fused):
    jmodel, variables, sd = flagship
    jax_mode = "interpret" if fused else False
    jcfg = dataclasses.replace(
        _config(), wavlm_geometry=dict(SMALL, fused_attention=jax_mode, fused_conv=jax_mode)
    )
    _, audio = _inputs(1)
    want = _jax_apply(
        jax_build_model(jcfg), variables, audio,
        method=lambda m, a: m.audio_model.encode_sequence(a),
    )
    port = WavLMModel(WavLMConfig(**SMALL, fused_attention=fused, fused_conv=fused))
    port.load_state_dict(_sub_state_dict(sd, "audio_model.wavlm."), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(audio[:, 0]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_video_encode_frames_matches_jax(flagship):
    """Through the port's random BN statistics, sent back to JAX."""
    jmodel, variables, sd = flagship
    port = VideoNet()
    port.load_state_dict(_sub_state_dict(sd, "video_model."), strict=True)
    randomize_bn_stats(port, seed=3)
    back, report = torch_state_dict_to_flax(
        {f"video_model.{k}": v for k, v in port.state_dict().items()}, variables, strict=False
    )
    assert not report.missing_flax_paths or all(
        not p.split(":")[1].startswith("video_model") for p in report.missing_flax_paths
    )
    video, _ = _inputs(2)
    want = _jax_apply(jmodel, back, video, method=lambda m, v: m.video_model.encode_frames(v))
    with torch.no_grad():
        got = port.eval().encode_frames(torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["mean", "attn"])
def test_temporal_pooler_matches_jax(mode):
    x = np.random.RandomState(4).randn(2, 11, 32).astype(np.float32)
    jpool = JaxTemporalPooler(dim=32, mode=mode)
    variables = jpool.init(jax.random.PRNGKey(1), jnp.asarray(x))
    port = TemporalPooler(32, mode)
    port.load_state_dict(flax_params_to_state_dict(flatten_dict(variables)), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(_jax_apply(jpool, variables, x)), atol=1e-5
    )


def test_flagship_fusion_matches_jax(flagship):
    jmodel, variables, sd = flagship
    video, audio = _inputs(5)
    want, _ = _jax_apply(jmodel, variables, video, audio)
    port = build_model(_config(), device="cpu")
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(video), torch.from_numpy(audio))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize(
    "overrides",
    [
        {"xattn_head": "gated", "temporal_pooling": "attn"},
        {"xattn_head": "concat", "xattn_use_emotion_prior": True},
    ],
    ids=["gated_attn", "concat_prior"],
)
def test_fusion_variants_match_jax(overrides):
    cfg = _config(**overrides)
    jmodel = jax_build_model(cfg)
    video, audio = _inputs(6)
    variables = _jax_init(jmodel, video, audio)
    want, _ = _jax_apply(jmodel, variables, video, audio)
    port = build_model(cfg, device="cpu")
    port.load_state_dict(flax_params_to_state_dict(flatten_dict(variables)), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(video), torch.from_numpy(audio))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize(
    "overrides",
    [{"fusion": "early"}, {"compute_dtype": "float16"}, {"temporal_pooling": "lstm"}],
    ids=["unknown_fusion", "unknown_dtype", "unknown_pooling"],
)
def test_unported_configs_raise(overrides):
    """Every mode of the JAX factory builds (`tests/test_torch_families.py`
    holds each against the JAX package); what neither package has raises
    `ValueError`, as there."""
    with pytest.raises(ValueError):
        build_model(_config(**overrides), device="cpu")
    with pytest.raises(ValueError):
        jax_build_model(_config(**overrides)).init(
            jax.random.PRNGKey(0), jnp.zeros(VIDEO), jnp.zeros(AUDIO)
        )


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(_config())
