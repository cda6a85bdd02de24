"""The model families of the port against the JAX package's, on the CPU in
float32: the mel audio branch, the transformer pooler, the late / concat /
gated / audio / video modes of `build_model`, and the measurement entry
points rehearsed at small widths.

As in `tests/test_torch_models.py`: the JAX side is initialised, its weights
go to the port through `flax_params_to_state_dict` (held equal to the JAX
package's `flax_to_torch_state_dict`) and load with `strict=True`, so the
port declares exactly the leaves the JAX init creates; the same numpy inputs
go through both.  Tolerance 1e-4 (float32, other sum orders; the outputs are
logits of order 1).  Small geometry: the `SMALL` WavLM of the JAX suite,
d_model 32, 2 frames of 32x32, mel [64, 101].
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from multimodalemotionrecognition_tpu.config import ModelConfig
from multimodalemotionrecognition_tpu.convert import signature as jax_signature
from multimodalemotionrecognition_tpu.convert.torch_import import flax_to_torch_state_dict
from multimodalemotionrecognition_tpu.models import audio as jax_audio
from multimodalemotionrecognition_tpu.models import temporal as jax_temporal
from multimodalemotionrecognition_tpu.models.factory import build_model as jax_build_model
from multimodalemotionrecognition_tpu.models.fusion import FusionModel as JaxFusionModel
from multimodalemotionrecognition_torch import entry as port_entry
from multimodalemotionrecognition_torch.bench import forward as bench_forward
from multimodalemotionrecognition_torch.convert import checkpoint
from multimodalemotionrecognition_torch.convert.params import flax_params_to_state_dict
from multimodalemotionrecognition_torch.models import (
    AudioCNN,
    AudioResNet18,
    FusionModel,
    TemporalPooler,
    VideoNet,
    build_model,
    init_parameters,
)
from multimodalemotionrecognition_torch.models.temporal import sinusoidal_positional_encoding
from multimodalemotionrecognition_torch.ops.stochastic import RngStreams

from tests.helpers import randomize_bn_stats
from tests.test_wavlm_fused_attn import SMALL

VIDEO = (2, 2, 3, 32, 32)
MEL = (2, 1, 64, 101)
WAV = (2, 1, 4000)
ATOL = 1e-4
MODULAR = dict(fused_attention=False, fused_conv=False)


def _config(**overrides) -> ModelConfig:
    base = dict(
        fusion="xattn", use_wavlm=False, spec_augment=False, xattn_d_model=32,
        xattn_attn_dropout=0.0, xattn_stochastic_depth=0.0,
        wavlm_geometry=dict(SMALL, **MODULAR),
    )
    return ModelConfig(**{**base, **overrides})


def _inputs(cfg: ModelConfig, seed: int):
    rng = np.random.RandomState(seed)
    video = rng.randn(*VIDEO).astype(np.float32)
    if cfg.use_wavlm:
        audio = (rng.randn(*WAV) * 0.1).astype(np.float32)
    else:
        audio = (rng.randn(*MEL) * 10.0 - 20.0).astype(np.float32)  # dB-like
    if cfg.fusion == "audio":
        return [audio]
    return [video] if cfg.fusion == "video" else [video, audio]


def _load(port, variables):
    port.load_state_dict(flax_params_to_state_dict(flatten_dict(variables)), strict=True)
    return port.eval()


# (config overrides, the signature a config-less checkpoint of it infers to)
FAMILIES = {
    "xattn_mel_resnet": (dict(), ("xattn", "concat")),
    "xattn_gated_head_mel_cnn": (
        dict(fusion="xattn_gated", use_resnet_audio=False, temporal_pooling="attn"),
        ("xattn", "gated")),
    "gated_cnn_clip": (
        dict(fusion="gated", use_resnet_audio=False, fusion_align_mode="clip"),
        ("gated", "gated")),
    "concat_wavlm_attn_pool": (
        dict(fusion="concat", use_wavlm=True, temporal_pooling="attn"), ("concat", "concat")),
    "late_mel": (dict(fusion="late"), ("late", "concat")),
    "late_wavlm": (dict(fusion="late", use_wavlm=True), ("late", "concat")),
    "audio_mel": (dict(fusion="audio", use_resnet_audio=False), ("audio", "concat")),
    "audio_wavlm": (dict(fusion="audio", use_wavlm=True), ("audio", "concat")),
    "video": (dict(fusion="video", temporal_pooling="attn"), ("video", "concat")),
    "xattn_wavlm_transformer_pool": (
        dict(use_wavlm=True, temporal_pooling="transformer"), ("xattn", "concat")),
}


@pytest.mark.parametrize("family", FAMILIES)
def test_build_model_matches_jax(family):
    overrides, signature = FAMILIES[family]
    cfg = _config(**overrides)
    inputs = _inputs(cfg, seed=len(family))
    jmodel = jax_build_model(cfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))
    want = jax.jit(lambda v, *xs: jmodel.apply(v, *xs))(variables, *map(jnp.asarray, inputs))
    want, aux = want if isinstance(want, tuple) else (want, None)

    port = build_model(cfg, device="cpu")
    reference = flax_to_torch_state_dict(variables)
    assert port.state_dict().keys() == reference.keys()
    exported = flax_params_to_state_dict(flatten_dict(variables))
    for key, value in reference.items():
        np.testing.assert_array_equal(exported[key].numpy(), value, err_msg=key)
    # The deterministic initialisers are the JAX package's (zero biases but
    # -1.0 in the gate MLPs, bias_scale 1, logit_scale log(1 / 0.07)).
    fresh = port.state_dict()
    for key, value in reference.items():
        if key.rsplit(".", 1)[-1] in ("bias", "in_proj_bias", "bias_scale", "logit_scale",
                                      "running_mean", "running_var"):
            np.testing.assert_array_equal(fresh[key].numpy(), value, err_msg=key)
    _load(port, variables)

    tensors = list(map(torch.from_numpy, inputs))
    with torch.no_grad():
        got = port(*tensors)
        if aux is not None:
            again, port_aux = port(*tensors, return_aux=True)
            assert torch.equal(again, got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if cfg.fusion == "late":  # probabilities, not logits
        np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-6)
        assert (got >= 0).all()
    if aux is not None:
        if aux["alignment_loss"] is None:
            assert port_aux["alignment_loss"] is None
        else:
            np.testing.assert_allclose(
                float(port_aux["alignment_loss"]), float(aux["alignment_loss"]), atol=1e-5)

    sd = port.state_dict()
    assert checkpoint.infer_model_signature(sd) == jax_signature.infer_model_signature(sd)
    assert checkpoint.infer_model_signature(sd) == signature
    assert checkpoint.checkpoint_uses_wavlm(sd) == jax_signature.checkpoint_uses_wavlm(sd)
    assert checkpoint.checkpoint_uses_wavlm(sd) == cfg.use_wavlm


@pytest.mark.parametrize(
    "port_cls,jax_cls", [(AudioCNN, jax_audio.AudioCNN), (AudioResNet18, jax_audio.AudioResNet18)],
    ids=["cnn", "non_residual_resnet18"],
)
def test_audio_encoder_matches_jax_with_random_bn_statistics(port_cls, jax_cls):
    """Eval forward through random BatchNorm statistics, sent to JAX."""
    from multimodalemotionrecognition_tpu.convert.torch_import import torch_state_dict_to_flax

    x = (np.random.RandomState(0).randn(*MEL) * 10.0 - 20.0).astype(np.float32)
    jmodel = jax_cls(embedding_dim=24)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    port = _load(port_cls(24), variables)
    randomize_bn_stats(port, seed=2)
    back, report = torch_state_dict_to_flax(port.state_dict(), variables)
    assert not report.missing_flax_paths and not report.unused_torch_keys
    want = jax.jit(lambda v, a: jmodel.apply(v, a))(back, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 16, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)


def test_audio_encoder_train_mode_follows_the_flax_batchnorm_rule():
    """Batch statistics in the forward, and running statistics that move by
    Flax's rule (momentum 0.9 there, 0.1 here; biased batch variance)."""
    x = (np.random.RandomState(3).randn(4, 1, 64, 37) * 10.0).astype(np.float32)
    jmodel = jax_audio.AudioCNN(embedding_dim=16)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    want, updates = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = _load(AudioCNN(16), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)
    moved = flax_params_to_state_dict(flatten_dict({"batch_stats": updates["batch_stats"]}))
    state = port.state_dict()
    for key, value in moved.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(state[key].numpy(), value.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    assert int(state["features.1.num_batches_tracked"]) == 1


@pytest.mark.parametrize("layers", [1, 2])
def test_transformer_pooler_matches_jax(layers):
    x = np.random.RandomState(4).randn(2, 11, 32).astype(np.float32)
    jpool = jax_temporal.TemporalPooler(dim=32, mode="transformer", num_layers=layers)
    variables = jpool.init(jax.random.PRNGKey(1), jnp.asarray(x))
    port = _load(TemporalPooler(32, "transformer", num_layers=layers), variables)
    assert port.pool.encoder.layers[0].linear1.out_features == 128  # max(2d, 4d)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jpool.apply(variables, jnp.asarray(x))),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("length,dim", [(8, 32), (149, 7), (5, 1)])
def test_positional_encoding_equals_jax(length, dim):
    np.testing.assert_array_equal(
        sinusoidal_positional_encoding(length, dim),
        jax_temporal.sinusoidal_positional_encoding(length, dim),
    )


def test_transformer_pooler_train_mode_draws_from_the_generator():
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 9, 32).astype(np.float32))
    port = TemporalPooler(32, "transformer", dropout=0.3)
    init_parameters(port, torch.Generator().manual_seed(0))
    with torch.no_grad():
        outs = [port(x, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
        evald = port(x)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], evald) and torch.isfinite(outs[0]).all()


class _FrameStub(nn.Module):
    embedding_dim: int = 24

    def encode_frames(self, video, train=False):
        return video


class _MelStub(nn.Module):
    """An audio encoder without `encode_sequence`: the fusion's mel fallback."""


class _Tower(torch.nn.Module):
    def __init__(self, width):
        super().__init__()
        self.embedding_dim = width

    def encode_frames(self, x, *train):
        return x


def test_mel_fallback_conv_matches_jax():
    """`audio_time_conv` (Conv1d k=3 over [B, Ta, n_mels]) exists only for an
    audio encoder without a sequence interface."""
    rng = np.random.RandomState(6)
    v = rng.randn(2, 4, 24).astype(np.float32)
    mel = rng.randn(2, 1, 20, 33).astype(np.float32)
    jmodel = JaxFusionModel(
        audio_model=_MelStub(), video_model=_FrameStub(), num_classes=5, mode="xattn",
        d_model=16, num_heads=2, audio_n_mels=20, xattn_attn_dropout=0.0,
        xattn_stochastic_depth=0.0,
    )
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(v), jnp.asarray(mel))
    port = FusionModel(torch.nn.Module(), _Tower(24), num_classes=5, d_model=16, num_heads=2,
                       audio_n_mels=20)
    assert port.audio_time_conv.weight.shape == (16, 20, 3) and not hasattr(port, "audio_seq_proj")
    _load(port, variables)
    want, _ = jmodel.apply(variables, jnp.asarray(v), jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(v), torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_init_parameters_knows_the_new_leaves():
    """Gate biases -1.0 on both linears, `logit_scale` = log(1 / 0.07),
    `bias_scale` 1: the JAX package's initialisers."""
    gated = build_model(_config(fusion="gated", use_resnet_audio=False, fusion_align_mode="clip"),
                        device="cpu")
    sd = gated.state_dict()
    assert (sd["gate.0.bias"] == -1.0).all() and (sd["gate.3.bias"] == -1.0).all()
    assert not sd["classifier.bias"].any() and not sd["audio_proj.bias"].any()
    np.testing.assert_allclose(float(sd["semantic_alignment.logit_scale"]), np.log(1 / 0.07), rtol=1e-6)
    xattn = build_model(_config(xattn_head="gated", xattn_use_emotion_prior=True), device="cpu")
    sd = xattn.state_dict()
    assert (sd["xattn_gate.0.bias"] == -1.0).all() and (sd["xattn_gate.3.bias"] == -1.0).all()
    assert float(sd["emotion_prior_bias.bias_scale"]) == 1.0


def test_gated_train_forward_uses_modality_dropout_and_specaugment():
    cfg = _config(fusion="gated", use_resnet_audio=False, spec_augment=True)
    port = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    video, audio = map(torch.from_numpy, _inputs(cfg, seed=7))
    before = {k: v.clone() for k, v in port.state_dict().items() if "running_mean" in k}
    with torch.no_grad():
        outs = [port(video, audio, True, RngStreams(s)) for s in (0, 0, 1)]
        with pytest.raises(ValueError, match="rng"):
            port(video, audio, True)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert all(torch.isfinite(o).all() for o in outs)
    after = port.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in before.items())
    # Both modalities dropped: the gate sees zeros, every sample gets the
    # classifier's bias.
    port.modality_dropout = (1.0, 1.0)
    with torch.no_grad():
        dropped = port(video, audio, True, RngStreams(2))
    np.testing.assert_allclose(
        dropped.numpy(), port.classifier.bias.detach().expand(2, -1).numpy(), atol=1e-6)


def test_unknown_mode_and_head_raise():
    with pytest.raises(ValueError, match="Unknown fusion mode"):
        build_model(_config(fusion="early"), device="cpu")
    with pytest.raises(ValueError, match="head"):
        VideoNet(head="logits")
    with pytest.raises(ValueError, match="Unknown xattn head"):
        FusionModel(torch.nn.Module(), _Tower(24), num_classes=5, xattn_head="sum")


SMALL_BENCH = dict(frames=2, frame_size=32, samples=8000, xattn_d_model=32)


@pytest.mark.parametrize("use_wavlm", [True, False], ids=["wavlm", "mel"])
def test_bench_forward_rehearsed_on_the_cpu(monkeypatch, capsys, use_wavlm):
    monkeypatch.setenv("BENCH_BATCH", "2")
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.setenv("BENCH_DTYPE", "float32")
    monkeypatch.setenv("BENCH_WAVLM", "1" if use_wavlm else "0")
    sizes = dict(SMALL_BENCH, wavlm_geometry=dict(SMALL)) if use_wavlm else SMALL_BENCH
    report = bench_forward.run_single(device="cpu", **sizes)
    name = "torch_xattn_wavlm_fwd" if use_wavlm else "torch_xattn_fwd"
    assert report["metric"] == f"{name}_throughput_b2_float32"
    assert report["unit"] == "3s_clips_per_min" and report["value"] > 0
    assert report["card"] == "cpu" and report["method"] == "host_clock_min3"
    assert capsys.readouterr().out.strip().startswith("{")


def test_bench_step_is_seeded_and_takes_the_plain_path_override():
    """Two steps built apart share weights and inputs, so the kernel path
    can be held against the plain path (`fused_attention=False`); on the CPU
    both run the plain versions and agree to rounding (1e-6)."""
    kernels = bench_forward.make_step(
        2, True, "float32", "cpu", wavlm_geometry=dict(SMALL), **SMALL_BENCH)
    plain = bench_forward.make_step(
        2, True, "float32", "cpu", **SMALL_BENCH,
        wavlm_geometry=dict(SMALL, fused_attention=False, fused_conv=False))
    got, want = kernels(), plain()
    assert got.shape == (2, 8) and not got.requires_grad
    assert float((got[0] - got[1]).abs().max()) > 1e-4  # the clips differ
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert torch.equal(got, kernels())


def test_measurement_entries_raise_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    monkeypatch.setenv("BENCH_BATCH", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_forward.run_single()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.entry()
    monkeypatch.setenv("BENCH_DTYPE", "float16")
    with pytest.raises(ValueError, match="BENCH_DTYPE"):
        bench_forward.run_single(device="cpu")


def test_entry_returns_the_flagship_forward():
    forward, (model, video, audio) = port_entry.entry(
        device="cpu", wavlm_geometry=dict(SMALL), xattn_d_model=32)
    assert video.shape == (1, 8, 3, 112, 112) and audio.shape == (1, 1, 48000)
    assert model.mode == "xattn" and hasattr(model.audio_model, "wavlm")
    probs = forward(model, video, audio)
    assert probs.shape == (1, 8) and not probs.requires_grad
    np.testing.assert_allclose(float(probs.sum()), 1.0, atol=1e-6)
