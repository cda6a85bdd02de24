"""The fused and int8 serving options: `TorchModelRunner(device="cpu")` with
`fused=True`, `quantize_int8=True` and both against `JaxModelRunner` with the
same options, on reference-format checkpoints of the cross-attention model
at small widths (the JAX suite's `SMALL` WavLM, d_model 32, full ResNet18),
float32, atol 5e-5 on the probabilities.

On the CPU the port's K4 wrapper runs its plain version; the JAX runner runs
its Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from multimodalemotionrecognition_tpu.config import ModelConfig
from multimodalemotionrecognition_tpu.convert import torch_import
from multimodalemotionrecognition_tpu.models.factory import build_model as jax_build_model
from multimodalemotionrecognition_tpu.runtime.runner import JaxModelRunner
from multimodalemotionrecognition_torch.convert.params import state_dict_key
from multimodalemotionrecognition_torch.runtime.quant import Int8Linear, quantize_weight_int8
from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

from tests.test_wavlm_fused_attn import SMALL

FRAMES = (8, 3, 32, 32)
ATOL = 5e-5
OPTIONS = {
    "fused": dict(fused=True),
    "int8": dict(quantize_int8=True),
    "int8_fused": dict(quantize_int8=True, fused=True),
}


def _save_checkpoint(path, seed=0, **extra):
    cfg = ModelConfig(
        fusion="xattn", num_classes=8, use_wavlm=True, spec_augment=False,
        xattn_d_model=32, xattn_attn_dropout=0.0, xattn_stochastic_depth=0.0,
        wavlm_geometry=dict(SMALL), **extra,
    )
    model = jax_build_model(cfg)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + FRAMES), jnp.zeros((1, 1, 48000))
    )
    torch_import.save_torch_checkpoint(path, variables, config=cfg.to_checkpoint_dict())
    return str(path)


def _clips(n, seed):
    rng = np.random.RandomState(seed)
    video = rng.randn(n, *FRAMES).astype(np.float32)
    audio = (rng.randn(n, 1, 48000) * 0.1).astype(np.float32)
    return video, audio


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _save_checkpoint(tmp_path_factory.mktemp("torch_fused") / "best_xattn_wavlm.pt")


@pytest.fixture(scope="module")
def modular(ckpt):
    return TorchModelRunner(ckpt, device="cpu")


@pytest.mark.parametrize("name", list(OPTIONS))
def test_runner_options_match_jax(ckpt, modular, name):
    jax_runner = JaxModelRunner(ckpt, **OPTIONS[name])
    port = TorchModelRunner(ckpt, device="cpu", **OPTIONS[name])
    assert (port._fused_forward is not None) == ("fused" in name)
    assert bool(port.quantized) == ("int8" in name)
    video, audio = _clips(3, seed=1)
    got = port.predict_probs(video, audio)
    assert got.shape == (3, 8)
    np.testing.assert_allclose(got, jax_runner.predict_probs(video, audio), atol=ATOL)
    np.testing.assert_allclose(
        port.predict_probs_blank_video(audio[:1]),
        jax_runner.predict_probs_blank_video(audio[:1]),
        atol=ATOL,
    )
    # Against the port's own modular float path: equal when only fused, and
    # within the JAX suite's int8 bound (`tests/test_runner.py`) otherwise.
    base = modular.predict_probs(video, audio)
    if name == "fused":
        np.testing.assert_allclose(got, base, atol=ATOL)
    else:
        assert np.abs(got - base).max() < 0.05


@pytest.mark.parametrize(
    "extra",
    [
        {"temporal_pooling": "attn"},
        {"xattn_use_emotion_prior": True},
        {"xattn_head": "gated"},
        {"temporal_pooling": "attn", "xattn_use_emotion_prior": True, "xattn_head": "gated"},
    ],
    ids=["attn-pool", "emotion-prior", "gated-head", "all"],
)
def test_runner_fused_variants_match_jax(tmp_path, extra):
    """The fused block absorbs attention pooling, the emotion-prior bias and
    the gated head: each matches the JAX fused runner and the port's modular
    path."""
    path = _save_checkpoint(tmp_path / "variant.pt", seed=2, **extra)
    port = TorchModelRunner(path, device="cpu", fused=True)
    assert port._fused_forward is not None, extra
    video, audio = _clips(2, seed=7)
    got = port.predict_probs(video, audio)
    np.testing.assert_allclose(
        got, JaxModelRunner(path, fused=True).predict_probs(video, audio), atol=ATOL
    )
    np.testing.assert_allclose(
        got, TorchModelRunner(path, device="cpu").predict_probs(video, audio), atol=ATOL
    )


def test_fused_runner_refuses_a_model_the_kernel_does_not_take(ckpt, tmp_path):
    """No quiet modular path: the transformer pooler with `fused=True` raises
    before a model is built."""
    blob = torch.load(ckpt, map_location="cpu", weights_only=False)
    blob["config"] = {**blob["config"], "temporal_pooling": "transformer"}
    path = tmp_path / "transformer_pool.pt"
    torch.save(blob, path)
    with pytest.raises(ValueError, match="fused=True.*temporal_pooling='transformer'"):
        TorchModelRunner(path, device="cpu", fused=True)


def test_quantised_keys_values_and_scales_equal_jax(ckpt):
    jax_runner = JaxModelRunner(ckpt, quantize_int8=True)
    port = TorchModelRunner(ckpt, device="cpu", quantize_int8=True)
    leaves = flatten_dict(jax.device_get(jax_runner.variables))
    want = {state_dict_key(path): path for path in jax_runner._dequant_scales}
    assert {f"{name}.weight" for name in port.quantized} == set(want)
    assert all(np.asarray(leaves[path]).dtype == np.int8 for path in want.values())
    state = port.model.state_dict()
    for name, module in port.quantized.items():
        path = want[f"{name}.weight"]
        assert isinstance(module, Int8Linear) and f"{name}.weight" not in state
        assert state[f"{name}.weight_q"].dtype == torch.int8
        # Flax [in, out] with a [1, out] scale row; torch [out, in], [out].
        np.testing.assert_array_equal(state[f"{name}.weight_q"].numpy().T, leaves[path])
        np.testing.assert_array_equal(
            state[f"{name}.scale"].numpy()[None], jax_runner._dequant_scales[path]
        )
    # Never the packed attention weight, embeddings, convs or N=1 score layers.
    assert not any(
        key.endswith(("in_proj_weight", "rel_attn_embed.weight", "conv.weight"))
        for key in want
    )
    assert "emotion_prior_bias.v_query_bias" not in port.quantized


def test_quantiser_formula_and_scale_dtype_survive_a_cast():
    w = torch.tensor([[0.5, -1.0, 0.25] + [0.0] * 5, [0.0] * 8])
    q, scale = quantize_weight_int8(w)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q[0, :3].numpy(), [64, -127, 32])
    np.testing.assert_allclose(scale.numpy(), [1.0 / 127.0, 1e-8 / 127.0], rtol=1e-6)
    linear = torch.nn.Linear(8, 8)
    x = torch.randn(4, 8)
    module = Int8Linear(linear)  # takes over the layer's bias parameter
    torch.testing.assert_close(
        module(x), torch.nn.functional.linear(x, linear.weight, linear.bias),
        atol=2e-2, rtol=0,
    )
    module.to(torch.bfloat16)
    assert module.scale.dtype == torch.float32 and module.bias.dtype == torch.bfloat16
    assert module.weight_q.dtype == torch.int8
    assert module(x.bfloat16()).dtype == torch.bfloat16


def test_int8_runner_keeps_k1_operands_dequantised_once(ckpt):
    """The attention kernel's (in, out) out-projection is made at load, from
    the int8 weight too, not on every request."""
    port = TorchModelRunner(ckpt, device="cpu", quantize_int8=True)
    layer = port.model.audio_model.wavlm.encoder.layers[0]
    wo, bo, ln_s, ln_b = layer._k1_operands
    out_proj = layer.attention.out_proj
    assert isinstance(out_proj, Int8Linear)
    torch.testing.assert_close(wo, out_proj.weight.t().contiguous(), atol=0, rtol=0)
    assert bo.shape == ln_s.shape == ln_b.shape == (1, wo.shape[0])
    layer.to(torch.float64)
    assert layer._k1_operands is None
