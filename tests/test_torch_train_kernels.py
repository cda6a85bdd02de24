"""The port's train-path kernel functions against the JAX package's.

K1 with dropout and K2 (the backward of the WavLM attention sublayer), on
the CPU: the port's wrappers run their plain PyTorch versions, the JAX
kernels run in interpret mode, as `tests/test_wavlm_attn_vjp.py` runs them.
Same numpy inputs on both sides, the same dropout seed and the same padded
length `Tp` (the attention mask's index stride), so the masks are equal bit
for bit.  Tolerances: float32 1e-5 on outputs and 1e-4 on gradients
(another sum order); bfloat16 2e-2 on outputs and 5e-2 of a gradient's
largest entry (both sides round the operands of every product to bfloat16,
at slightly different values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalemotionrecognition_tpu.ops.pallas_wavlm_attn import (
    _drop_threshold,
    _hash_keep,
    wavlm_fused_attention_sublayer,
)
from multimodalemotionrecognition_torch.kernels import (
    fused_conv_layer,
    hash_keep_plain,
    wavlm_attention_sublayer,
    wavlm_attention_sublayer_backward,
    wavlm_attention_sublayer_backward_plain,
    wavlm_attention_sublayer_plain,
)
from multimodalemotionrecognition_torch.kernels.wavlm_attn import drop_threshold

NAMES = ("hidden", "q", "k", "v", "gate", "bias", "wo", "bo", "lns", "lnb")
COMPUTE = (0, 1, 2, 3, 6)  # the operands that take the compute dtype
H, SEED = 4, 5


def _inputs(b=2, h=H, tp=16, dh=8, seed=0):
    """As `tests/test_wavlm_attn_vjp.py::_inputs`, from a numpy generator."""
    rng = np.random.default_rng(seed)
    e = h * dh
    f32 = np.float32
    return [
        (rng.standard_normal((b, tp, e)) * 0.5).astype(f32),
        (rng.standard_normal((b, tp, e)) * 0.3).astype(f32),
        (rng.standard_normal((b, tp, e)) * 0.3).astype(f32),
        (rng.standard_normal((b, tp, e)) * 0.3).astype(f32),
        (1.0 + rng.random((b, h * tp, 1))).astype(f32),
        rng.standard_normal((h * tp, tp)).astype(f32),
        (rng.standard_normal((e, e)) * 0.1).astype(f32),
        (rng.standard_normal((1, e)) * 0.1).astype(f32),
        (1.0 + 0.1 * rng.standard_normal((1, e))).astype(f32),
        (0.1 * rng.standard_normal((1, e))).astype(f32),
    ]


def _cotangent(shape, seq_len, seed=7):
    """Zero on the rows at or past seq_len, which the forward leaves unspecified."""
    cot = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    cot[:, seq_len:] = 0.0
    return cot


def _torch_args(args, dtype=torch.float32):
    out = [torch.from_numpy(a) for a in args]
    for i in COMPUTE:
        out[i] = out[i].to(dtype)
    return out


def _jax_args(args, dtype=jnp.float32):
    out = [jnp.asarray(a) for a in args]
    for i in COMPUTE:
        out[i] = out[i].astype(dtype)
    return out


def _jax_sublayer(args, seq_len, attn_p, hid_p):
    return wavlm_fused_attention_sublayer(
        *args, num_heads=H, seq_len=seq_len, attn_dropout=attn_p, hidden_dropout=hid_p,
        dropout_seed=jnp.asarray([SEED], jnp.int32), interpret=True,
    )


def _jax_grads(args, cot, seq_len, attn_p, hid_p):
    out, vjp = jax.vjp(lambda *a: _jax_sublayer(a, seq_len, attn_p, hid_p), *args)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(cot).astype(out.dtype))]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.937])
@pytest.mark.parametrize("shape", [(16, 16), (13, 32), (160, 160)])
@pytest.mark.parametrize("base", [0, 5, 0x7FEB352D, 0xFFFFFFFF, 0x9E3779B9 + 12345])
def test_hash_keep_equals_jax_bit_for_bit(base, shape, rate):
    assert drop_threshold(rate) == _drop_threshold(rate)
    want = np.asarray(_hash_keep(jnp.uint32(base), shape, _drop_threshold(rate)))
    got = hash_keep_plain(base, shape, drop_threshold(rate)).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1.0 - rate)) < 0.1


def test_hash_keep_takes_a_tensor_of_bases():
    bases = torch.tensor([[1, 2], [3, 0xFFFFFFFF + 7]])  # wraps mod 2**32
    got = hash_keep_plain(bases, (8, 16), drop_threshold(0.3))
    assert got.shape == (2, 2, 8, 16)
    want = np.asarray(_hash_keep(jnp.uint32(6), (8, 16), _drop_threshold(0.3)))
    np.testing.assert_array_equal(got[1, 1].numpy(), want)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("seq_len", [16, 13])
@pytest.mark.parametrize("attn_p,hid_p", [(0.1, 0.0), (0.0, 0.1), (0.1, 0.1), (0.3, 0.2)])
def test_forward_with_dropout_matches_pallas_kernel(attn_p, hid_p, seq_len, dtype, atol):
    args = _inputs()
    want = _jax_sublayer(_jax_args(args, getattr(jnp, dtype)), seq_len, attn_p, hid_p)
    got = wavlm_attention_sublayer_plain(
        *_torch_args(args, getattr(torch, dtype)), num_heads=H, seq_len=seq_len,
        attn_dropout=attn_p, hidden_dropout=hid_p, dropout_seed=SEED,
    )
    np.testing.assert_allclose(
        _np(got)[:, :seq_len], np.asarray(want.astype(jnp.float32))[:, :seq_len], atol=atol
    )


def test_dropout_changes_the_output_and_depends_on_the_seed():
    args = _torch_args(_inputs())
    kw = dict(num_heads=H, seq_len=16, attn_dropout=0.1, hidden_dropout=0.1)
    base = wavlm_attention_sublayer(*args, num_heads=H, seq_len=16)
    a = wavlm_attention_sublayer(*args, **kw, dropout_seed=1)
    b = wavlm_attention_sublayer(*args, **kw, dropout_seed=2)
    again = wavlm_attention_sublayer(*args, **kw, dropout_seed=1)
    assert not torch.equal(a, base) and not torch.equal(a, b)
    torch.testing.assert_close(a, again, atol=0, rtol=0)


@pytest.mark.parametrize("seq_len", [16, 13])
@pytest.mark.parametrize("attn_p,hid_p", [(0.0, 0.0), (0.1, 0.0), (0.0, 0.1), (0.1, 0.1)])
def test_backward_matches_jax_custom_vjp(attn_p, hid_p, seq_len):
    """All ten gradients, from the plain backward and through the Function."""
    args = _inputs()
    cot = _cotangent(args[0].shape, seq_len)
    want = _jax_grads(_jax_args(args), cot, seq_len, attn_p, hid_p)
    statics = dict(num_heads=H, seq_len=seq_len, attn_dropout=attn_p, hidden_dropout=hid_p,
                   dropout_seed=SEED)

    plain = wavlm_attention_sublayer_backward_plain(
        torch.from_numpy(cot), *_torch_args(args), **statics
    )
    leaves = [t.requires_grad_() for t in _torch_args(args)]
    launches = wavlm_attention_sublayer_backward.launches
    out = wavlm_attention_sublayer(*leaves, **statics)
    through_function = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    assert wavlm_attention_sublayer_backward.launches == launches  # CPU: no kernel ran

    for name, w, p, f in zip(NAMES, want, plain, through_function):
        assert p.shape == w.shape and f.shape == w.shape, name
        np.testing.assert_allclose(_np(p), w, atol=1e-4, rtol=1e-4, err_msg=f"plain d{name}")
        np.testing.assert_allclose(_np(f), w, atol=1e-4, rtol=1e-4, err_msg=f"Function d{name}")
        assert np.abs(w).max() > 0.0, name


@pytest.mark.parametrize("seq_len", [16, 13])
@pytest.mark.parametrize("attn_p,hid_p", [(0.0, 0.0), (0.1, 0.1)])
def test_backward_bf16_matches_jax_custom_vjp(attn_p, hid_p, seq_len):
    args = _inputs(seed=1)
    cot = _cotangent(args[0].shape, seq_len)
    want = _jax_grads(_jax_args(args, jnp.bfloat16), cot, seq_len, attn_p, hid_p)
    got = wavlm_attention_sublayer_backward_plain(
        torch.from_numpy(cot).bfloat16(), *_torch_args(args, torch.bfloat16),
        num_heads=H, seq_len=seq_len, attn_dropout=attn_p, hidden_dropout=hid_p,
        dropout_seed=SEED,
    )
    for i, (name, w, g) in enumerate(zip(NAMES, want, got)):
        assert g.dtype == (torch.bfloat16 if i < 4 else torch.float32), name
        err = np.abs(_np(g) - w).max()
        assert err <= 5e-2 * np.abs(w).max(), (name, err, np.abs(w).max())


def test_function_casts_dwo_to_wo_dtype():
    leaves = [t.requires_grad_() for t in _torch_args(_inputs(), torch.bfloat16)]
    out = wavlm_attention_sublayer(*leaves, num_heads=H, seq_len=16)
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert grads[6].dtype == torch.bfloat16 and grads[5].dtype == torch.float32


def test_padded_rows_get_zero_grads():
    """Rows and columns at or past seq_len get exact zeros, whatever the
    padded rows of the inputs and of the cotangent hold."""
    seq_len = 12
    args = _torch_args(_inputs())
    for i in range(4):
        args[i][:, seq_len:] = float("nan")
    cot = torch.from_numpy(_cotangent(args[0].shape, 16))
    cot[:, seq_len:] = float("nan")
    grads = wavlm_attention_sublayer_backward_plain(
        cot, *args, num_heads=H, seq_len=seq_len, attn_dropout=0.1, hidden_dropout=0.1,
        dropout_seed=3,
    )
    for name, g in zip(NAMES, grads):
        assert torch.isfinite(g).all(), name
    for name, g in zip(NAMES[:4], grads[:4]):
        assert torch.count_nonzero(g[:, seq_len:]) == 0, name
        assert g[:, :seq_len].abs().max() > 0, name
    dgate = grads[4].view(2, H, 16)
    dbias = grads[5].view(H, 16, 16)
    assert torch.count_nonzero(dgate[:, :, seq_len:]) == 0
    assert torch.count_nonzero(dbias[:, seq_len:]) == 0
    assert torch.count_nonzero(dbias[:, :, seq_len:]) == 0


@pytest.mark.parametrize("seq_len", [16, 13])
@pytest.mark.parametrize("attn_p,hid_p", [(0.0, 0.0), (0.1, 0.1)])
def test_plain_backward_equals_autograd_of_plain_forward(attn_p, hid_p, seq_len):
    args = _inputs(seed=2)
    cot = torch.from_numpy(_cotangent(args[0].shape, seq_len))
    statics = dict(num_heads=H, seq_len=seq_len, attn_dropout=attn_p, hidden_dropout=hid_p,
                   dropout_seed=SEED)
    leaves = [t.requires_grad_() for t in _torch_args(args)]
    want = torch.autograd.grad(wavlm_attention_sublayer_plain(*leaves, **statics), leaves, cot)
    got = wavlm_attention_sublayer_backward_plain(cot, *_torch_args(args), **statics)
    for name, w, g in zip(NAMES, want, got):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4, msg=f"d{name}")


def test_dropout_needs_a_seed_and_a_rate_below_one():
    args = _torch_args(_inputs())
    with pytest.raises(ValueError, match="dropout_seed"):
        wavlm_attention_sublayer(*args, num_heads=H, seq_len=16, hidden_dropout=0.1)
    with pytest.raises(ValueError, match="outside"):
        wavlm_attention_sublayer(*args, num_heads=H, seq_len=16, attn_dropout=1.0, dropout_seed=1)
    with pytest.raises(ValueError, match="dout"):
        wavlm_attention_sublayer_backward(
            torch.zeros(2, 16, 8), *args, None, None, num_heads=H, seq_len=16
        )


def test_conv_wrapper_has_no_backward():
    y = torch.randn(1, 8, 8)
    w = torch.randn(12, 5, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_conv_layer(y, w, k=3, stride=2, cin=4)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_conv_layer(y.clone().requires_grad_(), w.detach(), k=3, stride=2, cin=4)
    with torch.no_grad():
        assert fused_conv_layer(y, w, k=3, stride=2, cin=4).shape == (1, 8, 5)
