"""The port's kernel functions against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode, as the JAX package's own tests run them.
Same numpy inputs on both sides, float32, the JAX suite's tolerances
(`tests/test_wavlm_fused_attn.py`: 2e-5 for the attention sublayer, 1e-5
for the conv layer).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from multimodalemotionrecognition_tpu.ops.pallas_conv_fe import (
    fused_conv_layer as jax_fused_conv_layer,
)
from multimodalemotionrecognition_tpu.ops.pallas_wavlm_attn import (
    wavlm_fused_attention_sublayer,
)
from multimodalemotionrecognition_torch.kernels import (
    fused_conv_layer,
    fused_conv_layer_plain,
    wavlm_attention_sublayer,
    wavlm_attention_sublayer_plain,
)


def _sublayer_inputs(seed, b, h, tp, dh):
    rng = np.random.RandomState(seed)
    e = h * dh
    f32 = np.float32
    return [
        (rng.randn(b, tp, e) * 0.5).astype(f32),  # hidden
        (rng.randn(b, tp, e) * 0.3).astype(f32),  # q (pre-scaled)
        (rng.randn(b, tp, e) * 0.3).astype(f32),  # k
        (rng.randn(b, tp, e) * 0.3).astype(f32),  # v
        (1.0 + rng.rand(b, h * tp, 1)).astype(f32),  # gate
        rng.randn(h * tp, tp).astype(f32),  # position bias
        (rng.randn(e, e) * 0.1).astype(f32),  # wo
        (rng.randn(1, e) * 0.1).astype(f32),  # bo
        (1.0 + 0.1 * rng.randn(1, e)).astype(f32),  # ln scale
        (0.1 * rng.randn(1, e)).astype(f32),  # ln bias
    ]


@pytest.mark.parametrize(
    "b,h,tp,dh,seq",
    [(3, 4, 32, 16, 27), (2, 4, 24, 8, 24)],
    ids=["padded_keys", "unpadded"],
)
def test_attention_sublayer_matches_pallas_kernel(b, h, tp, dh, seq):
    args = _sublayer_inputs(0, b, h, tp, dh)
    want = wavlm_fused_attention_sublayer(
        *map(jnp.asarray, args), num_heads=h, seq_len=seq, interpret=True
    )
    got = wavlm_attention_sublayer(*map(torch.from_numpy, args), num_heads=h, seq_len=seq)
    np.testing.assert_allclose(
        got[:, :seq].numpy(), np.asarray(want)[:, :seq], atol=2e-5
    )


def test_attention_sublayer_ignores_padded_keys():
    """Values in key/value rows >= seq_len do not reach the valid rows."""
    b, h, tp, dh, seq = 2, 2, 16, 8, 11
    args = [torch.from_numpy(a) for a in _sublayer_inputs(1, b, h, tp, dh)]
    out1 = wavlm_attention_sublayer(*args, num_heads=h, seq_len=seq)
    args[2][:, seq:] = 99.0
    args[3][:, seq:] = -99.0
    out2 = wavlm_attention_sublayer(*args, num_heads=h, seq_len=seq)
    torch.testing.assert_close(out1[:, :seq], out2[:, :seq], atol=1e-6, rtol=0)


def _conv_inputs(seed, b, t, cin, cout, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, cin).astype(np.float32)
    w = (rng.randn(k, cin, cout) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("gelu", ["input", "output"])
def test_conv_layer_matches_pallas_kernel(k, gelu):
    b, t, cin, cout, s = 2, 96, 16, 24, 2
    x, w = _conv_inputs(3, b, t, cin, cout, k)
    y = x.reshape(b, t // s, s * cin)
    w_flat = w.reshape(k * cin, cout)
    flags = dict(gelu_input=gelu == "input", gelu_output=gelu == "output")
    want = jax_fused_conv_layer(
        jnp.asarray(y), jnp.asarray(w_flat), k=k, stride=s, cin=cin,
        interpret=True, **flags,
    )
    got = fused_conv_layer(
        torch.from_numpy(y), torch.from_numpy(w_flat), k=k, stride=s, cin=cin, **flags
    )
    t_out = (t - k) // s + 1
    assert got.shape == (b, t // s, cout)
    np.testing.assert_allclose(
        got[:, :t_out].numpy(), np.asarray(want)[:, :t_out], atol=1e-5
    )


def test_conv_layer_reads_only_the_logical_rows():
    """With t_in < rows*stride the result equals F.conv1d over the first
    t_in rows, whatever the rows past t_in hold."""
    b, t_in, rows, cin, cout, k, s = 2, 93, 48, 8, 12, 3, 2
    x, w = _conv_inputs(4, b, rows * s, cin, cout, k)
    x[:, t_in:] = np.nan
    got = fused_conv_layer(
        torch.from_numpy(x).view(b, rows, s * cin),
        torch.from_numpy(w.reshape(k * cin, cout)),
        k=k, stride=s, cin=cin, gelu_output=True, t_in=t_in,
    )
    xt = torch.from_numpy(x[:, :t_in]).transpose(1, 2)
    want = F.gelu(F.conv1d(xt, torch.from_numpy(w).permute(2, 1, 0), stride=s))
    t_out = (t_in - k) // s + 1
    torch.testing.assert_close(got[:, :t_out], want.transpose(1, 2), atol=1e-5, rtol=1e-5)


def test_wrappers_run_the_plain_version_on_cpu_without_counting():
    args = [torch.from_numpy(a) for a in _sublayer_inputs(2, 1, 2, 8, 8)]
    n1 = wavlm_attention_sublayer.launches
    torch.testing.assert_close(
        wavlm_attention_sublayer(*args, num_heads=2, seq_len=8),
        wavlm_attention_sublayer_plain(*args, num_heads=2, seq_len=8),
        atol=0, rtol=0,
    )
    y = torch.randn(1, 8, 8)
    w = torch.randn(12, 5)
    n3 = fused_conv_layer.launches
    torch.testing.assert_close(
        fused_conv_layer(y, w, k=3, stride=2, cin=4),
        fused_conv_layer_plain(y, w, k=3, stride=2, cin=4),
        atol=0, rtol=0,
    )
    assert wavlm_attention_sublayer.launches == n1
    assert fused_conv_layer.launches == n3


@pytest.mark.parametrize(
    "change,error",
    [
        (lambda a: a.__setitem__(4, a[4][:, :-1]), ValueError),  # gate shape
        (lambda a: a.__setitem__(5, a[5].double()), TypeError),  # bias dtype
        (lambda a: a.__setitem__(1, a[1].transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
        (lambda a: a.__setitem__(6, a[6].half()), TypeError),  # wo dtype
    ],
    ids=["gate_shape", "bias_dtype", "q_not_contiguous", "wo_dtype"],
)
def test_attention_wrapper_rejects_bad_inputs(change, error):
    args = [torch.from_numpy(a) for a in _sublayer_inputs(5, 2, 2, 8, 8)]
    change(args)
    with pytest.raises(error):
        wavlm_attention_sublayer(*args, num_heads=2, seq_len=8)


def test_attention_wrapper_refuses_dropout():
    """Without a seed, as the JAX wrapper does; with one it runs
    (`tests/test_torch_train_kernels.py`)."""
    args = [torch.from_numpy(a) for a in _sublayer_inputs(6, 1, 2, 8, 8)]
    with pytest.raises(ValueError, match="dropout_seed"):
        wavlm_attention_sublayer(*args, num_heads=2, seq_len=8, attn_dropout=0.1)


@pytest.mark.parametrize(
    "y_shape,w_shape,kw",
    [
        ((1, 8, 6), (12, 5), {}),  # lane dim != stride*cin
        ((1, 8, 8), (8, 5), {}),  # w rows != k*cin
        ((1, 8, 8), (12, 5), {"t_in": 17}),  # t_in past the buffer
    ],
)
def test_conv_wrapper_rejects_bad_inputs(y_shape, w_shape, kw):
    with pytest.raises(ValueError):
        fused_conv_layer(torch.zeros(y_shape), torch.zeros(w_shape), k=3, stride=2, cin=4, **kw)
