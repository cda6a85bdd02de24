"""K3's tensor-core addressing, checked on the CPU.

The tensor-core kernel (`csrc/conv_fe_tc.cu`) reads its operands as 2-D
boxes placed by `conv_tile_plan`: per K step a row shift and a column of the
[B*rows, stride*cin] view of the input and a row of `w_flat`.  A numpy
gather by that plan, boxes past the end reading zeros as TMA gives them,
must equal the plain version and the JAX package's Pallas kernel (in
interpret mode) on every row below t_out, whatever lies past t_in.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalemotionrecognition_tpu.ops.pallas_conv_fe import (
    fused_conv_layer as jax_fused_conv_layer,
)
from multimodalemotionrecognition_torch.kernels.conv_fe import (
    conv_tile_plan,
    fused_conv_layer_plain,
    tensor_core_route,
)


def _gather_by_plan(y, w_flat, k, stride, cin, bk, gelu_output):
    """The kernel's K loop in numpy: float64 sums over the plan's boxes."""
    b, rows, s_cin = y.shape
    y2 = y.reshape(b * rows, s_cin).astype(np.float64)
    acc = np.zeros((b * rows, w_flat.shape[1]))
    for shift, col, w_row in conv_tile_plan(k, stride, cin, bk):
        box = np.zeros((b * rows, bk))
        box[: b * rows - shift] = y2[shift:, col:col + bk]
        acc += box @ w_flat[w_row:w_row + bk].astype(np.float64)
    if gelu_output:
        acc = torch.nn.functional.gelu(torch.from_numpy(acc)).numpy()
    return acc.reshape(b, rows, -1)


@pytest.mark.parametrize("k,bk", [(3, 16), (3, 8), (2, 16)])
def test_tile_plan_covers_the_reduction_once_in_boxes(k, bk):
    stride, cin = 2, 16
    plan = conv_tile_plan(k, stride, cin, bk)
    assert [w_row for _, _, w_row in plan] == list(range(0, k * cin, bk))
    for shift, col, w_row in plan:
        # reduction index kk = tap * cin + c lies at input sample t*stride + tap
        tap = w_row // cin
        assert (shift, col) == (tap // stride, (tap % stride) * cin + w_row % cin)
        assert col + bk <= stride * cin  # a box never straddles two input rows
    with pytest.raises(ValueError, match="multiple of the K step"):
        conv_tile_plan(3, 2, 24, 16)


@pytest.mark.parametrize("k,t_in,gelu_output", [(3, 37, True), (2, 37, False), (3, 41, False),
                                                (2, 29, True)])
def test_gather_by_plan_matches_plain_and_pallas(k, t_in, gelu_output):
    b, cin, cout, stride = 2, 16, 24, 2
    rows = -(-t_in // stride)
    rng = np.random.RandomState(k * 100 + t_in)
    x = rng.randn(b, rows * stride, cin).astype(np.float32)
    x[:, t_in:] = np.nan  # past t_in: never reaches a row < t_out
    w_flat = (rng.randn(k * cin, cout) * 0.2).astype(np.float32)
    y = x.reshape(b, rows, stride * cin)
    t_out = (t_in - k) // stride + 1

    got = _gather_by_plan(y, w_flat, k, stride, cin, 16, gelu_output)[:, :t_out]
    assert np.isfinite(got).all()
    plain = fused_conv_layer_plain(torch.from_numpy(y), torch.from_numpy(w_flat), k, stride, cin,
                                   gelu_output=gelu_output, t_in=t_in)
    np.testing.assert_allclose(got, plain[:, :t_out].numpy(), atol=1e-5)
    pallas = jax_fused_conv_layer(jnp.asarray(y), jnp.asarray(w_flat), k=k, stride=stride,
                                  cin=cin, gelu_output=gelu_output, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas)[:, :t_out], atol=1e-5)


@pytest.mark.parametrize(
    "dtype,cin,gelu_input,expected",
    [(torch.bfloat16, 512, False, True), (torch.bfloat16, 512, True, False),
     (torch.float32, 512, False, False), (torch.bfloat16, 16, False, False)],
)
def test_tensor_core_route_is_decided_by_the_arguments(dtype, cin, gelu_input, expected):
    y = torch.zeros(1, 4, 2 * cin, dtype=dtype)
    w = torch.zeros(3 * cin, 512, dtype=dtype)
    assert tensor_core_route(y, w, 3, cin, gelu_input) is expected
