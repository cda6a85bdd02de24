"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere.  This file imports no
JAX, so on a machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from multimodalemotionrecognition_torch.kernels import (
    fused_conv_layer,
    fused_conv_layer_plain,
    wavlm_attention_sublayer,
    wavlm_attention_sublayer_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _sublayer_inputs(b, h, tp, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    e = h * 64

    def r(*shape, scale=1.0, shift=0.0, dt=dtype):
        return (torch.randn(*shape, generator=g) * scale + shift).to(device, dt)

    return [
        r(b, tp, e, scale=0.5), r(b, tp, e, scale=0.3), r(b, tp, e, scale=0.3),
        r(b, tp, e, scale=0.3),
        (1.0 + torch.rand(b, h * tp, 1, generator=g)).to(device),
        r(h * tp, tp, dt=torch.float32),
        r(e, e, scale=e**-0.5),
        r(1, e, scale=0.1, dt=torch.float32),
        r(1, e, scale=0.1, shift=1.0, dt=torch.float32),
        r(1, e, scale=0.1, dt=torch.float32),
    ]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,tp,seq", [(8, 149, 149), (2, 160, 149), (1, 37, 37)])
def test_attention_kernel_matches_plain(cuda, dtype, atol, b, tp, seq):
    h = 12
    args = _sublayer_inputs(b, h, tp, dtype, cuda)
    before = wavlm_attention_sublayer.launches
    got = wavlm_attention_sublayer(*args, num_heads=h, seq_len=seq)
    want = wavlm_attention_sublayer_plain(*args, num_heads=h, seq_len=seq)
    torch.cuda.synchronize()
    assert wavlm_attention_sublayer.launches == before + 1
    err = (got[:, :seq].float() - want[:, :seq].float()).abs().max().item()
    assert err <= atol, err


@pytest.mark.parametrize(
    "dtype,atol,rtol", [(torch.float32, 1e-4, 0.0), (torch.bfloat16, 0.0, 2e-2)]
)
@pytest.mark.parametrize(
    "t_in,k,gelu_in,gelu_out",
    [(9599, 3, False, True), (599, 2, True, False), (299, 2, False, False)],
)
def test_conv_kernel_matches_plain(cuda, dtype, atol, rtol, t_in, k, gelu_in, gelu_out):
    b, cin, cout, s = 2, 512, 512, 2
    rows = -(-t_in // s)
    g = torch.Generator().manual_seed(1)
    y = torch.randn(b, rows, s * cin, generator=g).to(cuda, dtype)
    w = (torch.randn(k * cin, cout, generator=g) * (k * cin) ** -0.5).to(cuda, dtype)
    flags = dict(gelu_input=gelu_in, gelu_output=gelu_out, t_in=t_in)
    before = fused_conv_layer.launches
    got = fused_conv_layer(y, w, k, s, cin, **flags)
    want = fused_conv_layer_plain(y, w, k, s, cin, **flags)
    torch.cuda.synchronize()
    assert fused_conv_layer.launches == before + 1
    t_out = (t_in - k) // s + 1
    ref = want[:, :t_out].float()
    err = (got[:, :t_out].float() - ref).abs().max().item()
    assert err <= max(atol, rtol * ref.abs().max().item()), err
