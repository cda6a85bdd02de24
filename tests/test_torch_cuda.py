"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere.  This file imports no
JAX, so on a machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from multimodalemotionrecognition_torch.kernels import (
    FusedBlockSpec,
    extract_block_params,
    fused_bidirectional_xattn,
    fused_bidirectional_xattn_plain,
    fused_block,
    fused_block_plain,
    fused_conv_layer,
    fused_conv_layer_plain,
    wavlm_attention_sublayer,
    wavlm_attention_sublayer_backward,
    wavlm_attention_sublayer_backward_plain,
    wavlm_attention_sublayer_forward,
    wavlm_attention_sublayer_plain,
    wavlm_attention_sublayer_tiled,
    wavlm_attention_sublayer_tiled_plain,
    xattn_params_from_state_dict,
)
from multimodalemotionrecognition_torch.kernels.build import load_library
from multimodalemotionrecognition_torch.kernels.conv_fe import (
    split_tf32,
    split_weight_tf32,
    tensor_core_route,
    tf32x3_route,
)
from multimodalemotionrecognition_torch.kernels.wavlm_attn import (
    tensor_core_route as attention_tensor_core_route,
)
from multimodalemotionrecognition_torch.kernels.wavlm_attn import (
    tf32x3_route as attention_tf32x3_route,
)
from multimodalemotionrecognition_torch.models.factory import init_parameters
from multimodalemotionrecognition_torch.models.fusion import FusionModel
from multimodalemotionrecognition_torch.runtime.quant import quantize_linears_int8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kernel_names(fn, attempts=3):
    """Names of the CUDA kernels fn() launches (torch.profiler).  Warmed up,
    and three calls in the window: the tracer can miss the first launches
    after it starts.  A window with no device event at all is taken again
    (up to `attempts`): the tracer now and then returns an empty one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}
        if names:
            break
    return names


def _sublayer_inputs(b, h, tp, dtype, device, seed=0, e=None):
    g = torch.Generator().manual_seed(seed)
    e = h * 64 if e is None else e

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


K6_TENSOR_CORE = {torch.bfloat16: ("tiled_core_mma", "tiled_proj_mma"),
                  torch.float32: ("tiled_core_tf32", "tiled_proj_tf32")}
K6_CUDA_CORE = ("tiled_attn_core", "tiled_out_proj")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,tp,seq,e", [(8, 12, 160, 149, 768), (16, 12, 149, 149, 768),
                                          (4, 12, 37, 37, 768), (8, 4, 161, 100, 256),
                                          (4, 8, 37, 37, 256)])
def test_tiled_attention_kernel_matches_plain_and_k1_for_every_tile(cuda, dtype, atol, b, h, tp,
                                                                     seq, e):
    """K6: within tolerance of its plain version on every row (padding rows
    included), the same bits for every tile size, and K1's values below
    seq_len within the same tolerance.  Where the head width is 64 (K1's
    tensor-core route) K6 runs its tensor-core kernels and equals K1 bit for
    bit below seq_len; a head width of 32 takes its CUDA-core kernels."""
    from multimodalemotionrecognition_torch.kernels.wavlm_attn_tiled import tensor_core_route

    args = _sublayer_inputs(b, h, tp, dtype, cuda, e=e)
    tensor_cores = tensor_core_route(args[0], h, seq)
    assert tensor_cores == (e == 64 * h)
    before = wavlm_attention_sublayer_tiled.launches
    ref = wavlm_attention_sublayer_tiled(1, *args, h, seq)
    want = wavlm_attention_sublayer_tiled_plain(1, *args, h, seq)
    k1 = wavlm_attention_sublayer(*args, num_heads=h, seq_len=seq)
    torch.cuda.synchronize()
    assert torch.isfinite(ref).all()
    assert (ref.float() - want.float()).abs().max().item() <= atol
    assert (ref[:, :seq].float() - k1[:, :seq].float()).abs().max().item() <= atol
    if tensor_cores:
        assert torch.equal(ref[:, :seq], k1[:, :seq])
    tiles = [g for g in (2, 4, 8) if b % g == 0]
    for g in tiles:
        assert torch.equal(wavlm_attention_sublayer_tiled(g, *args, h, seq), ref), g
    assert wavlm_attention_sublayer_tiled.launches == before + 1 + len(tiles)
    names = _kernel_names(lambda: wavlm_attention_sublayer_tiled(2, *args, h, seq))
    want_names, other = ((K6_TENSOR_CORE[dtype], K6_CUDA_CORE) if tensor_cores
                         else (K6_CUDA_CORE, K6_TENSOR_CORE[dtype]))
    assert all(any(w in n for n in names) for w in want_names), names
    assert not any(o in n for o in other for n in names), names


def test_tiled_attention_kernel_refuses_what_it_does_not_take(cuda):
    args = _sublayer_inputs(4, 12, 37, torch.float32, cuda)
    with pytest.raises(ValueError, match="g_tile"):
        wavlm_attention_sublayer_tiled(3, *args, 12, 37)
    args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        wavlm_attention_sublayer_tiled(2, *args, 12, 37)
    wide = _sublayer_inputs(1, 18, 16, torch.float32, cuda)  # E = 1152 > 1024
    with pytest.raises(ValueError, match="E=1152"):
        wavlm_attention_sublayer_tiled(1, *wide, 18, 16)


GRAD_NAMES = ("hidden", "q", "k", "v", "gate", "bias", "wo", "bo", "lns", "lnb")
# Relative to a gradient's largest entry.  float32: another sum order.
# bfloat16: kernel and plain version round the operands of every product to
# bfloat16 at values a float32 rounding apart, and K2 reads K1's context
# where the plain version recomputes it.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("attn_p,hid_p", [(0.1, 0.1), (0.1, 0.0), (0.0, 0.1)])
@pytest.mark.parametrize("b,tp,seq", [(16, 149, 149), (2, 160, 149), (1, 37, 37)])
def test_attention_kernel_with_dropout_matches_plain(cuda, dtype, atol, attn_p, hid_p, b, tp, seq):
    """Equal masks show as equal outputs: one flipped element of the hidden
    mask moves its row by far more than the tolerance."""
    h = 12
    args = _sublayer_inputs(b, h, tp, dtype, cuda)
    kw = dict(num_heads=h, seq_len=seq, attn_dropout=attn_p, hidden_dropout=hid_p,
              dropout_seed=1234567)
    got = wavlm_attention_sublayer(*args, **kw)
    want = wavlm_attention_sublayer_plain(*args, **kw)
    off = wavlm_attention_sublayer(*args, num_heads=h, seq_len=seq)
    torch.cuda.synchronize()
    err = (got[:, :seq].float() - want[:, :seq].float()).abs().max().item()
    assert err <= atol, err
    assert (got[:, :seq].float() - off[:, :seq].float()).abs().max().item() > 10 * atol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("attn_p,hid_p", [(0.0, 0.0), (0.1, 0.1)])
@pytest.mark.parametrize("b,tp,seq", [(16, 149, 149), (2, 160, 149), (3, 37, 37)])
def test_attention_backward_kernel_matches_plain(cuda, dtype, attn_p, hid_p, b, tp, seq):
    h = 12
    args = [t.requires_grad_() for t in _sublayer_inputs(b, h, tp, dtype, cuda)]
    statics = dict(num_heads=h, seq_len=seq, attn_dropout=attn_p, hidden_dropout=hid_p,
                   dropout_seed=7654321)
    g = torch.Generator().manual_seed(9)
    dout = torch.randn(b, tp, h * 64, generator=g).to(cuda, dtype)
    dout[:, seq:] = float("nan")  # never read
    before = wavlm_attention_sublayer_backward.launches
    out = wavlm_attention_sublayer(*args, **statics)
    got = torch.autograd.grad(out, args, dout)
    want = wavlm_attention_sublayer_backward_plain(dout, *(a.detach() for a in args), **statics)
    again = torch.autograd.grad(wavlm_attention_sublayer(*args, **statics), args, dout)
    torch.cuda.synchronize()
    assert wavlm_attention_sublayer_backward.launches == before + 2
    for name, x, y, z in zip(GRAD_NAMES, got, want, again):
        assert x.shape == y.shape and torch.isfinite(x).all(), name
        assert x.dtype == (dtype if name in ("hidden", "q", "k", "v", "wo") else torch.float32)
        err = (x.float() - y.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * y.float().abs().max().item(), (name, err)
        assert torch.equal(x, z), f"d{name} differs between two runs"  # no atomics
    for x in got[:4]:
        assert torch.count_nonzero(x[:, seq:]) == 0


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


@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("h,tp,seq", [(12, 149, 149), (12, 149, 131), (12, 160, 149), (12, 160, 57),
                                      (4, 96, 77)])
def test_attention_tensor_core_path_matches_plain(cuda, h, tp, seq, b, dropout):
    """bf16 K1 on the tensor cores (dh = 64, seq_len <= 160) against its
    plain version, rows < seq_len, with and without both dropouts."""
    args = _sublayer_inputs(b, h, tp, torch.bfloat16, cuda, seed=11)
    kw = dict(num_heads=h, seq_len=seq)
    if dropout:
        kw.update(attn_dropout=0.1, hidden_dropout=0.1, dropout_seed=424242)
    got = wavlm_attention_sublayer(*args, **kw)
    want = wavlm_attention_sublayer_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got[:, :seq]).all()
    err = (got[:, :seq].float() - want[:, :seq].float()).abs().max().item()
    assert err <= 3e-2, err


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, {"attn_core_mma", "out_proj_mma"}),
                                         (torch.float32, {"attn_core_tf32", "out_proj_tf32"})])
def test_attention_kernel_route_follows_the_dtype(cuda, dtype, route):
    args = _sublayer_inputs(2, 12, 149, dtype, cuda)
    names = _kernel_names(lambda: wavlm_attention_sublayer(*args, num_heads=12, seq_len=149))
    for name in route:
        assert any(name in n for n in names), (name, names)
    assert any("wavlm_attn_ln" in n for n in names), names


@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("h,tp,seq", [(12, 149, 149), (12, 149, 131), (12, 160, 149), (12, 160, 57),
                                      (4, 96, 77)])
def test_attention_tf32x3_path_matches_plain(cuda, h, tp, seq, b, dropout):
    """float32 K1 on the tensor cores (3xTF32; dh = 64, seq_len <= 160)
    against its plain version at float32's tolerance, rows < seq_len, with
    and without both dropouts (a flipped mask bit moves a row far more)."""
    args = _sublayer_inputs(b, h, tp, torch.float32, cuda, seed=11)
    assert attention_tf32x3_route(args[0], h, seq)
    kw = dict(num_heads=h, seq_len=seq)
    if dropout:
        kw.update(attn_dropout=0.1, hidden_dropout=0.1, dropout_seed=424242)
    got = wavlm_attention_sublayer(*args, **kw)
    want = wavlm_attention_sublayer_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got[:, :seq]).all()
    err = (got[:, :seq] - want[:, :seq]).abs().max().item()
    assert err <= 1e-4, err


@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("b,tp,seq", [(2, 160, 149), (3, 64, 37), (2, 149, 131)])
def test_attention_tf32x3_never_reads_rows_past_seq_len(cuda, b, tp, seq, dropout):
    """NaN in hidden, q, k and v at rows >= seq_len: the float32 tensor-core
    K1 gives the bits it gives with zeros there on every row < seq_len, and
    so do its context and pre-LayerNorm rows (what K2 reads)."""
    h = 12
    args = _sublayer_inputs(b, h, tp, torch.float32, cuda, seed=27)
    kw = dict(num_heads=h, seq_len=seq)
    if dropout:
        kw.update(attn_dropout=0.1, hidden_dropout=0.1, dropout_seed=97)
    results = []
    for fill in (0.0, float("nan")):
        padded = [t.clone() for t in args]
        for t in padded[:4]:
            t[:, seq:] = fill
        results.append(wavlm_attention_sublayer_forward(*padded, **kw))
    torch.cuda.synchronize()
    for name, x, y in zip(("out", "ctx", "pre"), *results):
        assert torch.isfinite(y[:, :seq]).all(), name
        assert torch.equal(x[:, :seq], y[:, :seq]), f"{name} picked up a row past seq_len"


@pytest.mark.parametrize(
    "h,e,tp,seq",
    [(12, 768, 249, 249), (12, 768, 249, 231), (12, 768, 161, 161), (4, 768, 37, 37),
     (8, 256, 64, 64)],
    ids=["seq249", "seq231", "seq161", "dh192", "dh32"],
)
def test_attention_f32_off_the_tf32x3_route_runs_the_cuda_core_kernels(cuda, h, e, tp, seq):
    """float32 K1 past 160 keys or at a head width other than 64 keeps the
    CUDA-core core and out-projection (by name), within 1e-4 of its plain
    version on rows < seq_len."""
    args = _sublayer_inputs(2, h, tp, torch.float32, cuda, seed=29, e=e)
    assert not attention_tf32x3_route(args[0], h, seq)
    kw = dict(num_heads=h, seq_len=seq, attn_dropout=0.1, hidden_dropout=0.1, dropout_seed=31)
    got = wavlm_attention_sublayer(*args, **kw)
    want = wavlm_attention_sublayer_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got[:, :seq] - want[:, :seq]).abs().max().item()
    assert err <= 1e-4, err
    names = _kernel_names(lambda: wavlm_attention_sublayer(*args, **kw))
    for name in ("wavlm_attn_core", "wavlm_attn_out_proj", "wavlm_attn_ln"):
        assert any(name in n for n in names), (name, names)
    assert not any("tf32" in n or "mma" in n for n in names), names


def test_split_tf32_on_the_device_is_bit_equal_to_the_plain_helper(cuda):
    """The kernels' split (`split_tf32` in csrc/hopper.cuh, cvt.rna) on
    normal, tie, subnormal and signed values, against `conv_fe.split_tf32`."""
    g = torch.Generator().manual_seed(17)
    wide = torch.randn(8192, generator=g) * torch.exp2(torch.randint(-120, 120, (8192,), generator=g))
    grid = split_tf32(torch.randn(2048, generator=g))[0]
    step = torch.exp2(torch.floor(torch.log2(grid.abs())) - 11)  # half a TF32 step
    ties = grid + torch.sign(grid) * step
    bits = torch.randint(1, 0x800000, (2048,), generator=g, dtype=torch.int32)
    subnormal = bits.view(torch.float32) * torch.where(torch.rand(2048, generator=g) < 0.5, -1.0, 1.0)
    x = torch.cat([wide, ties, subnormal, torch.tensor([0.0, -0.0, 1.0, 2.0**-126])]).to(cuda)
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    lib = load_library()
    err = lib.emo_split_tf32(x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.numel(),
                             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    want_hi, want_lo = split_tf32(x)
    torch.cuda.synchronize()
    assert torch.equal(hi.view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), want_lo.view(torch.int32))


@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("b,tp,seq", [(2, 249, 249), (1, 249, 231), (3, 161, 161)])
def test_attention_bf16_past_160_keys_runs_the_cuda_core_kernels(cuda, b, tp, seq, dropout):
    """bf16 K1 with seq_len > 160 (a clip longer than about 3.2 s) keeps the
    CUDA-core core and out-projection: against its plain version, rows <
    seq_len, with and without both dropouts, and the kernels by name."""
    args = _sublayer_inputs(b, 12, tp, torch.bfloat16, cuda, seed=13)
    kw = dict(num_heads=12, seq_len=seq)
    if dropout:
        kw.update(attn_dropout=0.1, hidden_dropout=0.1, dropout_seed=8642)
    got = wavlm_attention_sublayer(*args, **kw)
    want = wavlm_attention_sublayer_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got[:, :seq]).all()
    err = (got[:, :seq].float() - want[:, :seq].float()).abs().max().item()
    assert err <= 3e-2, err
    names = _kernel_names(lambda: wavlm_attention_sublayer(*args, **kw))
    for name in ("wavlm_attn_core", "wavlm_attn_out_proj", "wavlm_attn_ln"):
        assert any(name in n for n in names), (name, names)
    assert not any("mma" in n for n in names), names


def _misaligned(x):
    """x's values in a contiguous tensor whose data starts one element (2
    bytes in bf16, 4 in float32) past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def test_bf16_tensor_core_kernels_refuse_misaligned_operands(cuda):
    """K3's and K1's tensor-core launchers raise on an operand that is not
    16-byte aligned; neither sends it to its CUDA-core kernel."""
    cin = 512
    y = torch.randn(2, 300, 2 * cin, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(3 * cin, 512, device=cuda, dtype=torch.bfloat16) * 0.03
    assert tensor_core_route(_misaligned(y), w, 3, cin, False)
    before = fused_conv_layer.launches
    for yy, ww in ((_misaligned(y), w), (y, _misaligned(w))):
        with pytest.raises(RuntimeError, match="fused_conv_layer: CUDA error"):
            fused_conv_layer(yy, ww, 3, 2, cin, gelu_output=True)
    assert fused_conv_layer.launches == before
    args = _sublayer_inputs(2, 12, 149, torch.bfloat16, cuda)
    args[1] = _misaligned(args[1])
    before = wavlm_attention_sublayer.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        wavlm_attention_sublayer(*args, num_heads=12, seq_len=149)
    assert wavlm_attention_sublayer.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_behind_the_kernel_forward(cuda, dtype):
    """K2's ten gradients at the serving shape with seq_len < Tp and both
    dropouts, reading the context and pre-LayerNorm rows the forward wrote
    (in bf16 the tensor-core K1); two runs bit-identical."""
    b, h, tp, seq = 8, 12, 149, 131
    args = [t.requires_grad_() for t in _sublayer_inputs(b, h, tp, dtype, cuda, seed=5)]
    statics = dict(num_heads=h, seq_len=seq, attn_dropout=0.1, hidden_dropout=0.1,
                   dropout_seed=97531)
    g = torch.Generator().manual_seed(6)
    dout = torch.randn(b, tp, h * 64, generator=g).to(cuda, dtype)
    got = torch.autograd.grad(wavlm_attention_sublayer(*args, **statics), args, dout)
    again = torch.autograd.grad(wavlm_attention_sublayer(*args, **statics), args, dout)
    want = wavlm_attention_sublayer_backward_plain(dout, *(a.detach() for a in args), **statics)
    torch.cuda.synchronize()
    for name, x, y, z in zip(GRAD_NAMES, got, want, again):
        assert torch.isfinite(x).all(), name
        err = (x.float() - y.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * y.float().abs().max().item(), (name, err)
        assert torch.equal(x, z), f"d{name} differs between two runs"


# K2's kernels by route: the tensor-core ones (dh 64, seq_len <= 160; bf16
# `tensor_core_route`, f32 `tf32x3_route`) and the CUDA-core ones, which those
# routes must not launch.
K2_TENSOR_CORE = {torch.bfloat16: ("bwd_proj_mma", "bwd_attn_mma"),
                  torch.float32: ("bwd_transpose_tf32", "bwd_proj_tf32", "bwd_query_tf32",
                                  "bwd_key_tf32")}
K2_CUDA_CORE = ("bwd_gemm", "bwd_attn_q", "bwd_attn_kv")


@pytest.mark.parametrize(
    "dtype,h,e,tp,seq,tensor_cores",
    [(torch.bfloat16, 12, 768, 149, 149, True), (torch.bfloat16, 12, 768, 37, 37, True),
     (torch.bfloat16, 4, 256, 96, 77, True), (torch.float32, 12, 768, 149, 149, True),
     (torch.bfloat16, 12, 768, 161, 161, False), (torch.bfloat16, 4, 768, 37, 37, False),
     (torch.float32, 12, 768, 161, 161, False), (torch.float32, 4, 768, 37, 37, False),
     (torch.float32, 4, 256, 96, 77, True), (torch.float32, 12, 768, 37, 37, True)],
    ids=["bf16-149", "bf16-37", "bf16-4heads-dh64", "f32", "bf16-161", "bf16-4heads-dh192",
         "f32-161", "f32-4heads-dh192", "f32-4heads-dh64", "f32-37"],
)
def test_attention_backward_route_follows_the_arguments(cuda, dtype, h, e, tp, seq, tensor_cores):
    """K2 runs its tensor-core kernels at head width 64 and seq_len <= 160
    (bf16 on mma.sync, f32 in 3xTF32) and its CUDA-core kernels elsewhere
    (kernel names by profiler), and its ten gradients agree with the plain
    backward on either route."""
    args = _sublayer_inputs(2, h, tp, dtype, cuda, seed=21, e=e)
    kw = dict(num_heads=h, seq_len=seq, attn_dropout=0.1, hidden_dropout=0.1, dropout_seed=1357)
    route = attention_tensor_core_route if dtype == torch.bfloat16 else attention_tf32x3_route
    assert route(args[0], h, seq) is tensor_cores
    dout = torch.randn(2, tp, e, generator=torch.Generator().manual_seed(22)).to(cuda, dtype)
    _, ctx, pre = wavlm_attention_sublayer_forward(*args, **kw)
    got = wavlm_attention_sublayer_backward(dout, *args, ctx, pre, **kw)
    want = wavlm_attention_sublayer_backward_plain(dout, *args, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(GRAD_NAMES, got, want):
        assert torch.isfinite(x).all(), name
        err = (x.float() - y.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * y.float().abs().max().item(), (name, err)
    names = _kernel_names(lambda: wavlm_attention_sublayer_backward(dout, *args, ctx, pre, **kw))
    other = sum((v for d, v in K2_TENSOR_CORE.items() if d != dtype), ())
    ran, left_out = ((K2_TENSOR_CORE[dtype], K2_CUDA_CORE + other) if tensor_cores
                     else (K2_CUDA_CORE, K2_TENSOR_CORE[dtype] + other))
    for name in ran + ("bwd_ln", "bwd_colsum", "bwd_dbias_reduce"):
        assert any(name in n for n in names), (name, names)
    for name in left_out:
        assert not any(name in n for n in names), (name, names)


def _backward_refuses_misaligned_operands(dtype, device):
    """K2's tensor-core route raises on an operand that is not 16-byte
    aligned and counts no launch; it never sends it to the CUDA-core kernels."""
    h, tp = 12, 149
    args = _sublayer_inputs(2, h, tp, dtype, device, seed=23)
    kw = dict(num_heads=h, seq_len=tp)
    _, ctx, pre = wavlm_attention_sublayer_forward(*args, **kw)
    dout = torch.randn(2, tp, h * 64, device=device, dtype=dtype)
    before = wavlm_attention_sublayer_backward.launches
    for i in (1, 2, 3, 6, None):  # q, k, v, wo, then K1's context
        bad = list(args)
        bad_ctx = ctx
        if i is None:
            bad_ctx = _misaligned(ctx)
        else:
            bad[i] = _misaligned(args[i])
        with pytest.raises(RuntimeError, match="wavlm_attention_sublayer_backward: CUDA error"):
            wavlm_attention_sublayer_backward(dout, *bad, bad_ctx, pre, **kw)
    assert wavlm_attention_sublayer_backward.launches == before


def test_attention_backward_refuses_misaligned_bf16_operands(cuda):
    """K2's bf16 tensor-core route (mma.sync) refuses misaligned operands."""
    _backward_refuses_misaligned_operands(torch.bfloat16, cuda)


def test_attention_backward_refuses_misaligned_f32_operands(cuda):
    """K2's f32 tensor-core route (3xTF32: cp.async and TMA) refuses
    misaligned operands."""
    assert attention_tf32x3_route(torch.zeros(1, 149, 768), 12, 149)
    _backward_refuses_misaligned_operands(torch.float32, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tp,seq", [(2, 160, 149), (3, 64, 37), (2, 149, 131)])
def test_attention_backward_never_reads_rows_past_seq_len(cuda, dtype, b, tp, seq):
    """NaN in q, k, v, K1's context and pre-LayerNorm rows, hidden and the
    cotangent at rows >= seq_len: all ten gradients are bit-equal to those
    with zeros there, and the rows past seq_len of dhidden/dq/dk/dv are zero."""
    h = 12
    args = _sublayer_inputs(b, h, tp, dtype, cuda, seed=25)
    kw = dict(num_heads=h, seq_len=seq, attn_dropout=0.1, hidden_dropout=0.1, dropout_seed=2468)
    _, ctx, pre = wavlm_attention_sublayer_forward(*args, **kw)
    dout = torch.randn(b, tp, h * 64, generator=torch.Generator().manual_seed(26)).to(cuda, dtype)

    def padded(fill):
        out = [t.clone() for t in (dout, *args[:4], ctx, pre)]
        for t in out:
            t[:, seq:] = fill
        return out

    results = []
    for fill in (0.0, float("nan")):
        d, hidden, q, k, v, c, p = padded(fill)
        results.append(wavlm_attention_sublayer_backward(
            d, hidden, q, k, v, *args[4:], c, p, **kw))
    torch.cuda.synchronize()
    for name, x, y in zip(GRAD_NAMES, *results):
        assert torch.isfinite(y).all(), name
        assert torch.equal(x, y), f"d{name} picked up a row past seq_len"
    for x in results[1][:4]:
        assert torch.count_nonzero(x[:, seq:]) == 0


# The six conv layers of WavLM-base after L0, at a 3 s clip: (k, t_in); every
# t_in is odd, so the last input row is half past t_in and the last M tile partial.
CONV_LAYERS = [(3, 9599), (3, 4799), (3, 2399), (3, 1199), (2, 599), (2, 299)]


@pytest.mark.parametrize("gelu_in,gelu_out", [(False, True), (False, False), (True, False),
                                              (True, True)])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("layer", range(1, 7), ids=lambda i: f"L{i}")
def test_conv_kernel_bf16_matches_plain_on_every_layer(cuda, layer, b, gelu_in, gelu_out):
    """bf16 K3 on each layer shape; with gelu_input the CUDA-core kernel
    runs (the tensor-core kernel does not take it).  NaN past t_in in the
    buffer reaches no row < t_out."""
    k, t_in = CONV_LAYERS[layer - 1]
    cin = cout = 512
    s = 2
    rows = -(-t_in // s)
    g = torch.Generator().manual_seed(layer)
    y = torch.randn(b, rows, s * cin, generator=g).to(cuda, torch.bfloat16)
    y.view(b, rows * s, cin)[:, t_in:] = float("nan")
    w = (torch.randn(k * cin, cout, generator=g) * (k * cin) ** -0.5).to(cuda, torch.bfloat16)
    assert tensor_core_route(y, w, k, cin, gelu_in) == (not gelu_in)
    flags = dict(gelu_input=gelu_in, gelu_output=gelu_out, t_in=t_in)
    before = fused_conv_layer.launches
    got = fused_conv_layer(y, w, k, s, cin, **flags)
    want = fused_conv_layer_plain(y, w, k, s, cin, **flags)
    torch.cuda.synchronize()
    assert fused_conv_layer.launches == before + 1
    t_out = (t_in - k) // s + 1
    ref = want[:, :t_out].float()
    assert torch.isfinite(got[:, :t_out]).all()
    err = (got[:, :t_out].float() - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


@pytest.mark.parametrize(
    "cin,cout,k,s,t_in",
    [(64, 200, 3, 2, 301), (128, 72, 2, 2, 97), (64, 136, 5, 2, 203), (64, 64, 4, 3, 95)],
    ids=["cout200", "cout72", "k5_shift2", "stride3"],
)
def test_conv_tensor_core_kernel_on_other_shapes(cuda, cin, cout, k, s, t_in):
    """Shapes the tensor-core route takes beyond WavLM's: a partial last
    column tile (cout not a multiple of 128), taps two input rows ahead,
    stride 3; against the plain version."""
    rows = -(-t_in // s)
    g = torch.Generator().manual_seed(cout + k)
    y = torch.randn(3, rows, s * cin, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(k * cin, cout, generator=g) * (k * cin) ** -0.5).to(cuda, torch.bfloat16)
    assert tensor_core_route(y, w, k, cin, False)
    got = fused_conv_layer(y, w, k, s, cin, gelu_output=True, t_in=t_in)
    want = fused_conv_layer_plain(y, w, k, s, cin, gelu_output=True, t_in=t_in)
    torch.cuda.synchronize()
    t_out = (t_in - k) // s + 1
    ref = want[:, :t_out].float()
    err = (got[:, :t_out].float() - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


@pytest.mark.parametrize("gelu_in,kernel", [(False, "conv_fe_wgmma"), (True, "conv_fe_kernel")])
def test_conv_kernel_route_follows_the_arguments(cuda, gelu_in, kernel):
    cin = 512
    y = torch.randn(2, 300, 2 * cin, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(3 * cin, 512, device=cuda, dtype=torch.bfloat16) * 0.03
    names = _kernel_names(lambda: fused_conv_layer(y, w, 3, 2, cin, gelu_input=gelu_in))
    assert any(kernel in n for n in names), names
    assert len([n for n in names if "conv_fe" in n]) == 1, names


@pytest.mark.parametrize("gelu_out", [True, False])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("layer", range(1, 7), ids=lambda i: f"L{i}")
def test_conv_kernel_f32_matches_plain_on_every_layer(cuda, layer, b, gelu_out):
    """float32 K3 on the tensor cores (3xTF32) on each layer shape, against
    its plain version at float32's tolerance, with the split weight made by
    the wrapper and passed in (the same bits).  NaN past t_in in the buffer
    reaches no row < t_out."""
    k, t_in = CONV_LAYERS[layer - 1]
    cin = cout = 512
    s = 2
    rows = -(-t_in // s)
    g = torch.Generator().manual_seed(layer)
    y = torch.randn(b, rows, s * cin, generator=g).to(cuda)
    y.view(b, rows * s, cin)[:, t_in:] = float("nan")
    w = (torch.randn(k * cin, cout, generator=g) * (k * cin) ** -0.5).to(cuda)
    assert tf32x3_route(y, w, k, cin, False)
    flags = dict(gelu_output=gelu_out, t_in=t_in)
    before = fused_conv_layer.launches
    got = fused_conv_layer(y, w, k, s, cin, **flags)
    again = fused_conv_layer(y, w, k, s, cin, **flags, w_split=split_weight_tf32(w))
    want = fused_conv_layer_plain(y, w, k, s, cin, **flags)
    torch.cuda.synchronize()
    assert fused_conv_layer.launches == before + 2
    t_out = (t_in - k) // s + 1
    assert torch.isfinite(got[:, :t_out]).all()
    assert torch.equal(got[:, :t_out], again[:, :t_out])
    err = (got[:, :t_out] - want[:, :t_out]).abs().max().item()
    assert err <= 1e-4, err


@pytest.mark.parametrize(
    "cin,cout,k,s,t_in",
    [(64, 200, 3, 2, 301), (128, 72, 2, 2, 97), (64, 136, 5, 2, 203), (64, 64, 4, 3, 95),
     (32, 64, 3, 2, 101)],
    ids=["cout200", "cout72", "k5_shift2", "stride3", "cin32"],
)
def test_conv_tf32x3_kernel_on_other_shapes(cuda, cin, cout, k, s, t_in):
    """Shapes the float32 tensor-core route takes beyond WavLM's (a partial
    last column tile, taps two input rows ahead, stride 3, cin 32), against
    the plain version."""
    rows = -(-t_in // s)
    g = torch.Generator().manual_seed(cout + k)
    y = torch.randn(3, rows, s * cin, generator=g).to(cuda)
    w = (torch.randn(k * cin, cout, generator=g) * (k * cin) ** -0.5).to(cuda)
    assert tf32x3_route(y, w, k, cin, False)
    got = fused_conv_layer(y, w, k, s, cin, gelu_output=True, t_in=t_in)
    want = fused_conv_layer_plain(y, w, k, s, cin, gelu_output=True, t_in=t_in)
    torch.cuda.synchronize()
    t_out = (t_in - k) // s + 1
    err = (got[:, :t_out] - want[:, :t_out]).abs().max().item()
    assert err <= 1e-4, err


@pytest.mark.parametrize("gelu_in,cin,kernel", [(False, 512, "conv_fe_tf32"),
                                                (True, 512, "conv_fe_kernel"),
                                                (False, 48, "conv_fe_kernel")])
def test_conv_kernel_f32_route_follows_the_arguments(cuda, gelu_in, cin, kernel):
    """float32 K3: the 3xTF32 kernel without `gelu_input`; the CUDA-core
    kernel with it, or at a cin that is not a multiple of 32, within 1e-4."""
    y = torch.randn(2, 300, 2 * cin, device=cuda)
    w = torch.randn(3 * cin, 512, device=cuda) * (3 * cin) ** -0.5
    names = _kernel_names(lambda: fused_conv_layer(y, w, 3, 2, cin, gelu_input=gelu_in))
    assert any(kernel in n for n in names), names
    assert len([n for n in names if "conv_fe" in n]) == 1, names
    got = fused_conv_layer(y, w, 3, 2, cin, gelu_input=gelu_in)
    want = fused_conv_layer_plain(y, w, 3, 2, cin, gelu_input=gelu_in)
    torch.cuda.synchronize()
    t_out = (600 - 3) // 2 + 1
    assert (got[:, :t_out] - want[:, :t_out]).abs().max().item() <= 1e-4


def test_f32_tensor_core_kernels_refuse_misaligned_operands(cuda):
    """K3's and K1's float32 tensor-core launchers raise on an operand that
    is not 16-byte aligned; neither sends it to its CUDA-core kernel."""
    cin = 512
    y = torch.randn(2, 300, 2 * cin, device=cuda)
    w = torch.randn(3 * cin, 512, device=cuda) * 0.03
    assert tf32x3_route(_misaligned(y), w, 3, cin, False)
    before = fused_conv_layer.launches
    for yy, split in ((_misaligned(y), None), (y, _misaligned(split_weight_tf32(w)))):
        with pytest.raises(RuntimeError, match="fused_conv_layer: CUDA error"):
            fused_conv_layer(yy, w, 3, 2, cin, gelu_output=True, w_split=split)
    assert fused_conv_layer.launches == before
    args = _sublayer_inputs(2, 12, 149, torch.float32, cuda)
    args[1] = _misaligned(args[1])
    before = wavlm_attention_sublayer.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        wavlm_attention_sublayer(*args, num_heads=12, seq_len=149)
    assert wavlm_attention_sublayer.launches == before


class _Tower(torch.nn.Module):
    def __init__(self, width):
        super().__init__()
        self.embedding_dim = self.sequence_dim = width

    def encode_sequence(self, x, *train):
        return x


def _fusion_block(device, pooling, head, prior, int8, seed=2):
    """A full-width fusion block, every parameter random -> (model, params, spec)."""
    g = torch.Generator().manual_seed(seed)
    model = FusionModel(
        _Tower(768), _Tower(512), num_classes=8, xattn_head=head, temporal_pooling=pooling,
        xattn_use_emotion_prior=prior,
    )
    init_parameters(model, g)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim < 2:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    model = model.to(device).eval()
    if int8:
        quantize_linears_int8(model)
    spec = FusedBlockSpec(num_heads=4, d_model=128, pooling=pooling, head=head,
                          use_prior=prior, num_classes=8)
    return model, extract_block_params(model.state_dict(), spec, device=device), spec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("b,samples_per_block", [(8, 1), (8, 8), (5, 2), (1, 1)])
@pytest.mark.parametrize(
    "pooling,head,prior",
    [("mean", "concat", False), ("attn", "gated", True), ("attn", "concat", False)],
)
def test_fused_block_kernel_matches_plain(
    cuda, pooling, head, prior, b, samples_per_block, int8, dtype
):
    _, params, spec = _fusion_block(cuda, pooling, head, prior, int8)
    g = torch.Generator().manual_seed(3)
    v_feat = torch.randn(b, 8, 512, generator=g).abs().to(cuda, dtype)
    a_seq = torch.randn(b, 149, 768, generator=g).to(cuda, dtype)
    before = fused_block.launches
    got = fused_block(v_feat, a_seq, params, spec, samples_per_block=samples_per_block)
    want = fused_block_plain(v_feat, a_seq, params, spec)
    torch.cuda.synchronize()
    assert fused_block.launches == before + 1
    assert got.shape == (b, 8) and got.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= 1e-4, err


def test_fused_block_kernel_matches_the_modular_model(cuda):
    model, params, spec = _fusion_block(cuda, "attn", "gated", True, int8=False)
    model.video_model.encode_frames = lambda x, *train: x
    model.audio_model.encode_sequence = lambda x, *train: x
    g = torch.Generator().manual_seed(4)
    v_feat = torch.randn(3, 8, 512, generator=g).abs().to(cuda)
    a_seq = torch.randn(3, 149, 768, generator=g).to(cuda)
    with torch.no_grad():
        want = model(v_feat, a_seq)
    got = fused_block(v_feat, a_seq, params, spec)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


def test_fused_block_kernel_refuses_what_it_does_not_take(cuda):
    _, params, spec = _fusion_block(cuda, "mean", "concat", False, int8=False)
    v_feat = torch.randn(2, 8, 512, device=cuda)
    a_seq = torch.randn(2, 149, 768, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_block(v_feat.transpose(0, 1).contiguous().transpose(0, 1), a_seq, params, spec)
    with pytest.raises(ValueError, match="outside what the K4 kernel takes"):
        fused_block(torch.randn(2, 40, 512, device=cuda), a_seq, params, spec)


_K4_TENSOR_CORE = ("fb_rows_tc", "fb_video_tc", "fb_audio_tc", "fb_head_tc")
_K4_CUDA_CORE = ("fused_block_audio_tokens", "fused_block_core")


@pytest.mark.parametrize(
    "ta,ds,dv,tensor_cores",
    [(149, 768, 512, True), (16, 768, 512, True), (15, 768, 240, False), (149, 772, 512, False)],
    ids=["serving", "ta16", "ta15", "ds772"],
)
def test_fused_block_route_follows_the_shapes(cuda, ta, ds, dv, tensor_cores):
    """Ta=15 (with towers narrow enough for the CUDA-core kernel, which stages
    v_feat in a [Ta, d] buffer) and Ds=772 (not a multiple of 8) take the
    CUDA-core kernel; the serving shapes and Ta=16 the tensor-core route."""
    from multimodalemotionrecognition_torch.kernels.fused_block import tensor_core_route

    _, params, spec = _fusion_block(cuda, "attn", "gated", True, int8=False)
    for name, width in (("aseq_w", ds), ("vin_w", dv)):
        if params.matrices[name].shape[0] != width:  # another tower width
            params.matrices[name] = torch.randn(width, 128, device=cuda) * width**-0.5
            params._table = None
    g = torch.Generator().manual_seed(6)
    v_feat = torch.randn(2, 8, dv, generator=g).abs().to(cuda)
    a_seq = torch.randn(2, ta, ds, generator=g).to(cuda)
    assert tensor_core_route(v_feat, a_seq, params, spec) is tensor_cores
    names = _kernel_names(lambda: fused_block(v_feat, a_seq, params, spec))
    want, other = (_K4_TENSOR_CORE, _K4_CUDA_CORE) if tensor_cores else (_K4_CUDA_CORE, _K4_TENSOR_CORE)
    assert all(any(w in n for n in names) for w in want), names
    assert not any(o in n for o in other for n in names), names
    got = fused_block(v_feat, a_seq, params, spec)
    assert (got - fused_block_plain(v_feat, a_seq, params, spec)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize(
    "pooling,head,prior", [("mean", "concat", False), ("attn", "gated", True)],
    ids=["mean_concat", "attn_gated_prior"],
)
def test_fused_block_tensor_core_route_is_bit_identical_across_blocks_and_runs(
    cuda, pooling, head, prior, b, int8, dtype
):
    _, params, spec = _fusion_block(cuda, pooling, head, prior, int8)
    g = torch.Generator().manual_seed(7)
    v_feat = torch.randn(b, 8, 512, generator=g).abs().to(cuda, dtype)
    a_seq = torch.randn(b, 149, 768, generator=g).to(cuda, dtype)
    runs = [fused_block(v_feat, a_seq, params, spec, samples_per_block=k) for k in (1, 3, 8, 1)]
    want = fused_block_plain(v_feat, a_seq, params, spec)
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert (runs[0] - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("which", ["v_feat", "a_seq"])
def test_fused_block_tensor_core_route_refuses_misaligned_towers(cuda, which):
    _, params, spec = _fusion_block(cuda, "mean", "concat", False, int8=False)
    shapes = {"v_feat": (2, 8, 512), "a_seq": (2, 149, 768)}
    tensors = {k: torch.randn(*shape, device=cuda) for k, shape in shapes.items()}
    shape = shapes[which]  # the same shape, one float past a 16-byte boundary
    tensors[which] = torch.randn(int(torch.tensor(shape).prod()) + 1, device=cuda)[1:].view(shape)
    before = fused_block.launches
    with pytest.raises(RuntimeError, match="misaligned"):
        fused_block(tensors["v_feat"], tensors["a_seq"], params, spec)
    assert fused_block.launches == before


def _xattn_params(d, seed=7):
    """Random K5 parameters of width d (the fusion block's are 128 wide)."""
    from multimodalemotionrecognition_torch.kernels import XattnParams

    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale):
        return (torch.randn(*shape, generator=g) * scale).to("cuda")

    values = {}
    for name in XattnParams._fields:
        kind = name.split("_", 1)[1]
        if kind == "in_kernel":
            values[name] = r(d, 3 * d, scale=d ** -0.5)
        elif kind == "out_kernel":
            values[name] = r(d, d, scale=d ** -0.5)
        elif kind == "in_bias":
            values[name] = r(3 * d, scale=0.1)
        else:
            values[name] = r(d, scale=0.1) + (1.0 if kind == "norm_scale" else 0.0)
    return XattnParams(**values)


K5_TENSOR_CORE = ("xa_rows_tc", "xa_video_tc", "xa_audio_tc", "xa_pool")
K5_CUDA_CORE = ("xattn_audio_proj", "xattn_core")


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("b,ta,d", [(8, 149, 128), (3, 149, 128), (1, 149, 128), (8, 16, 128),
                                    (3, 16, 128), (1, 16, 128), (3, 37, 128), (3, 37, 48)])
def test_xattn_kernel_matches_plain(cuda, b, ta, d, with_bias):
    """K5 within FUSION_TOL of its plain version, one counted launch a call.
    At d = 128 the tensor-core route runs (`xattn_tc.cuh`), and a sample's
    embeddings are the same bits at every B and across runs; d = 48 is
    outside that route and takes the CUDA-core kernels."""
    from multimodalemotionrecognition_torch.kernels.xattn import tensor_core_route

    if d == 128:
        model, _, _ = _fusion_block(cuda, "mean", "concat", False, int8=False)
        params = xattn_params_from_state_dict(model.state_dict(), device=cuda)
    else:
        params = _xattn_params(d)
    g = torch.Generator().manual_seed(5)
    v8 = torch.randn(8, 8, d, generator=g).to(cuda)
    a8 = torch.randn(8, ta, d, generator=g).to(cuda)
    biases8 = (None, None)
    if with_bias:
        biases8 = ((torch.randn(8, 8, ta, generator=g) * 0.5).to(cuda),
                   (torch.randn(8, ta, 8, generator=g) * 0.5).to(cuda))
    v, a = v8[:b].contiguous(), a8[:b].contiguous()
    biases = tuple(None if x is None else x[:b].contiguous() for x in biases8)
    tensor_cores = tensor_core_route(v, a, 4)
    assert tensor_cores == (d == 128)
    before = fused_bidirectional_xattn.launches
    got = fused_bidirectional_xattn(params, v, a, *biases, num_heads=4)
    want = fused_bidirectional_xattn_plain(params, v, a, *biases, num_heads=4)
    torch.cuda.synchronize()
    assert fused_bidirectional_xattn.launches == before + 1
    for x, y in zip(got, want):
        assert x.shape == (b, d)
        assert (x - y).abs().max().item() <= 1e-4
    names = _kernel_names(lambda: fused_bidirectional_xattn(params, v, a, *biases, num_heads=4))
    want_names, other = ((K5_TENSOR_CORE, K5_CUDA_CORE) if tensor_cores
                         else (K5_CUDA_CORE, K5_TENSOR_CORE))
    assert all(any(w in n for n in names) for w in want_names), names
    assert not any(o in n for o in other for n in names), names
    if tensor_cores:
        full = fused_bidirectional_xattn(params, v8, a8, *biases8, num_heads=4)
        again = fused_bidirectional_xattn(params, v, a, *biases, num_heads=4)
        for x, y, z in zip(got, full, again):
            assert torch.equal(x, y[:b]) and torch.equal(x, z)


# ---------------------------------------------------------------------------
# the trainer's gradient accumulation and warm start, through the kernels
# ---------------------------------------------------------------------------


def _flagship_trainer(cuda, dtype, tmp_path, **train_kw):
    from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig
    from multimodalemotionrecognition_torch.train import EmotionTrainer

    trainer = EmotionTrainer(
        ModelConfig(fusion="xattn", use_wavlm=True, compute_dtype=dtype),
        TrainConfig(two_stage_training=True, output_dir=str(tmp_path), **train_kw), device=cuda,
    )
    state = trainer.init_state()
    runs = []  # WavLM's layers_run after each forward: one entry per microbatch
    state.model.audio_model.wavlm.register_forward_hook(
        lambda m, i, o: runs.append(list(m.layers_run)))
    return trainer, state, runs


def _flagship_batch(cuda, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 256, (b, 8, 3, 112, 112), generator=g, dtype=torch.uint8).to(cuda),
            (torch.randn(b, 1, 48000, generator=g) * 0.1).to(cuda),
            torch.randint(0, 8, (b,), generator=g).to(cuda), torch.ones(b, dtype=torch.bool).to(cuda))


def _stage2_step_launches(trainer, state, runs, batch):
    counters = (wavlm_attention_sublayer, fused_conv_layer, wavlm_attention_sublayer_backward)
    before = [fn.launches for fn in counters]
    runs.clear()
    total, *_ = trainer.train_step(state, *batch, trainer.trainable_mask(2), trainer.lr_tree(2, {}))
    torch.cuda.synchronize()
    assert torch.isfinite(total)
    got = [fn.launches - n for fn, n in zip(counters, before)]
    want = [sum(len(r) for r in runs), 6 * len(runs), sum(len({10, 11} & set(r)) for r in runs)]
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_grad_accum_step_launches_the_kernels_per_microbatch(cuda, dtype, tmp_path):
    """A grad_accum=2 stage-2 step of the full-width flagship: per microbatch
    12 K1 less the LayerDrop skips, 6 K3, one K2 per trainable layer that ran;
    one optimizer step."""
    trainer, state, runs = _flagship_trainer(cuda, dtype, tmp_path, grad_accum=2)
    got, want = _stage2_step_launches(trainer, state, runs, _flagship_batch(cuda, 4))
    assert len(runs) == 2 and got == want, (got, want, runs)
    assert state.opt_state.count == 1 and state.step == 1


def test_trainer_warm_start_then_step(cuda, tmp_path):
    """Branch checkpoints written by `convert/pretrained.py` from torchvision-
    and HF-layout dicts (the positional conv as weight-norm g and v) land in
    the branches; then a stage-2 step through the kernels."""
    from multimodalemotionrecognition_torch.convert.pretrained import convert_pretrained

    source, _, _ = _flagship_trainer(cuda, "float32", tmp_path, seed=1)
    names = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3", "7": "layer4"}
    video = {f"{names[k.split('.')[1]]}.{k.split('.', 2)[2]}": v.cpu()
             for k, v in source.model.video_model.state_dict().items()}
    video["fc.weight"], video["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    audio = {k.removeprefix("wavlm."): v.cpu() for k, v in source.model.audio_model.state_dict().items()}
    pos = "encoder.pos_conv_embed.conv"
    w = audio.pop(pos + ".weight")
    norm = w.double().pow(2).sum(dim=(0, 1), keepdim=True).sqrt().float()
    audio[pos + ".weight_g"], audio[pos + ".weight_v"] = norm, w.clone()  # g * v / |v| = w
    for arch, raw in (("resnet18", video), ("wavlm-base", audio)):
        torch.save(raw, tmp_path / f"{arch}.pth")
        convert_pretrained(arch, tmp_path / f"{arch}.pth", tmp_path / f"{arch}.pt")
    trainer, state, runs = _flagship_trainer(
        cuda, "float32", tmp_path, seed=2, audio_ckpt=str(tmp_path / "wavlm-base.pt"),
        video_ckpt=str(tmp_path / "resnet18.pt"))
    assert trainer.warm_start_report == {"audio_model": (0, 0), "video_model": (0, 0)}
    want = source.model.state_dict()
    for key, value in state.model.state_dict().items():
        if key.startswith(("audio_model.", "video_model.")):
            tol = 1e-6 if key.endswith(pos + ".weight") else 0.0
            assert (value - want[key]).abs().max().item() <= tol, key
    got, want = _stage2_step_launches(trainer, state, runs, _flagship_batch(cuda, 2, seed=1))
    assert got == want, (got, want, runs)


# A 2-layer WavLM with the base model's seven conv layers, at narrow widths.
SMALL_WAVLM = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                   conv_dim=(16,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
# abs. Without augmentation both wires give the same frames (the device's
# /255 and normalisation are the host's float32 operations). With it, the
# frame noise (sigma <= 5e-4) is drawn on the device for the uint8 wire, and
# the float wire's frame noise consumes the per-sample RandomState before the
# audio's noise draws, so the audio augmentation is another draw too (as in
# the JAX package): the losses then agree as two draws of one distribution.
WIRE_LOSS_TOL = {False: 1e-5, True: 0.25}


@pytest.mark.parametrize("augment", [False, True])
def test_trainer_epoch_from_the_loaders_on_either_video_wire(cuda, tmp_path, monkeypatch, augment):
    """One stage-1 epoch of the flagship at a small WavLM through
    `build_loaders`, on the uint8 wire (the augmentation's tail replayed on
    the card) against the float32 wire, through the kernels."""
    import numpy as np

    from multimodalemotionrecognition_torch.config import DataConfig, ModelConfig, TrainConfig, VideoConfig
    from multimodalemotionrecognition_torch.data.pipeline import build_loaders
    from multimodalemotionrecognition_torch.data.synthetic import generate_synthetic_ravdess
    from multimodalemotionrecognition_torch.train import EmotionTrainer

    generate_synthetic_ravdess(tmp_path / "corpus", actors=(1, 2), emotions=(3, 5), seconds=0.5,
                               size=64, seed=3, clips_per_pair=2)
    monkeypatch.chdir(tmp_path)
    dc = DataConfig(data_root=str(tmp_path / "corpus"), split_mode="actor", train_actors=(1, 2),
                    val_actors=(), test_actors=(), video=VideoConfig(num_frames=2, size=32),
                    use_face_crop=False, train_augment=augment)
    losses, launches = {}, {}
    for wire in ("float32", "uint8"):
        train, _, _ = build_loaders(dc, 4, num_workers=2, wire=wire)
        trainer = EmotionTrainer(
            ModelConfig(fusion="xattn", use_wavlm=True, xattn_d_model=32, wavlm_geometry=SMALL_WAVLM),
            TrainConfig(two_stage_training=True, seed=0, output_dir=str(tmp_path)), device=cuda)
        state = trainer.init_state()
        before = wavlm_attention_sublayer.launches, fused_conv_layer.launches
        _, metrics = trainer.run_epoch(state, train, True, trainer.trainable_mask(1),
                                       trainer.lr_tree(1, {}))
        launches[wire] = (wavlm_attention_sublayer.launches - before[0],
                          fused_conv_layer.launches - before[1])
        losses[wire] = metrics["loss"]
    assert all(map(np.isfinite, losses.values())), losses
    assert abs(losses["uint8"] - losses["float32"]) <= WIRE_LOSS_TOL[augment], losses
    assert all(k1 >= 1 and k3 == 12 for k1, k3 in launches.values()), launches  # 2 steps x 6


# ---------------------------------------------------------------------------
# the serving stack: the dynamic batcher over the kernels' runner
# ---------------------------------------------------------------------------

SERVE_TOL = {"float32": 1e-3, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def flagship_ckpt(tmp_path_factory):
    """The full-width flagship, random weights from a seed, as a reference-format .pt."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multimodalemotionrecognition_torch.config import ModelConfig
    from multimodalemotionrecognition_torch.models.factory import build_model

    cfg = ModelConfig(fusion="xattn", use_wavlm=True)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    path = tmp_path_factory.mktemp("serve") / "flagship.pt"
    torch.save({"model": model.state_dict(), "config": cfg.to_checkpoint_dict()}, path)
    return str(path)


def _wav_payloads(n, seed):
    """.wav uploads of seeded noise at 16, 48 and 22.05 kHz (3, 2 and 4 s)."""
    import io

    import numpy as np
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        sr, seconds = ((16000, 3.0), (48000, 2.0), (22050, 4.0))[i % 3]
        buf = io.BytesIO()
        wavfile.write(buf, sr, np.clip(rng.randn(int(sr * seconds)) * 4000, -32768, 32767).astype(np.int16))
        out.append((f"clip{i}.wav", buf.getvalue()))
    return out


def _burst_through_the_batcher(runner, bursts):
    """Each burst's uploads submitted at once to a gateway + `DynamicBatcher`
    over `runner`, one burst after another; -> per burst the results in
    submission order, and the batcher's batch sizes."""
    import asyncio

    from multimodalemotionrecognition_torch.config import ServeConfig
    from multimodalemotionrecognition_torch.serving.batcher import DynamicBatcher, InferenceGateway

    async def scenario():
        cfg = ServeConfig()
        gateway = InferenceGateway(cfg)
        batcher = DynamicBatcher(gateway, runner, cfg)
        task = asyncio.create_task(batcher.run())
        results = []
        for payloads in bursts:
            ids = await gateway.submit_many(payloads)
            results.append(await asyncio.gather(*(gateway.wait_for_result(t) for t in ids)))
        batcher.stop()
        await task
        return results, batcher.timer.samples("batch_size")

    return asyncio.run(scenario())


def _direct_probs(runner, payloads):
    """Each upload's preprocessed audio through `predict_probs_blank_video` alone."""
    import numpy as np

    from multimodalemotionrecognition_torch.serving.preprocess import EmotionPreprocessService

    pre = EmotionPreprocessService()
    rows = []
    for name, data in payloads:
        _, audio, blank = pre.preprocess_payload(name, data, use_wavlm=True, raw_uint8=True)
        assert blank
        rows.append(runner.predict_probs_blank_video(audio)[0])
    return np.stack(rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batcher_on_the_card_matches_direct_calls(cuda, flagship_ckpt, dtype):
    """A burst of 12 .wav uploads through the batcher (ServeConfig's defaults:
    batches of up to 8, buckets 1, 2, 4, 8, the int16 wire, the blank-video
    route): every result within the serving tolerance of a direct call, the
    same argmax, 12 K1 + 6 K3 launches per batch forward."""
    import numpy as np

    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

    runner = TorchModelRunner(flagship_ckpt, device=cuda, compute_dtype=dtype, device_normalize=True)
    runner.warmup()
    payloads = _wav_payloads(12, seed=1)
    before = (wavlm_attention_sublayer.launches, fused_conv_layer.launches)
    (results,), sizes = _burst_through_the_batcher(runner, [payloads])
    launches = (wavlm_attention_sublayer.launches - before[0], fused_conv_layer.launches - before[1])
    assert sum(sizes) == 12 and max(sizes) > 1, sizes
    assert launches == (12 * len(sizes), 6 * len(sizes)), (launches, sizes)
    got = np.array([r["probs"] for r in results])
    want = _direct_probs(runner, payloads)
    assert np.abs(got - want).max() <= SERVE_TOL[dtype]
    assert (got.argmax(axis=1) == want.argmax(axis=1)).all()


def test_batcher_bursts_in_a_row_keep_the_staged_copy_ordered(cuda, flagship_ckpt):
    """The batcher stages batch N+1's host->device copy on the event loop's
    thread while batch N's forward runs in an executor thread.  Eight bursts
    in a row, each of new uploads: every result within 1e-3 of a direct call
    (a copy not ordered before its forward would hand a batch stale or
    partial audio)."""
    import numpy as np

    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

    runner = TorchModelRunner(flagship_ckpt, device=cuda, device_normalize=True)
    runner.warmup()
    bursts = [_wav_payloads(10, seed=10 + k) for k in range(8)]
    results, sizes = _burst_through_the_batcher(runner, bursts)
    assert sum(sizes) == 80 and max(sizes) > 1, sizes
    for payloads, burst in zip(bursts, results):
        got = np.array([r["probs"] for r in burst])
        assert np.abs(got - _direct_probs(runner, payloads)).max() <= SERVE_TOL["float32"]


# ---------------------------------------------------------------------------
# K1 and K3 as registered operators: opcheck on the card, a small export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_kernel_operators_on_the_card(cuda, dtype):
    """`torch.library.opcheck` runs the CUDA kernels through the dispatcher,
    the fake implementation and AOT dispatch, and compares their outputs
    (K1 on its tensor-core route: head width 64; K3 on its tensor-core
    route: cin a multiple of 64).  Every output row is written: seq_len =
    Tp for K1, t_out = rows for K3 (rows past those are unspecified)."""
    from multimodalemotionrecognition_torch.kernels import conv_fe, wavlm_attn

    g = torch.Generator().manual_seed(0)
    b, t, e, h = 2, 40, 128, 2
    q, k, v, hidden = (torch.randn(b, t, e, generator=g).to(cuda, dtype) for _ in range(4))
    args = (hidden, q * 0.125, k, v, torch.randn(b, h * t, 1, generator=g).to(cuda),
            torch.randn(h * t, t, generator=g).to(cuda),
            (torch.randn(e, e, generator=g) * 0.05).to(cuda, dtype),
            torch.randn(1, e, generator=g).to(cuda), torch.ones(1, e, device=cuda),
            torch.zeros(1, e, device=cuda))
    before = wavlm_attention_sublayer.launches
    torch.library.opcheck(wavlm_attn._k1_op, (*args, h, t, 1e-5, 0.0, 0.0, None))
    assert wavlm_attention_sublayer.launches > before
    y = torch.randn(2, 16, 2 * 64, generator=g).to(cuda, dtype)  # stride 2, cin 64
    w_flat = (torch.randn(2 * 64, 64, generator=g) * 0.05).to(cuda, dtype)  # k 2: t_out 16
    before = fused_conv_layer.launches
    torch.library.opcheck(conv_fe._k3_op, (y, w_flat, 2, 2, 64, False, True, 32, None))
    assert fused_conv_layer.launches > before


def test_export_on_the_card_launches_the_kernels(cuda, tmp_path):
    """A small WavLM xattn model exported on the card: 2 K1 and 6 K3
    operator nodes per graph, and the loaded program launches them and
    answers as the runner does."""
    import numpy as np

    from multimodalemotionrecognition_torch.config import ModelConfig
    from multimodalemotionrecognition_torch.models.factory import build_model
    from multimodalemotionrecognition_torch.runtime import export
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

    cfg = ModelConfig(fusion="xattn", use_wavlm=True, xattn_d_model=32, wavlm_geometry=SMALL_WAVLM)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    ckpt = tmp_path / "small.pt"
    torch.save({"model": model.state_dict(), "config": cfg.to_checkpoint_dict()}, ckpt)
    path = export.export_program(ckpt, tmp_path / "small", batch_sizes=(2,), device=cuda)
    exported = export.load_exported(path)
    assert export.kernel_nodes(exported.programs[2]) == {
        "emo.wavlm_attention_sublayer": 2, "emo.fused_conv_layer": 6}
    rng = np.random.RandomState(0)
    video = rng.randn(2, 8, 3, 112, 112).astype(np.float32)
    audio = (rng.randn(2, 1, 48000) * 0.1).astype(np.float32)
    before = wavlm_attention_sublayer.launches, fused_conv_layer.launches
    got = exported.predict_probs(video, audio)
    assert (wavlm_attention_sublayer.launches - before[0],
            fused_conv_layer.launches - before[1]) == (2, 6)
    want = TorchModelRunner(ckpt, device=cuda).predict_probs(video, audio)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_two_ranks_on_the_card_step_like_one_rank(cuda):
    """The flagship at SMALL widths (WavLM's dropouts, LayerDrop and span
    masking on; K1, K2 and K3 launched), one stage-2 step on two ranks
    (NCCL over two cards, else Gloo with both on cuda:0) against one rank on
    the global batch of 4: the same LayerDrop draw, every draw the global
    draw's rows bit for bit, the losses within 1e-5, the audio branch's and
    the fusion's gradients within 1e-4 of each leaf's largest entry (K2's
    bound), the BatchNorm statistics within 1e-5 / 1e-4."""
    from multimodalemotionrecognition_torch.config import TrainConfig
    from multimodalemotionrecognition_torch.parallel import launch
    from multimodalemotionrecognition_torch.train import EmotionTrainer

    # The tests' directory is on the path (pytest's rootdir-less import): on
    # the card's machine another package takes the name `tests`.
    import torch_dp_workers as workers

    if torch.cuda.device_count() >= 2:
        backend, devices = "nccl", ["cuda:0", "cuda:1"]
    else:
        backend, devices = "gloo", ["cuda:0", "cuda:0"]
    config = workers.flagship_small_config(fused_conv=True)
    batch = workers.flagship_batch(4)
    ranks = launch(workers.trainer_step_rank, 2, backend, devices, timeout_s=600,
                   args=(config, workers.FLAGSHIP_TRAIN, batch))
    trainer = EmotionTrainer(config, TrainConfig(**workers.FLAGSHIP_TRAIN), device=cuda)
    one = workers.trainer_step(trainer, trainer.init_state(), batch)
    workers.assert_steps_agree(one, ranks, loss_tol=1e-5, grad_rel=1e-4, stats_tol=(1e-5, 1e-4))
