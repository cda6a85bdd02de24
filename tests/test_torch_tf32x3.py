"""The float32 tensor-core routes of K3 and K1 (3xTF32), checked on the CPU.

The kernels (`csrc/conv_fe_tf32.cu`, `csrc/wavlm_attn_tf32.cuh`) split every
float32 operand into two TF32 parts and sum three TF32 products, each exact
in the float32 accumulator.  Here: the split (`split_tf32`) against a numpy
model of `cvt.rna.tf32.f32`; both route predicates; the K-major split
weight; the headers' constants and shared-memory plans; the split-product
arithmetic of both kernels, emulated in PyTorch, against the JAX package's
Pallas kernels in interpret mode (float32, 1e-4 abs); why the route is
three terms (one TF32 pass misses that tolerance at K3's depth); and why
the kernels fold their accumulator into a float32 total every few steps
(a model of the tensor cores' truncating accumulation).
"""

import re
from pathlib import Path

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
from multimodalemotionrecognition_torch.kernels import conv_fe, wavlm_attn
from multimodalemotionrecognition_torch.kernels.conv_fe import (
    conv_tile_plan,
    fused_conv_layer_plain,
    split_tf32,
    split_weight_tf32,
    tensor_core_route,
    tf32x3_route,
)
from multimodalemotionrecognition_torch.kernels.wavlm_attn import (
    forward_core_smem_bytes,
    tensor_core_route as attention_tensor_core_route,
    tf32x3_route as attention_tf32x3_route,
)

CSRC = Path(conv_fe.__file__).resolve().parent / "csrc"
MAX_SMEM = 227 * 1024  # what one block of an H100 may use
TOL = 1e-4  # float32 abs: K3_TOL and K1_TOL of chip_smoke.py


def _tf32_model(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 by value: the nearest number of 11 significant bits
    on float32's exponent range (spacing 2^-136 below 2^-125), ties away
    from zero."""
    x64 = x.astype(np.float64)
    out = np.zeros_like(x64)
    nz = x64 != 0
    _, e = np.frexp(np.abs(x64[nz]))  # |x| = m * 2^e, m in [0.5, 1)
    ulp = np.ldexp(1.0, np.maximum(e - 11, -136))
    out[nz] = np.sign(x64[nz]) * np.floor(np.abs(x64[nz]) / ulp + 0.5) * ulp
    return out.astype(np.float32)


def _split_cases() -> np.ndarray:
    rng = np.random.default_rng(0)
    wide = rng.standard_normal(4096) * np.exp2(rng.integers(-120, 120, 4096))
    grid = _tf32_model(rng.standard_normal(512).astype(np.float32)).astype(np.float64)
    _, e = np.frexp(np.abs(grid))
    ties = grid + np.sign(grid) * np.ldexp(1.0, e - 12)  # exactly half a TF32 step past
    bits = rng.integers(1, 0x800000, 512, dtype=np.uint32)  # subnormal magnitudes
    subnormal = bits.view(np.float32) * np.where(rng.random(512) < 0.5, -1, 1)
    fixed = [1 + 2.0**-11, -(1 + 2.0**-11), 1 + 3 * 2.0**-11, 2.0**-140, -3 * 2.0**-149,
             2.0**-126, 0.0, -0.0, 1.0, -2.5]
    return np.concatenate([wide, ties, subnormal, fixed]).astype(np.float32)


def test_split_tf32_rounds_as_cvt_rna():
    x = _split_cases()
    hi, lo = split_tf32(torch.from_numpy(x))
    want_hi = _tf32_model(x)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), _tf32_model(x - want_hi))  # x - hi is exact
    for part in (hi, lo):  # the 13 bits the tensor cores drop are zero
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    # Ties go away from zero, not to even.
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11)], dtype=torch.float32)
    assert split_tf32(tie)[0].tolist() == [1 + 2.0**-10, -(1 + 2.0**-10)]


def test_split_tf32_parts_sum_to_x_within_2_to_the_minus_22():
    x = _split_cases()
    x = torch.from_numpy(x[np.abs(x) >= 2.0**-100])  # lo stays a normal number
    hi, lo = split_tf32(x)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0**-22, rel
    with pytest.raises(TypeError):
        split_tf32(x.to(torch.bfloat16))


@pytest.mark.parametrize(
    "dtype,k,cin,cout,gelu_input,expected",
    [(torch.float32, 3, 512, 512, False, True), (torch.float32, 2, 512, 512, False, True),
     (torch.float32, 3, 32, 200, False, True), (torch.float32, 3, 512, 512, True, False),
     (torch.bfloat16, 3, 512, 512, False, False), (torch.float32, 3, 16, 512, False, False),
     (torch.float32, 3, 512, 100, False, False), (torch.float32, 3, 4096, 512, False, False)],
)
def test_conv_tf32x3_route_is_decided_by_the_arguments(dtype, k, cin, cout, gelu_input, expected):
    y = torch.zeros(1, 4, 2 * cin, dtype=dtype)
    w = torch.zeros(k * cin, cout, dtype=dtype)
    assert tf32x3_route(y, w, k, cin, gelu_input) is expected
    # The bf16 route is unchanged: never float32.
    assert tensor_core_route(y, w, k, cin, gelu_input) is (
        dtype == torch.bfloat16 and not gelu_input and cin % 64 == 0 and k * cin <= 8192)


@pytest.mark.parametrize(
    "dtype,h,e,seq_len,expected",
    [(torch.float32, 12, 768, 149, True), (torch.float32, 12, 768, 160, True),
     (torch.float32, 12, 768, 1, True), (torch.float32, 4, 256, 77, True),
     (torch.float32, 12, 768, 161, False), (torch.float32, 4, 768, 149, False),
     (torch.bfloat16, 12, 768, 149, False)],
)
def test_attention_tf32x3_route_is_decided_by_the_arguments(dtype, h, e, seq_len, expected):
    hidden = torch.zeros(1, seq_len, e, dtype=dtype)
    assert attention_tf32x3_route(hidden, h, seq_len) is expected
    # K2 and the bf16 K1 keep their rule: float32 never takes it.
    if dtype == torch.float32:
        assert attention_tensor_core_route(hidden, h, seq_len) is False


def test_split_weight_is_w_flat_transposed_and_split():
    g = torch.Generator().manual_seed(3)
    w_flat = torch.randn(3 * 64, 40, generator=g) * 0.1
    ws = split_weight_tf32(w_flat)
    assert ws.shape == (2, 40, 192) and ws.dtype == torch.float32 and ws.is_contiguous()
    hi, lo = split_tf32(w_flat.t().contiguous())
    assert torch.equal(ws[0], hi) and torch.equal(ws[1], lo)
    err = (ws[0].double() + ws[1].double() - w_flat.t().double()).abs()
    assert (err <= 2.0**-22 * w_flat.t().double().abs()).all()
    with pytest.raises(ValueError):
        split_weight_tf32(w_flat.to(torch.bfloat16))


def _constants(path: Path, names):
    src = path.read_text()
    # `constexpr int kA = 1, kB = 2;` declares several on one line.
    return src, {n: int(re.search(rf"constexpr int (?:\w+ = \d+, )*{n} = (\d+)[,;]", src)[1])
                 for n in names}


def test_python_mirror_holds_the_conv_header_and_its_ring_fits():
    src, c = _constants(CSRC / "conv_fe_tf32.cu", ("kBM", "kBN", "kBK", "kStages", "kMaxSteps"))
    assert c["kBK"] == conv_fe._TF32_BK and c["kMaxSteps"] == conv_fe._TF32_MAX_STEPS
    assert c["kBK"] * 4 == 128  # one 128-byte swizzle row of float32 per box row
    # Stages of A, W_hi and W_lo boxes; A_lo double-buffered per warpgroup.
    assert "kSmemBytes = kStages * kStageBytes + kLoBytes + 2 * kStages * 8 + 1024;" in src
    tile = c["kBM"] * c["kBK"] * 4
    smem = c["kStages"] * 3 * tile + 2 * tile + 2 * c["kStages"] * 8 + 1024
    assert smem == 230_464 <= MAX_SMEM
    # The plan of 32-deep steps covers WavLM's layers within kMaxSteps.
    for k in (3, 2):
        plan = conv_tile_plan(k, 2, 512, conv_fe._TF32_BK)
        assert len(plan) == k * 512 // 32 <= c["kMaxSteps"]


def test_python_mirror_holds_the_attention_header_and_its_blocks_fit():
    src, c = _constants(CSRC / "wavlm_attn_tf32.cuh",
                        ("kHeadDim", "kMaxKeys", "kRowStride", "kCoreWarps", "kPM", "kPN", "kPK",
                         "kPStages"))
    assert (c["kHeadDim"], c["kMaxKeys"]) == (wavlm_attn._TC_HEAD_DIM, wavlm_attn._TC_MAX_KEYS)
    assert 16 * c["kCoreWarps"] == wavlm_attn._TF32_CORE_ROWS
    assert "core_smem_bytes(int keys) { return 4 * (kCoreRows + keys) * 128 + 1024; }" in src
    # Q (64 rows) and K (160 keys) as hi and lo in 256-byte rows, + 1 KB of
    # alignment: 115,712 bytes, two blocks an SM (228 KB, 1 KB reserved each).
    assert forward_core_smem_bytes(160) == 4 * (64 + 160) * 128 + 1024 == 115_712
    assert 2 * (forward_core_smem_bytes(160) + 1024) <= 228 * 1024
    # V takes K's space once S is computed: kKeys rows of kRowStride float32.
    assert 160 * c["kRowStride"] * 4 <= 2 * 2 * 160 * 128
    assert forward_core_smem_bytes(149) == forward_core_smem_bytes(65)
    assert forward_core_smem_bytes(64) == 4 * (64 + 64) * 128 + 1024
    with pytest.raises(ValueError):
        forward_core_smem_bytes(161)
    # The out-projection's ring: kPStages stages of a ctx and a W_o^T box (64
    # rows x 128 bytes each), the lo halves double-buffered; two blocks an SM.
    assert ("kProjSmemBytes = kPStages * kPStageBytes + 2 * kPStageBytes + 2 * kPStages * 8 + 1024;"
            in src)
    stage = 2 * c["kPM"] * c["kPK"] * 4
    assert c["kPM"] == c["kPN"] and c["kPK"] * 4 == 128
    proj = c["kPStages"] * stage + 2 * stage + 2 * c["kPStages"] * 8 + 1024
    assert proj == 99_392 and 2 * (proj + 1024) <= 228 * 1024


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b as the kernels take it: lo.hi + hi.lo + hi.hi of TF32 parts."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _conv_by_plan(y, w_flat, k, stride, cin, gelu_output, product):
    """The float32 kernel's K loop: the plan's 32-deep boxes of Y2 (zeros
    past the end, as TMA gives them) against the K-major weight's columns."""
    b, rows, s_cin = y.shape
    y2 = y.reshape(b * rows, s_cin)
    w_t = w_flat.t()
    acc = torch.zeros(b * rows, w_flat.shape[1])
    for shift, col, w_row in conv_tile_plan(k, stride, cin, conv_fe._TF32_BK):
        box = torch.zeros(b * rows, conv_fe._TF32_BK)
        box[: b * rows - shift] = y2[shift:, col:col + conv_fe._TF32_BK]
        acc += product(box, w_t[:, w_row:w_row + conv_fe._TF32_BK].t())
    if gelu_output:
        acc = F.gelu(acc)
    return acc.reshape(b, rows, -1)


@pytest.mark.parametrize("k,cin,t_in,gelu_output", [(3, 64, 37, True), (2, 32, 29, False),
                                                    (3, 32, 41, False)])
def test_split_product_conv_matches_pallas(k, cin, t_in, gelu_output):
    b, cout, stride = 2, 40, 2
    rows = -(-t_in // stride)
    rng = np.random.default_rng(k * 100 + t_in)
    x = rng.standard_normal((b, rows * stride, cin)).astype(np.float32)
    x[:, t_in:] = np.nan  # past t_in: never reaches a row < t_out
    w_flat = (rng.standard_normal((k * cin, cout)) * (k * cin) ** -0.5).astype(np.float32)
    y = x.reshape(b, rows, stride * cin)
    t_out = (t_in - k) // stride + 1

    got = _conv_by_plan(torch.from_numpy(y), torch.from_numpy(w_flat), k, stride, cin,
                        gelu_output, _mm3)[:, :t_out]
    assert torch.isfinite(got).all()
    pallas = jax_fused_conv_layer(jnp.asarray(y), jnp.asarray(w_flat), k=k, stride=stride,
                                  cin=cin, gelu_output=gelu_output, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas)[:, :t_out], atol=TOL, rtol=0)
    plain = fused_conv_layer_plain(torch.from_numpy(y), torch.from_numpy(w_flat), k, stride,
                                   cin, gelu_output=gelu_output, t_in=t_in)
    np.testing.assert_allclose(got.numpy(), plain[:, :t_out].numpy(), atol=TOL, rtol=0)


def test_one_tf32_pass_misses_the_float32_tolerance_at_l1_depth():
    """L1's reduction (k*cin = 1536): three split products stay within 1e-4
    of float32's result; one TF32 pass, even rounded to nearest, does not."""
    k, cin, cout, stride, t_in = 3, 512, 64, 2, 129
    rows = -(-t_in // stride)
    rng = np.random.default_rng(11)
    y = torch.from_numpy(rng.standard_normal((1, rows, stride * cin)).astype(np.float32))
    w_flat = torch.from_numpy(
        (rng.standard_normal((k * cin, cout)) * (k * cin) ** -0.5).astype(np.float32))
    t_out = (t_in - k) // stride + 1
    want = fused_conv_layer_plain(y, w_flat, k, stride, cin, t_in=t_in)[:, :t_out].double()

    def one_pass(a, b):
        return split_tf32(a)[0] @ split_tf32(b)[0]

    three = _conv_by_plan(y, w_flat, k, stride, cin, False, _mm3)[:, :t_out]
    one = _conv_by_plan(y, w_flat, k, stride, cin, False, one_pass)[:, :t_out]
    err3 = (three.double() - want).abs().max().item()
    err1 = (one.double() - want).abs().max().item()
    assert err3 <= TOL / 10, err3
    assert err1 > TOL, err1


def _truncating_product(a, w, fold_steps=None):
    """a . w as 3xTF32 products into an accumulator that rounds toward zero
    after each 8-deep step (the tensor cores' behaviour the kernels guard
    against), optionally restarted every `fold_steps` steps and added to a
    float32 total with rounded additions (the kernels' fold)."""
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = split_tf32(w)
    acc = torch.zeros(a.shape[0], w.shape[1])
    total = torch.zeros_like(acc)
    for step, k0 in enumerate(range(0, a.shape[1], 8)):
        if fold_steps and step and step % fold_steps == 0:
            total, acc = total + acc, torch.zeros_like(acc)
        for x, y in ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)):
            exact = acc.double() + x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double()
            f = exact.float()
            acc = torch.where(f.double().abs() > exact.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return total + acc


def test_truncating_accumulation_is_folded_every_four_stages():
    """Why K3 and K1's out-projection restart their wgmma accumulator every
    four 32-deep stages: one truncating chain over L1's depth (k*cin =
    1536) drifts more than a fifth of the 1e-4 tolerance (6.0e-5 here),
    chunks of 16 steps stay within a few float32 roundings (5.0e-6)."""
    rng = np.random.default_rng(13)
    a = torch.from_numpy(rng.standard_normal((128, 1536)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((1536, 32)) * 1536**-0.5).astype(np.float32))
    exact = a.double() @ w.double()
    chain = (_truncating_product(a, w) - exact).abs().max().item()
    folded = (_truncating_product(a, w, fold_steps=4 * 32 // 8) - exact).abs().max().item()
    assert chain > 2e-5, chain
    assert folded < 1e-5, folded


def _attention_inputs(b, h, tp, seed=0):
    rng = np.random.default_rng(seed)
    e = h * 64
    f32 = np.float32
    return [
        (rng.standard_normal((b, tp, e)) * 0.5).astype(f32),
        (rng.standard_normal((b, tp, e)) * 0.3).astype(f32),
        (rng.standard_normal((b, tp, e)) * 0.3).astype(f32),
        (rng.standard_normal((b, tp, e)) * 0.3).astype(f32),
        (1.0 + rng.random((b, h * tp, 1))).astype(f32),
        rng.standard_normal((h * tp, tp)).astype(f32),
        (rng.standard_normal((e, e)) * e**-0.5).astype(f32),
        (rng.standard_normal((1, e)) * 0.1).astype(f32),
        (1.0 + 0.1 * rng.standard_normal((1, e))).astype(f32),
        (0.1 * rng.standard_normal((1, e))).astype(f32),
    ]


def _k1_by_split_products(hidden, q, k, v, gate, bias, wo, bo, lns, lnb, h, seq_len,
                          attn_p, hid_p, seed, eps=1e-5):
    """K1's float32 tensor-core arithmetic: every product in three TF32
    parts; softmax, dropout and LayerNorm in float32."""
    b, tp, e = hidden.shape
    keep_attn, keep_hid = wavlm_attn._keep_masks(seed, b, h, tp, e, attn_p, hid_p, "cpu")

    def heads(x):
        return x.view(b, tp, h, e // h).transpose(1, 2)

    s = _mm3(heads(q), heads(k).transpose(-1, -2)) + gate.view(b, h, tp, 1) * bias.view(h, tp, tp)
    s[..., seq_len:] = -float("inf")
    p = wavlm_attn._drop(torch.softmax(s, dim=-1), keep_attn, attn_p)
    ctx = _mm3(p, heads(v)).transpose(1, 2).reshape(b, tp, e)
    pre = wavlm_attn._drop(_mm3(ctx, wo) + bo.view(e), keep_hid, hid_p) + hidden
    return F.layer_norm(pre, (e,), lns.view(e), lnb.view(e), eps)


@pytest.mark.parametrize("attn_p,hid_p", [(0.0, 0.0), (0.1, 0.1)], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("tp,seq", [(24, 24), (24, 19)])
def test_split_product_attention_matches_pallas(tp, seq, attn_p, hid_p):
    b, h, seed = 2, 2, 5
    args = _attention_inputs(b, h, tp)
    kw = dict(num_heads=h, seq_len=seq, attn_dropout=attn_p, hidden_dropout=hid_p)
    want = wavlm_fused_attention_sublayer(
        *map(jnp.asarray, args), **kw, dropout_seed=jnp.asarray([seed], jnp.int32),
        interpret=True)
    got = _k1_by_split_products(*map(torch.from_numpy, args), h, seq, attn_p, hid_p, seed)
    np.testing.assert_allclose(got[:, :seq].numpy(), np.asarray(want)[:, :seq], atol=TOL, rtol=0)


def _k2_by_split_products(dout, hidden, q, k, v, gate, bias, wo, bo, lns, lnb, h, seq_len,
                          attn_p, hid_p, seed, eps=1e-5):
    """K2's float32 tensor-core arithmetic (`csrc/wavlm_attn_bwd_tf32.cuh`):
    K1's saved context and pre-LayerNorm rows from its split products; the
    LayerNorm backward in float32; dctx and dW_o with the tensor cores'
    truncating accumulation folded every four 32-deep steps, dW_o over the
    B*Tp rows of the transposed operands (zeros past seq_len); the
    query-side pass (S, the softmax and its log-sum-exp, D = dctx . ctx, dP,
    dS, dQ, dgate, dbias) and the key-side pass (S^T, P^T from the saved
    log-sum-exp, dP^T, dS^T with the saved D, dK, dV), every product in
    three TF32 parts.  -> the ten gradients; rows and columns past seq_len
    zero, as the kernel leaves them."""
    b, tp, e = hidden.shape
    dh = e // h
    valid = torch.arange(tp) < seq_len
    rows = valid[None, :, None]
    hidden, q, k, v, dout = (t * rows for t in (hidden, q, k, v, dout))
    keep_attn, keep_hid = wavlm_attn._keep_masks(seed, b, h, tp, e, attn_p, hid_p, "cpu")
    fold = 4 * 32 // 8  # 8-deep steps between folds

    def heads(x):
        return x.view(b, tp, h, dh).transpose(1, 2)

    def merge(x):
        return x.transpose(1, 2).reshape(b, tp, e)

    gb = gate.view(b, h, tp, 1) * bias.view(h, tp, tp)  # [b, h, query, key]
    keys_past = ~valid[None, None, None, :]

    # K1's saved context and pre-LayerNorm rows.
    s = _mm3(heads(q), heads(k).transpose(-1, -2)) + gb
    p1 = wavlm_attn._drop(torch.softmax(s.masked_fill(keys_past, -float("inf")), -1),
                          keep_attn, attn_p)
    ctx = merge(_mm3(p1, heads(v))) * rows
    pre = wavlm_attn._drop(_mm3(ctx, wo) + bo.view(e), keep_hid, hid_p) + hidden

    # LayerNorm and residual backward (`bwd_ln`), float32.
    mean = pre.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((pre - mean) ** 2).mean(-1, keepdim=True) + eps)
    normed = (pre - mean) * rstd
    dn = dout * lns.view(e)
    dpre = rstd * (dn - dn.mean(-1, keepdim=True) - normed * (dn * normed).mean(-1, keepdim=True))
    dproj = wavlm_attn._drop(dpre, keep_hid, hid_p) * rows
    dlns = (dout * normed).sum((0, 1)).view(1, e)
    dlnb = dout.sum((0, 1)).view(1, e)
    dbo = dproj.sum((0, 1)).view(1, e)

    # (b) the out-projection products, A . B^T with both operands K-major.
    dctx = _truncating_product(dproj.reshape(-1, e), wo.t(), fold).view(b, tp, e)
    dwo = _truncating_product(ctx.reshape(-1, e).t(), dproj.reshape(-1, e), fold)

    # (c) the query-side pass.
    qh, kh, vh, gh = heads(q), heads(k), heads(v), heads(dctx)
    s = (_mm3(qh, kh.transpose(-1, -2)) + gb).masked_fill(keys_past, -float("inf"))
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.softmax(s, -1)
    d = (gh * heads(ctx)).sum(-1, keepdim=True)
    ds = p * (wavlm_attn._drop(_mm3(gh, vh.transpose(-1, -2)), keep_attn, attn_p) - d)
    ds = ds * valid[None, None, :, None]  # rows past seq_len are not stored
    dq = merge(_mm3(ds, kh))
    dgate = (ds * bias.view(h, tp, tp)).sum(-1).reshape(b, h * tp, 1)
    dbias = (gate.view(b, h, tp, 1) * ds).sum(0).reshape(h * tp, tp)

    # (d) the key-side pass: [b, h, key, query], P^T from the saved log-sum-exp.
    both = valid[:, None] & valid[None, :]
    p_t = torch.exp(_mm3(kh, qh.transpose(-1, -2)) + gb.transpose(-1, -2)
                    - lse.transpose(-1, -2)).masked_fill(~both, 0.0)
    keep_t = None if keep_attn is None else keep_attn.transpose(-1, -2)
    dv = merge(_mm3(wavlm_attn._drop(p_t, keep_t, attn_p), gh))
    dp_t = wavlm_attn._drop(_mm3(vh, gh.transpose(-1, -2)), keep_t, attn_p)
    dk = merge(_mm3(p_t * (dp_t - d.transpose(-1, -2)), qh))
    return (dpre * rows, dq * rows, dk * rows, dv * rows, dgate, dbias, dwo, dbo, dlns, dlnb)


@pytest.mark.parametrize("attn_p,hid_p", [(0.0, 0.0), (0.1, 0.1)], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("tp,seq", [(24, 24), (24, 19)])
def test_split_product_backward_matches_jax_custom_vjp(tp, seq, attn_p, hid_p):
    """The ten gradients of the float32 tensor-core K2's arithmetic against
    the JAX custom VJP (its Pallas backward in interpret mode), within 1e-4
    of each gradient's largest entry (GRAD_TOL of chip_smoke.py)."""
    import jax

    b, h, seed = 2, 2, 5
    args = _attention_inputs(b, h, tp)
    cot = np.random.default_rng(7).standard_normal(args[0].shape).astype(np.float32)
    cot[:, seq:] = 0.0  # the forward leaves those rows unspecified
    kw = dict(num_heads=h, seq_len=seq, attn_dropout=attn_p, hidden_dropout=hid_p)
    _, vjp = jax.vjp(lambda *a: wavlm_fused_attention_sublayer(
        *a, **kw, dropout_seed=jnp.asarray([seed], jnp.int32), interpret=True),
        *map(jnp.asarray, args))
    want = vjp(jnp.asarray(cot))
    got = _k2_by_split_products(torch.from_numpy(cot), *map(torch.from_numpy, args), h, seq,
                                attn_p, hid_p, seed)
    names = ("hidden", "q", "k", "v", "gate", "bias", "wo", "bo", "lns", "lnb")
    for name, x, y in zip(names, got, want):
        y = np.asarray(y)
        assert x.shape == y.shape, name
        scale = np.abs(y).max()
        assert scale > 0.0, name
        err = np.abs(x.numpy() - y).max()
        assert err <= TOL * scale, (name, err / scale)
