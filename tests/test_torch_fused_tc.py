"""K4's tensor-core route (`csrc/fused_block_tc.cuh`), checked on the CPU.

The route cuts the fusion block into four grid-wide launches: (1) every
row-wise product over 16-row tiles of all audio and video rows, (2) the
video side per sample, (3) the audio update per row tile with per-tile
pool partials, (4) the head per sample from those partials.  Every Linear
layer is three TF32 products of split operands (3xTF32), int8 weights
dequantised before the split.  Here: that launch plan modelled in PyTorch,
every product through `_mm3` (the split-product model of
`tests/test_torch_tf32x3.py`), against the JAX package's Pallas kernel in
interpret mode (as `tests/test_torch_fused.py` runs it) over mean/attn
pooling, concat/gated heads, the prior and int8, at atol 5e-5; the route
rule; the shared-memory and workspace mirrors of the header.  Small widths
as `tests/test_torch_fused.py`: d_model 32, 4 heads, 8 video and 21 audio
tokens, tower widths 24 and 40, batch 8.
"""

import importlib
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from multimodalemotionrecognition_tpu.ops import pallas_fused_block
from multimodalemotionrecognition_tpu.runtime.runner import JaxModelRunner
from multimodalemotionrecognition_torch.kernels.conv_fe import split_tf32
from multimodalemotionrecognition_torch.kernels.fused_block import (
    FusedBlockSpec,
    extract_block_params,
    tc_smem_bytes,
    tc_workspace_floats,
    tensor_core_route,
)
from multimodalemotionrecognition_torch.kernels.xattn import layer_norm_plain
from multimodalemotionrecognition_torch.runtime.quant import quantize_linears_int8
from tests.test_torch_fused import ATOL, B, TA, T, _block

k4 = importlib.import_module("multimodalemotionrecognition_torch.kernels.fused_block")
HEADER = Path(k4.__file__).resolve().parent / "csrc" / "fused_block_tc.cuh"
ROWS = 16  # kRows: a row tile, and an m-tile
MAX_SMEM = 227 * 1024


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b as the route takes it: lo.hi + hi.lo + hi.hi of TF32 parts."""
    a_hi, a_lo = split_tf32(a.contiguous())
    b_hi, b_lo = split_tf32(b.contiguous())
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _tiles(rows: int, per_sample: int):
    """The row tiles of launches (1) and (3): (tile, part, sample, rows) for
    each sample's rows in each 16-row tile of the flattened rows."""
    for t in range(-(-rows // ROWS)):
        r0, r1 = t * ROWS, min(rows, (t + 1) * ROWS)
        for part, s in enumerate(range(r0 // per_sample, (r1 - 1) // per_sample + 1)):
            yield t, part, s, slice(max(r0, s * per_sample), min(r1, (s + 1) * per_sample))


def _k4_by_launch_plan(v_feat, a_seq, p, spec: FusedBlockSpec):
    """The tensor-core route's arithmetic, launch by launch -> logits [B, C]."""
    m, vec = p.matrix, p.vectors
    b, t, _ = v_feat.shape
    ta, d, h = a_seq.shape[1], spec.d_model, spec.num_heads
    dh = d // h
    qscale = torch.tensor(dh**-0.5, dtype=torch.float32)

    def lin(x, name, bias=None, col0=0, n=None):
        w = m(name)
        n = w.shape[1] - col0 if n is None else n
        y = _mm3(x, w[:, col0:col0 + n])
        return y if bias is None else y + vec[bias][col0:col0 + n]

    # (1) rows: every product of a row, over all rows of the batch together.
    a_rows = a_seq.reshape(b * ta, -1).float()
    a = lin(lin(a_rows, "aseq_w", "aseq_b"), "ain_w", "ain_b")
    ka = lin(a, "v2a_in_w", "v2a_in_b", d, d)
    va = lin(a, "v2a_in_w", "v2a_in_b", 2 * d, d)
    qa = lin(a, "a2v_in_w", "a2v_in_b", 0, d) * qscale
    v = lin(v_feat.reshape(b * t, -1).float(), "vin_w", "vin_b")
    qv = lin(v, "v2a_in_w", "v2a_in_b", 0, d) * qscale
    consts = torch.zeros(b, 4)
    if spec.use_prior:
        sak, saq = _mm3(a, m("ep_ak_w")[:d])[:, 0], _mm3(a, m("ep_aq_w")[:d])[:, 0]
        svq, svk = _mm3(v, m("ep_vq_w")[:d])[:, 0], _mm3(v, m("ep_vk_w")[:d])[:, 0]
        apart = {(tile, part): a[rows].sum(0) for tile, part, _, rows in _tiles(b * ta, ta)}

    # (2) the video side, per sample.
    kvv, vemb = [], []
    for s in range(b):
        vs, qs = v[s * t:(s + 1) * t], qv[s * t:(s + 1) * t]
        scores = torch.zeros(h, t, ta)
        if spec.use_prior:
            a_mean = sum(apart[tile, part] for tile, part, s2, _ in _tiles(b * ta, ta)
                         if s2 == s) / ta
            pooled = torch.cat([vs.sum(0) / t, a_mean])[None]
            prior = lin(torch.relu(lin(pooled, "ep_p0_w", "ep_p0_b")), "ep_p3_w", "ep_p3_b")
            for i, name in enumerate(("ep_vq", "ep_ak", "ep_aq", "ep_vk")):
                consts[s, i] = (_mm3(prior, m(f"{name}_w")[d:]) + vec[f"{name}_b"])[0, 0]
            vq = svq[s * t:(s + 1) * t] + consts[s, 0]
            ak = sak[s * ta:(s + 1) * ta] + consts[s, 1]
            scores = torch.tanh(vq[:, None] + ak[None, :]) * vec["ep_scale"]
        k_s, v_s = ka[s * ta:(s + 1) * ta], va[s * ta:(s + 1) * ta]
        qh = qs.view(t, h, dh).transpose(0, 1)
        kh = k_s.view(ta, h, dh).transpose(0, 1)
        probs = torch.softmax(qh @ kh.transpose(1, 2) + scores, dim=-1)  # [h, t, ta]
        y = _mm3(probs.reshape(h * t, ta), v_s)  # every head's rows against all columns
        ctx = torch.stack([y[hh * t:(hh + 1) * t, hh * dh:(hh + 1) * dh] for hh in range(h)], 1)
        v_new = layer_norm_plain(vs + lin(ctx.reshape(t, d), "v2a_out_w", "v2a_out_b"),
                                 vec["vn_s"], vec["vn_b"])
        kvv.append((lin(v_new, "a2v_in_w", "a2v_in_b", d, d),
                    lin(v_new, "a2v_in_w", "a2v_in_b", 2 * d, d)))
        if spec.pooling == "attn":
            z = layer_norm_plain(v_new, vec["vp_ln_s"], vec["vp_ln_b"])
            z = lin(F.gelu(lin(z, "vp_w1", "vp_b1")), "vp_w2", "vp_b2")
            vemb.append((torch.softmax(z[:, 0], 0)[:, None] * v_new).sum(0))
        else:
            vemb.append(v_new.sum(0) / t)

    # (3) the audio update per row, then the pool partials per tile and sample.
    a_new = torch.zeros_like(a)
    for s in range(b):
        rows = slice(s * ta, (s + 1) * ta)
        k_v, v_v = kvv[s]
        qh = qa[rows].view(ta, h, dh).transpose(0, 1)
        scores = qh @ k_v.view(t, h, dh).transpose(0, 1).transpose(1, 2)  # [h, ta, t]
        if spec.use_prior:
            aq = saq[rows] + consts[s, 2]
            vk = svk[s * t:(s + 1) * t] + consts[s, 3]
            scores = scores + torch.tanh(aq[:, None] + vk[None, :]) * vec["ep_scale"]
        ctx = torch.softmax(scores, -1) @ v_v.view(t, h, dh).transpose(0, 1)  # [h, ta, dh]
        out = lin(ctx.transpose(0, 1).reshape(ta, d), "a2v_out_w", "a2v_out_b")
        a_new[rows] = layer_norm_plain(a[rows] + out, vec["an_s"], vec["an_b"])
    if spec.pooling == "attn":
        z = layer_norm_plain(a_new, vec["ap_ln_s"], vec["ap_ln_b"])
        score = lin(F.gelu(lin(z, "ap_w1", "ap_b1")), "ap_w2", "ap_b2")[:, 0]
    partials = {}
    for tile, part, s, rows in _tiles(b * ta, ta):
        if spec.pooling == "attn":
            mx = score[rows].max()
            e = torch.exp(score[rows] - mx)
            partials.setdefault(s, []).append((mx, e.sum(), (e[:, None] * a_new[rows]).sum(0)))
        else:
            partials.setdefault(s, []).append(a_new[rows].sum(0))

    # (4) the head: the partials in tile order, then the head's products.
    aemb = []
    for s in range(b):
        if spec.pooling == "attn":
            top = max(mx for mx, _, _ in partials[s])
            scale = [torch.exp(mx - top) for mx, _, _ in partials[s]]
            total = sum(l * c for (_, l, _), c in zip(partials[s], scale))
            aemb.append(sum(acc * c for (_, _, acc), c in zip(partials[s], scale)) / total)
        else:
            aemb.append(sum(partials[s]) / ta)
    vemb, aemb = torch.stack(vemb), torch.stack(aemb)
    both = torch.cat([vemb, aemb], 1)
    if spec.head == "concat":
        return lin(torch.relu(lin(both, "h_w1", "h_b1")), "h_w2", "h_b2")
    g = torch.sigmoid(lin(torch.relu(lin(both, "g_w1", "g_b1")), "g_w2", "g_b2"))
    return lin(g * vemb + (1.0 - g) * aemb, "c_w", "c_b")


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize(
    "pooling,head,prior",
    [("mean", "concat", False), ("mean", "gated", True), ("attn", "gated", True),
     ("attn", "concat", False)],
    ids=["mean_concat", "mean_gated_prior", "attn_gated_prior", "attn_concat"],
)
def test_launch_plan_matches_pallas_kernel(pooling, head, prior, int8):
    variables, v, a, spec, port = _block(pooling, head, prior, seed=11)
    scales = {}
    if int8:
        holder = types.SimpleNamespace(_dequant_scales=scales)
        variables = JaxModelRunner._quantize_dense_int8(holder, variables)
        quantize_linears_int8(port)
    jspec = pallas_fused_block.FusedBlockSpec(**spec)
    args, layout = pallas_fused_block.extract_block_params(variables["params"], jspec, scales)
    fn = pallas_fused_block.build_fused_block_fn(jspec, layout, interpret=True)
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(a), *args))

    pspec = FusedBlockSpec(**spec)
    params = extract_block_params(port.state_dict(), pspec)
    assert bool(params.scales) == int8
    got = _k4_by_launch_plan(torch.from_numpy(v), torch.from_numpy(a), params, pspec)
    assert got.shape == (B, spec["num_classes"]) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_row_tiles_cover_every_row_once_with_at_most_two_samples():
    seen = []
    for tile, part, s, rows in _tiles(B * TA, TA):
        assert part in (0, 1) and s == rows.start // TA == (rows.stop - 1) // TA
        seen += list(range(rows.start, rows.stop))
    assert seen == list(range(B * TA))


def _operands(t=T, ta=TA, dv=24, ds=40, d=32, h=4, pooling="attn", head="gated", prior=True):
    spec = FusedBlockSpec(num_heads=h, d_model=d, pooling=pooling, head=head, use_prior=prior,
                          num_classes=8)
    matrices = {"ep_p3_w": torch.zeros(16, 8), "ap_w1": torch.zeros(d, d // 2),
                "h_w1": torch.zeros(2 * d, 256)}
    params = types.SimpleNamespace(matrices=matrices)
    return torch.zeros(2, t, dv), torch.zeros(2, ta, ds), params, spec


@pytest.mark.parametrize(
    "change,expected",
    [({}, True), ({"t": 16}, True), ({"t": 17}, False), ({"ta": 16}, True), ({"ta": 15}, False),
     ({"d": 128}, True), ({"d": 96, "h": 4}, True), ({"d": 160, "h": 4}, False),
     ({"d": 48, "h": 4}, False), ({"d": 64, "h": 32}, False), ({"dv": 20}, False),
     ({"ds": 44}, False), ({"dv": 512, "ds": 768, "d": 128, "ta": 149}, True),
     ({"ds": 5000}, False)],
    ids=["small", "t16", "t17", "ta16", "ta15", "d128", "d96", "d160", "d48", "dh2", "dv20",
         "ds44", "flagship", "ds5000"],
)
def test_route_is_decided_by_the_shapes(change, expected):
    assert tensor_core_route(*_operands(**change)) is expected


def _constants(names):
    # The product machinery (kThreads ... kBaseBytes) lives in tc_product.cuh,
    # which the route's header includes and K5's tensor-core route shares.
    src = HEADER.read_text() + (HEADER.parent / "tc_product.cuh").read_text()
    found = {}
    for name in names:
        hit = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert hit, name
        found[name] = eval(hit.group(1), {}, dict(found))  # noqa: S307 - the header's own arithmetic
    return src, found


def test_python_mirror_holds_the_header_and_every_block_fits_at_the_flagship():
    src, c = _constants(("kThreads", "kRows", "kMaxCols", "kChunk", "kRingStages", "kRingBytes",
                         "kXRows", "kXBlockBytes"))
    assert (c["kRows"], c["kMaxCols"], c["kChunk"], c["kRingStages"], c["kXRows"]) == (
        k4._TC_ROWS, k4._TC_MAX_COLS, k4._TC_CHUNK, k4._TC_RING_STAGES, k4._TC_X_ROWS)
    assert "kBaseBytes = 4 * kXBlockBytes + kRingStages * kRingBytes;" in src
    assert k4._TC_BASE_BYTES == 67_072
    # Two warpgroups of 64 output columns; a chunk is one 128-byte column
    # block of X (32 float32) and 32 weight rows of kMaxCols float32 plus 16
    # bytes of padding (4 mod 32 words: conflict-free A fragments).
    assert c["kMaxCols"] == 64 * c["kThreads"] // 128
    assert c["kChunk"] * 4 == 128 and c["kRingBytes"] == c["kChunk"] * (4 * c["kMaxCols"] + 16)
    assert (c["kRingBytes"] // c["kChunk"] // 4) % 32 == 4
    for kernel in ("rows", "video", "audio", "head"):
        assert f"inline size_t {kernel}_smem_bytes(const Params& p)" in src
    assert src.count("return 1024 + kBaseBytes + 4 * ") == 4
    flagship = dict(B=8, T=8, Ta=149, Dv=512, Ds=768, d=128, H=4, C=8)
    for extra in (dict(pool_hidden=0, prior_dim=0, prior_hidden=0, head_hidden=256),
                  dict(pool_hidden=64, prior_dim=8, prior_hidden=64, head_hidden=128)):
        smem = tc_smem_bytes({**flagship, **extra})
        assert max(smem.values()) <= MAX_SMEM, smem
    assert tc_smem_bytes({**flagship, **extra}) == {
        "rows": 134_400, "video": 145_504, "audio": 141_776, "head": 101_696}


def test_workspace_mirror_follows_the_header():
    src = HEADER.read_text()
    assert ("const size_t sizes[9] = {rv * d, rv * d, rv * 2, ra * 2, tiles * 2 * d, rv * 2 * d,"
            in src)
    assert "(size_t)p.B * d, (size_t)p.B * 4, tiles * 2 * (2 + d)};" in src
    tiles = -(-8 * 149 // 16)
    assert tiles == 75
    assert tc_workspace_floats(8, 8, 149, 128) == (
        2 * 64 * 128 + 2 * 64 + 2 * 1192 + tiles * 256 + 64 * 256 + 8 * 128 + 32
        + tiles * 2 * 130)
