"""K1 and K2: the WavLM attention sublayer, forward and backward, as
hand-written CUDA kernels joined by a `torch.autograd.Function`.

K1 replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
pallas_wavlm_attn.py::_sublayer_kernel`, K2 its backward
`_sublayer_bwd_kernel` (both reached through `wavlm_fused_attention_sublayer`,
which `models/wavlm.py` calls once per encoder layer).  The CUDA sources and
their design notes are `csrc/wavlm_attn.cu` and `csrc/wavlm_attn_bwd.cu`.
K1 is three launches: the attention core, the out-projection and the
LayerNorm.  With a head width of 64 and `seq_len` <= 160 (the WavLM models:
64 and 149) the first two run on the tensor cores: in bfloat16
`csrc/wavlm_attn_tc.cuh` (mma.sync of bf16 into float32,
`tensor_core_route`), in float32 `csrc/wavlm_attn_tf32.cuh` (TF32 with
split products, 3xTF32, at float32 accuracy: the scores and the
out-projection on wgmma, P.V on mma.sync; `tf32x3_route`; the wrapper passes
W_o transposed, a per-call copy); at other shapes on CUDA cores.  K2 follows
the same two rules: its out-projection products and its attention backward
run on the tensor cores, in bfloat16 `csrc/wavlm_attn_bwd_tc.cuh` (six
launches in all), in float32 `csrc/wavlm_attn_bwd_tf32.cuh` (3xTF32: the
products and the scores on wgmma, dQ, dK and dV on mma.sync, a query-side
and a key-side pass; eight launches); at other shapes on CUDA cores (eight
launches).  The choice follows from the arguments alone.

`wavlm_attention_sublayer` keeps the JAX function's public layout: q/k/v in
their natural [B, Tp, E] layout with q pre-scaled by dh^-0.5, the per-query
gate as [B, H*Tp, 1] float32, the relative position bias as [H*Tp, Tp]
float32 shared by the batch, `wo` as the [E, E] (in, out) kernel, and
bo / LayerNorm scale / bias as float32 [1, E].  It returns
LayerNorm(hidden + dropout(attention(q, k, v) @ wo + bo)) in hidden's dtype;
rows at or past `seq_len` are unspecified.  It is differentiable in all ten
tensors: the backward gives zeros for rows and columns at or past `seq_len`
and takes the cotangent as zero there.

Dropout (training): `attn_dropout` drops softmax probabilities and
`hidden_dropout` the projected output before the residual, both from the
JAX package's stateless hash (`hash_keep_plain` is `_hash_keep` bit for
bit), seeded by one int32 `dropout_seed` that the caller draws on the host
(a data-parallel rank shifts it to its first row: `shifted_dropout_seed`).
K1's forward can instead read the seed at run time from `seed_dev`, a
one-element int32 tensor on the device: a CUDA graph captured around the
call then replays with whatever seed the tensor holds
(`train/prefix_graph.py`, the frozen layers of a train step, which K2 never
differentiates).
The attention mask's index stride is the padded `Tp`, as in the JAX kernel:
equal seeds give equal masks only at equal `Tp`.

K1's forward is the registered operator `torch.ops.emo.wavlm_attention_sublayer`
(a `torch.library.custom_op` with a fake implementation), so that
`torch.export` records it as one node of the graph (`runtime/export.py`)
and an exported program launches it; every forward launch, in serving and
in training, goes through it.  K2 is not an operator: no exported path
takes a gradient.

For CPU tensors the wrappers run the plain PyTorch versions
(`wavlm_attention_sublayer_plain`, `wavlm_attention_sublayer_backward_plain`).
For CUDA tensors they launch the kernels or raise.  Kernel launches are
counted in `wavlm_attention_sublayer.launches` (K1) and
`wavlm_attention_sublayer_backward.launches` (K2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.nn import functional as F

from multimodalemotionrecognition_torch.kernels.build import check, load_library

__all__ = [
    "backward_attention_smem_bytes",
    "backward_tf32_smem_bytes",
    "drop_threshold",
    "hash_keep_plain",
    "forward_core_smem_bytes",
    "shifted_dropout_seed",
    "tensor_core_route",
    "tf32x3_route",
    "wavlm_attention_sublayer",
    "wavlm_attention_sublayer_backward",
    "wavlm_attention_sublayer_backward_plain",
    "wavlm_attention_sublayer_forward",
    "wavlm_attention_sublayer_plain",
]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_SMEM = 227 * 1024
_COL_ROWS = 32  # rows per column-sum partial: kColRows in csrc/wavlm_attn_bwd.cu
_MASK32 = 0xFFFFFFFF
_BATCH_STRIDE, _HEAD_STRIDE, _HIDDEN_OFFSET = 0x632BE59B, 0x9E3779B9, 0x7FEB352D
# The tensor-core route: kHeadDim and kMaxKeys of csrc/wavlm_attn_tc.cuh and
# csrc/wavlm_attn_bwd_tc.cuh; 72 bf16 per row of a Q/K/V/dctx tile there.
_TC_HEAD_DIM, _TC_MAX_KEYS, _TC_ROW_STRIDE = 64, 160, 72
# K1's float32 tensor-core core (csrc/wavlm_attn_tf32.cuh): the same head
# width and key count, 64 query rows; Q and K as hi and lo in 128-byte rows.
_TF32_CORE_ROWS = 64
# K2's float32 tensor-core passes (csrc/wavlm_attn_bwd_tf32.cuh): kRows query
# or key rows a block; kRowBytes, a row of 64 float32 as hi and lo.
_TF32_BWD_ROWS, _TF32_BWD_ROW_BYTES = 64, 512


def tensor_core_route(hidden: torch.Tensor, num_heads: int, seq_len: int) -> bool:
    """True when K1 and K2 run their tensor-core kernels on these arguments:
    bfloat16, a head width of 64 and `seq_len` <= 160.  Otherwise their
    CUDA-core kernels run.  The choice reads the dtype and shapes only: a
    bfloat16 operand that is not 16-byte aligned is refused by the kernel
    with an error, never sent to the CUDA-core kernels."""
    return (hidden.dtype == torch.bfloat16 and hidden.shape[-1] == _TC_HEAD_DIM * num_heads
            and seq_len <= _TC_MAX_KEYS)


def tf32x3_route(hidden: torch.Tensor, num_heads: int, seq_len: int) -> bool:
    """True when K1 and K2 run their float32 tensor-core kernels (3xTF32) on
    these arguments: float32, a head width of 64 and `seq_len` <= 160.
    Otherwise, in float32, their CUDA-core kernels run.  As with
    `tensor_core_route`, a misaligned operand is refused by the kernel with
    an error, never sent to the CUDA-core kernels."""
    return (hidden.dtype == torch.float32 and hidden.shape[-1] == _TC_HEAD_DIM * num_heads
            and seq_len <= _TC_MAX_KEYS)


def forward_core_smem_bytes(seq_len: int) -> int:
    """Shared memory of one block of K1's float32 tensor-core core
    (`core_smem_bytes` in csrc/wavlm_attn_tf32.cuh): Q (64 query rows) and
    K_h (padded to 64 keys up to seq_len 64 and to 160 above) as TF32 hi
    and lo parts in rows of 64 float32 (V takes K's space later), and 1 KB
    of alignment."""
    if not 1 <= seq_len <= _TC_MAX_KEYS:
        raise ValueError(f"seq_len={seq_len} outside the tensor-core route (1 to {_TC_MAX_KEYS})")
    keys = 64 if seq_len <= 64 else _TC_MAX_KEYS
    return 2 * 4 * _TC_HEAD_DIM * (_TF32_CORE_ROWS + keys) + 1024


def backward_attention_smem_bytes(seq_len: int) -> int:
    """Shared memory of one block of K2's tensor-core attention backward
    (`AttnPlan` in csrc/wavlm_attn_bwd_tc.cuh): Q, K, V and dctx of one
    (head, element) in bf16, and P_d and dS as bf16 squares, all padded to
    64 keys up to seq_len 64 and to 160 above."""
    if not 1 <= seq_len <= _TC_MAX_KEYS:
        raise ValueError(f"seq_len={seq_len} outside the tensor-core route (1 to {_TC_MAX_KEYS})")
    keys = 64 if seq_len <= 64 else _TC_MAX_KEYS
    return 2 * (4 * keys * _TC_ROW_STRIDE + 2 * keys * (keys + 8))


def backward_tf32_smem_bytes(seq_len: int) -> Tuple[int, int]:
    """Shared memory of one block of K2's float32 tensor-core query-side and
    key-side passes (`query_smem_bytes`, `key_smem_bytes` in
    csrc/wavlm_attn_bwd_tf32.cuh): two 64-row tiles (Q and dctx of the query
    tile, or K and V of the key tile) and two tiles of every key or query
    (K and V, or Q and dctx), all as TF32 hi and lo, padded to 64 keys up to
    seq_len 64 and to 160 above; then the query tile's row terms D, or every
    query's log-sum-exp, D and gate; and 1 KB of alignment.  -> (query pass,
    key pass)."""
    if not 1 <= seq_len <= _TC_MAX_KEYS:
        raise ValueError(f"seq_len={seq_len} outside the tensor-core route (1 to {_TC_MAX_KEYS})")
    keys = 64 if seq_len <= 64 else _TC_MAX_KEYS
    tiles = _TF32_BWD_ROW_BYTES * (2 * _TF32_BWD_ROWS + 2 * keys) + 1024
    return tiles + 4 * _TF32_BWD_ROWS, tiles + 3 * 4 * keys


# ---------------------------------------------------------------------------
# the dropout hash
# ---------------------------------------------------------------------------


def drop_threshold(rate: float) -> int:
    """uint32 cut for a drop probability `rate`: keep iff hash >= cut."""
    return min(int(round(rate * 2.0**32)), 2**32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 tensors holding uint32 values (torch has
    no uint32 arithmetic on the CPU; 16-bit halves keep int64 from overflowing)."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash_keep_plain(base, shape: Tuple[int, int], threshold: int, device=None) -> torch.Tensor:
    """Keep mask over a (rows, cols) index space: two murmur3 finalizer
    rounds over (r * cols + c) ^ base, kept iff >= threshold.  `base` is an
    int or an int64 tensor of stream bases; the mask has base's shape plus
    `shape`."""
    rows, cols = shape
    base = torch.as_tensor(base, dtype=torch.int64, device=device) & _MASK32
    r = torch.arange(rows, dtype=torch.int64, device=base.device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=base.device)[None, :]
    x = ((r * cols + c) & _MASK32) ^ base[..., None, None]
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= threshold


def shifted_dropout_seed(seed: int, first_row: int) -> int:
    """The int32 seed whose masks for rows 0, 1, ... are `seed`'s masks for
    rows first_row, first_row + 1, ...: each row's stream base is seed +
    row * stride (mod 2^32), in K1, K2 and the plain versions alike.  A
    data-parallel rank holding global rows first_row... passes it, so its
    masks are the global step's rows."""
    shifted = (int(seed) + int(first_row) * _BATCH_STRIDE) & _MASK32
    return shifted - (1 << 32) if shifted >= (1 << 31) else shifted


def _keep_masks(seed: int, b: int, h: int, tp: int, e: int, attn_p: float, hid_p: float, device):
    """-> (attention keep [B, H, Tp, Tp] or None, hidden keep [B, Tp, E] or None)."""
    batch = (int(seed) + torch.arange(b, dtype=torch.int64, device=device) * _BATCH_STRIDE) & _MASK32
    attn = hid = None
    if attn_p > 0.0:
        heads = (torch.arange(1, h + 1, dtype=torch.int64, device=device) * _HEAD_STRIDE) & _MASK32
        attn = hash_keep_plain(batch[:, None] + heads[None, :], (tp, tp), drop_threshold(attn_p))
    if hid_p > 0.0:
        hid = hash_keep_plain(batch + _HIDDEN_OFFSET, (tp, e), drop_threshold(hid_p))
    return attn, hid


def _drop(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    if keep is None:
        return x
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _plain_forward_parts(hidden, q, k, v, gate, position_bias, wo, bo, num_heads, seq_len,
                         attn_dropout, hidden_dropout, dropout_seed):
    """The forward up to the pre-LayerNorm sum, float32 math with the
    kernel's roundings (dropped probabilities and context rows pass through
    the compute dtype).  -> (probs, probs_d, ctx [B, Tp, E] in the compute
    dtype, pre-norm rows, attention keep, hidden keep)."""
    b, tp, e = hidden.shape
    h = num_heads
    dh = e // h
    cdt = v.dtype

    def heads(x):
        return x.view(b, tp, h, dh).transpose(1, 2).float()

    keep_attn, keep_hid = _keep_masks(
        dropout_seed or 0, b, h, tp, e, attn_dropout, hidden_dropout, hidden.device
    )
    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2))
    scores = scores + gate.view(b, h, tp, 1) * position_bias.view(h, tp, tp)
    if seq_len < tp:
        pad = torch.arange(tp, device=scores.device) >= seq_len
        scores = scores.masked_fill(pad, -1e30)
    probs = torch.softmax(scores, dim=-1)
    probs_d = _drop(probs, keep_attn, attn_dropout).to(cdt).float()
    ctx = torch.matmul(probs_d, heads(v)).to(cdt)
    ctx = ctx.transpose(1, 2).reshape(b, tp, e)
    proj = torch.matmul(ctx.float(), wo.float()) + bo.view(e)
    pre = _drop(proj, keep_hid, hidden_dropout) + hidden.float()
    return probs, probs_d, ctx, pre, keep_attn, keep_hid


def wavlm_attention_sublayer_plain(
    hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias,
    num_heads: int, seq_len: int, eps: float = 1e-5,
    attn_dropout: float = 0.0, hidden_dropout: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1."""
    e = hidden.shape[-1]
    pre = _plain_forward_parts(
        hidden, q, k, v, gate, position_bias, wo, bo, num_heads, seq_len,
        attn_dropout, hidden_dropout, dropout_seed,
    )[3]
    out = F.layer_norm(pre, (e,), ln_scale.view(e), ln_bias.view(e), eps)
    return out.to(hidden.dtype)


def wavlm_attention_sublayer_backward_plain(
    dout, hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias,
    num_heads: int, seq_len: int, eps: float = 1e-5,
    attn_dropout: float = 0.0, hidden_dropout: float = 0.0,
    dropout_seed: Optional[int] = None,
):
    """Plain PyTorch version of K2, written out from the TPU kernel's body
    (not autograd of the forward): recompute the forward, LayerNorm and
    residual backward, then per head the out-projection, context, softmax
    and score backward, with the kernel's casts to the compute dtype before
    each product.  -> (dhidden, dq, dk, dv, dgate, dbias, dwo, dbo, dlns,
    dlnb); the last six are float32 and summed over the batch where the
    operand is shared."""
    b, tp, e = hidden.shape
    h = num_heads
    dh = e // h
    cdt = v.dtype
    if seq_len < tp:
        # Rows at or past seq_len are unspecified in the forward: read them,
        # and the cotangent there, as zeros.
        valid = (torch.arange(tp, device=hidden.device) < seq_len)[None, :, None]
        hidden, q, k, v, dout = (torch.where(valid, t, torch.zeros_like(t))
                                 for t in (hidden, q, k, v, dout))

    def heads(x):  # [B, Tp, E] -> [B, H, Tp, dh] float32
        return x.view(b, tp, h, dh).transpose(1, 2).float()

    def merge(x):  # [B, H, Tp, dh] -> [B, Tp, E]
        return x.transpose(1, 2).reshape(b, tp, e)

    # ---- recompute the forward up to the pre-norm sum ----
    probs, probs_d, ctx, pre, keep_attn, keep_hid = _plain_forward_parts(
        hidden, q, k, v, gate, position_bias, wo, bo, num_heads, seq_len,
        attn_dropout, hidden_dropout, dropout_seed,
    )
    mean = pre.mean(dim=-1, keepdim=True)
    var = ((pre - mean) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    normed = (pre - mean) * rstd

    # ---- LayerNorm + residual backward ----
    g_out = dout.float()
    dlns = (g_out * normed).sum(dim=(0, 1)).view(1, e)
    dlnb = g_out.sum(dim=(0, 1)).view(1, e)
    dn = g_out * ln_scale.view(e)
    dout_pre = rstd * (
        dn - dn.mean(dim=-1, keepdim=True) - normed * (dn * normed).mean(dim=-1, keepdim=True)
    )
    dhidden = dout_pre.to(hidden.dtype)
    dproj = _drop(dout_pre, keep_hid, hidden_dropout)
    dbo = dproj.sum(dim=(0, 1)).view(1, e)
    dproj_c = dproj.to(cdt).float()

    # ---- out-projection: dctx = dproj . wo^T, dwo = ctx^T . dproj ----
    dctx_c = heads(torch.matmul(dproj_c, wo.float().t()).to(cdt))
    dwo = torch.einsum("bti,btn->in", ctx.float(), dproj_c)

    # ---- per-head attention backward (dropout masks regenerated) ----
    vh = heads(v)
    dv = torch.matmul(probs_d.transpose(-1, -2), dctx_c)
    dprobs = _drop(torch.matmul(dctx_c, vh.transpose(-1, -2)), keep_attn, attn_dropout)
    dscores = probs * (dprobs - (dprobs * probs).sum(dim=-1, keepdim=True))
    bias = position_bias.view(h, tp, tp)
    dgate = (dscores * bias).sum(dim=-1).reshape(b, h * tp, 1)
    dbias = (gate.view(b, h, tp, 1) * dscores).sum(dim=0).reshape(h * tp, tp)
    ds_c = dscores.to(cdt).float()
    dq = torch.matmul(ds_c, heads(k))
    dk = torch.matmul(ds_c.transpose(-1, -2), heads(q))
    return (
        dhidden, merge(dq).to(q.dtype), merge(dk).to(k.dtype), merge(dv).to(v.dtype),
        dgate, dbias, dwo, dbo, dlns, dlnb,
    )


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _validate(hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias,
              num_heads, seq_len):
    if hidden.ndim != 3:
        raise ValueError(f"hidden must be [B, Tp, E], got {tuple(hidden.shape)}")
    b, tp, e = hidden.shape
    h = num_heads
    if h < 1 or e % h != 0:
        raise ValueError(f"E={e} is not a multiple of num_heads={h}")
    if not 1 <= seq_len <= tp:
        raise ValueError(f"seq_len={seq_len} outside [1, Tp={tp}]")
    if hidden.dtype not in _DTYPES:
        raise TypeError(f"hidden dtype {hidden.dtype} not in {_DTYPES}")
    expected = {
        "q": (q, (b, tp, e), hidden.dtype),
        "k": (k, (b, tp, e), hidden.dtype),
        "v": (v, (b, tp, e), hidden.dtype),
        "gate": (gate, (b, h * tp, 1), torch.float32),
        "position_bias": (position_bias, (h * tp, tp), torch.float32),
        "wo": (wo, (e, e), hidden.dtype),
        "bo": (bo, (1, e), torch.float32),
        "ln_scale": (ln_scale, (1, e), torch.float32),
        "ln_bias": (ln_bias, (1, e), torch.float32),
    }
    for name, (t, shape, dtype) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} dtype {t.dtype} != {dtype}")
        if t.device != hidden.device:
            raise ValueError(f"{name} on {t.device}, hidden on {hidden.device}")
    for name, t in (("hidden", hidden), *((n, x[0]) for n, x in expected.items())):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _dropout_args(attn_dropout: float, hidden_dropout: float, dropout_seed: Optional[int]):
    """The C entries' dropout arguments: seed, then (threshold, 1/keep) for
    the attention and the hidden mask; threshold 0 switches a mask off."""
    out = [int(dropout_seed or 0)]
    for rate in (attn_dropout, hidden_dropout):
        out += [drop_threshold(rate), 1.0 / (1.0 - rate)] if rate > 0.0 else [0, 1.0]
    return out


def wavlm_attention_sublayer_forward(
    hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias,
    num_heads: int, seq_len: int, eps: float = 1e-5,
    attn_dropout: float = 0.0, hidden_dropout: float = 0.0,
    dropout_seed: Optional[int] = None,
    seed_dev: Optional[torch.Tensor] = None,
):
    """K1 -> (out, ctx, pre): the sublayer's output and the two buffers K2
    reads, the attention context [B, Tp, E] in the compute dtype and the
    pre-LayerNorm rows in float32 (both None on the CPU, where the plain
    backward recomputes them).  Runs the registered operator
    `torch.ops.emo.wavlm_attention_sublayer`, so `torch.export` records it
    as one node.  Not recorded by autograd: `wavlm_attention_sublayer` is
    the differentiable entry.  `seed_dev`, a one-element int32 tensor on
    hidden's device, is read at run time as the dropout seed in place of
    `dropout_seed`."""
    args = (hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias)
    for name, rate in (("attn_dropout", attn_dropout), ("hidden_dropout", hidden_dropout)):
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"{name}={rate} outside [0, 1)")
    if seed_dev is not None:
        if (seed_dev.shape != (1,) or seed_dev.dtype != torch.int32
                or seed_dev.device != hidden.device):
            raise ValueError(f"seed_dev must be a one-element int32 tensor on {hidden.device}, "
                             f"got {seed_dev.dtype} {tuple(seed_dev.shape)} on {seed_dev.device}")
    elif (attn_dropout > 0.0 or hidden_dropout > 0.0) and dropout_seed is None:
        raise ValueError("dropout_seed is required when a dropout rate is above 0")
    _validate(*args, num_heads, seq_len)
    if hidden.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {hidden.device}")
    out, ctx, pre = _k1_op(*args, num_heads, seq_len, eps, attn_dropout, hidden_dropout,
                           dropout_seed, seed_dev)
    if hidden.device.type == "cpu":
        return out, None, None
    return out, ctx, pre


@torch.library.custom_op("emo::wavlm_attention_sublayer", mutates_args=(), device_types="cpu")
def _k1_op(
    hidden: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    gate: torch.Tensor, position_bias: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
    ln_scale: torch.Tensor, ln_bias: torch.Tensor, num_heads: int, seq_len: int, eps: float,
    attn_dropout: float, hidden_dropout: float, dropout_seed: Optional[int],
    seed_dev: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 as an operator.  On the CPU the plain version; ctx and pre are
    empty there (an operator returns tensors, never None)."""
    if seed_dev is not None:
        dropout_seed = int(seed_dev[0])
    out = wavlm_attention_sublayer_plain(
        hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias,
        num_heads, seq_len, eps, attn_dropout, hidden_dropout, dropout_seed,
    )
    return out, hidden.new_empty(0), hidden.new_empty(0, dtype=torch.float32)


@_k1_op.register_fake
def _k1_fake(hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias, num_heads,
             seq_len, eps, attn_dropout, hidden_dropout, dropout_seed, seed_dev=None):
    if hidden.device.type == "cpu":
        return (torch.empty_like(hidden), hidden.new_empty(0),
                hidden.new_empty(0, dtype=torch.float32))
    return (torch.empty_like(hidden), torch.empty_like(hidden),
            torch.empty_like(hidden, dtype=torch.float32))


@_k1_op.register_kernel("cuda")
def _k1_cuda(hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias, num_heads,
             seq_len, eps, attn_dropout, hidden_dropout, dropout_seed, seed_dev=None):
    """K1 on the card: one call of the C entry, three launches."""
    args = (hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias)
    b, tp, e = hidden.shape
    dh = e // num_heads
    if e > 1024:
        raise ValueError(f"E={e} > 1024 is not supported by the K1 kernel")
    if tf32x3_route(hidden, num_heads, seq_len):
        smem = forward_core_smem_bytes(seq_len)
    else:
        smem = 4 * (seq_len * (2 * dh + 1) + 8 * (dh + seq_len))
    if smem > _MAX_SMEM:
        raise ValueError(f"seq_len={seq_len} needs {smem} B of shared memory")

    lib = load_library()
    fn = lib.emo_wavlm_attn_f32 if hidden.dtype == torch.float32 else lib.emo_wavlm_attn_bf16
    ctx = torch.empty_like(hidden)  # attention context, compute dtype
    pre = torch.empty_like(hidden, dtype=torch.float32)  # pre-LayerNorm rows
    out = torch.empty_like(hidden)
    # The float32 tensor-core out-projection reads W_o transposed (TF32
    # wgmma takes both operands K-major): a per-call copy, ~2.4 MB at E=768.
    wo_t = wo.t().contiguous() if tf32x3_route(hidden, num_heads, seq_len) else None
    with torch.cuda.device(hidden.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            *(t.data_ptr() for t in (*args, ctx, pre, out)),
            None if wo_t is None else wo_t.data_ptr(),
            None if seed_dev is None else seed_dev.data_ptr(),
            b, tp, seq_len, e, num_heads, eps,
            *_dropout_args(attn_dropout, hidden_dropout, dropout_seed), stream,
        )
    check(lib, err, "wavlm_attention_sublayer")
    wavlm_attention_sublayer.launches += 1
    return out, ctx, pre


def wavlm_attention_sublayer_backward(
    dout: torch.Tensor,  # [B, Tp, E] cotangent of the sublayer's output
    hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias,
    ctx: Optional[torch.Tensor],  # [B, Tp, E] K1's attention context (CUDA only)
    pre: Optional[torch.Tensor],  # [B, Tp, E] float32, K1's pre-LayerNorm rows (CUDA only)
    num_heads: int,
    seq_len: int,
    eps: float = 1e-5,
    attn_dropout: float = 0.0,
    hidden_dropout: float = 0.0,
    dropout_seed: Optional[int] = None,
):
    """K2 -> (dhidden, dq, dk, dv [B, Tp, E] in their inputs' dtypes; dgate
    [B, H*Tp, 1], dbias [H*Tp, Tp], dwo [E, E], dbo, dlns, dlnb [1, E] in
    float32).  `ctx` and `pre` are the buffers K1 wrote in the forward with
    the same seed and rates; the CPU path recomputes them and ignores both."""
    args = (hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias)
    _validate(*args, num_heads, seq_len)
    if dout.shape != hidden.shape or dout.dtype != hidden.dtype or dout.device != hidden.device:
        raise ValueError(
            f"dout {tuple(dout.shape)} {dout.dtype} on {dout.device} does not match hidden"
        )
    if not dout.is_contiguous():
        raise ValueError("dout must be contiguous")
    if (attn_dropout > 0.0 or hidden_dropout > 0.0) and dropout_seed is None:
        raise ValueError("dropout_seed is required when a dropout rate is above 0")
    if hidden.device.type == "cpu":
        return wavlm_attention_sublayer_backward_plain(
            dout, *args, num_heads, seq_len, eps, attn_dropout, hidden_dropout, dropout_seed
        )
    if hidden.device.type != "cuda":
        raise ValueError(f"unsupported device {hidden.device}")
    b, tp, e = hidden.shape
    h = num_heads
    dh = e // h
    for name, t, dtype in (("ctx", ctx, hidden.dtype), ("pre", pre, torch.float32)):
        if (t is None or t.shape != hidden.shape or t.dtype != dtype
                or t.device != hidden.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be K1's contiguous {dtype} [B, Tp, E] buffer")
    if e > 1024:
        raise ValueError(f"E={e} > 1024 is not supported by the K2 kernel")
    if tensor_core_route(hidden, h, seq_len):
        smem = backward_attention_smem_bytes(seq_len)
    elif tf32x3_route(hidden, h, seq_len):
        smem = max(backward_tf32_smem_bytes(seq_len))
    else:
        smem = 4 * (2 * seq_len * (dh + 1) + 16 * (dh + seq_len) + 3 * seq_len)
    if smem > _MAX_SMEM:
        raise ValueError(f"seq_len={seq_len} needs {smem} B of shared memory")

    lib = load_library()
    fn = lib.emo_wavlm_attn_bwd_f32 if hidden.dtype == torch.float32 else lib.emo_wavlm_attn_bwd_bf16
    dev, f32 = hidden.device, torch.float32
    # Rows at or past seq_len are not written by the kernel: zeros when there are any.
    like = torch.zeros_like if seq_len < tp else torch.empty_like
    dhidden, dq, dk, dv = like(hidden), like(q), like(k), like(v)
    dgate = like(gate)
    dbias = torch.empty_like(position_bias)
    dwo = torch.empty(e, e, dtype=f32, device=dev)
    dbo, dlns, dlnb = (torch.empty(1, e, dtype=f32, device=dev) for _ in range(3))
    col_chunks = -(-(b * tp) // _COL_ROWS)
    scratch = (
        torch.empty_like(hidden),  # dproj, compute dtype
        torch.empty_like(hidden),  # dctx, compute dtype
        torch.empty(b * tp, 4, dtype=f32, device=dev),  # per row: mean, rstd, two row means
        torch.empty(col_chunks, 3, e, dtype=f32, device=dev),  # column-sum partials
        torch.empty(b, h * tp, tp, dtype=f32, device=dev),  # bias partials, one per batch element
        # float32 only: log-sum-exp and softmax row term per (head, query)
        torch.empty(b, h * tp, dtype=f32, device=dev),
        torch.empty(b, h * tp, dtype=f32, device=dev),
    )
    # The float32 tensor-core route's transposed ctx and dproj ([2, E, B*Tp
    # rounded up to 4]): TF32 wgmma reads both operands of dW_o K-major.
    transposed = (torch.empty(2, e, -(-(b * tp) // 4) * 4, dtype=f32, device=dev)
                  if tf32x3_route(hidden, h, seq_len) else None)
    outputs = (dhidden, dq, dk, dv, dgate, dbias, dwo, dbo, dlns, dlnb)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            *(t.data_ptr() for t in (dout, q, k, v, gate, position_bias, wo, ln_scale, ctx, pre,
                                     *outputs, *scratch)),
            None if transposed is None else transposed.data_ptr(),
            b, tp, seq_len, e, h, col_chunks, eps,
            *_dropout_args(attn_dropout, hidden_dropout, dropout_seed), stream,
        )
    check(lib, err, "wavlm_attention_sublayer_backward")
    wavlm_attention_sublayer_backward.launches += 1
    return outputs


class _Sublayer(torch.autograd.Function):
    """K1 forward, K2 backward."""

    @staticmethod
    def forward(fctx, hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias, statics):
        args = (hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias)
        out, ctx, pre = wavlm_attention_sublayer_forward(*args, *statics)
        fctx.save_for_backward(*args, ctx, pre)
        fctx.statics = statics
        return out

    @staticmethod
    @once_differentiable
    def backward(fctx, dout):
        *args, ctx, pre = fctx.saved_tensors
        grads = list(wavlm_attention_sublayer_backward(
            dout.contiguous(), *args, ctx, pre, *fctx.statics
        ))
        grads[6] = grads[6].to(args[6].dtype)  # dwo in wo's dtype
        return (*grads, None)


def wavlm_attention_sublayer(
    hidden: torch.Tensor,  # [B, Tp, E] residual input
    q: torch.Tensor,  # [B, Tp, E], pre-scaled by dh**-0.5
    k: torch.Tensor,  # [B, Tp, E]
    v: torch.Tensor,  # [B, Tp, E]
    gate: torch.Tensor,  # [B, H*Tp, 1] float32
    position_bias: torch.Tensor,  # [H*Tp, Tp] float32
    wo: torch.Tensor,  # [E, E] (in, out)
    bo: torch.Tensor,  # [1, E] float32
    ln_scale: torch.Tensor,  # [1, E] float32
    ln_bias: torch.Tensor,  # [1, E] float32
    num_heads: int,
    seq_len: int,
    eps: float = 1e-5,
    attn_dropout: float = 0.0,
    hidden_dropout: float = 0.0,
    dropout_seed: Optional[int] = None,  # int32, required when a rate is above 0
    seed_dev: Optional[torch.Tensor] = None,  # [1] int32 on the device: the seed at run time
) -> torch.Tensor:
    """-> LayerNorm(hidden + dropout(attention @ wo + bo)): [B, Tp, E] in
    hidden's dtype, differentiable in all ten tensors.  Where autograd
    records none of them (serving, `torch.export`, frozen layers), the
    operator is called directly and K2 has nothing to pair with.  A seed
    read from `seed_dev` is only for such calls: K2 takes it by value."""
    tensors = (hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias)
    statics = (num_heads, seq_len, eps, attn_dropout, hidden_dropout, dropout_seed)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if seed_dev is not None:
            raise ValueError("seed_dev on a differentiated call: K2 takes the seed by value")
        return _Sublayer.apply(*tensors, statics)
    return wavlm_attention_sublayer_forward(*tensors, *statics, seed_dev)[0]


wavlm_attention_sublayer.launches = 0
wavlm_attention_sublayer_backward.launches = 0
