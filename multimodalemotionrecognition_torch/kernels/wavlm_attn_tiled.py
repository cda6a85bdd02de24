"""K6: the batch-tiled WavLM attention sublayer (eval), G batch elements per
thread block.

Replaces the TPU kernel `benchmarks/bench_attn_tile.py::_tiled_kernel`
(launched by `tiled_call`): the arithmetic of K1's eval path
(`kernels/wavlm_attn.py`) with `g_tile` batch elements per program, every
`g_tile` giving the same tensor bit for bit.  It is the kernel of a
measurement (`bench/attn_tile.py`): does keeping what the batch shares (the
head's position bias, the out-projection's tile) resident across several
elements beat one block per element?  The CUDA source and its design note are
`csrc/wavlm_attn_tiled.cu`.

`wavlm_attention_sublayer_tiled` takes the operands in `tiled_call`'s order
and layout: hidden/q/k/v [B, Tp, E] with q pre-scaled by dh^-0.5, the gate
[B, H*Tp, 1] float32, the position bias [H*Tp, Tp] float32, `wo` the [E, E]
(in, out) kernel, bo and the LayerNorm scale and bias [1, E] float32.  Key
columns at or past `seq_len` get no weight; all Tp rows of the output are
computed and written (the padding rows hold what the padding rows of q and
hidden give).  There is no dropout and no gradient.

On the card two routes compute it.  Where `tensor_core_route` says so (a
head width of 64 and `seq_len` <= 160, K1's tensor-core route) the kernels
of `csrc/wavlm_attn_tiled_tc.cuh` (bfloat16) and `csrc/
wavlm_attn_tiled_tf32.cuh` (float32, 3xTF32) run K1's tensor-core
arithmetic with the batch tile inside the block: the same bits as K1 on rows
below `seq_len`.  The float32 route reads W_o transposed, a per-call copy
counted in its time.  Other shapes run the CUDA-core kernels of
`csrc/wavlm_attn_tiled.cu`.

For CPU tensors the wrapper runs the plain PyTorch version; for CUDA tensors
it launches the kernel or raises.  Kernel calls are counted in
`wavlm_attention_sublayer_tiled.launches`.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from multimodalemotionrecognition_torch.kernels.build import check, load_library
from multimodalemotionrecognition_torch.kernels.wavlm_attn import (
    _MAX_SMEM,
    _plain_forward_parts,
    _validate,
)

__all__ = [
    "tensor_core_route",
    "wavlm_attention_sublayer_tiled",
    "wavlm_attention_sublayer_tiled_plain",
]

_GEMM_DEPTH, _GEMM_TILE = 16, 64  # kBK and kBM = kBN in csrc/wavlm_attn_tiled.cu
_TC_HEAD_DIM, _TC_MAX_KEYS = 64, 160  # the tensor-core route's head width and keys held
_MAX_WIDTH = 1024  # the LayerNorm pass: 32 lanes x kLnMaxPerLane


def tensor_core_route(hidden: torch.Tensor, num_heads: int, seq_len: int) -> bool:
    """True when K6 runs its tensor-core kernels on these arguments (the
    shapes of K1's tensor-core routes, `wavlm_attn.tensor_core_route` and
    `tf32x3_route`): bfloat16 or float32, a head width of 64, `seq_len` <=
    160, E <= 1024.  Otherwise its CUDA-core kernels run.  A misaligned
    operand is refused by the kernel with an error."""
    e = hidden.shape[-1]
    return (hidden.dtype in (torch.bfloat16, torch.float32) and e == _TC_HEAD_DIM * num_heads
            and seq_len <= _TC_MAX_KEYS and e <= _MAX_WIDTH)


def _check_tile(g_tile: int, batch: int) -> None:
    if g_tile < 1 or batch % g_tile != 0:
        raise ValueError(f"batch {batch} is not a multiple of g_tile={g_tile}")


def wavlm_attention_sublayer_tiled_plain(
    g_tile: int, hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias,
    num_heads: int, seq_len: int, eps: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch version of K6, walking the batch as the TPU kernel
    does: tiles of `g_tile` elements, one element at a time inside a tile,
    float32 math with the kernel's roundings.  Every element goes through the
    same calls at the same shapes whatever `g_tile` is, so the result does
    not depend on it."""
    b, _, e = hidden.shape
    _check_tile(g_tile, b)
    out = torch.empty_like(hidden)
    for tile in range(0, b, g_tile):
        for i in range(tile, tile + g_tile):
            one = slice(i, i + 1)
            pre = _plain_forward_parts(
                hidden[one], q[one], k[one], v[one], gate[one], position_bias, wo, bo,
                num_heads, seq_len, 0.0, 0.0, None,
            )[3]
            out[one] = F.layer_norm(pre, (e,), ln_scale.view(e), ln_bias.view(e), eps).to(out.dtype)
    return out


def wavlm_attention_sublayer_tiled(
    g_tile: int,  # batch elements per thread block
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
) -> torch.Tensor:
    """-> LayerNorm(hidden + attention @ wo + bo): [B, Tp, E] in hidden's
    dtype, the same bits for every `g_tile` that divides B."""
    args = (hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias)
    _validate(*args, num_heads, seq_len)
    b, tp, e = hidden.shape
    _check_tile(g_tile, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(
            "wavlm_attention_sublayer_tiled has no backward: call it under "
            "torch.no_grad(), or use wavlm_attention_sublayer"
        )
    if hidden.device.type == "cpu":
        return wavlm_attention_sublayer_tiled_plain(g_tile, *args, num_heads, seq_len, eps)
    if hidden.device.type != "cuda":
        raise ValueError(f"unsupported device {hidden.device}")
    return _launch(g_tile, *args, num_heads, seq_len, eps,
                   tensor_cores=tensor_core_route(hidden, num_heads, seq_len))


def _launch(g_tile, hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias,
            num_heads: int, seq_len: int, eps: float, tensor_cores: bool) -> torch.Tensor:
    """K6 on the card by the route named: the tensor-core kernels (shapes
    `tensor_core_route` takes) or the CUDA-core kernels of
    csrc/wavlm_attn_tiled.cu."""
    args = (hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias)
    b, tp, e = hidden.shape
    dh = e // num_heads
    if tensor_cores:
        if not tensor_core_route(hidden, num_heads, seq_len):
            raise ValueError(
                f"{hidden.dtype}, E={e}, {num_heads} heads, seq_len={seq_len}: outside "
                "K6's tensor-core route")
    elif e > 1024 or e % _GEMM_DEPTH != 0:
        raise ValueError(f"E={e} must be a multiple of {_GEMM_DEPTH} up to 1024 for the K6 kernel")
    else:
        smem = max(
            4 * (seq_len * (2 * dh + 1) + 8 * (dh + seq_len) + 32 * seq_len),  # attention core
            4 * (e * _GEMM_TILE + _GEMM_DEPTH * (_GEMM_TILE + 4)),  # out-projection
        )
        if smem > _MAX_SMEM:
            raise ValueError(f"seq_len={seq_len}, E={e} need {smem} B of shared memory")
    if b // g_tile > 65535:
        raise ValueError(f"B / g_tile = {b // g_tile} exceeds the grid's limit of 65535")

    lib = load_library()
    f32 = hidden.dtype == torch.float32
    ctx = torch.empty_like(hidden)  # attention context, compute dtype
    pre = torch.empty_like(hidden, dtype=torch.float32)  # pre-LayerNorm rows
    out = torch.empty_like(hidden)
    with torch.cuda.device(hidden.device):
        stream = torch.cuda.current_stream().cuda_stream
        pointers = [t.data_ptr() for t in (*args, ctx, pre, out)]
        if tensor_cores:
            fn = lib.emo_wavlm_attn_tiled_tc_f32 if f32 else lib.emo_wavlm_attn_tiled_tc_bf16
            # The float32 out-projection reads W_o transposed (TF32 wgmma
            # takes both operands K-major): a per-call copy, as K1's.
            wo_t = wo.t().contiguous() if f32 else None
            pointers.append(None if wo_t is None else wo_t.data_ptr())
        else:
            fn = lib.emo_wavlm_attn_tiled_f32 if f32 else lib.emo_wavlm_attn_tiled_bf16
        err = fn(*pointers, g_tile, b, tp, seq_len, e, num_heads, eps, stream)
    check(lib, err, "wavlm_attention_sublayer_tiled")
    wavlm_attention_sublayer_tiled.launches += 1
    return out


wavlm_attention_sublayer_tiled.launches = 0
