"""K1: the WavLM attention sublayer (forward), a hand-written CUDA kernel.

Replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
pallas_wavlm_attn.py::_sublayer_kernel` (via `wavlm_fused_attention_sublayer`),
which `models/wavlm.py` calls once per encoder layer.  The CUDA source and
its design note are in `csrc/wavlm_attn.cu`.

`wavlm_attention_sublayer` keeps the JAX function's public layout: q/k/v in
their natural [B, Tp, E] layout with q pre-scaled by dh^-0.5, the per-query
gate as [B, H*Tp, 1] float32, the relative position bias as [H*Tp, Tp]
float32 shared by the batch, `wo` as the [E, E] (in, out) kernel, and
bo / LayerNorm scale / bias as float32 [1, E].  It returns
LayerNorm(hidden + attention(q, k, v) @ wo + bo) in hidden's dtype; rows at
or past `seq_len` are unspecified.

For a CPU tensor the wrapper runs `wavlm_attention_sublayer_plain`, the same
function in plain PyTorch.  For a CUDA tensor it launches the kernel or
raises.  `wavlm_attention_sublayer.launches` counts kernel launches.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from multimodalemotionrecognition_torch.kernels.build import check, load_library

__all__ = ["wavlm_attention_sublayer", "wavlm_attention_sublayer_plain"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_SMEM = 227 * 1024


def wavlm_attention_sublayer_plain(
    hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias,
    num_heads: int, seq_len: int, eps: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (float32 math, the kernel's roundings:
    probabilities and context rows pass through the compute dtype)."""
    b, tp, e = hidden.shape
    h = num_heads
    dh = e // h

    def heads(x):
        return x.view(b, tp, h, dh).transpose(1, 2).float()

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2))
    scores = scores + gate.view(b, h, tp, 1) * position_bias.view(h, tp, tp)
    if seq_len < tp:
        pad = torch.arange(tp, device=scores.device) >= seq_len
        scores = scores.masked_fill(pad, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    ctx = torch.matmul(probs, heads(v)).to(v.dtype)
    ctx = ctx.transpose(1, 2).reshape(b, tp, e)
    out = torch.matmul(ctx.float(), wo.float()) + bo.view(e) + hidden.float()
    out = F.layer_norm(out, (e,), ln_scale.view(e), ln_bias.view(e), eps)
    return out.to(hidden.dtype)


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
) -> torch.Tensor:
    """-> LayerNorm(hidden + attention @ wo + bo): [B, Tp, E] in hidden's
    dtype.  Eval only: a dropout rate above 0 raises."""
    if attn_dropout != 0.0 or hidden_dropout != 0.0:
        raise NotImplementedError(
            "K1 dropout (training) comes with the backward kernel; rates must be 0"
        )
    args = (hidden, q, k, v, gate, position_bias, wo, bo, ln_scale, ln_bias)
    _validate(*args, num_heads, seq_len)
    if hidden.device.type == "cpu":
        return wavlm_attention_sublayer_plain(*args, num_heads, seq_len, eps)
    if hidden.device.type != "cuda":
        raise ValueError(f"unsupported device {hidden.device}")
    b, tp, e = hidden.shape
    dh = e // num_heads
    if e > 1024:
        raise ValueError(f"E={e} > 1024 is not supported by the K1 kernel")
    smem = 4 * (seq_len * (2 * dh + 1) + 8 * (dh + seq_len))
    if smem > _MAX_SMEM:
        raise ValueError(f"seq_len={seq_len} needs {smem} B of shared memory")

    lib = load_library()
    fn = lib.emo_wavlm_attn_f32 if hidden.dtype == torch.float32 else lib.emo_wavlm_attn_bf16
    ctx = torch.empty_like(hidden)  # attention context, compute dtype
    proj = torch.empty_like(hidden, dtype=torch.float32)  # pre-LayerNorm rows
    out = torch.empty_like(hidden)
    with torch.cuda.device(hidden.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            *(t.data_ptr() for t in (*args, ctx, proj, out)),
            b, tp, seq_len, e, num_heads, eps, stream,
        )
    check(lib, err, "wavlm_attention_sublayer")
    wavlm_attention_sublayer.launches += 1
    return out


wavlm_attention_sublayer.launches = 0
