"""K5: the bidirectional cross-attention core, a hand-written CUDA kernel.

Replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
pallas_xattn.py::_fused_kernel` (via `fused_bidirectional_xattn`): from the
projected video tokens [B, T, d] and audio tokens [B, Ta, d] it computes

    v' = LN(v + MHA(q=v, kv=a)  + optional bias [B, T, Ta])
    a' = LN(a + MHA(q=a, kv=v') + optional bias [B, Ta, T])
    v_emb = mean_T(v')    a_emb = mean_Ta(a')

in float32, a2v attending over the updated video tokens.  It is the middle
of K4 (`kernels/fused_block.py`), which shares its device functions
(`csrc/fusion.cuh`) and its plain functions (`mha_plain`, `layer_norm_plain`).
The CUDA source and its design note are in `csrc/xattn.cu`.

`XattnParams` keeps the JAX layout: `*_in_kernel` [d, 3d] and `*_out_kernel`
[d, d] are (in, out) matrices, the transposes of torch's `in_proj_weight`
and `out_proj.weight`.

On the card two routes compute it.  Where `tensor_core_route` says so (the
serving shapes: T <= 16, d a multiple of 32 up to 128, at most 8 heads of a
width that is a multiple of 4) the tensor-core route runs (`csrc/
xattn_tc.cuh`: four launches, every product on wgmma in 3xTF32, the video
side on a cluster of one block per head); other shapes run the CUDA-core
kernels of `csrc/xattn.cu`.

For CPU tensors the wrapper runs `fused_bidirectional_xattn_plain`; for CUDA
tensors it launches the kernel or raises.
`fused_bidirectional_xattn.launches` counts kernel calls (one per call of
either route).

This module also holds the pointer table both kernels' C entry points take
(`PointerTable`), in the order of the enums in `csrc/fusion.cuh`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from multimodalemotionrecognition_torch.kernels.build import check, load_library

__all__ = [
    "XattnParams",
    "fused_bidirectional_xattn",
    "fused_bidirectional_xattn_plain",
    "tc_smem_bytes",
    "tc_workspace_floats",
    "tensor_core_route",
    "xattn_params_from_state_dict",
]

LN_EPS = 1e-5
_MAX_VIDEO_TOKENS = 16  # csrc/fusion.cuh::kMaxT
_MAX_SMEM = 227 * 1024
_MAX_HEADS = 8  # csrc/xattn_tc.cuh::kMaxHeads: a cluster of one block per head
# csrc/tc_product.cuh, the tensor-core product of K4's and K5's routes: kRows,
# kMaxCols, kChunk, kRingStages, kXRows, and the shared memory every kernel
# of those routes starts with (kBaseBytes: X's double-buffered hi and lo
# chunk blocks, the weight ring), plus 1 KB to align it to the swizzle's
# atoms.
_TC_ROWS, _TC_MAX_COLS, _TC_CHUNK, _TC_RING_STAGES, _TC_X_ROWS = 16, 128, 32, 3, 32
_TC_BASE_BYTES = 4 * _TC_X_ROWS * 128 + _TC_RING_STAGES * _TC_CHUNK * (4 * _TC_MAX_COLS + 16)

# The entry points' tables, in the order of csrc/fusion.cuh's enums.
TENSOR_SLOTS = (
    "v_in", "a_in", "bias_v2a", "bias_a2v", "a_tok", "ka", "va", "qa",
    "out", "out_v", "out_a", "work",
)
MATRIX_SLOTS = (
    "vin_w", "aseq_w", "ain_w", "v2a_in_w", "v2a_out_w", "a2v_in_w", "a2v_out_w",
    "ep_p0_w", "ep_p3_w", "ep_vq_w", "ep_ak_w", "ep_aq_w", "ep_vk_w",
    "vp_w1", "vp_w2", "ap_w1", "ap_w2",
    "h_w1", "h_w2", "g_w1", "g_w2", "c_w", "ep_tok_w",
)
VECTOR_SLOTS = (
    "vin_b", "aseq_b", "ain_b", "v2a_in_b", "v2a_out_b", "a2v_in_b", "a2v_out_b",
    "vn_s", "vn_b", "an_s", "an_b",
    "ep_p0_b", "ep_p3_b", "ep_vq_b", "ep_ak_b", "ep_aq_b", "ep_vk_b", "ep_scale",
    "vp_ln_s", "vp_ln_b", "vp_b1", "vp_b2", "ap_ln_s", "ap_ln_b", "ap_b1", "ap_b2",
    "h_b1", "h_b2", "g_b1", "g_b2", "c_b",
)
INT_SLOTS = (
    "B", "T", "Ta", "Dv", "Ds", "d", "H", "C", "pool_hidden", "prior_dim",
    "prior_hidden", "head_hidden", "pooling", "head", "bias_mode", "samples_per_block",
    "work_floats",
)
BIAS_NONE, BIAS_PRIOR, BIAS_EXTERNAL = 0, 1, 2
_TENSOR_INDEX = {name: i for i, name in enumerate(TENSOR_SLOTS)}


class XattnParams(NamedTuple):
    """Parameters of both attention directions and the two norms, float32."""

    v2a_in_kernel: torch.Tensor  # [d, 3d]
    v2a_in_bias: torch.Tensor  # [3d]
    v2a_out_kernel: torch.Tensor  # [d, d]
    v2a_out_bias: torch.Tensor  # [d]
    a2v_in_kernel: torch.Tensor
    a2v_in_bias: torch.Tensor
    a2v_out_kernel: torch.Tensor
    a2v_out_bias: torch.Tensor
    v_norm_scale: torch.Tensor  # [d]
    v_norm_bias: torch.Tensor
    a_norm_scale: torch.Tensor
    a_norm_bias: torch.Tensor


def xattn_params_from_state_dict(
    state_dict: Mapping[str, torch.Tensor], device=None
) -> XattnParams:
    """The fusion block's attention parameters from a `FusionModel` state
    dict (float weights), as contiguous float32 (in, out) matrices."""

    def vec(key):
        return state_dict[key].detach().to(device=device, dtype=torch.float32).contiguous()

    def mat(key):
        return state_dict[key].detach().to(device=device, dtype=torch.float32).t().contiguous()

    return XattnParams(
        mat("v2a_attn.in_proj_weight"), vec("v2a_attn.in_proj_bias"),
        mat("v2a_attn.out_proj.weight"), vec("v2a_attn.out_proj.bias"),
        mat("a2v_attn.in_proj_weight"), vec("a2v_attn.in_proj_bias"),
        mat("a2v_attn.out_proj.weight"), vec("a2v_attn.out_proj.bias"),
        vec("v_norm.weight"), vec("v_norm.bias"),
        vec("a_norm.weight"), vec("a_norm.bias"),
    )


def layer_norm_plain(x, scale, bias, eps: float = LN_EPS):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def mha_plain(q_in, kv_in, w_in, b_in, w_out, b_out, bias, num_heads: int):
    """torch-semantics multi-head attention on [B, L, d] float32 tokens with
    (in, out) weights; `bias` is an additive [B, Lq, Lk] or None."""
    b, lq, d = q_in.shape
    lk = kv_in.shape[1]
    dh = d // num_heads
    q = (torch.matmul(q_in, w_in[:, :d]) + b_in[:d]) * dh**-0.5
    k = torch.matmul(kv_in, w_in[:, d : 2 * d]) + b_in[d : 2 * d]
    v = torch.matmul(kv_in, w_in[:, 2 * d :]) + b_in[2 * d :]
    q = q.view(b, lq, num_heads, dh).transpose(1, 2)
    k = k.view(b, lk, num_heads, dh).transpose(1, 2)
    v = v.view(b, lk, num_heads, dh).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2))
    if bias is not None:
        scores = scores + bias[:, None]
    ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
    return torch.matmul(ctx.transpose(1, 2).reshape(b, lq, d), w_out) + b_out


def bidirectional_attention_plain(params: XattnParams, v, a, v2a_bias, a2v_bias, num_heads):
    """-> (v', a'), both float32."""
    p = params
    v2 = mha_plain(v, a, p.v2a_in_kernel, p.v2a_in_bias, p.v2a_out_kernel,
                   p.v2a_out_bias, v2a_bias, num_heads)
    v_new = layer_norm_plain(v + v2, p.v_norm_scale, p.v_norm_bias)
    # The reference's ordering: a2v attends over the updated video tokens.
    a2 = mha_plain(a, v_new, p.a2v_in_kernel, p.a2v_in_bias, p.a2v_out_kernel,
                   p.a2v_out_bias, a2v_bias, num_heads)
    a_new = layer_norm_plain(a + a2, p.a_norm_scale, p.a_norm_bias)
    return v_new, a_new


def fused_bidirectional_xattn_plain(
    params: XattnParams, v_tokens, a_tokens, v2a_bias=None, a2v_bias=None,
    num_heads: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5, float32 math."""
    if v2a_bias is not None:
        v2a_bias, a2v_bias = v2a_bias.float(), a2v_bias.float()
    v_new, a_new = bidirectional_attention_plain(
        params, v_tokens.float(), a_tokens.float(), v2a_bias, a2v_bias, num_heads
    )
    return v_new.mean(dim=1), a_new.mean(dim=1)


class PointerTable:
    """The pointer table the C entry points of `csrc/fusion.cuh` take, with
    the parameter slots (matrices, their scales, vectors) checked and filled
    once; `launch` adds a call's tensors.  Absent names are null pointers."""

    def __init__(
        self,
        what: str,
        device: torch.device,
        matrices: Mapping[str, torch.Tensor],
        scales: Mapping[str, torch.Tensor],
        vectors: Mapping[str, torch.Tensor],
    ):
        operands = [None] * len(TENSOR_SLOTS)
        for name in MATRIX_SLOTS:
            operands += [matrices.get(name), scales.get(name)]
        operands += [vectors.get(n) for n in VECTOR_SLOTS]
        for t in operands:
            if t is not None and (t.device != device or not t.is_contiguous()):
                raise ValueError(f"{what}: parameters must be contiguous tensors on {device}")
        self.what, self.device = what, device
        self._operands = operands  # keeps the tensors behind the pointers alive
        self._base = (ctypes.c_void_p * len(operands))(
            *(None if t is None else t.data_ptr() for t in operands)
        )

    def launch(
        self, entry: str, tensors: Mapping[str, Optional[torch.Tensor]], ints: Mapping[str, int]
    ) -> None:
        """Call the C entry point `entry` on the current stream with this
        call's tensors (contiguous, on the table's device) and ints (absent:
        0); raises on a CUDA error."""
        ptrs = type(self._base).from_buffer_copy(self._base)
        for name, t in tensors.items():
            if t is None:
                continue
            if t.device != self.device or not t.is_contiguous():
                raise ValueError(f"{self.what}: {name} must be contiguous on {self.device}")
            ptrs[_TENSOR_INDEX[name]] = t.data_ptr()
        values = (ctypes.c_int * len(INT_SLOTS))(*(ints.get(n, 0) for n in INT_SLOTS))
        dh = ints["d"] // ints["H"]
        lib = load_library()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, entry)(
                ptrs, len(ptrs), values, len(values), LN_EPS, dh**-0.5, stream
            )
        check(lib, err, self.what)


def _validate(params, v_tokens, a_tokens, v2a_bias, a2v_bias, num_heads):
    if v_tokens.ndim != 3 or a_tokens.ndim != 3:
        raise ValueError("v_tokens must be [B, T, d] and a_tokens [B, Ta, d]")
    b, t, d = v_tokens.shape
    ta = a_tokens.shape[1]
    if a_tokens.shape[0] != b or a_tokens.shape[2] != d:
        raise ValueError(f"a_tokens shape {tuple(a_tokens.shape)} does not match [B={b}, Ta, d={d}]")
    if num_heads < 1 or d % num_heads != 0:
        raise ValueError(f"d={d} is not a multiple of num_heads={num_heads}")
    if (v2a_bias is None) != (a2v_bias is None):
        raise ValueError("give both attention biases or neither")
    if v2a_bias is not None and (
        tuple(v2a_bias.shape) != (b, t, ta) or tuple(a2v_bias.shape) != (b, ta, t)
    ):
        raise ValueError(
            f"bias shapes {tuple(v2a_bias.shape)}, {tuple(a2v_bias.shape)} != "
            f"{(b, t, ta)}, {(b, ta, t)}"
        )
    shapes = {
        "in_kernel": (d, 3 * d), "in_bias": (3 * d,), "out_kernel": (d, d), "out_bias": (d,),
        "norm_scale": (d,), "norm_bias": (d,),
    }
    for name, value in params._asdict().items():
        want = shapes[name.split("_", 1)[1]]
        if tuple(value.shape) != want or value.dtype != torch.float32:
            raise ValueError(f"params.{name}: need float32 {want}, got {value.dtype} {tuple(value.shape)}")
        if value.device != v_tokens.device:
            raise ValueError(f"params.{name} on {value.device}, tokens on {v_tokens.device}")
    for name, t_ in (("a_tokens", a_tokens), ("v2a_bias", v2a_bias), ("a2v_bias", a2v_bias)):
        if t_ is not None and t_.device != v_tokens.device:
            raise ValueError(f"{name} on {t_.device}, v_tokens on {v_tokens.device}")


def _x_stride(k: int) -> int:
    """Row stride of a shared X tile of width k (csrc/tc_product.cuh::x_stride)."""
    return -(-k // 32) * 32 + 4


def tc_smem_bytes(t: int, ta: int, d: int, num_heads: int) -> Dict[str, int]:
    """Shared memory of each kernel of K5's tensor-core route
    (`rows_smem_bytes`, `video_smem_bytes`, `audio_smem_bytes` in
    csrc/xattn_tc.cuh)."""
    r, dh = _TC_ROWS, d // num_heads
    floats = {
        "rows": r * _x_stride(d),
        "video": t * (3 * _x_stride(dh) + _x_stride(ta) + 4 * _x_stride(d)),
        "audio": 5 * r * _x_stride(d) + t * (2 * d + 4) + r * num_heads * t,
    }
    return {name: 1024 + _TC_BASE_BYTES + 4 * n for name, n in floats.items()}


def tc_workspace_floats(b: int, t: int, ta: int, d: int) -> int:
    """float32 workspace of K5's tensor-core route (csrc/xattn_tc.cuh::
    carve_work): the v2a keys and values and the a2v queries of the audio
    tokens, the v2a queries of the video tokens, the a2v keys and values of
    v', the column sums of a' per 16-row tile of a sample; each piece
    rounded up to 4 floats."""
    tiles = -(-ta // _TC_ROWS)
    sizes = (b * ta * 2 * d, b * ta * d, b * t * d, b * t * 2 * d, b * tiles * d)
    return sum(-(-n // 4) * 4 for n in sizes)


def tensor_core_route(v_tokens: torch.Tensor, a_tokens: torch.Tensor, num_heads: int) -> bool:
    """True when K5 runs its tensor-core route (csrc/xattn_tc.cuh) on these
    tokens: T <= 16, d a multiple of 32 up to 128, at most 8 heads (a
    cluster of one block per head) of a width that is a multiple of 4, and
    every kernel's shared memory within 227 KB.  Otherwise the CUDA-core
    kernels of csrc/xattn.cu run.  The shapes alone decide."""
    t, d = v_tokens.shape[1], v_tokens.shape[2]
    ta = a_tokens.shape[1]
    return (t <= _MAX_VIDEO_TOKENS and d % 32 == 0 and d <= 128 and num_heads <= _MAX_HEADS
            and d % num_heads == 0 and (d // num_heads) % 4 == 0
            and max(tc_smem_bytes(t, ta, d, num_heads).values()) <= _MAX_SMEM)


def fused_bidirectional_xattn(
    params: XattnParams,
    v_tokens: torch.Tensor,  # [B, T, d]
    a_tokens: torch.Tensor,  # [B, Ta, d]
    v2a_bias: Optional[torch.Tensor] = None,  # [B, T, Ta]
    a2v_bias: Optional[torch.Tensor] = None,  # [B, Ta, T]
    num_heads: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (v_emb [B, d], a_emb [B, d]) float32: attention, residual,
    LayerNorm and mean pool of both streams."""
    _validate(params, v_tokens, a_tokens, v2a_bias, a2v_bias, num_heads)
    device = v_tokens.device
    if device.type == "cpu":
        return fused_bidirectional_xattn_plain(
            params, v_tokens, a_tokens, v2a_bias, a2v_bias, num_heads
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _launch(params, v_tokens, a_tokens, v2a_bias, a2v_bias, num_heads,
                   tensor_core_route(v_tokens, a_tokens, num_heads))


def _launch(params, v_tokens, a_tokens, v2a_bias, a2v_bias, num_heads, tensor_cores: bool):
    """K5 on the card by the route named: the tensor-core kernels of
    csrc/xattn_tc.cuh (shapes `tensor_core_route` takes) or the CUDA-core
    kernels of csrc/xattn.cu (any shape `_validate` takes, within shared
    memory)."""
    device = v_tokens.device
    b, t, d = v_tokens.shape
    ta = a_tokens.shape[1]

    def f32(x):
        return None if x is None else x.float().contiguous()

    a_tok = f32(a_tokens)
    out = torch.empty(2, b, d, dtype=torch.float32, device=device)
    if tensor_cores:
        work_floats = tc_workspace_floats(b, t, ta, d)
        work = torch.empty(work_floats, dtype=torch.float32, device=device)
        scratch = (None, None, None)
    else:
        work_floats, work = 0, None
        scratch = torch.empty(3, b, ta, d, dtype=torch.float32, device=device)
    p = params
    table = PointerTable(
        "fused_bidirectional_xattn", device,
        matrices={
            "v2a_in_w": p.v2a_in_kernel, "v2a_out_w": p.v2a_out_kernel,
            "a2v_in_w": p.a2v_in_kernel, "a2v_out_w": p.a2v_out_kernel,
        },
        scales={},
        vectors={
            "v2a_in_b": p.v2a_in_bias, "v2a_out_b": p.v2a_out_bias,
            "a2v_in_b": p.a2v_in_bias, "a2v_out_b": p.a2v_out_bias,
            "vn_s": p.v_norm_scale, "vn_b": p.v_norm_bias,
            "an_s": p.a_norm_scale, "an_b": p.a_norm_bias,
        },
    )
    table.launch(
        "emo_xattn_tc" if tensor_cores else "emo_xattn",
        tensors={
            "v_in": f32(v_tokens), "bias_v2a": f32(v2a_bias), "bias_a2v": f32(a2v_bias),
            "a_tok": a_tok, "ka": scratch[0], "va": scratch[1], "qa": scratch[2],
            "out_v": out[0], "out_a": out[1], "work": work,
        },
        ints={
            "B": b, "T": t, "Ta": ta, "d": d, "H": num_heads,
            "bias_mode": BIAS_NONE if v2a_bias is None else BIAS_EXTERNAL,
            "samples_per_block": 1, "work_floats": work_floats,
        },
    )
    fused_bidirectional_xattn.launches += 1
    return out[0], out[1]


fused_bidirectional_xattn.launches = 0
