"""K3: one wide-K layer of the WavLM conv feature extractor, a hand-written
CUDA kernel.

Replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
pallas_conv_fe.py::_conv_kernel` (via `fused_conv_layer`), which
`models/wavlm.py` calls for the conv layers L1..L6.  Three CUDA sources, each
with its design note, all implicit GEMMs: `csrc/conv_fe_tc.cu` (TMA + wgmma
on the tensor cores) for bfloat16 without the input-side GELU;
`csrc/conv_fe_tf32.cu` (the same pipeline in TF32 with split products,
3xTF32, at float32 accuracy) for float32 without it; `csrc/conv_fe.cu`
(CUDA cores) for `gelu_input=True` and the shapes neither tensor-core
kernel takes.  Which one runs is decided by the arguments alone
(`tensor_core_route`, `tf32x3_route`).

The float32 kernel reads the weight K-major and split into TF32 hi and lo
parts, [2, cout, k*cin] (`split_weight_tf32`): pass it as `w_split` where
the weight is constant (the model caches it for serving), or the wrapper
makes it from `w_flat` on each call.

`fused_conv_layer` keeps the JAX signature: `y` is the stride-reshaped
input [B, rows, stride*cin] (a free view of the NWC [B, rows*stride, cin]
activations) and `w_flat` the tap-major [k*cin, cout] kernel.  `t_in` is the
logical input length (default rows*stride): input rows at or past it are
never read, so the caller pads nothing for the kernel's sake.  The result is
[B, rows, cout] in y's dtype; rows at or past t_out = (t_in - k) // stride + 1
are unspecified.

For a CPU tensor the wrapper runs `fused_conv_layer_plain`, the same
function in plain PyTorch.  For a CUDA tensor it launches one of the three
kernels or raises.  `fused_conv_layer.launches` counts kernel launches of
any of them.

The kernel has no backward (neither has the TPU kernel): the wrapper raises
when a gradient is asked through it, so training runs it only on a frozen
feature extractor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch
from torch.nn import functional as F

from multimodalemotionrecognition_torch.kernels.build import check, load_library

__all__ = [
    "conv_tile_plan",
    "fused_conv_layer",
    "fused_conv_layer_plain",
    "split_tf32",
    "split_weight_tf32",
    "tensor_core_route",
    "tf32x3_route",
]

_DTYPES = (torch.float32, torch.bfloat16)
_BK = 64  # the bf16 tensor-core kernel's K step: kBK in csrc/conv_fe_tc.cu
_MAX_STEPS = 128  # kMaxSteps there
_TF32_BK = 32  # the float32 one's (32 float32 = 128 bytes): kBK in csrc/conv_fe_tf32.cu
_TF32_MAX_STEPS = 256  # kMaxSteps there


def conv_tile_plan(k: int, stride: int, cin: int, bk: int = _BK) -> List[Tuple[int, int, int]]:
    """The tensor-core kernel's K loop over the k*cin reduction, one entry
    per bk-deep step: (row shift, column, w_flat row).  With y viewed as the
    2-D [B*rows, stride*cin] matrix Y2, step i of output row m reads the box
    Y2[m + shift, col : col + bk] against w_flat[w_row : w_row + bk]: the
    reduction index kk lies at Y2[m + kk // (stride*cin), kk % (stride*cin)],
    so a tap that reaches into the next input row is a row shift (the TPU
    kernel's halo).  Needs bk to divide cin."""
    if cin % bk:
        raise ValueError(f"cin={cin} is not a multiple of the K step {bk}")
    s_cin = stride * cin
    return [(kk0 // s_cin, kk0 % s_cin, kk0) for kk0 in range(0, k * cin, bk)]


@functools.lru_cache(maxsize=None)
def _plan_array(k: int, stride: int, cin: int, bk: int = _BK):
    plan = conv_tile_plan(k, stride, cin, bk)
    return (ctypes.c_int * (3 * len(plan)))(*(x for step in plan for x in step)), len(plan)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero, as `cvt.rna.tf32.f32`: + half of the 13 dropped bits on
    the magnitude, then clear them (int32 view; Inf and NaN pass through)."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 x -> (hi, lo) with hi = tf32(x), lo = tf32(x - hi): both exact
    TF32 values, x - (hi + lo) within 2^-22 of x for normal values.  The
    kernels' `split_tf32` (`csrc/hopper.cuh`) in plain PyTorch, bit for bit."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {x.dtype}")
    hi = _tf32_round(x)
    return hi, _tf32_round(x - hi)


def _tf32_round_finite_(x: torch.Tensor) -> torch.Tensor:
    """`_tf32_round` in place, for finite values (two passes)."""
    x.view(torch.int32).add_(0x1000).bitwise_and_(-0x2000)
    return x


def split_weight_tf32(w_flat: torch.Tensor) -> torch.Tensor:
    """The float32 kernel's weight operand: tap-major [k*cin, cout] float32
    -> [2, cout, k*cin], W^T (K contiguous, as TF32 wgmma reads both
    operands) split into hi (index 0) and lo (index 1): `split_tf32(w_flat.t())`
    bit for bit for finite weights, in six elementwise passes (made per
    forward where the weights are not cached)."""
    if w_flat.ndim != 2 or w_flat.dtype != torch.float32:
        raise ValueError(f"w_flat must be a float32 [k*cin, cout] matrix, got "
                         f"{w_flat.dtype} {tuple(w_flat.shape)}")
    out = torch.empty((2, w_flat.shape[1], w_flat.shape[0]), device=w_flat.device)
    _tf32_round_finite_(out[0].copy_(w_flat.t()))
    _tf32_round_finite_(torch.sub(w_flat.t(), out[0], out=out[1]))
    return out


def tensor_core_route(y: torch.Tensor, w_flat: torch.Tensor, k: int, cin: int,
                      gelu_input: bool) -> bool:
    """True when `fused_conv_layer` runs the tensor-core kernel on these
    arguments: bfloat16, no input-side GELU, cin a multiple of 64, k*cin <=
    8192 and cout a multiple of 8.  Otherwise the CUDA-core kernel runs.
    The choice reads dtypes, flags and shapes only: a bfloat16 operand that
    is not 16-byte aligned (TMA's rule) is refused by the kernel with an
    error, never sent to the slower kernel."""
    return (y.dtype == torch.bfloat16 and not gelu_input and cin % _BK == 0
            and k * cin <= _MAX_STEPS * _BK and w_flat.shape[1] % 8 == 0)


def tf32x3_route(y: torch.Tensor, w_flat: torch.Tensor, k: int, cin: int,
                 gelu_input: bool) -> bool:
    """True when `fused_conv_layer` runs the float32 tensor-core kernel
    (3xTF32) on these arguments: float32, no input-side GELU, cin a multiple
    of 32, k*cin <= 8192 and cout a multiple of 8.  Otherwise, in float32,
    the CUDA-core kernel runs.  Decided by dtypes, flags and shapes only, as
    `tensor_core_route`: an operand that is not 16-byte aligned is refused
    by the kernel with an error."""
    return (y.dtype == torch.float32 and not gelu_input and cin % _TF32_BK == 0
            and k * cin <= _TF32_MAX_STEPS * _TF32_BK and w_flat.shape[1] % 8 == 0)


def fused_conv_layer_plain(
    y: torch.Tensor, w_flat: torch.Tensor, k: int, stride: int, cin: int,
    gelu_input: bool = False, gelu_output: bool = False,
    t_in: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K3: im2col by `unfold`, one float32 matmul,
    exact GELUs; rows at or past t_out are zero."""
    b, rows, _ = y.shape
    t_in = rows * stride if t_in is None else t_in
    t_out = (t_in - k) // stride + 1
    x = y.reshape(b, rows * stride * cin)[:, : t_in * cin].float()
    if gelu_input:
        x = F.gelu(x)
    cols = x.unfold(1, k * cin, stride * cin)  # [B, t_out, k*cin]
    acc = torch.matmul(cols, w_flat.float())
    if gelu_output:
        acc = F.gelu(acc)
    out = y.new_zeros(b, rows, w_flat.shape[1])
    out[:, :t_out] = acc.to(y.dtype)
    return out


def fused_conv_layer(
    y: torch.Tensor,  # [B, rows, stride*cin]
    w_flat: torch.Tensor,  # [k*cin, cout]
    k: int,
    stride: int,
    cin: int,
    gelu_input: bool = False,
    gelu_output: bool = False,
    t_in: Optional[int] = None,
    w_split: Optional[torch.Tensor] = None,  # [2, cout, k*cin]: split_weight_tf32(w_flat)
) -> torch.Tensor:
    """-> conv output [B, rows, cout] in y's dtype (rows >= t_out unspecified).

    On the card, without `gelu_input`, bfloat16 runs on the tensor cores
    (`csrc/conv_fe_tc.cu`, see `tensor_core_route`) and float32 too, in
    3xTF32 (`csrc/conv_fe_tf32.cu`, see `tf32x3_route`; it reads `w_split`,
    made from `w_flat` here when not given); `gelu_input=True` and other
    shapes run the CUDA-core kernel (`csrc/conv_fe.cu`).  `w_split` is read
    on that route only."""
    if y.ndim != 3 or w_flat.ndim != 2:
        raise ValueError(
            f"y must be [B, rows, stride*cin] and w_flat [k*cin, cout], got "
            f"{tuple(y.shape)} and {tuple(w_flat.shape)}"
        )
    b, rows, s_cin = y.shape
    if s_cin != stride * cin:
        raise ValueError(f"lane dim {s_cin} != stride*cin {stride * cin}")
    if w_flat.shape[0] != k * cin:
        raise ValueError(f"w_flat rows {w_flat.shape[0]} != k*cin {k * cin}")
    t_in = rows * stride if t_in is None else t_in
    if not k <= t_in <= rows * stride:
        raise ValueError(f"t_in={t_in} outside [k={k}, rows*stride={rows * stride}]")
    if y.dtype not in _DTYPES or w_flat.dtype != y.dtype:
        raise TypeError(f"y/w_flat dtypes {y.dtype}/{w_flat.dtype}: need one of {_DTYPES}")
    if w_flat.device != y.device:
        raise ValueError(f"w_flat on {w_flat.device}, y on {y.device}")
    if not (y.is_contiguous() and w_flat.is_contiguous()):
        raise ValueError("y and w_flat must be contiguous")
    if torch.is_grad_enabled() and (y.requires_grad or w_flat.requires_grad):
        raise RuntimeError(
            "fused_conv_layer has no backward: freeze the conv feature extractor "
            "(or call it under torch.no_grad()) or use the modular conv path"
        )
    if y.device.type == "cpu":
        return fused_conv_layer_plain(
            y, w_flat, k, stride, cin, gelu_input, gelu_output, t_in
        )
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")

    lib = load_library()
    cout = w_flat.shape[1]
    out = torch.empty(b, rows, cout, dtype=y.dtype, device=y.device)
    shape = (b, rows, t_in, k, stride, cin, cout)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tensor_core_route(y, w_flat, k, cin, gelu_input):
            plan, steps = _plan_array(k, stride, cin)
            err = lib.emo_conv_fe_wgmma_bf16(
                y.data_ptr(), w_flat.data_ptr(), out.data_ptr(), *shape,
                int(gelu_output), plan, steps, stream,
            )
        elif tf32x3_route(y, w_flat, k, cin, gelu_input):
            if w_split is None:
                w_split = split_weight_tf32(w_flat)
            elif (w_split.shape != (2, cout, k * cin) or w_split.dtype != torch.float32
                  or w_split.device != y.device or not w_split.is_contiguous()):
                raise ValueError(
                    f"w_split must be split_weight_tf32(w_flat): a contiguous float32 "
                    f"[2, {cout}, {k * cin}] tensor on {y.device}, got {w_split.dtype} "
                    f"{tuple(w_split.shape)} on {w_split.device}")
            plan, steps = _plan_array(k, stride, cin, _TF32_BK)
            err = lib.emo_conv_fe_wgmma_tf32x3(
                y.data_ptr(), w_split.data_ptr(), out.data_ptr(), *shape,
                int(gelu_output), plan, steps, stream,
            )
        else:
            fn = lib.emo_conv_fe_f32 if y.dtype == torch.float32 else lib.emo_conv_fe_bf16
            err = fn(
                y.data_ptr(), w_flat.data_ptr(), out.data_ptr(), *shape,
                int(gelu_input), int(gelu_output), stream,
            )
    check(lib, err, "fused_conv_layer")
    fused_conv_layer.launches += 1
    return out


fused_conv_layer.launches = 0
