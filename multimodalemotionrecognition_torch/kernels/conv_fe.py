"""K3: one wide-K layer of the WavLM conv feature extractor, a hand-written
CUDA kernel.

Replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
pallas_conv_fe.py::_conv_kernel` (via `fused_conv_layer`), which
`models/wavlm.py` calls for the conv layers L1..L6.  Two CUDA sources, each
with its design note: `csrc/conv_fe_tc.cu`, an implicit GEMM fed by TMA and
run by wgmma on the tensor cores, for bfloat16 without the input-side GELU;
`csrc/conv_fe.cu`, float32 FMAs on CUDA cores, for float32 and for
`gelu_input=True`.  Which one runs is decided by the arguments alone
(`tensor_core_route`).

`fused_conv_layer` keeps the JAX signature: `y` is the stride-reshaped
input [B, rows, stride*cin] (a free view of the NWC [B, rows*stride, cin]
activations) and `w_flat` the tap-major [k*cin, cout] kernel.  `t_in` is the
logical input length (default rows*stride): input rows at or past it are
never read, so the caller pads nothing for the kernel's sake.  The result is
[B, rows, cout] in y's dtype; rows at or past t_out = (t_in - k) // stride + 1
are unspecified.

For a CPU tensor the wrapper runs `fused_conv_layer_plain`, the same
function in plain PyTorch.  For a CUDA tensor it launches one of the two
kernels or raises.  `fused_conv_layer.launches` counts kernel launches of
either.

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

__all__ = ["conv_tile_plan", "fused_conv_layer", "fused_conv_layer_plain", "tensor_core_route"]

_DTYPES = (torch.float32, torch.bfloat16)
_BK = 64  # the tensor-core kernel's K step: kBK in csrc/conv_fe_tc.cu
_MAX_STEPS = 128  # kMaxSteps there


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
def _plan_array(k: int, stride: int, cin: int):
    plan = conv_tile_plan(k, stride, cin)
    return (ctypes.c_int * (3 * len(plan)))(*(x for step in plan for x in step)), len(plan)


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
) -> torch.Tensor:
    """-> conv output [B, rows, cout] in y's dtype (rows >= t_out unspecified).

    On the card, bfloat16 without `gelu_input` runs on the tensor cores
    (`csrc/conv_fe_tc.cu`; see `tensor_core_route` for the shapes it takes);
    float32 and `gelu_input=True` run the CUDA-core kernel (`csrc/conv_fe.cu`)."""
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
