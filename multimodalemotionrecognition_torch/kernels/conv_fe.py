"""K3: one wide-K layer of the WavLM conv feature extractor, a hand-written
CUDA kernel.

Replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
pallas_conv_fe.py::_conv_kernel` (via `fused_conv_layer`), which
`models/wavlm.py` calls for the conv layers L1..L6.  The CUDA source and its
design note are in `csrc/conv_fe.cu`.

`fused_conv_layer` keeps the JAX signature: `y` is the stride-reshaped
input [B, rows, stride*cin] (a free view of the NWC [B, rows*stride, cin]
activations) and `w_flat` the tap-major [k*cin, cout] kernel.  `t_in` is the
logical input length (default rows*stride): input rows at or past it are
never read, so the caller pads nothing for the kernel's sake.  The result is
[B, rows, cout] in y's dtype; rows at or past t_out = (t_in - k) // stride + 1
are unspecified.

For a CPU tensor the wrapper runs `fused_conv_layer_plain`, the same
function in plain PyTorch.  For a CUDA tensor it launches the kernel or
raises.  `fused_conv_layer.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from multimodalemotionrecognition_torch.kernels.build import check, load_library

__all__ = ["fused_conv_layer", "fused_conv_layer_plain"]

_DTYPES = (torch.float32, torch.bfloat16)


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
    """-> conv output [B, rows, cout] in y's dtype (rows >= t_out unspecified)."""
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
    if y.device.type == "cpu":
        return fused_conv_layer_plain(
            y, w_flat, k, stride, cin, gelu_input, gelu_output, t_in
        )
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")

    lib = load_library()
    fn = lib.emo_conv_fe_f32 if y.dtype == torch.float32 else lib.emo_conv_fe_bf16
    cout = w_flat.shape[1]
    out = torch.empty(b, rows, cout, dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            y.data_ptr(), w_flat.data_ptr(), out.data_ptr(),
            b, rows, t_in, k, stride, cin, cout,
            int(gelu_input), int(gelu_output), stream,
        )
    check(lib, err, "fused_conv_layer")
    fused_conv_layer.launches += 1
    return out


fused_conv_layer.launches = 0
