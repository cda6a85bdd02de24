"""K2's routes and the shared-memory plans of its tensor-core attention
blocks, on the CPU: both follow from the arguments alone, as K3's route does
(`tests/test_torch_conv_plan.py`), and the Python mirrors hold the CUDA
headers' constants.  bfloat16 takes `tensor_core_route`
(`csrc/wavlm_attn_bwd_tc.cuh`), float32 `tf32x3_route`
(`csrc/wavlm_attn_bwd_tf32.cuh`)."""

import re
from pathlib import Path

import pytest
import torch

from multimodalemotionrecognition_torch.kernels import wavlm_attn
from multimodalemotionrecognition_torch.kernels.wavlm_attn import (
    backward_attention_smem_bytes,
    backward_tf32_smem_bytes,
    tensor_core_route,
    tf32x3_route,
)

CSRC = Path(wavlm_attn.__file__).resolve().parent / "csrc"
MAX_SMEM = 227 * 1024  # what one block of an H100 may use


@pytest.mark.parametrize(
    "dtype,h,e,seq_len,expected",
    [(torch.bfloat16, 12, 768, 149, True), (torch.bfloat16, 12, 768, 160, True),
     (torch.bfloat16, 12, 768, 1, True), (torch.bfloat16, 4, 256, 77, True),
     (torch.bfloat16, 12, 768, 161, False), (torch.bfloat16, 4, 768, 149, False),
     (torch.float32, 12, 768, 149, False)],
)
def test_tensor_core_route_is_decided_by_the_arguments(dtype, h, e, seq_len, expected):
    hidden = torch.zeros(1, max(seq_len, 1), e, dtype=dtype)
    assert tensor_core_route(hidden, h, seq_len) is expected


def test_attention_block_fits_in_shared_memory_at_160_keys():
    """Q, K, V, dctx as [160][72] bf16 tiles and P_d, dS as [160][168] bf16
    squares: 199,680 bytes of the 227 KB a block may have; 64 keys below."""
    assert backward_attention_smem_bytes(160) == 2 * (4 * 160 * 72 + 2 * 160 * 168) == 199_680
    assert backward_attention_smem_bytes(160) <= MAX_SMEM
    assert backward_attention_smem_bytes(149) == backward_attention_smem_bytes(65)
    assert backward_attention_smem_bytes(64) == 2 * (4 * 64 * 72 + 2 * 64 * 72)
    with pytest.raises(ValueError):
        backward_attention_smem_bytes(161)


def test_python_mirror_holds_the_header_constants():
    src = (CSRC / "wavlm_attn_bwd_tc.cuh").read_text()
    found = {name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
             for name in ("kHeadDim", "kMaxKeys", "kRowStride")}
    assert found == {"kHeadDim": wavlm_attn._TC_HEAD_DIM, "kMaxKeys": wavlm_attn._TC_MAX_KEYS,
                     "kRowStride": wavlm_attn._TC_ROW_STRIDE}
    assert "static constexpr int kSquareStride = kKeys + 8;" in src
    # K1's tensor-core rule, which K2 shares.
    fwd = (CSRC / "wavlm_attn_tc.cuh").read_text()
    assert "constexpr int kHeadDim = 64;" in fwd and "constexpr int kMaxKeys = 160;" in fwd


@pytest.mark.parametrize(
    "h,e,seq_len,expected",
    [(12, 768, 149, True), (12, 768, 160, True), (12, 768, 161, False), (4, 256, 77, True),
     (4, 768, 149, False), (12, 1152, 149, False)],
    ids=["dh64-149", "dh64-160", "dh64-161", "dh64-4heads", "dh192", "dh96"],
)
def test_f32_route_is_decided_by_the_arguments(h, e, seq_len, expected):
    """float32 K2 takes the 3xTF32 kernels at head width 64 and seq_len <=
    160 and its CUDA-core kernels elsewhere; the bf16 rule never takes it."""
    hidden = torch.zeros(1, seq_len, e, dtype=torch.float32)
    assert tf32x3_route(hidden, h, seq_len) is expected
    assert tensor_core_route(hidden, h, seq_len) is False


def _header(name):
    return (CSRC / name).read_text()


def test_f32_python_mirror_holds_the_header_constants():
    src = _header("wavlm_attn_bwd_tf32.cuh")
    found = {name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
             for name in ("kHeadDim", "kMaxKeys", "kRows", "kThreads", "kSlice")}
    assert found == {"kHeadDim": wavlm_attn._TC_HEAD_DIM, "kMaxKeys": wavlm_attn._TC_MAX_KEYS,
                     "kRows": wavlm_attn._TF32_BWD_ROWS, "kThreads": 128, "kSlice": 32}
    assert "constexpr int kRowBytes = 2 * 4 * kHeadDim;" in src
    assert 2 * 4 * wavlm_attn._TC_HEAD_DIM == wavlm_attn._TF32_BWD_ROW_BYTES
    assert "return kRowBytes * (2 * kRows + 2 * keys) + 4 * kRows + 1024;" in src
    assert "return kRowBytes * (2 * kRows + 2 * keys) + 3 * 4 * keys + 1024;" in src
    # K2's float32 source takes the new route at K1's float32 tensor-core rule.
    bwd = _header("wavlm_attn_bwd.cu")
    assert '#include "wavlm_attn_bwd_tf32.cuh"' in bwd
    assert "dh == emo::tf32b::kHeadDim && seq_len <= emo::tf32b::kMaxKeys" in bwd


def test_f32_attention_blocks_fit_in_shared_memory_at_160_keys():
    """Query side: Q and dctx of 64 queries, K and V of 160 keys, as hi and
    lo in 512-byte rows, the 64 row terms and 1 KB of alignment; key side:
    K and V of 64 keys, Q and dctx of 160 queries, their log-sum-exp, D and
    gate.  Both under the 227 KB a block may have, one block an SM."""
    query, key = backward_tf32_smem_bytes(160)
    assert query == 512 * (2 * 64 + 2 * 160) + 4 * 64 + 1024 == 230_656
    assert key == 512 * (2 * 64 + 2 * 160) + 3 * 4 * 160 + 1024 == 232_320
    assert max(query, key) <= MAX_SMEM
    assert backward_tf32_smem_bytes(149) == backward_tf32_smem_bytes(65)
    assert backward_tf32_smem_bytes(64) == (512 * 256 + 256 + 1024, 512 * 256 + 768 + 1024)
    with pytest.raises(ValueError):
        backward_tf32_smem_bytes(161)
