"""K2's route and its tensor-core attention block's shared-memory plan, on
the CPU: both follow from the arguments alone, as K3's route does
(`tests/test_torch_conv_plan.py`), and the Python mirror holds the CUDA
header's constants."""

import re
from pathlib import Path

import pytest
import torch

from multimodalemotionrecognition_torch.kernels import wavlm_attn
from multimodalemotionrecognition_torch.kernels.wavlm_attn import (
    backward_attention_smem_bytes,
    tensor_core_route,
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
