"""Multi-head attention with torch `nn.MultiheadAttention` parameters.

Counterpart of the JAX package's `ops/attention.py`.  The parameters are
those of `nn.MultiheadAttention` (packed `in_proj_weight` / `in_proj_bias`,
`out_proj`), so reference checkpoints load as they are; the math is written
out (matmul, float32 softmax) instead of calling `nn.MultiheadAttention`,
whose fused fast path would hide it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["TorchMultiHeadAttention"]


class TorchMultiHeadAttention(nn.Module):
    """batch_first MHA.  `bias` is an additive float attention bias of shape
    [B, L, S] or [B, H, L, S], added to the scaled scores like torch's
    float attn_mask."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(
                f"embed_dim={embed_dim} not divisible by num_heads={num_heads}"
            )
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        e, h = self.embed_dim, self.num_heads
        dh = e // h
        b, lq, lk = query.shape[0], query.shape[1], key.shape[1]
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = nn.functional.linear(query, wq, bq)
        k = nn.functional.linear(key, wk, bk)
        v = nn.functional.linear(value, wv, bv)
        q = q.view(b, lq, h, dh).transpose(1, 2) * (dh**-0.5)
        k = k.view(b, lk, h, dh).transpose(1, 2)
        v = v.view(b, lk, h, dh).transpose(1, 2)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if bias is not None:
            if bias.ndim == 3:
                bias = bias[:, None]
            scores = scores + bias.float()
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, lq, e)
        return self.out_proj(out)
