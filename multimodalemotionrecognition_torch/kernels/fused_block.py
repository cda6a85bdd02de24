"""K4: the whole cross-attention fusion block, a hand-written CUDA kernel.

Replaces the two TPU kernels of `multimodalemotionrecognition_tpu/ops/
pallas_fused_block.py` (`_block_kernel`, one sample per program, and
`_block_kernel_batched`, several), reached through `build_fused_block_fn`:
everything between the two towers and the logits,

    v  = v_feat @ W_vin                      [T, d]
    a  = (a_seq @ W_aseq) @ W_ain            [Ta, d]
    (optional emotion-prior additive biases)
    v' = LN(v + MHA(q=v, kv=a))
    a' = LN(a + MHA(q=a, kv=v'))             a2v sees the updated v
    v_emb, a_emb = pool(v'), pool(a')        mean or attention pooling
    logits = head(v_emb, a_emb)              concat MLP or gated

in float32 whatever the towers' dtype, eval mode.  int8 weight-only matrices
(`runtime/quant.py`) ride with their per-output-feature scales and are
dequantised inside the kernel.  The CUDA source and its design note are in
`csrc/fused_block.cu`; one kernel with `samples_per_block` stands for both
TPU kernels.

`extract_block_params` turns a `FusionModel` state dict into the kernel's
operands once (float32 or int8 (in, out) matrices, float32 vectors); do it
when the model is loaded, not per request.

For CPU tensors `fused_block` runs `fused_block_plain`; for CUDA tensors it
launches the kernel or raises.  `fused_block.launches` counts wrapper calls
that launched the kernel (two CUDA launches each).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch.nn import functional as F

from multimodalemotionrecognition_torch.kernels.xattn import (
    BIAS_NONE,
    BIAS_PRIOR,
    XattnParams,
    bidirectional_attention_plain,
    PointerTable,
    layer_norm_plain,
)

__all__ = [
    "FusedBlockParams",
    "FusedBlockSpec",
    "extract_block_params",
    "fused_block",
    "fused_block_plain",
]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_VIDEO_TOKENS = 16  # csrc/fusion.cuh::kMaxT
_MAX_SMEM = 227 * 1024


@dataclasses.dataclass(frozen=True)
class FusedBlockSpec:
    """Static configuration of the fused block."""

    num_heads: int
    d_model: int
    pooling: str  # "mean" | "attn"
    head: str  # "concat" | "gated"
    use_prior: bool
    num_classes: int


def _linear_table(spec: FusedBlockSpec) -> List[Tuple[str, str, str]]:
    """The block's linear layers: (weight operand, bias operand, module path)."""
    t = [
        ("vin_w", "vin_b", "v_in_proj"),
        ("aseq_w", "aseq_b", "audio_seq_proj"),
        ("ain_w", "ain_b", "a_in_proj"),
        ("v2a_out_w", "v2a_out_b", "v2a_attn.out_proj"),
        ("a2v_out_w", "a2v_out_b", "a2v_attn.out_proj"),
    ]
    if spec.use_prior:
        t += [
            ("ep_p0_w", "ep_p0_b", "emotion_prior_bias.prior_net.0"),
            ("ep_p3_w", "ep_p3_b", "emotion_prior_bias.prior_net.3"),
            ("ep_vq_w", "ep_vq_b", "emotion_prior_bias.v_query_bias"),
            ("ep_ak_w", "ep_ak_b", "emotion_prior_bias.a_key_bias"),
            ("ep_aq_w", "ep_aq_b", "emotion_prior_bias.a_query_bias"),
            ("ep_vk_w", "ep_vk_b", "emotion_prior_bias.v_key_bias"),
        ]
    if spec.pooling == "attn":
        for stream in ("v", "a"):
            mod = f"{stream}_temporal_pool.pool.score"
            t += [
                (f"{stream}p_w1", f"{stream}p_b1", f"{mod}.1"),
                (f"{stream}p_w2", f"{stream}p_b2", f"{mod}.4"),
            ]
    if spec.head == "concat":
        t += [("h_w1", "h_b1", "xattn_mlp.0"), ("h_w2", "h_b2", "xattn_mlp.3")]
    else:
        t += [
            ("g_w1", "g_b1", "xattn_gate.0"),
            ("g_w2", "g_b2", "xattn_gate.3"),
            ("c_w", "c_b", "xattn_classifier"),
        ]
    return t


@dataclasses.dataclass
class FusedBlockParams:
    """The kernel's parameter operands.  `matrices` are contiguous (in, out)
    float32 or int8; an int8 matrix has its float32 [out] scale in `scales`;
    `vectors` are contiguous float32."""

    matrices: Dict[str, torch.Tensor]
    scales: Dict[str, torch.Tensor]
    vectors: Dict[str, torch.Tensor]
    _table: Optional[PointerTable] = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        for name, w in self.matrices.items():
            if w.dtype not in (torch.float32, torch.int8) or (w.dtype == torch.int8) != (
                name in self.scales
            ):
                raise TypeError(f"{name}: need float32, or int8 with a scale; got {w.dtype}")

    def pointer_table(self) -> PointerTable:
        """The kernel's pointer table, made at the first launch."""
        if self._table is None:
            self._table = PointerTable(
                "fused_block", self.device, self.matrices, self.scales, self.vectors
            )
        return self._table

    def matrix(self, name: str) -> torch.Tensor:
        """The float32 (in, out) matrix, dequantised if it is int8."""
        w = self.matrices[name]
        return w.float() * self.scales[name] if name in self.scales else w

    @property
    def device(self) -> torch.device:
        return self.vectors["vn_s"].device

    def xattn(self) -> XattnParams:
        m, v = self.matrix, self.vectors
        return XattnParams(
            m("v2a_in_w"), v["v2a_in_b"], m("v2a_out_w"), v["v2a_out_b"],
            m("a2v_in_w"), v["a2v_in_b"], m("a2v_out_w"), v["a2v_out_b"],
            v["vn_s"], v["vn_b"], v["an_s"], v["an_b"],
        )


def extract_block_params(
    state_dict: Mapping[str, torch.Tensor], spec: FusedBlockSpec, device=None
) -> FusedBlockParams:
    """`FusionModel` state dict -> the kernel's operands on `device`.  A
    linear layer quantised by `runtime/quant.py` (entries `weight_q`, `scale`)
    stays int8; every other parameter becomes float32."""
    matrices: Dict[str, torch.Tensor] = {}
    scales: Dict[str, torch.Tensor] = {}
    vectors: Dict[str, torch.Tensor] = {}

    def f32(key):
        return state_dict[key].detach().to(device=device, dtype=torch.float32)

    for w_name, b_name, mod in _linear_table(spec):
        if f"{mod}.weight_q" in state_dict:
            q = state_dict[f"{mod}.weight_q"].detach().to(device=device)
            matrices[w_name] = q.t().contiguous()
            scales[w_name] = f32(f"{mod}.scale").contiguous()
        else:
            matrices[w_name] = f32(f"{mod}.weight").t().contiguous()
        vectors[b_name] = f32(f"{mod}.bias").contiguous()
    for name, mod in (("v2a_in", "v2a_attn"), ("a2v_in", "a2v_attn")):
        matrices[f"{name}_w"] = f32(f"{mod}.in_proj_weight").t().contiguous()
        vectors[f"{name}_b"] = f32(f"{mod}.in_proj_bias").contiguous()
    for name, mod in (("vn", "v_norm"), ("an", "a_norm")):
        vectors[f"{name}_s"] = f32(f"{mod}.weight").contiguous()
        vectors[f"{name}_b"] = f32(f"{mod}.bias").contiguous()
    if spec.use_prior:
        vectors["ep_scale"] = f32("emotion_prior_bias.bias_scale").reshape(1).contiguous()
    if spec.pooling == "attn":
        for stream in ("v", "a"):
            mod = f"{stream}_temporal_pool.pool.score.0"
            vectors[f"{stream}p_ln_s"] = f32(f"{mod}.weight").contiguous()
            vectors[f"{stream}p_ln_b"] = f32(f"{mod}.bias").contiguous()
    return FusedBlockParams(matrices, scales, vectors)


def _prior_bias_plain(v, a, p: FusedBlockParams):
    """EmotionPriorBiasAdapter: -> (v2a [B, T, Ta], a2v [B, Ta, T])."""
    d = v.shape[-1]
    pooled = torch.cat([v.mean(dim=1), a.mean(dim=1)], dim=-1)
    hidden = torch.relu(pooled @ p.matrix("ep_p0_w") + p.vectors["ep_p0_b"])
    prior = hidden @ p.matrix("ep_p3_w") + p.vectors["ep_p3_b"]  # [B, prior_dim]

    def scores(tokens, name):
        w = p.matrix(f"{name}_w")  # [d + prior_dim, 1]: token part, prior part
        const = prior @ w[d:] + p.vectors[f"{name}_b"]  # [B, 1]
        return (tokens @ w[:d])[..., 0] + const

    scale = p.vectors["ep_scale"]
    v2a = torch.tanh(scores(v, "ep_vq")[:, :, None] + scores(a, "ep_ak")[:, None, :]) * scale
    a2v = torch.tanh(scores(a, "ep_aq")[:, :, None] + scores(v, "ep_vk")[:, None, :]) * scale
    return v2a, a2v


def _attn_pool_plain(x, p: FusedBlockParams, stream: str):
    """TemporalAttentionPooling: LN -> Linear -> exact GELU -> Linear(., 1)
    -> softmax over time -> weighted sum."""
    v = p.vectors
    s = layer_norm_plain(x, v[f"{stream}p_ln_s"], v[f"{stream}p_ln_b"])
    s = F.gelu(s @ p.matrix(f"{stream}p_w1") + v[f"{stream}p_b1"])
    s = s @ p.matrix(f"{stream}p_w2") + v[f"{stream}p_b2"]  # [B, T, 1]
    return torch.sum(x * torch.softmax(s, dim=1), dim=1)


def fused_block_plain(
    v_feat: torch.Tensor, a_seq: torch.Tensor, params: FusedBlockParams, spec: FusedBlockSpec
) -> torch.Tensor:
    """Plain PyTorch version of K4: -> logits [B, C] float32."""
    p, vec = params, params.vectors
    v = v_feat.float() @ p.matrix("vin_w") + vec["vin_b"]
    a = (a_seq.float() @ p.matrix("aseq_w") + vec["aseq_b"]) @ p.matrix("ain_w") + vec["ain_b"]
    v2a_bias = a2v_bias = None
    if spec.use_prior:
        v2a_bias, a2v_bias = _prior_bias_plain(v, a, p)
    v_new, a_new = bidirectional_attention_plain(
        p.xattn(), v, a, v2a_bias, a2v_bias, spec.num_heads
    )
    if spec.pooling == "attn":
        v_emb, a_emb = _attn_pool_plain(v_new, p, "v"), _attn_pool_plain(a_new, p, "a")
    else:
        v_emb, a_emb = v_new.mean(dim=1), a_new.mean(dim=1)
    both = torch.cat([v_emb, a_emb], dim=1)
    if spec.head == "concat":
        hidden = torch.relu(both @ p.matrix("h_w1") + vec["h_b1"])
        return hidden @ p.matrix("h_w2") + vec["h_b2"]
    gate_hidden = torch.relu(both @ p.matrix("g_w1") + vec["g_b1"])
    g = torch.sigmoid(gate_hidden @ p.matrix("g_w2") + vec["g_b2"])
    return (g * v_emb + (1.0 - g) * a_emb) @ p.matrix("c_w") + vec["c_b"]


def _validate(v_feat, a_seq, params: FusedBlockParams, spec: FusedBlockSpec):
    if spec.pooling not in ("mean", "attn"):
        raise ValueError(f"pooling={spec.pooling!r}: the fused block takes 'mean' or 'attn'")
    if spec.head not in ("concat", "gated"):
        raise ValueError(f"head={spec.head!r}: the fused block takes 'concat' or 'gated'")
    if v_feat.ndim != 3 or a_seq.ndim != 3 or v_feat.shape[0] != a_seq.shape[0]:
        raise ValueError(
            f"v_feat must be [B, T, Dv] and a_seq [B, Ta, Ds], got "
            f"{tuple(v_feat.shape)} and {tuple(a_seq.shape)}"
        )
    if v_feat.dtype not in _DTYPES or a_seq.dtype != v_feat.dtype:
        raise TypeError(f"v_feat/a_seq dtypes {v_feat.dtype}/{a_seq.dtype}: need one of {_DTYPES}")
    if a_seq.device != v_feat.device or params.device != v_feat.device:
        raise ValueError(
            f"v_feat on {v_feat.device}, a_seq on {a_seq.device}, params on {params.device}"
        )
    d = spec.d_model
    if spec.num_heads < 1 or d % spec.num_heads != 0:
        raise ValueError(f"d_model={d} is not a multiple of num_heads={spec.num_heads}")
    want = {"vin_w": (v_feat.shape[2], d), "aseq_w": (a_seq.shape[2], d), "ain_w": (d, d)}
    for name, shape in want.items():
        if tuple(params.matrices[name].shape) != shape:
            raise ValueError(f"{name} shape {tuple(params.matrices[name].shape)} != {shape}")


def fused_block(
    v_feat: torch.Tensor,  # [B, T, Dv] per-frame video features
    a_seq: torch.Tensor,  # [B, Ta, Ds] audio sequence
    params: FusedBlockParams,
    spec: FusedBlockSpec,
    samples_per_block: int = 1,
) -> torch.Tensor:
    """-> logits [B, num_classes] float32.  `samples_per_block` is the number
    of samples one thread block of the per-sample kernel walks over."""
    _validate(v_feat, a_seq, params, spec)
    if samples_per_block < 1:
        raise ValueError(f"samples_per_block={samples_per_block} must be >= 1")
    device = v_feat.device
    if device.type == "cpu":
        return fused_block_plain(v_feat, a_seq, params, spec)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not (v_feat.is_contiguous() and a_seq.is_contiguous()):
        raise ValueError("v_feat and a_seq must be contiguous")
    b, t, dv = v_feat.shape
    ta, ds = a_seq.shape[1], a_seq.shape[2]
    d, c = spec.d_model, spec.num_classes
    m = params.matrices
    pool_hidden = m["ap_w1"].shape[1] if spec.pooling == "attn" else 0
    prior_hidden, prior_dim = tuple(m["ep_p3_w"].shape) if spec.use_prior else (0, 0)
    head_hidden = m["h_w1"].shape[1] if spec.head == "concat" else d
    if t > _MAX_VIDEO_TOKENS or spec.num_heads * t > d or t * dv > ta * d:
        raise ValueError(f"T={t}, Dv={dv}, Ta={ta}, d={d}: outside what the K4 kernel takes")
    # csrc/fused_block.cu::core_floats and the row-tile kernel's buffers.
    hid = -(-max(d, prior_hidden, head_hidden) // 4) * 4
    core = (2 * ta * d + 5 * t * d + ta * pool_hidden + 3 * d + hid + prior_dim
            + 2 * t + 2 * ta + max(t, ta) + 8)
    if 4 * max(core, 16 * (ds + 2 * d)) > _MAX_SMEM:
        raise ValueError(f"Ta={ta}, d={d}, Ds={ds} need more than {_MAX_SMEM} B of shared memory")

    scratch = torch.empty(4, b, ta, d, dtype=torch.float32, device=device)
    logits = torch.empty(b, c, dtype=torch.float32, device=device)
    entry = "emo_fused_block_f32" if v_feat.dtype == torch.float32 else "emo_fused_block_bf16"
    params.pointer_table().launch(
        entry,
        tensors={
            "v_in": v_feat, "a_in": a_seq, "a_tok": scratch[0], "ka": scratch[1],
            "va": scratch[2], "qa": scratch[3], "out": logits,
        },
        ints={
            "B": b, "T": t, "Ta": ta, "Dv": dv, "Ds": ds, "d": d, "H": spec.num_heads,
            "C": c, "pool_hidden": pool_hidden, "prior_dim": prior_dim,
            "prior_hidden": prior_hidden, "head_hidden": head_hidden,
            "pooling": int(spec.pooling == "attn"), "head": int(spec.head == "gated"),
            "bias_mode": BIAS_PRIOR if spec.use_prior else BIAS_NONE,
            "samples_per_block": samples_per_block,
        },
    )
    fused_block.launches += 1
    return logits


fused_block.launches = 0
