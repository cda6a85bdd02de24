"""WavLM-base speech encoder, eval and train forward.

Counterpart of the JAX package's `models/wavlm.py` (HF `WavLMModel`): a
7-layer conv feature extractor (GroupNorm on the first layer), feature
projection, a weight-normed positional conv (merged into a plain weight at
load), and post-norm transformer layers with WavLM's gated relative
position bias.  Module paths are the HF/reference state-dict keys.

Hand-written kernels sit on this path, chosen by
`WavLMConfig.fused_attention` / `fused_conv` ("auto": when the activations
are on CUDA):

  * K1 `kernels/wavlm_attn.py` runs each encoder layer's attention sublayer
    after the q/k/v projections (scores + gated bias, softmax, context,
    out-projection, residual, post-LayerNorm); when serving, its constant
    operands are made once by `cache_kernel_operands` (from an int8
    out-projection too);
  * K2, its backward, through the same wrapper's `autograd.Function`;
  * K3 `kernels/conv_fe.py` runs conv layers L1..L6 with their GELU; its
    weights (with, in float32 on the card, their TF32 split) are made once
    by `cache_kernel_operands` when serving, else per forward.

Training (`forward(..., train=True, rng=RngStreams)`): the feature
projection, encoder, activation and hidden dropouts, span masking with the
learned `masked_spec_embed`, and batch-level LayerDrop (one host draw per
layer above 0 per step; a dropped layer is skipped outright, which is the
same function as computing it and keeping the input).  The first
`fused_train_layers` layers take K1 with its two in-kernel dropouts, seeded
per layer call from the host side of the "dropout" stream; K3 runs only
when `fused_train_conv` says the feature extractor is frozen.  A layer's
host draws (`WavLMModel.layer_runs`, `WavLMEncoderLayer.draw_seed`) are
apart from its device work (`WavLMEncoderLayer.compute`), so that the
trainer's `train/prefix_graph.py` can replay the frozen front end and
layers from CUDA graphs (`WavLMModel.prefix_graphs`) after the same draws.

Tensor parallelism (`parallel/tensor.py::shard_module_`): each encoder
layer's q/k/v and FFN up-projection become column-parallel pieces and its
out-projection and FFN down-projection row-parallel ones over a mesh row.
Each piece holds H / tp whole heads: the gate is computed for every head
on the row's first device and each piece takes its heads' rows of it and
of the layer-0 relative-position bias; the row-parallel sums add their
bias once, and the residuals, LayerNorms and the hidden dropout run after
the sum there.  The attention-probability and activation dropouts are
drawn at full width and sliced (`dropout_pieces`), so every draw of a
train step is the one-device draw.  Where the heads do not split (E
divides by tp, H does not) the pieces' q/k/v are joined on the first
device and each piece gets its context columns back.  K1 fuses the
out-projection and the LayerNorm over every head, so under tensor
parallelism `fused_attention="auto"` takes the modular sublayer and True
raises; K3 runs as before, its layers replicated.

L0 (k=10, stride 5, one input channel) and its GroupNorm stay `F.conv1d`
plus float32 statistics, as they were plain XLA in the JAX package.  The
JAX package's TPU workarounds are not carried over: the kernels take
logical lengths, so the waveform is not padded to a multiple of the stride
product and the sequence is not padded 149 -> 160.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from multimodalemotionrecognition_torch.config import WavLMConfig
from multimodalemotionrecognition_torch.kernels.conv_fe import (
    fused_conv_layer,
    split_weight_tf32,
    tf32x3_route,
)
from multimodalemotionrecognition_torch.kernels.wavlm_attn import (
    shifted_dropout_seed,
    wavlm_attention_sublayer,
)
from multimodalemotionrecognition_torch.models.temporal import TemporalPooler, check_head
from multimodalemotionrecognition_torch.ops.stochastic import (
    RngStreams,
    draw_rows,
    dropout,
    dropout_pieces,
    row_offset,
)
from multimodalemotionrecognition_torch.parallel.tensor import ColumnParallelLinear

__all__ = ["WavLMAudioEncoder", "WavLMAttentionSelf", "WavLMEncoderLayer", "WavLMModel"]


def _relative_position_buckets(
    query_length: int, key_length: int, num_buckets: int, max_distance: int
) -> np.ndarray:
    """T5-style bidirectional relative position bucketing
    (HF `WavLMAttention._relative_positions_bucket`)."""
    context = np.arange(query_length)[:, None]
    memory = np.arange(key_length)[None, :]
    relative = memory - context

    nb = num_buckets // 2
    buckets = (relative > 0).astype(np.int64) * nb
    rel_abs = np.abs(relative)

    max_exact = nb // 2
    is_small = rel_abs < max_exact
    with np.errstate(divide="ignore"):
        rel_large = np.log(np.maximum(rel_abs, 1).astype(np.float64) / max_exact)
    rel_large = rel_large / math.log(max_distance / max_exact)
    rel_large = (max_exact + rel_large * (nb - max_exact)).astype(np.int64)
    rel_large = np.minimum(rel_large, nb - 1)

    buckets += np.where(is_small, rel_abs, rel_large)
    return buckets


def _use_kernel(flag, x: torch.Tensor) -> bool:
    """"auto" -> the kernel path when x is on CUDA; True/False force it."""
    if flag == "auto":
        return x.is_cuda
    return bool(flag)


def _attention_kernel(flag, x: torch.Tensor, tensor_parallel: bool) -> bool:
    """`_use_kernel` for K1.  K1 needs every head of a layer and the whole
    out-projection on one device: under tensor parallelism "auto" takes the
    modular sublayer and True raises (nothing reroutes quietly)."""
    if tensor_parallel:
        if flag != "auto" and flag:
            raise ValueError("fused_attention=True under tensor parallelism: the attention "
                             "kernel (K1) needs every head of a layer on one device")
        return False
    return _use_kernel(flag, x)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, T, h * dh] -> [B, h, T, dh]."""
    b, t, c = x.shape
    return x.view(b, t, h, c // h).transpose(1, 2)


def _probs(q, k, gate, position_bias, h: int) -> torch.Tensor:
    """The attention probabilities [B, h, T, T] in float32 of the h heads
    of q (scaled) and k [B, T, h * dh], with the gated relative-position
    bias (gate [B, h, T, 1], position_bias [h, T, T])."""
    scores = torch.matmul(_heads(q, h).float(), _heads(k, h).float().transpose(-1, -2))
    scores = scores + (gate * position_bias[None].to(gate.dtype)).float()
    return torch.softmax(scores, dim=-1)


def _context(attn, v, h: int) -> torch.Tensor:
    """P . V of the h heads, back to [B, T, h * dh]."""
    b, _, t, _ = attn.shape
    return torch.matmul(attn, _heads(v, h)).transpose(1, 2).reshape(b, t, -1)


class WavLMAttentionSelf(nn.Module):
    """WavLM self-attention with gated relative position bias."""

    def __init__(self, config: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        e, h = config.hidden_size, config.num_attention_heads
        self.config = config
        self.num_heads = h
        self.q_proj = nn.Linear(e, e)
        self.k_proj = nn.Linear(e, e)
        self.v_proj = nn.Linear(e, e)
        self.out_proj = nn.Linear(e, e)
        self.gru_rel_pos_linear = nn.Linear(e // h, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
        if has_relative_position_bias:
            self.rel_attn_embed = nn.Embedding(config.num_buckets, h)
        self._bucket_tables = {}

    def bucket_table(self, t: int, device) -> torch.Tensor:
        """The [T, T] bucket indices on `device`, made once per (T, device):
        a host-to-device copy on every forward would be a launch more, and
        no CUDA graph can hold a copy from pageable memory.  Under
        `torch.export` the table is made and not kept (a graph constant)."""
        key = (t, torch.device(device))
        table = self._bucket_tables.get(key)
        if table is None:
            cfg = self.config
            buckets = _relative_position_buckets(t, t, cfg.num_buckets, cfg.max_bucket_distance)
            table = torch.from_numpy(buckets).to(device)
            if not torch.compiler.is_compiling():
                self._bucket_tables[key] = table
        return table

    def relative_position_bias(self, t: int, device) -> torch.Tensor:
        """[H, T, T] bucketed relative bias (layer 0 owns the embedding)."""
        if not hasattr(self, "rel_attn_embed"):
            raise ValueError("First layer must compute the position bias.")
        values = self.rel_attn_embed(self.bucket_table(t, device))  # [T, T, H]
        return values.permute(2, 0, 1)

    @property
    def tensor_parallel(self) -> bool:
        """Whether `shard_module_` split this layer's heads over a mesh row."""
        return isinstance(self.q_proj, ColumnParallelLinear)

    def gate(self, hidden: torch.Tensor) -> torch.Tensor:
        """The gate [B, H, T, 1] of every head (HF WavLMAttention: a per-head
        scalar per query position computed from the raw layer input)."""
        b, t, e = hidden.shape
        h = self.num_heads
        proj = self.gru_rel_pos_linear(hidden.view(b, t, h, e // h).transpose(1, 2))
        gates = torch.sigmoid(proj.view(b, h, t, 2, 4).sum(-1))
        gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
        return gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0

    def projections(self, hidden: torch.Tensor):
        """-> (q * dh^-0.5, k, v) in [B, T, E] and the gate [B, H, T, 1]."""
        dh = hidden.shape[-1] // self.num_heads
        q = self.q_proj(hidden) * (dh**-0.5)
        return q, self.k_proj(hidden), self.v_proj(hidden), self.gate(hidden)

    def forward(
        self, hidden: torch.Tensor, position_bias: torch.Tensor,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Modular path: -> attention output [B, T, E] (before the residual),
        on `hidden`'s device.  A generator turns the attention-probability
        dropout on (training)."""
        if self.tensor_parallel:
            return self._forward_pieces(hidden, position_bias, dropout_generator)
        h = self.num_heads
        q, k, v, gate = self.projections(hidden)
        attn = _probs(q, k, gate, position_bias, h).to(v.dtype)
        if dropout_generator is not None:
            attn = dropout(attn, self.config.attention_dropout, dropout_generator)
        return self.out_proj(_context(attn, v, h))

    def _forward_pieces(self, hidden, position_bias, gen):
        """`forward` with the heads split over a mesh row: piece i attends
        with heads [i H/tp, (i+1) H/tp) on its device; the row-parallel
        out-projection sums the pieces on `hidden`'s device."""
        e, h = hidden.shape[-1], self.num_heads
        devices = self.q_proj.devices
        tp = len(devices)
        gate = self.gate(hidden)
        xs = [hidden.to(d) for d in devices]
        qs = [q * ((e // h) ** -0.5) for q in self.q_proj(xs)]
        ks, vs = self.k_proj(xs), self.v_proj(xs)
        rate = self.config.attention_dropout
        if h % tp:
            # Heads straddle the pieces: attend on the first device, then
            # give each piece its columns of the context.
            q, k, v = (torch.cat([p.to(hidden.device) for p in parts], dim=-1)
                       for parts in (qs, ks, vs))
            attn = _probs(q, k, gate, position_bias, h).to(v.dtype)
            if gen is not None:
                attn = dropout(attn, rate, gen)
            ctx = _context(attn, v, h)
            width = e // tp
            return self.out_proj([ctx[..., i * width:(i + 1) * width].to(d)
                                  for i, d in enumerate(devices)])
        local = h // tp
        attns = []
        for i, (q, k, v, device) in enumerate(zip(qs, ks, vs, devices)):
            heads = slice(i * local, (i + 1) * local)
            attns.append(_probs(q, k, gate[:, heads].to(device),
                                position_bias[heads].to(device), local).to(v.dtype))
        attns = dropout_pieces(attns, 1, rate, gen)
        return self.out_proj([_context(a, v, local) for a, v in zip(attns, vs)])


class _FeedForward(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.config = config
        self.intermediate_dense = nn.Linear(config.hidden_size, config.intermediate_size)
        self.output_dense = nn.Linear(config.intermediate_size, config.hidden_size)

    def forward(
        self, x: torch.Tensor, dropout_generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        up = self.intermediate_dense
        if isinstance(up, ColumnParallelLinear):
            # Tensor parallel: each piece's columns of the activation; the
            # activation dropout drawn at full width and sliced.
            x = [F.gelu(h) for h in up([x.to(d) for d in up.devices])]
            x = dropout_pieces(x, -1, self.config.activation_dropout, dropout_generator)
        else:
            x = F.gelu(up(x))
            if dropout_generator is not None:
                x = dropout(x, self.config.activation_dropout, dropout_generator)
        if dropout_generator is None:
            return self.output_dense(x)
        return dropout(self.output_dense(x), self.config.hidden_dropout, dropout_generator)


class WavLMEncoderLayer(nn.Module):
    """Post-norm transformer layer (HF WavLMEncoderLayer, base variant)."""

    def __init__(self, config: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        e = config.hidden_size
        self.config = config
        self.attention = WavLMAttentionSelf(config, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(e, eps=config.layer_norm_eps)
        self.feed_forward = _FeedForward(config)
        self.final_layer_norm = nn.LayerNorm(e, eps=config.layer_norm_eps)
        self._k1_operands = None

    def _make_k1_operands(self):
        """K1's constant operands: the out-projection as the (in, out)
        matrix in the compute dtype (dequantised when the layer is int8),
        and b_o, LayerNorm scale and bias as float32 [1, E]."""
        e = self.layer_norm.weight.shape[0]
        out_proj = self.attention.out_proj
        return (
            out_proj.weight.t().to(self.layer_norm.weight.dtype).contiguous(),
            out_proj.bias.float().view(1, e),
            self.layer_norm.weight.float().view(1, e),
            self.layer_norm.bias.float().view(1, e),
        )

    def cache_kernel_operands(self) -> None:
        """Make K1's constant operands once, after the weights are loaded
        and cast, instead of on every forward: for serving, where the
        weights no longer change.  Moving or casting the module afterwards
        drops the cache; a train-mode forward, or one that records a
        gradient for these weights, never reads it.  Under tensor
        parallelism K1 does not run and nothing is made."""
        if self.attention.tensor_parallel:
            return
        with torch.no_grad():
            self._k1_operands = self._make_k1_operands()

    def _apply(self, fn, recurse=True):
        self._k1_operands = None  # made for one device and dtype
        return super()._apply(fn, recurse)

    def _k1_operands_for(self, train: bool):
        """The cached operands when they cannot be stale: not in a train-mode
        forward and not while autograd records these weights."""
        weights = (self.attention.out_proj.weight, self.attention.out_proj.bias,
                   self.layer_norm.weight, self.layer_norm.bias)
        live = train or (torch.is_grad_enabled() and any(w.requires_grad for w in weights))
        if live or self._k1_operands is None:
            return self._make_k1_operands()
        return self._k1_operands

    def forward(
        self,
        hidden: torch.Tensor,
        position_bias: Optional[torch.Tensor],
        train: bool = False,
        rng: Optional[RngStreams] = None,
        fused: Optional[bool] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`fused` None: by `config.fused_attention` (standalone use; the
        model passes it explicitly).  `train` needs `rng`.  The layer's host
        draws (`draw_seed`), then its device work (`compute`)."""
        cfg = self.config
        if train and rng is None:
            raise ValueError("a train-mode forward needs rng (RngStreams)")
        fused = _attention_kernel(cfg.fused_attention if fused is None else fused, hidden,
                                  self.attention.tensor_parallel)
        seed = self.draw_seed(rng, hidden.shape[0]) if fused and train else None
        return self.compute(hidden, position_bias, train, rng, fused, seed)

    def draw_seed(self, rng: RngStreams, rows: int) -> Optional[int]:
        """A train-mode layer's host draw on K1's route: one dropout seed for
        the step from the host side of the "dropout" stream, shifted to the
        global batch's row of this rank's first (`rows` rows a rank); None,
        and nothing drawn, when both of K1's rates are 0."""
        cfg = self.config
        if cfg.attention_dropout > 0.0 or cfg.hidden_dropout > 0.0:
            return shifted_dropout_seed(rng.kernel_seed("dropout"), row_offset(rows))
        return None

    def compute(
        self,
        hidden: torch.Tensor,
        position_bias: Optional[torch.Tensor],
        train: bool,
        rng: Optional[RngStreams],
        fused: bool,
        seed: Optional[int] = None,
        seed_dev: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layer's device work once its host draws are made: on K1's
        route (`fused`) the kernel's dropouts take `seed`, or the int32 that
        `seed_dev` ([1], on the device) holds when the kernel runs; the
        modular path and the feed-forward draw from the device side of the
        "dropout" stream.  -> (output, the position bias, made here when
        None: layer 0)."""
        cfg = self.config
        b, t, e = hidden.shape
        gen = rng.device("dropout") if train else None
        if position_bias is None:
            position_bias = self.attention.relative_position_bias(t, hidden.device)
        if fused:
            attn = self.attention
            q, k, v, gate = attn.projections(hidden)
            h = attn.num_heads
            # Training: the modular sublayer's two dropout sites (attention
            # probabilities, projected output) run inside the kernel.
            attn_p = cfg.attention_dropout if train else 0.0
            hid_p = cfg.hidden_dropout if train else 0.0
            hidden = wavlm_attention_sublayer(
                hidden, q, k, v,
                gate.float().reshape(b, h * t, 1),
                position_bias.float().reshape(h * t, t),
                *self._k1_operands_for(train),
                num_heads=h,
                seq_len=t,
                eps=cfg.layer_norm_eps,
                attn_dropout=attn_p,
                hidden_dropout=hid_p,
                dropout_seed=seed,
                seed_dev=seed_dev,
            )
        else:
            attn_out = self.attention(hidden, position_bias, gen)
            if train:
                attn_out = dropout(attn_out, cfg.hidden_dropout, gen)
            hidden = self.layer_norm(hidden + attn_out)
        hidden = self.final_layer_norm(hidden + self.feed_forward(hidden, gen))
        return hidden, position_bias


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int, group_norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride, bias=False)
        if group_norm:
            self.layer_norm = nn.GroupNorm(cout, cout, eps=1e-5)


class _FeatureExtractor(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        dims = (1,) + tuple(config.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, group_norm=(i == 0))
            for i, (k, s) in enumerate(zip(config.conv_kernel, config.conv_stride))
        )


class _FeatureProjection(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(config.conv_dim[-1], eps=config.layer_norm_eps)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size)


class _PosConvEmbed(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        k = config.num_conv_pos_embeddings
        self.conv = nn.Conv1d(
            config.hidden_size, config.hidden_size, k, padding=k // 2,
            groups=config.num_conv_pos_embedding_groups,
        )


class _Encoder(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = _PosConvEmbed(config)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(
            WavLMEncoderLayer(config, has_relative_position_bias=(i == 0))
            for i in range(config.num_hidden_layers)
        )


def _rows_multiple_of(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Contiguous [B, T', C] with T' the next multiple of `multiple`, so the
    stride-reshaped view exists.  Rows past T stay unset: K3 is given the
    logical length and never reads them."""
    b, t, c = x.shape
    rows = -(-t // multiple) * multiple
    if rows == t and x.is_contiguous():
        return x
    out = x.new_empty(b, rows, c)
    out[:, :t] = x
    return out


class WavLMModel(nn.Module):
    """HF WavLMModel equivalent: waveform [B, T_samples] -> hidden [B, T, E]."""

    def __init__(self, config: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.config = config
        self.feature_extractor = _FeatureExtractor(config)
        self.feature_projection = _FeatureProjection(config)
        self.masked_spec_embed = nn.Parameter(torch.empty(config.hidden_size))
        self.encoder = _Encoder(config)
        self.layers_run: list = []  # indices of the layers the last forward ran (LayerDrop)
        self._k3_operands = None
        # Set by the trainer (`train/prefix_graph.py::PrefixGraphs`): replays
        # the frozen front end and first layers of a train-mode forward.
        self.prefix_graphs = None

    def _make_k3_operands(self):
        """K3's weights for L1..L6, per layer (w_flat, w_split): the tap-major
        [k*cin, cout] matrix and, on the card where the float32 kernel takes
        it (`tf32x3_route`), its K-major TF32 split; else None."""
        out = []
        for layer, k in zip(self.feature_extractor.conv_layers[1:], self.config.conv_kernel[1:]):
            w = layer.conv.weight  # [cout, cin, k] -> tap-major [k*cin, cout]
            cin = w.shape[1]
            w_flat = w.permute(2, 1, 0).reshape(k * cin, w.shape[0])
            # The activations share the weight's dtype, which is all the route reads of them.
            split = (split_weight_tf32(w_flat)
                     if w.is_cuda and tf32x3_route(w_flat, w_flat, k, cin, False) else None)
            out.append((w_flat, split))
        return out

    def _k3_operands_for(self, train: bool):
        """The cached operands when they cannot be stale (as
        `WavLMEncoderLayer._k1_operands_for`), else made for this forward."""
        weights = [layer.conv.weight for layer in self.feature_extractor.conv_layers[1:]]
        live = train or (torch.is_grad_enabled() and any(w.requires_grad for w in weights))
        if live or self._k3_operands is None:
            return self._make_k3_operands()
        return self._k3_operands

    def _apply(self, fn, recurse=True):
        self._k3_operands = None  # made for one device and dtype
        if self.prefix_graphs is not None:
            self.prefix_graphs.drop()  # captured on one device's weights
        return super()._apply(fn, recurse)

    @property
    def tensor_parallel(self) -> bool:
        return any(layer.attention.tensor_parallel for layer in self.encoder.layers)

    def frames(self, samples: int) -> int:
        """The frames the conv feature extractor makes of `samples` samples."""
        for k, s in zip(self.config.conv_kernel, self.config.conv_stride):
            samples = (samples - k) // s + 1
        return samples

    def _conv_features(self, wav: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, T_samples] -> conv features [B, T, C] (NWC).  In a train-mode
        forward K3 runs only on a feature extractor declared frozen
        (`fused_train_conv`): it has no backward."""
        cfg = self.config
        layers = self.feature_extractor.conv_layers
        l0 = layers[0]
        x = F.conv1d(wav[:, None, :], l0.conv.weight, stride=cfg.conv_stride[0])
        # GroupNorm(groups=channels): per-channel statistics over time in
        # float32 (bf16 sums drift over ~10k steps), then the exact GELU.
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        xf = (xf - mean) * torch.rsqrt(var + 1e-5)
        xf = xf * l0.layer_norm.weight.float()[:, None] + l0.layer_norm.bias.float()[:, None]
        x = F.gelu(xf).to(wav.dtype)

        if (train and not cfg.fused_train_conv) or not _use_kernel(cfg.fused_conv, x):
            for layer, s in zip(layers[1:], cfg.conv_stride[1:]):
                x = F.gelu(F.conv1d(x, layer.conv.weight, stride=s))
            return x.transpose(1, 2)

        x = x.transpose(1, 2)  # NWC [B, T, C]
        b, t_log = x.shape[0], x.shape[1]
        operands = self._k3_operands_for(train)
        for (w_flat, w_split), k, s in zip(operands, cfg.conv_kernel[1:], cfg.conv_stride[1:]):
            cin = x.shape[2]
            x = _rows_multiple_of(x, s)
            x = fused_conv_layer(
                x.view(b, x.shape[1] // s, s * cin), w_flat, k=k, stride=s,
                cin=cin, gelu_output=True, t_in=t_log, w_split=w_split,
            )
            t_log = (t_log - k) // s + 1
        return x[:, :t_log]

    def cache_kernel_operands(self) -> None:
        """K3's weights, then each layer's K1 operands (see
        `WavLMEncoderLayer.cache_kernel_operands`), made once for serving."""
        with torch.no_grad():
            self._k3_operands = self._make_k3_operands()
        for layer in self.encoder.layers:
            layer.cache_kernel_operands()

    def _mask_time(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """SpecAugment-style span masking along time (behavioural equivalent
        of HF `_compute_mask_indices`): ~mask_time_prob of the positions
        start a span of mask_time_length frames, written over with the
        learned mask embedding."""
        cfg = self.config
        b, t, _ = x.shape
        starts = draw_rows(
            lambda s: torch.rand(s, generator=generator, device=x.device), (b, t)
        ) < cfg.mask_time_prob
        window = cfg.mask_time_length
        # Dilate the starts into spans: a max-pool over the window ending at each frame.
        mask = F.max_pool1d(F.pad(starts.float()[:, None], (window - 1, 0)), window, stride=1)
        return torch.where(mask[:, 0, :, None] > 0, self.masked_spec_embed.to(x.dtype), x)

    def front_end(
        self, input_values: torch.Tensor, train: bool = False,
        rng: Optional[RngStreams] = None,
    ) -> torch.Tensor:
        """Waveform [B, T_samples] -> the first encoder layer's input [B, T, E]:
        conv features, feature projection, positional conv and LayerNorm;
        in training with the projection's and the encoder's dropouts and the
        span masking, all drawn on the device."""
        cfg = self.config
        gen = rng.device("dropout") if train else None
        x = self._conv_features(input_values, train)
        x = self.feature_projection.projection(self.feature_projection.layer_norm(x))
        if train:
            x = dropout(x, cfg.feat_proj_dropout, gen)
            if cfg.apply_spec_augment:
                x = self._mask_time(x, rng.device("wavlm_mask"))

        conv = self.encoder.pos_conv_embed.conv
        pos = conv(x.transpose(1, 2))
        if cfg.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :, :-1]
        x = x + F.gelu(pos).transpose(1, 2)
        x = self.encoder.layer_norm(x)
        if train:
            x = dropout(x, cfg.hidden_dropout, gen)
        return x

    def layer_runs(self, i: int, train: bool, rng: Optional[RngStreams]) -> bool:
        """Batch-level LayerDrop (HF WavLMEncoder.forward): one host draw per
        layer above 0 per train step; layer 0 always runs (it owns the
        position bias)."""
        p = self.config.layerdrop
        return not (train and i > 0 and p > 0.0 and rng.uniform("layerdrop") < p)

    def forward(
        self, input_values: torch.Tensor, train: bool = False,
        rng: Optional[RngStreams] = None,
    ) -> torch.Tensor:
        cfg = self.config
        if train and rng is None:
            raise ValueError("a train-mode forward needs rng (RngStreams)")
        # Eval takes the attention kernel in every layer; training in the
        # first `fused_train_layers` (the trainer sets the whole stack).
        n_layers = len(self.encoder.layers)
        n_fused = 0
        if _attention_kernel(cfg.fused_attention, input_values, self.tensor_parallel):
            n_fused = min(max(0, cfg.fused_train_layers), n_layers) if train else n_layers
        graphs = self.prefix_graphs
        if train and graphs is not None and graphs.engages(self, input_values, n_fused):
            # The frozen front end and layers 0..n-1 (sets `layers_run`).
            x, position_bias = graphs.run(self, input_values, rng)
            start = graphs.n_prefix
        else:
            x, position_bias, start = self.front_end(input_values, train, rng), None, 0
            self.layers_run = []
        for i in range(start, n_layers):
            if not self.layer_runs(i, train, rng):
                continue
            x, position_bias = self.encoder.layers[i](x, position_bias, train, rng,
                                                      fused=i < n_fused)
            self.layers_run.append(i)
        return x


class WavLMAudioEncoder(nn.Module):
    """Reference `WavLMAudioEncoder` (`src/models/wavlm_audio.py:13-183`):
    WavLM backbone + TemporalPooler + MLP head (hidden -> hidden -> ReLU ->
    Dropout 0.2 -> num_classes, keys `classifier.{0,3}`; the reference's
    embedding is the hidden size, `wavlm_audio.py:50`).
    `head` says how much is declared, as the JAX module creates only what a
    fusion mode calls: "none" the backbone alone (the cross-attention modes
    tap `encode_sequence`), "pool" with the temporal pooler (concat and gated
    read `encode`), "full" with the MLP head too (audio, late)."""

    def __init__(
        self, wavlm_config: WavLMConfig = WavLMConfig(), num_classes: int = 8,
        temporal_pooling: str = "mean", temporal_num_heads: int = 4,
        temporal_num_layers: int = 1, temporal_dropout: float = 0.1, head: str = "none",
    ):
        super().__init__()
        check_head(head)
        self.wavlm = WavLMModel(wavlm_config)
        hidden = self.embedding_dim = wavlm_config.hidden_size
        if head != "none":
            self.temporal_pool = TemporalPooler(
                hidden, temporal_pooling, temporal_dropout,
                num_heads=temporal_num_heads, num_layers=temporal_num_layers,
            )
        if head == "full":
            self.classifier = nn.Sequential(
                nn.Linear(hidden, hidden), nn.ReLU(), nn.Dropout(0.2),
                nn.Linear(hidden, num_classes),
            )

    @property
    def sequence_dim(self) -> int:
        return self.wavlm.config.hidden_size

    def encode_sequence(
        self, x: torch.Tensor, train: bool = False, rng: Optional[RngStreams] = None
    ) -> torch.Tensor:
        """Raw waveform [B, 1, T] or [B, T] -> hidden states [B, T', E]."""
        if x.ndim == 3:
            x = x[:, 0, :]
        return self.wavlm(x, train, rng)

    def _pooled(self, x, train, rng):
        gen = rng.device("dropout") if train and rng is not None else None
        return self.temporal_pool(self.encode_sequence(x, train, rng), gen), gen

    def encode(
        self, x: torch.Tensor, train: bool = False, rng: Optional[RngStreams] = None
    ) -> torch.Tensor:
        return self._pooled(x, train, rng)[0]

    def forward(
        self, x: torch.Tensor, train: bool = False, rng: Optional[RngStreams] = None
    ) -> torch.Tensor:
        emb, gen = self._pooled(x, train, rng)
        h = torch.relu(self.classifier[0](emb))
        if gen is not None:
            h = dropout(h, 0.2, gen)
        return self.classifier[3](h)
