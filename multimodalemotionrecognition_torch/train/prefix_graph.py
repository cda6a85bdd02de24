"""The frozen WavLM prefix of a train step, replayed from CUDA graphs.

In two-stage training the freeze policy keeps the same front of WavLM
frozen in every stage (`freeze.py::wavlm_frozen_prefix`): the conv feature
extractor, the feature projection, the span-mask embedding, the positional
conv, the encoder's LayerNorm and encoder layers 0 .. n-1 (n = 10 for the
base model at stage 2, where layers 10 and 11 train).  Nothing there
records a gradient, the shapes are fixed and the weights constant, yet
dispatched op by op it costs the host about 370 kernel launches a step
while the card waits.  `PrefixGraphs` replays it instead: one graph for
the front end (`WavLMModel.front_end`) and one per frozen layer
(`WavLMEncoderLayer.compute`), so a layer LayerDrop skips is simply not
replayed.  Everything after the prefix, the backward and the optimizer stay
eager.

The work and its random draws are the eager step's, bit for bit:

  * The host draws stay in Python and run in the eager order before the
    replays: LayerDrop's `uniform("layerdrop")` for each layer above 0
    (`WavLMModel.layer_runs`) and, for each layer that runs, K1's dropout
    seed (`WavLMEncoderLayer.draw_seed`).  The seeds reach the card in one
    copy a step into a device tensor that K1 reads at run time
    (`seed_dev`); the host copies from a ring of pinned buffers, each
    reused only after the event of its last copy, since the host runs up to
    an epoch ahead of the card.
  * The device draws (the dropout masks of the front end and of the
    feed-forward blocks, the span masks) come from the "dropout" and
    "wavlm_mask" generators, each registered with the graphs that draw from
    it: a replay reads the generator's seed and offset and advances it as
    the eager ops would.  A capture draws nothing.
  * The hidden state passes through static buffers allocated outside the
    graphs' pool: the waveform is copied into the front end's input, every
    unit reads and writes one hidden buffer, and layer 0 also writes the
    position bias into a static buffer, which the eager layers after the
    prefix read.  The graphs share one private pool and are captured in
    layer order; a replay skips layers but never reorders them.

The first step that meets a (waveform shape, dtype, n) key runs its units
eagerly on those buffers, which warms every lazy set-up (cuBLAS, cuDNN,
K1's and K3's first launches); the second captures the units and replays
them at once, since a capture runs nothing.  Graphs are dropped when the
module is moved or cast (`WavLMModel._apply`), when a weight they read
lives elsewhere (a parameter replaced, or bf16 casts made anew), and when
the step's generators are other ones.  K1's and K3's launch counters count
in their operators, which a replay does not enter: a replayed unit adds the
launches its capture counted.

Host spans (`utils/profiling.py::span`): `wavlm.prefix_replay` around each
replayed unit, `wavlm.prefix_eager` around each unit run eagerly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from multimodalemotionrecognition_torch.kernels.conv_fe import fused_conv_layer
from multimodalemotionrecognition_torch.kernels.wavlm_attn import wavlm_attention_sublayer
from multimodalemotionrecognition_torch.utils.profiling import span

__all__ = ["PrefixGraphs", "engages", "graph_key"]

# The device streams each unit draws from: the front end's dropouts and
# span masks, a layer's feed-forward dropouts.
FRONT_STREAMS, LAYER_STREAMS = ("dropout", "wavlm_mask"), ("dropout",)
_COUNTERS = (wavlm_attention_sublayer, fused_conv_layer)
_RING = 4  # pinned host buffers of the steps' seeds, used in turn


def engages(device_type: str, train: bool, n_prefix: int, conv_frozen: bool,
            tensor_parallel: bool, k1_layers: int) -> bool:
    """Whether a forward replays its frozen prefix from CUDA graphs: on the
    card, in a train-mode forward, with n > 0 frozen layers behind a frozen
    conv feature extractor, no tensor parallelism, and K1 in every layer of
    the prefix (`k1_layers` is how many of the first layers take it)."""
    return (device_type == "cuda" and train and n_prefix > 0 and conv_frozen
            and not tensor_parallel and k1_layers >= n_prefix)


def graph_key(wav: torch.Tensor, n_prefix: int) -> Tuple:
    """The graphs' key: the waveform's shape and dtype, and n (a
    `grad_accum` microbatch has a shape of its own)."""
    return tuple(wav.shape), wav.dtype, n_prefix


def _prefix_modules(model, n_prefix: int) -> List[torch.nn.Module]:
    """Every module whose own parameters the prefix reads: the trunk itself
    (the span-mask embedding) and everything in the front end and layers
    0 .. n-1."""
    enc = model.encoder
    parts = (model.feature_extractor, model.feature_projection, enc.pos_conv_embed,
             enc.layer_norm, *enc.layers[:n_prefix])
    return [model, *(m for part in parts for m in part.modules())]


class _Units:
    """One key's static buffers, its graphs and their launch counts."""

    def __init__(self, model, wav: torch.Tensor, n_prefix: int):
        cfg = model.config
        device = wav.device
        b, t = wav.shape[0], model.frames(wav.shape[-1])
        self.wav = torch.empty_like(wav, memory_format=torch.contiguous_format)
        self.hidden = torch.empty(b, t, cfg.hidden_size, dtype=wav.dtype, device=device)
        self.bias = torch.empty(cfg.num_attention_heads, t, t, dtype=torch.float32, device=device)
        self.seeds = torch.zeros(n_prefix, dtype=torch.int32, device=device)
        self.warm = False
        self.graphs: Optional[List[torch.cuda.CUDAGraph]] = None
        self.launches: List[Tuple[int, ...]] = []

    def front(self, model, rng) -> None:
        self.hidden.copy_(model.front_end(self.wav, True, rng))

    def layer(self, model, rng, i: int) -> None:
        layer = model.encoder.layers[i]
        if i == 0:
            self.bias.copy_(layer.attention.relative_position_bias(self.bias.shape[-1],
                                                                   self.bias.device))
        out, _ = layer.compute(self.hidden, self.bias, True, rng, True,
                               seed_dev=self.seeds[i:i + 1])
        self.hidden.copy_(out)


class PrefixGraphs:
    """The CUDA graphs of one WavLM trunk's frozen prefix, by `graph_key`.
    The trainer makes one per model (n, conv frozen: `wavlm_frozen_prefix`)
    and sets it as `WavLMModel.prefix_graphs`; the model's train-mode forward
    asks `engages` and then calls `run`."""

    def __init__(self, n_prefix: int, conv_frozen: bool):
        self.n_prefix = int(n_prefix)
        self.conv_frozen = bool(conv_frozen)
        self._units: Dict[Tuple, _Units] = {}
        self._modules: Optional[List[torch.nn.Module]] = None
        self._weights: Optional[Tuple] = None
        self._streams: Optional[Tuple] = None
        self._pool = None
        self._capture_stream = None
        self._ring: List[torch.Tensor] = []
        self._ring_events: List[Optional[torch.cuda.Event]] = []
        self._ring_next = 0

    def drop(self) -> None:
        """Forget every graph and buffer, and what they were captured on (the
        module was moved or cast)."""
        self._forget()
        self._modules = self._weights = self._streams = None

    def _forget(self) -> None:
        self._units.clear()
        self._pool = None

    def engages(self, model, wav: torch.Tensor, k1_layers: int) -> bool:
        """`engages` for this model's train-mode forward on `wav`, and every
        weight of the prefix frozen.  Drops the graphs when a weight lives
        elsewhere than at their capture."""
        if not engages(wav.device.type, True, self.n_prefix, self.conv_frozen,
                       model.tensor_parallel, k1_layers):
            return False
        if self._modules is None:
            self._modules = _prefix_modules(model, self.n_prefix)
        # `_parameters`, not `parameters()`: what `functional_call` (the bf16
        # step) puts in place is found there, and it costs a few microseconds.
        weights = tuple(t for m in self._modules for t in m._parameters.values()
                        if t is not None)
        if any(w.requires_grad for w in weights):
            return False
        self.check_weights(weights)
        return True

    def check_weights(self, weights) -> None:
        """Drop the graphs when any of `weights` has moved since they were
        captured (a replaced parameter, new casts): a graph reads the
        storage it was captured on."""
        where = tuple(w.data_ptr() for w in weights)
        if where != self._weights:
            self._forget()
            self._weights = where

    def run(self, model, wav: torch.Tensor, rng) -> Tuple[torch.Tensor, torch.Tensor]:
        """The prefix of a train-mode forward of `model` on the waveform
        [B, T_samples]: the host draws, then each unit eagerly (the key's
        first step; always off the card), or captured and replayed.  Sets
        `model.layers_run` to the prefix's layers that ran.  -> (hidden
        [B, T, E], position bias [H, T, T]), the static buffers."""
        n = self.n_prefix
        runs, seeds = [], [0] * n  # a skipped layer's seed is never read
        for i in range(n):
            if model.layer_runs(i, True, rng):
                runs.append(i)
                seeds[i] = model.encoder.layers[i].draw_seed(rng, wav.shape[0]) or 0
        model.layers_run = list(runs)
        streams = tuple(rng.device(name) for name in FRONT_STREAMS)
        if streams != self._streams:
            self._forget()
            self._streams = streams
        key = graph_key(wav, n)
        units = self._units.get(key)
        if units is None:
            units = self._units[key] = _Units(model, wav, n)
        with torch.no_grad():
            self._copy_seeds(units.seeds, seeds)
            units.wav.copy_(wav)
            steps = [lambda: units.front(model, rng)]
            steps += [lambda i=i: units.layer(model, rng, i) for i in range(n)]
            order = [0] + [1 + i for i in runs]
            if wav.is_cuda and units.warm and units.graphs is None:
                layer_streams = [rng.device(name) for name in LAYER_STREAMS]
                self._capture(units, steps, [streams] + [layer_streams] * n)
            if units.graphs is None:
                for j in order:
                    with span("wavlm.prefix_eager"):
                        steps[j]()
                units.warm = True
            else:
                for j in order:
                    with span("wavlm.prefix_replay"):
                        units.graphs[j].replay()
                        for counter, launches in zip(_COUNTERS, units.launches[j]):
                            counter.launches += launches
        return units.hidden, units.bias

    def _copy_seeds(self, dst: torch.Tensor, seeds: List[int]) -> None:
        """The step's seeds into `dst` on the current stream: through a
        pinned buffer of the ring on the card, reused once its last copy ran."""
        host = torch.tensor(seeds, dtype=torch.int32)
        if not dst.is_cuda:
            dst.copy_(host)
            return
        if len(self._ring) != _RING or self._ring[0].numel() != len(seeds):
            self._ring = [torch.empty(len(seeds), dtype=torch.int32, pin_memory=True)
                          for _ in range(_RING)]
            self._ring_events = [None] * _RING
        k = self._ring_next
        self._ring_next = (k + 1) % _RING
        if self._ring_events[k] is not None:
            self._ring_events[k].synchronize()
        self._ring[k].copy_(host)
        dst.copy_(self._ring[k], non_blocking=True)
        event = self._ring_events[k] or torch.cuda.Event()
        event.record()
        self._ring_events[k] = event

    def _capture(self, units: _Units, steps, generators) -> None:
        """Capture each unit, in order, into the shared pool on a side stream,
        with the device generators it draws from registered.  A capture runs
        nothing and leaves every generator where it was; the launch counters
        are put back and each unit's count kept for its replays."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(units.hidden.device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream())
        graphs, launches = [], []
        with torch.cuda.stream(stream):
            for step, registered in zip(steps, generators):
                graph = torch.cuda.CUDAGraph()
                for generator in registered:
                    graph.register_generator_state(generator)
                before = [c.launches for c in _COUNTERS]
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    step()
                finally:
                    graph.capture_end()
                launches.append(tuple(c.launches - n for c, n in zip(_COUNTERS, before)))
                for c, n in zip(_COUNTERS, before):
                    c.launches = n
                graphs.append(graph)
        torch.cuda.current_stream().wait_stream(stream)
        units.graphs, units.launches = graphs, launches
