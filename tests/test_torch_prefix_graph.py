"""The frozen WavLM prefix of a train step (`train/prefix_graph.py`), on the CPU.

The graphs themselves are captured and replayed only on the card
(`tests/test_torch_cuda.py`).  Here: the split forward that the graphs
replay (each layer's host draws first, then its device work on static
buffers, K1's seed read from a tensor) against the model's own forward, bit
for bit, generators included; the engage predicate; when the graphs are
dropped; and the bucket table made once per (T, device).
"""

import dataclasses

import pytest
import torch

from multimodalemotionrecognition_torch.config import WavLMConfig
from multimodalemotionrecognition_torch.models.wavlm import WavLMModel
from multimodalemotionrecognition_torch.ops.stochastic import RngStreams
from multimodalemotionrecognition_torch.train.prefix_graph import (
    PrefixGraphs,
    engages,
    graph_key,
)

# Four layers of the base model's shape at narrow widths; K1's plain version
# and K3's run on the CPU when the flags say True.
SMALL = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=4, intermediate_size=64,
             conv_dim=(32,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
             num_buckets=32, max_bucket_distance=64, fused_attention=True, fused_conv=True,
             fused_train_layers=4, fused_train_conv=True, mask_time_prob=0.2, mask_time_length=3)


def _model(**over):
    torch.manual_seed(0)
    model = WavLMModel(WavLMConfig(**{**SMALL, **over}))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) * 0.2)
        model.requires_grad_(False)
        for p in model.encoder.layers[3].parameters():
            p.requires_grad_(True)  # the trainable layer after a prefix of 3
    return model


def _rng_state(rng):
    state = rng.get_state()
    return {side: {k: v.clone() for k, v in state[side].items()} for side in ("device", "host")}


def _states_equal(a, b):
    return all(torch.equal(a[side][k], b[side][k]) for side in a for k in a[side])


@pytest.mark.parametrize("layerdrop,seed", [(0.0, 3), (0.6, 11)])
def test_split_prefix_forward_is_the_forward_bit_for_bit(layerdrop, seed):
    """The prefix's host draws first, then its units on static buffers with
    K1's seeds from a tensor, then the rest of the stack: the same output,
    the same layers run, and every stream's generators where the model's
    own forward leaves them (over two steps; seed 11 skips a layer of the
    prefix in one of them, which the test checks)."""
    model = _model(layerdrop=layerdrop)
    n_prefix = 3
    wav = torch.randn(2, 4000, generator=torch.Generator().manual_seed(seed)) * 0.1
    eager_rng, split_rng = RngStreams(seed), RngStreams(seed)
    graphs = PrefixGraphs(n_prefix, True)
    skipped = False
    for _ in range(2):
        want = model(wav, True, eager_rng)
        want_runs = list(model.layers_run)
        x, bias = graphs.run(model, wav, split_rng)
        got_runs = list(model.layers_run)
        position_bias = bias
        for i in range(n_prefix, len(model.encoder.layers)):
            if model.layer_runs(i, True, split_rng):
                x, position_bias = model.encoder.layers[i](x, position_bias, True, split_rng,
                                                          fused=True)
                got_runs.append(i)
        assert torch.equal(x, want)
        assert got_runs == want_runs
        assert _states_equal(_rng_state(split_rng), _rng_state(eager_rng))
        skipped |= len([i for i in want_runs if i < n_prefix]) < n_prefix
    assert skipped == (layerdrop > 0.0)


def test_forward_takes_the_split_prefix_where_it_engages(monkeypatch):
    """With the owner set and its predicate true, the model's forward runs
    the prefix through `run` and the rest eagerly: the same output as
    without the owner, and the trainable layer still records its gradient."""
    model = _model(layerdrop=0.3)
    wav = torch.randn(2, 4000, generator=torch.Generator().manual_seed(5)) * 0.1
    want = model(wav, True, RngStreams(7))
    model.prefix_graphs = PrefixGraphs(3, True)
    calls = []
    monkeypatch.setattr(PrefixGraphs, "engages",
                        lambda self, m, w, k1: calls.append(k1) or True)
    got = model(wav, True, RngStreams(7))
    assert calls == [4] and torch.equal(got, want) and got.requires_grad
    model(wav, False)  # eval never asks
    assert calls == [4]


@pytest.mark.parametrize("device,train,n_prefix,conv_frozen,tp,k1_layers,want", [
    ("cuda", True, 10, True, False, 12, True),  # stage 2 of two-stage training
    ("cuda", True, 12, True, False, 12, True),  # the audio model's stage 1
    ("cpu", True, 10, True, False, 12, False),
    ("cuda", False, 10, True, False, 12, False),  # eval and serving
    ("cuda", True, 0, False, False, 12, False),  # single-stage: everything trains
    ("cuda", True, 10, False, False, 12, False),
    ("cuda", True, 10, True, True, 0, False),  # tensor parallel: the modular sublayer
    ("cuda", True, 10, True, True, 12, False),
    ("cuda", True, 10, True, False, 9, False),  # K1 short of the prefix
])
def test_engage_predicate(device, train, n_prefix, conv_frozen, tp, k1_layers, want):
    assert engages(device, train, n_prefix, conv_frozen, tp, k1_layers) is want


def test_graph_key_tells_grad_accum_microbatches_apart():
    whole, half = torch.zeros(16, 48000), torch.zeros(8, 48000)
    assert graph_key(whole, 10) != graph_key(half, 10)
    assert graph_key(half, 10) == graph_key(torch.ones(8, 48000), 10)
    assert graph_key(whole, 10) != graph_key(whole.double(), 10)
    assert graph_key(whole, 10) != graph_key(whole, 12)


def _owner_with_units(model):
    """An owner that has seen `model`'s weights and holds one key's units
    (on the CPU no graph is captured: the units stand for them)."""
    graphs = PrefixGraphs(3, True)
    model.prefix_graphs = graphs
    weights = _weights(model)
    graphs.check_weights(weights)
    graphs.run(model, torch.zeros(2, 4000), RngStreams(1))
    assert graphs._units
    return graphs, weights


def _weights(model):
    return [t for m in model.modules() for t in m._parameters.values() if t is not None]


@pytest.mark.parametrize("change", ["cast", "move", "replace_weight"])
def test_graphs_are_dropped_when_their_weights_go(change):
    model = _model()
    graphs, weights = _owner_with_units(model)
    graphs.check_weights(weights)
    assert graphs._units  # nothing moved: kept
    if change == "cast":
        model.double()
        assert not graphs._units
    elif change == "move":
        model.to("cpu", memory_format=torch.contiguous_format)  # `_apply` all the same
        assert not graphs._units
    else:
        q = model.encoder.layers[1].attention.q_proj
        q.weight = torch.nn.Parameter(q.weight.detach().clone(), requires_grad=False)
        graphs.check_weights(_weights(model))
        assert not graphs._units


def test_graphs_are_dropped_for_other_generators():
    """A graph reads the generators it was captured with: another
    `RngStreams` (a new state) drops the units, the same one keeps them."""
    model = _model()
    graphs, _ = _owner_with_units(model)
    first = dict(graphs._units)
    rng = RngStreams(1)  # the same seed, other generators
    graphs.run(model, torch.zeros(2, 4000), rng)
    assert graphs._units.keys() == first.keys()
    assert all(graphs._units[k] is not first[k] for k in first)
    second = dict(graphs._units)
    graphs.run(model, torch.zeros(2, 4000), rng)
    assert all(graphs._units[k] is second[k] for k in second)


def test_the_bucket_table_is_made_once_per_length_and_device():
    attn = _model().encoder.layers[0].attention
    first = attn.bucket_table(12, "cpu")
    assert attn.bucket_table(12, torch.device("cpu")) is first
    other = attn.bucket_table(13, "cpu")
    assert other is not first and other.shape == (13, 13)
    assert len(attn._bucket_tables) == 2
    assert torch.equal(attn.relative_position_bias(12, "cpu"),
                       attn.rel_attn_embed(first).permute(2, 0, 1))


def test_trainer_sets_the_owner_from_the_freeze_policy():
    from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig
    from multimodalemotionrecognition_torch.train.trainer import EmotionTrainer

    geometry = {k: v for k, v in SMALL.items() if not k.startswith("fused")}
    geometry["num_hidden_layers"] = 12
    cfg = ModelConfig(fusion="audio", use_wavlm=True, wavlm_geometry=geometry)
    for tc, want in ((TrainConfig(wavlm_stage=2), (10, True)),
                     (TrainConfig(wavlm_stage=1), (12, True))):
        trainer = EmotionTrainer(cfg, tc, device="cpu")
        trainer.init_state()
        wavlm = trainer.model.wavlm
        assert wavlm.prefix_graphs is trainer.prefix_graphs
        assert (trainer.prefix_graphs.n_prefix, trainer.prefix_graphs.conv_frozen) == want
    trainer = EmotionTrainer(dataclasses.replace(cfg, fusion="xattn"), TrainConfig(),
                             device="cpu")
    trainer.init_state()
    assert trainer.prefix_graphs.n_prefix == 0  # single-stage: never engages


def _share_reader():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "perfbench/metrics/prefix_graph_share.train.py"
    spec = importlib.util.spec_from_file_location("prefix_graph_share_train", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("names,want", [
    (["wavlm.prefix_replay"] * 9 + ["aten::mm"], 100.0),
    (["wavlm.prefix_eager"] * 3 + ["wavlm.prefix_replay"], 25.0),
    (["trainer.step", "aten::mm"], None),  # a program without the spans
])
def test_the_benchmark_reads_the_share_of_replayed_units(names, want):
    from types import SimpleNamespace

    ops = [(name, 0.0, 1.0, 1) for name in names]
    assert _share_reader()(SimpleNamespace(trace={"cpu_ops": ops})) == want
    assert _share_reader()(SimpleNamespace(trace=None)) is None
