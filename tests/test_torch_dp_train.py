"""Data-parallel training in the port against the JAX package's dp mesh and
against one rank, on the CPU with two Gloo ranks.

`tests/test_trainer.py::TestDistributedCorrectness` defines the semantics:
sharding changes the layout, not the math.  Its protocol runs here on the
port: the concat model's eval-mode gradients (BatchNorm on running
statistics, so the tolerance can stay JAX's own, atol 2e-5 / rtol 1e-3) on
2 ranks against JAX's dp-2 mesh (in this process, on the suite's host
devices) and against 1 rank, and the train-mode BatchNorm statistics, which
must be the GLOBAL batch's (atol 1e-5 / rtol 1e-4, JAX's).  Against JAX
both packages take one log-mel array as the audio input (JAX's protocol
with the front end moved out of its jit): the model on the raw dB input is
so sensitive that the two front ends' float32 rounding (up to 2.4e-4 dB on
this batch, held by `tests/test_torch_mel.py`) moves 6 of one conv weight's
36,864 gradient entries 2.4e-6 past JAX's tolerance already on one rank,
as does computing the mel inside or outside the jit.  Against one rank the
port runs its own front end.

Then one two-stage train step of the flagship at SMALL widths, with WavLM's
dropouts, LayerDrop and span masking on and K1 / K2 through their plain
versions, on 2 ranks against 1 rank on the same global batch: every random
draw of the step (dropout, drop path, span mask, the uint8 wire's video
noise, K1's hashed masks) on each rank is the one-rank draw's rows bit for
bit, both ranks run the one-rank `layers_run`, the losses agree within
1e-5, the BatchNorm statistics within JAX's 1e-5 / 1e-4, and the audio
branch's and the fusion's gradients within 1e-4 of each leaf's largest
entry (floor 1e-6).  The ResNet's train-mode gradients at these sizes are
chaotic (ROADMAP queue 3), so the video tower is held by the loss
and its statistics.

With `grad_accum=2` the same step on 2 ranks, each holding its share of
each microbatch, against 1 rank at the same tolerances.

Every spawn shares one launch; the loader's rank split needs none.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import tests.test_trainer as jax_trainer_tests
from multimodalemotionrecognition_tpu.config import TrainConfig as JaxTrainConfig
from multimodalemotionrecognition_tpu.ops.mel import log_mel_spectrogram as jax_log_mel
from multimodalemotionrecognition_tpu.parallel import mesh as jax_mesh
from multimodalemotionrecognition_tpu.train import trainer as jax_trainer
from multimodalemotionrecognition_torch.config import DataConfig, ModelConfig, TrainConfig, VideoConfig
from multimodalemotionrecognition_torch.convert.params import (
    adam_moments_to_state_dict,
    flax_params_to_state_dict,
)
from multimodalemotionrecognition_torch.data import pipeline, synthetic
from multimodalemotionrecognition_torch.parallel.distributed import launch
from multimodalemotionrecognition_torch.train import EmotionTrainer

from tests import torch_dp_workers as workers

GRAD_TOL = dict(atol=2e-5, rtol=1e-3)  # JAX's TestDistributedCorrectness
STATS_TOL = dict(atol=1e-5, rtol=1e-4)
CONCAT_TRAIN = dict(lr=1e-3)
FLAGSHIP_ACCUM = dict(workers.FLAGSHIP_TRAIN, grad_accum=2)


def _concat_config():
    return ModelConfig(fusion="concat", num_classes=4, spec_augment=False)


def _jax_grads_and_stats(trainer, state, batch, mel):
    """`TestDistributedCorrectness._grads_and_stats` with the log-mel `mel`
    as the audio input: the eval-mode loss and gradients, and one train-mode
    forward's BatchNorm statistics, jitted over the trainer's mesh -> (loss,
    gradients, statistics under the port's names)."""
    from multimodalemotionrecognition_tpu.parallel.mesh import shard_batch

    def loss_fn(params, video, audio, labels, valid):
        variables = {"params": params, "batch_stats": state.batch_stats}
        outputs, aux, _ = trainer._apply(variables, video, audio, False, None, mutable=False)
        return trainer._losses(outputs, aux, labels, valid)[0]

    def stats_fn(params, video, audio):
        rngs = {name: jax.random.fold_in(jax.random.PRNGKey(123), i) for i, name in enumerate(
            ("dropout", "droppath", "specaugment", "modality", "wavlm_mask"))}
        variables = {"params": params, "batch_stats": state.batch_stats}
        return trainer._apply(variables, video, audio, True, rngs, mutable=True)[2]["batch_stats"]

    with trainer.mesh:
        sb = shard_batch(trainer.mesh, {"video": batch["video"], "audio": mel,
                                        "labels": batch["labels"], "valid": batch["valid"]})
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            state.params, sb["video"], sb["audio"], sb["labels"], sb["valid"])
        stats = jax.jit(stats_fn)(state.params, sb["video"], sb["audio"])
    grads = adam_moments_to_state_dict(flatten_dict(jax.device_get(grads)))
    stats = flax_params_to_state_dict(
        {("batch_stats", *p): v for p, v in flatten_dict(jax.device_get(stats)).items()})
    stats = {k: v for k, v in stats.items() if "running" in k}
    return float(loss), _numpy(grads), _numpy(stats)


def _numpy(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def concat_case():
    """The JAX suite's concat model on a dp-2 mesh, its initial state as the
    port's state dict, its batch of 8 and the batch's log-mel -> (JAX
    trainer, JAX state, state dict, batch, log-mel)."""
    trainer = jax_trainer.EmotionTrainer(
        jax_trainer_tests._small_model_cfg("concat"), JaxTrainConfig(**CONCAT_TRAIN),
        mesh=jax_mesh.make_mesh(devices=jax.devices()[:2]))
    state = trainer.init_state()
    toy = jax_trainer_tests._toy_batches(1, b=8, seed=7)[0]
    batch = {"video": toy.video, "audio": toy.audio, "labels": toy.labels.astype(np.int64),
             "valid": toy.valid}
    mel = np.array(jax_log_mel(jnp.asarray(toy.audio[:, 0, :])))[:, None]
    sd = flax_params_to_state_dict(flatten_dict({
        "params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}))
    return trainer, state, _numpy(sd), batch, mel


@pytest.fixture(scope="module")
def spawned(concat_case):
    """One spawn of two Gloo ranks (the concat protocol and the flagship
    steps), and JAX's protocol on the dp-2 mesh computed while they run ->
    (the ranks' results, JAX's (loss, gradients, statistics))."""
    trainer, state, sd, batch, mel = concat_case
    step_batch = workers.flagship_batch(4)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, workers.dp_train_rank, 2, "gloo", ["cpu", "cpu"],
                            timeout_s=300, args=(
            (_concat_config(), CONCAT_TRAIN, sd, batch, mel),
            (workers.flagship_small_config(), workers.FLAGSHIP_TRAIN, step_batch),
            (workers.flagship_small_config(), FLAGSHIP_ACCUM, step_batch)))
        want = _jax_grads_and_stats(trainer, state, batch, mel)
        return ranks.result(), want


@pytest.fixture(scope="module")
def jax_dp2(spawned):
    """JAX's protocol on a dp-2 mesh over one log-mel array -> (loss,
    gradients, statistics)."""
    return spawned[1]


@pytest.fixture(scope="module")
def two_ranks(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def one_rank_concat(concat_case):
    *_, sd, batch, _ = concat_case
    trainer = EmotionTrainer(_concat_config(), TrainConfig(**CONCAT_TRAIN), device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return workers.eval_grads_and_stats(trainer, state, batch)


def test_two_ranks_eval_gradients_equal_jax_dp2_and_one_rank(jax_dp2, two_ranks, one_rank_concat):
    want_loss, want_grads, *_ = jax_dp2
    (own0, on_jax_mel0), (own1, on_jax_mel1) = (r[0] for r in two_ranks)
    one_loss, one_grads, _ = one_rank_concat
    assert own0[0] == own1[0] and on_jax_mel0[0] == on_jax_mel1[0]
    assert abs(on_jax_mel0[0] - float(want_loss)) <= 1e-5 and abs(own0[0] - one_loss) <= 1e-5
    assert set(own0[1]) == set(on_jax_mel0[1]) == set(want_grads) == set(one_grads)
    for name in want_grads:
        for got, other in ((own0, own1), (on_jax_mel0, on_jax_mel1)):  # one all-reduce
            np.testing.assert_array_equal(got[1][name], other[1][name], err_msg=name)
        np.testing.assert_allclose(on_jax_mel0[1][name], want_grads[name], **GRAD_TOL,
                                   err_msg=f"{name}: 2 ranks against JAX's dp-2 mesh")
        np.testing.assert_allclose(own0[1][name], one_grads[name], **GRAD_TOL,
                                   err_msg=f"{name}: 2 ranks against 1")


def test_train_mode_batchnorm_takes_the_global_statistics(jax_dp2, two_ranks, one_rank_concat):
    """Per-rank statistics over 4 of the 8 clips would differ by O(1)."""
    _, _, want_stats, *_ = jax_dp2
    own = [r[0][0][2] for r in two_ranks]
    on_jax_mel = [r[0][1][2] for r in two_ranks]
    one = one_rank_concat[2]
    assert set(own[0]) == set(on_jax_mel[0]) == set(want_stats) == set(one)
    assert len(one) == 2 * (20 + 20)  # ResNet18's and AudioResNet18's 20 BatchNorms each
    for name in one:
        np.testing.assert_array_equal(own[0][name], own[1][name], err_msg=name)
        np.testing.assert_array_equal(on_jax_mel[0][name], on_jax_mel[1][name], err_msg=name)
        np.testing.assert_allclose(on_jax_mel[0][name], want_stats[name], **STATS_TOL,
                                   err_msg=f"{name}: 2 ranks against JAX's dp-2 mesh")
        np.testing.assert_allclose(own[0][name], one[name], **STATS_TOL,
                                   err_msg=f"{name}: 2 ranks against 1")


@pytest.fixture(scope="module")
def one_rank_step():
    trainer = EmotionTrainer(workers.flagship_small_config(), TrainConfig(**workers.FLAGSHIP_TRAIN),
                             device="cpu")
    return workers.trainer_step(trainer, trainer.init_state(), workers.flagship_batch(4))


def test_two_rank_flagship_step_equals_one_rank_and_draws_its_rows(two_ranks, one_rank_step):
    assert len(one_rank_step[3]["draws"]) >= 8 and len(one_rank_step[3]["k1_masks"]) >= 2
    assert any(n.startswith("video_model.") for n in one_rank_step[1])  # ResNet block 7 trains
    workers.assert_steps_agree(one_rank_step, [r[1] for r in two_ranks], loss_tol=1e-5,
                               grad_rel=1e-4, stats_tol=(STATS_TOL["atol"], STATS_TOL["rtol"]))


def test_two_rank_flagship_step_with_grad_accum_equals_one_rank(two_ranks):
    """grad_accum=2 over 2 ranks: each rank's microbatch i is its share of
    the one-rank step's microbatch i (the loader's `rank_rows`: rank 0
    holds rows 0 and 2 of 4, rank 1 rows 1 and 3), so the BatchNorm
    statistics chain over the same rows and every draw of a microbatch is
    the one-rank draw's rows.  The same tolerances as with one microbatch."""
    trainer = EmotionTrainer(workers.flagship_small_config(), TrainConfig(**FLAGSHIP_ACCUM),
                             device="cpu")
    one = workers.trainer_step(trainer, trainer.init_state(), workers.flagship_batch(4))
    assert len(one[3]["layers_run"]) == 2  # one WavLM forward per microbatch
    workers.assert_steps_agree(one, [r[2] for r in two_ranks], loss_tol=1e-5, grad_rel=1e-4,
                               stats_tol=(STATS_TOL["atol"], STATS_TOL["rtol"]))


# --------------------------------------------------------------------------- the loader


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    """3 actors x 2 emotions of 0.5 s: train actors 1 and 3 hold 4 pairs."""
    root = tmp_path_factory.mktemp("tiny_dp")
    synthetic.generate_synthetic_ravdess(root, actors=(1, 2, 3), emotions=(3, 5), seconds=0.5,
                                         size=64, seed=3)
    (root / "Actor_03" / "03-01-05-01-01-01-03.wav").unlink()
    return root


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_ranks_rows_concatenated_are_the_single_process_batch(tiny_corpus, tmp_path, monkeypatch,
                                                              wire):
    """3 train pairs, global batch 2 over 2 ranks: the last batch's second
    row is padding, so rank 1 holds no valid row there.  Bit for bit over
    two shuffled epochs, augmentation on."""
    monkeypatch.chdir(tmp_path)
    config = DataConfig(data_root=str(tiny_corpus), split_mode="actor", train_actors=(1, 3),
                        val_actors=(2,), test_actors=(4,), seed=11,
                        video=VideoConfig(num_frames=2, size=32))
    single = pipeline.build_loaders(config, 2, num_workers=2, wire=wire)[0]
    ranks = [pipeline.build_loaders(config, 2, num_workers=2, wire=wire, rank=r, world=2)[0]
             for r in range(2)]
    for _ in range(2):
        want = list(single)
        got = [list(loader) for loader in ranks]
        assert len(want) == len(got[0]) == len(got[1]) == 2
        for w, g0, g1 in zip(want, *got):
            for field in dataclasses.fields(w):
                key = field.name
                wv, parts = getattr(w, key), (getattr(g0, key), getattr(g1, key))
                if key == "meta":
                    assert parts[0] + parts[1] == wv
                elif wv is None:
                    assert parts == (None, None), key
                else:
                    np.testing.assert_array_equal(np.concatenate(parts), wv, err_msg=key)
    assert [b.size for b in got[1]] == [1, 0]
    with pytest.raises(ValueError, match="divide"):
        pipeline.BatchedLoader([], None, 3, world=2)


def _index_sample(pair, rs):
    """A stand-in decoder: every array of the sample holds its index."""
    return np.full((2,), pair, np.float32), np.full((1, 3), pair, np.float32), pair, {"i": pair}


def test_ranks_rows_follow_the_steps_microbatches():
    """Global batch 8 cut into 2 microbatches of 4 over 2 ranks: rank r's
    microbatch i is rows [4 i + 2 r, 4 i + 2 r + 2) of the global batch.
    10 pairs: the last batch holds 2, so rank 1 and every second
    microbatch are padding there."""
    assert pipeline.rank_rows(1, 2, 8, 2) == [2, 3, 6, 7]
    assert pipeline.rank_rows(1, 2, 8) == [4, 5, 6, 7]
    single = pipeline.BatchedLoader(range(10), _index_sample, 8, shuffle=True, num_threads=1)
    ranks = [pipeline.BatchedLoader(range(10), _index_sample, 8, shuffle=True, num_threads=1,
                                    rank=r, world=2, microbatches=2) for r in range(2)]
    for w, *parts in zip(single, *ranks):
        for r, g in enumerate(parts):
            rows = pipeline.rank_rows(r, 2, 8, 2)
            for key in ("video", "audio", "labels", "valid"):
                np.testing.assert_array_equal(getattr(g, key), getattr(w, key)[rows], err_msg=key)
            assert [m["i"] for m in g.meta] == list(g.labels[g.valid])
    assert [b.valid.tolist() for b in parts] == [[True, True, False, False], [False] * 4]
    with pytest.raises(ValueError, match="microbatch"):
        pipeline.BatchedLoader([], None, 6, world=2, microbatches=2)
