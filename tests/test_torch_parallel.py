"""The port's data-parallel layer (`parallel/`) against the JAX package's
`parallel/mesh.py`, and its collectives and per-sample draws, on the CPU.

The mesh helpers are held against JAX's on the suite's 8 host devices
(`tests/conftest.py`).  The collectives and the CLIP term run on two Gloo
ranks that `parallel.launch` spawns once for the module
(`tests/torch_dp_workers.py`).  The per-sample draws of a data-parallel step
need no group: under `batch_shard(BatchShard(r, 2))` each simulated rank must
draw exactly rows r of the single process's draw, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import PartitionSpec as P

from multimodalemotionrecognition_tpu.config import ModelConfig as JaxModelConfig
from multimodalemotionrecognition_tpu.models.factory import build_model as jax_build_model
from multimodalemotionrecognition_tpu.parallel import mesh as jax_mesh
from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig
from multimodalemotionrecognition_torch.convert.params import state_dict_key
from multimodalemotionrecognition_torch.kernels.wavlm_attn import _keep_masks, shifted_dropout_seed
from multimodalemotionrecognition_torch.models.factory import build_model
from multimodalemotionrecognition_torch.models.fusion import ClipStyleAlignment
from multimodalemotionrecognition_torch.models.resnet import EvalBatchNorm2d
from multimodalemotionrecognition_torch.ops.stochastic import drop_path, draw_rows, dropout, row_offset
from multimodalemotionrecognition_torch.parallel import distributed, mesh
from multimodalemotionrecognition_torch.parallel.distributed import BatchShard, batch_shard
from multimodalemotionrecognition_torch.train import EmotionTrainer

from tests import torch_dp_workers as workers
from tests.test_wavlm_fused_attn import SMALL

EXACT = dict(atol=0, rtol=0)


# --------------------------------------------------------------------------- mesh helpers


@pytest.mark.parametrize("shape,n", [((2, 1), 2), ((4, 2), 8), ((3, 1), 2), ((1, 2), 4), (None, 4)])
def test_make_mesh_shapes_and_errors_match_jax(shape, n):
    devices = jax.devices()[:n]
    try:
        want = jax_mesh.make_mesh(shape, devices=devices)
    except ValueError as exc:
        with pytest.raises(ValueError, match="mesh shape"):
            mesh.make_mesh(shape, devices=["cpu"] * n)
        assert "mesh shape" in str(exc)
        return
    got = mesh.make_mesh(shape, devices=["cpu"] * n)
    assert got.shape == dict(want.shape)
    assert got.size == want.devices.size
    assert [[d.type for d in row] for row in got.devices] == [["cpu"] * want.shape["model"]] * want.shape["data"]


def test_make_mesh_takes_repeated_devices_and_shard_params_splits_tp_params():
    """A (1, 2) mesh splits a leaf that a rule names into its two pieces on
    the row's devices and keeps any other leaf whole (tests/test_torch_tp.py
    holds every leaf against JAX's shards)."""
    m = mesh.make_mesh((2, 1), devices=["cpu", "cpu"])
    assert m.data_devices == [torch.device("cpu")] * 2
    q = "wavlm.encoder.layers.0.attention.q_proj.weight"
    (tp,) = mesh.shard_params(mesh.make_mesh((1, 2), devices=["cpu", "cpu"]),
                              {"w": torch.zeros(2), q: torch.arange(12.0).view(4, 3)})
    assert sorted(tp) == ["w", q.replace("q_proj.", "q_proj.shards.0."),
                          q.replace("q_proj.", "q_proj.shards.1.")]
    assert torch.equal(tp[q.replace("q_proj.", "q_proj.shards.1.")], torch.arange(6.0, 12.0).view(2, 3))
    copies = mesh.shard_params(m, {"w": torch.arange(3.0)})
    assert len(copies) == 2 and all(torch.equal(c["w"], torch.arange(3.0)) for c in copies)
    assert len(mesh.replicate(m, [torch.ones(2)])) == 2


def test_shard_batch_follows_jax_divisibility_rule():
    """Rows split over "data" when the leading dim divides, else replicated:
    each replica's piece equals the JAX shard on the same data-axis index."""
    rng = np.random.default_rng(0)
    batch = {"video": rng.standard_normal((4, 2, 3)).astype(np.float32),
             "labels": np.arange(4, dtype=np.int32),
             "odd": rng.standard_normal((3, 5)).astype(np.float32),
             "scalar": np.float32(2.5)}
    want = jax_mesh.shard_batch(jax_mesh.make_mesh((2, 1), devices=jax.devices()[:2]), batch)
    got = mesh.shard_batch(mesh.make_mesh((2, 1), devices=["cpu", "cpu"]), batch)
    assert len(got) == 2
    for key, leaf in want.items():
        split = leaf.sharding.spec == P("data")
        assert split == (key in ("video", "labels")), key
        shards = sorted(leaf.addressable_shards, key=lambda s: s.device.id)
        for i in range(2):
            np.testing.assert_array_equal(got[i][key].numpy(), np.asarray(shards[i].data), err_msg=key)


def test_param_sharding_rules_match_jax_on_every_small_wavlm_parameter():
    """JAX's `_TP_RULES` on each Flax name, and the port's rule on the same
    parameter's torch name: a matrix's two axes swap ([in, out] kernel,
    [out, in] weight), a bias's spec is the same."""
    cfg = dict(fusion="xattn", use_wavlm=True, num_classes=8, spec_augment=False, xattn_d_model=32,
               wavlm_geometry=dict(SMALL))
    shapes = jax.eval_shape(jax_build_model(JaxModelConfig(**cfg)).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 3, 32, 32)), jnp.zeros((1, 1, 8000)))
    port_names = {n for n, _ in build_model(ModelConfig(**cfg), device="cpu").named_parameters()}
    flat = flatten_dict(shapes["params"])
    sharded = 0
    for path in flat:
        joined = ".".join(path)
        name = state_dict_key(("params", *path))
        assert name in port_names, name
        spec = tuple(jax_mesh.param_sharding_rules(joined, True))
        want = spec[::-1] if len(spec) == 2 else spec
        assert mesh.param_sharding_rules(name, True) == want, (joined, spec)
        assert mesh.param_sharding_rules(name, False) == ()
        sharded += bool(spec)
    # q, k, v (weight and bias), out_proj, the MLP's two matrices and its
    # up-projection's bias, in each of the 2 encoder layers.
    assert sharded == 2 * 10


def test_trainer_takes_tensor_parallel_rows_and_refuses_unmatched_axes():
    cfg = ModelConfig(fusion="concat", num_classes=4, spec_augment=False)
    # A model axis of 2: the rank's row of two CPU devices (given, or made).
    for device in ("cpu", ["cpu", "cpu"]):
        trainer = EmotionTrainer(cfg, TrainConfig(mesh_shape=(1, 2)), device=device)
        assert trainer.shard is None and trainer.row == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="model axis of 2 takes a row of 2 devices, not 3"):
        EmotionTrainer(cfg, TrainConfig(mesh_shape=(1, 2)), device=["cpu"] * 3)
    # No process group here: a data axis of 2 has no second rank, with or
    # without a model axis.
    with pytest.raises(ValueError, match="needs 2 ranks"):
        EmotionTrainer(cfg, TrainConfig(mesh_shape=(2, 2)), device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        EmotionTrainer(cfg, TrainConfig(mesh_shape=(2, 1)), device="cpu")
    assert EmotionTrainer(cfg, TrainConfig(mesh_shape=(1, 1)), device="cpu").shard is None


def test_without_a_group_nothing_starts_and_launch_refuses_what_it_cannot_run(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.maybe_initialize_distributed() is False
    assert (distributed.rank(), distributed.world_size(), distributed.is_multi_host()) == (0, 1, False)
    assert distributed.local_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="NCCL"):
        distributed.launch(workers.collectives_and_infonce, 2, "nccl", ["cpu", "cpu"])
    with pytest.raises(ValueError, match="two ranks on one card"):
        distributed.launch(workers.collectives_and_infonce, 2, "nccl", ["cuda:0", "cuda:0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="finds 0 CUDA"):
            distributed.local_device("cuda")
        with pytest.raises(RuntimeError, match="CUDA card"):
            distributed.launch(workers.collectives_and_infonce, 2, "gloo", ["cuda:0", "cuda:0"])


def test_a_failing_rank_stops_the_others_and_raises():
    """Rank 1 raises while rank 0 waits in a collective: the launcher stops
    both and raises rank 1's traceback."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank 1 gives up"):
        distributed.launch(workers.fail_on_rank_one, 2, "gloo", ["cpu", "cpu"], timeout_s=120)


# --------------------------------------------------------------------------- collectives, CLIP


@pytest.fixture(scope="module")
def two_ranks():
    """One spawn of two Gloo ranks for the collectives, the CLIP term and a
    train-mode BatchNorm; weights and the global batch's inputs from a seed."""
    gen = torch.Generator().manual_seed(5)
    clip, bn = ClipStyleAlignment(12, 10, 6), EvalBatchNorm2d(5)
    with torch.no_grad():
        for p in (*clip.parameters(), *bn.parameters()):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    rng = np.random.default_rng(6)
    a = rng.standard_normal((8, 12)).astype(np.float32)
    v = rng.standard_normal((8, 10)).astype(np.float32)
    bn_x = (rng.standard_normal((6, 5, 3, 4)) * 2.0 + 1.0).astype(np.float32)
    bn_w = rng.standard_normal((6, 5, 3, 4)).astype(np.float32)
    states = [{k: t.clone().numpy() for k, t in m.state_dict().items()} for m in (clip, bn)]
    results = distributed.launch(
        workers.collectives_and_infonce, 2, "gloo", ["cpu", "cpu"], timeout_s=120,
        args=(states[0], a, v, states[1], bn_x, bn_w))
    return clip, a, v, bn, bn_x, bn_w, results


def test_all_reduce_and_all_gather_with_their_gradients(two_ranks):
    """Exact: small integers in float32."""
    results = two_ranks[-1]
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    for r, out in enumerate(results):
        np.testing.assert_array_equal(out["reduce"], 2 * base + 10.0)
        np.testing.assert_array_equal(out["reduce_grad"], np.full((2, 3), 1.0 + 2.0))
        np.testing.assert_array_equal(out["gather"], np.concatenate([base, base - 7.0]))
        weights = np.arange(12, dtype=np.float32).reshape(4, 3) * (1.0 + 2.0)
        np.testing.assert_array_equal(out["gather_grad"], weights[2 * r:2 * r + 2])
        assert out["gather_bf16_dtype"] == "torch.bfloat16"


def test_infonce_over_two_ranks_equals_one_rank_on_the_global_batch(two_ranks):
    """The ranks' shares of the CLIP loss sum to the one-rank loss; each
    rank's embedding gradients are the one-rank gradients' rows, and the
    parameters' gradients sum to the one-rank ones (1e-6)."""
    clip, a, v, *_, results = two_ranks
    at, vt = torch.from_numpy(a).requires_grad_(), torch.from_numpy(v).requires_grad_()
    _, _, loss = clip(at, vt)
    loss.backward()
    assert abs(sum(r["clip_loss"] for r in results) - loss.item()) <= 1e-6
    np.testing.assert_allclose(np.concatenate([r["clip_a_grad"] for r in results]), at.grad.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.concatenate([r["clip_v_grad"] for r in results]), vt.grad.numpy(),
                               atol=1e-6, rtol=0)
    for name, p in clip.named_parameters():
        np.testing.assert_allclose(sum(r["clip_param_grads"][name] for r in results),
                                   p.grad.numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_train_mode_batchnorm_over_two_ranks_equals_one_rank(two_ranks):
    """The global statistics and their gradient through the all-reduce:
    each rank's output and input gradient are one rank's rows, the scale's
    and shift's gradients sum to one rank's, the running statistics move
    alike on both (float32, 1e-6; the ranks sum in another order)."""
    *_, bn, bn_x, bn_w, results = two_ranks
    x = torch.from_numpy(bn_x).requires_grad_()
    y = bn(x, True)
    (y * torch.from_numpy(bn_w)).sum().backward()
    tol = dict(atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["bn_y"] for r in results]), y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([r["bn_x_grad"] for r in results]), x.grad.numpy(), **tol)
    for name, p in bn.named_parameters():
        np.testing.assert_allclose(sum(r["bn_param_grads"][name] for r in results), p.grad.numpy(),
                                   **tol, err_msg=name)
    for name, buf in bn.named_buffers():
        if "running" in name:
            for r in results:
                np.testing.assert_allclose(r["bn_stats"][name], buf.numpy(), **tol, err_msg=name)


# --------------------------------------------------------------------------- per-sample draws


def _per_rank(fn, world=2):
    out = []
    for r in range(world):
        with batch_shard(BatchShard(r, world)):
            out.append(fn())
    return out


def test_dropout_drop_path_and_row_draws_are_the_global_rows_bit_for_bit():
    x = torch.ones(6, 5, 7)
    draws = {
        "dropout": lambda g, n: dropout(x[:n], 0.3, g),
        "drop_path": lambda g, n: drop_path(x[:n], 0.4, True, g),
        "randn": lambda g, n: draw_rows(lambda s: torch.randn(s, generator=g), (n, 4)),
    }
    for name, fn in draws.items():
        whole = fn(torch.Generator().manual_seed(9), 6)
        parts = _per_rank(lambda: fn(torch.Generator().manual_seed(9), 3))
        np.testing.assert_allclose(torch.cat(parts).numpy(), whole.numpy(), **EXACT, err_msg=name)
    assert _per_rank(lambda: row_offset(3)) == [0, 3]
    assert row_offset(3) == 0
    assert distributed.current_shard() is distributed.ALONE
    with batch_shard(None):  # alone: no shard
        assert distributed.current_shard() is distributed.ALONE


@pytest.mark.parametrize("seed", [12345, 2**31 - 2], ids=["small", "wraps_past_int32"])
def test_shifted_k1_seed_gives_the_global_rows_masks(seed):
    """K1's hashed masks (attention and hidden) of rank r's rows under the
    shifted seed equal rows r of the global masks; the seed stays an int32."""
    b, h, tp, e = 4, 2, 6, 8
    whole = _keep_masks(seed, b, h, tp, e, 0.1, 0.1, "cpu")
    for r in range(2):
        shifted = shifted_dropout_seed(seed, r * 2)
        assert -2**31 <= shifted < 2**31
        part = _keep_masks(shifted, 2, h, tp, e, 0.1, 0.1, "cpu")
        for got, want in zip(part, whole):
            assert torch.equal(got, want[2 * r:2 * r + 2])
