"""Tensor parallelism in the port against the JAX package's, on the CPU.

The JAX package shards the WavLM trunk over its mesh's "model" axis by its
`_TP_RULES` (`parallel/mesh.py`) and lets XLA partition the step; the port
splits a replica's trunk over its mesh row in one process
(`parallel/tensor.py`).  Held here, at the JAX suite's SMALL geometry:

  * `shard_params` on a (1, 2) mesh gives every leaf JAX's per-device shape
    and piece (axes swapped), keeps a leaf whose axis does not divide whole
    (JAX replicates it), and `gather_params` undoes it bit for bit;
    `shard_module_` names its pieces as `shard_params` does;
  * the tensor-parallel encoder (tp 2, and tp 4 with heads that straddle
    the pieces) against JAX's tp-2 forward (the protocol of
    `tests/test_trainer.py::test_tp2_forward_matches_tp1`) and the port's
    tp 1, within that test's 1e-5;
  * `TorchModelRunner` on a (2, 2) mesh against JAX's runner on a (2, 2)
    mesh on one checkpoint, video and blank video, within JAX's own 2e-5
    (`tests/test_runner.py::test_runner_mesh_dp_tp_wavlm_matches_single`);
    int8 and bf16 at tp 2 against tp 1; the predictor through
    `ServeConfig(mesh_shape=(1, 2))`;
  * a two-stage flagship step with WavLM's dropouts, LayerDrop and span
    masking on, tp 2 in one process against tp 1: every draw equal, the
    loss within 1e-5, the gathered gradients within 1e-4 of each leaf's
    largest entry (the video tower held by the loss, as in
    `tests/test_torch_dp_train.py`); one deterministic step against JAX's
    `_train_step` on a `shard_params` state over a (1, 2) mesh (loss 1e-5,
    gradients 1e-4 of each leaf's largest, as `tests/test_torch_trainer.py`);
  * a resume file written under (1, 2) restored under (1, 1) and the
    reverse: parameters and Adam moments equal, the next step's loss equal;
  * `train --mesh_data 1 --mesh_model 2` in one process and
    `dryrun_multichip(4, device="cpu")` (two Gloo ranks of two CPU devices);
  * the refusals: K4 (`fused=True`) and K1 (`fused_wavlm=True`,
    `fused_attention=True`) under tensor parallelism raise `ValueError`.
"""

import copy
import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from multimodalemotionrecognition_tpu.config import ModelConfig as JaxModelConfig
from multimodalemotionrecognition_tpu.config import TrainConfig as JaxTrainConfig
from multimodalemotionrecognition_tpu.convert.torch_import import torch_state_dict_to_flax
from multimodalemotionrecognition_tpu.models.factory import build_model as jax_build_model
from multimodalemotionrecognition_tpu.models.wavlm import WavLMAudioEncoder as JaxWavLMAudioEncoder
from multimodalemotionrecognition_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from multimodalemotionrecognition_tpu.parallel import mesh as jax_mesh
from multimodalemotionrecognition_tpu.runtime.runner import JaxModelRunner
from multimodalemotionrecognition_tpu.train import freeze as jax_freeze
from multimodalemotionrecognition_tpu.train import trainer as jax_trainer
from multimodalemotionrecognition_torch.config import ModelConfig, ServeConfig, TrainConfig, WavLMConfig
from multimodalemotionrecognition_torch.convert.params import (
    adam_moments_to_state_dict,
    flax_params_to_state_dict,
    state_dict_key,
)
from multimodalemotionrecognition_torch.entry import dryrun_multichip
from multimodalemotionrecognition_torch.models import fusion as port_fusion
from multimodalemotionrecognition_torch.models.factory import build_model
from multimodalemotionrecognition_torch.models.wavlm import WavLMAudioEncoder
from multimodalemotionrecognition_torch.parallel import mesh
from multimodalemotionrecognition_torch.parallel.tensor import (
    ColumnParallelLinear,
    RowParallelLinear,
    shard_module_,
)
from multimodalemotionrecognition_torch.runtime.quant import Int8Linear
from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
from multimodalemotionrecognition_torch.serving.predictor import EmotionPredictor
from multimodalemotionrecognition_torch.train import EmotionTrainer
from multimodalemotionrecognition_torch.train import cli
from multimodalemotionrecognition_torch.train import trainer as port_trainer

from tests import torch_dp_workers as workers
from tests.test_torch_dp_serve import _clips, ckpt  # noqa: F401 - the shared checkpoint fixture
from tests.test_torch_trainer import ADAM_B1, TRAIN_KW, _batches, _model_config, _NoDropout, _tensors
from tests.test_wavlm_fused_attn import SMALL

EXACT = dict(atol=0, rtol=0)
CPU2 = ["cpu", "cpu"]


def _numpy(tensors):
    return {k: v.detach().float().cpu().numpy() for k, v in tensors.items()}


def _gathered(arrays):
    """numpy pieces by name -> numpy whole tensors by name."""
    return _numpy(mesh.gather_params({k: torch.from_numpy(v) for k, v in arrays.items()}))


# --------------------------------------------------------------------------- shard and gather


@pytest.fixture(scope="module")
def flagship_params():
    """The flagship at SMALL widths with the port's seeded initial weights
    -> (them as JAX's params, the port's state dict)."""
    kw = dict(fusion="xattn", use_wavlm=True, num_classes=8, spec_augment=False, xattn_d_model=32,
              wavlm_geometry=dict(SMALL))
    sd = build_model(ModelConfig(**kw), device="cpu", generator=torch.Generator().manual_seed(0))
    sd = {k: v for k, v in sd.state_dict().items() if not k.endswith("num_batches_tracked")}
    template = jax.eval_shape(jax_build_model(JaxModelConfig(**kw)).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 2, 3, 32, 32)), jnp.zeros((1, 1, 8000)))
    variables, _ = torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()}, template)
    return variables["params"], {k: v for k, v in sd.items() if "running_" not in k}


def test_shard_params_gives_jax_per_device_pieces_and_gather_params_inverts_it(flagship_params):
    params, sd = flagship_params
    want = flatten_dict(jax_mesh.shard_params(jax_mesh.make_mesh((1, 2), devices=jax.devices()[:2]),
                                              params))
    got = mesh.shard_params(mesh.make_mesh((1, 2), devices=CPU2), sd)
    assert len(got) == 1
    got = got[0]
    sharded = 0
    for path, leaf in want.items():
        name = state_dict_key(("params", *path))
        spec = tuple(leaf.sharding.spec)
        if "model" not in spec:  # whole on the device (the layouts of the two packages differ)
            assert leaf.sharding.shard_shape(leaf.shape) == leaf.shape
            assert got[name].numel() == leaf.size, name
            continue
        sharded += 1
        assert name not in got, name
        shards = sorted(leaf.addressable_shards, key=lambda s: s.device.id)
        for i, shard in enumerate(shards):
            piece = np.asarray(shard.data)
            piece = piece.T if piece.ndim == 2 else piece  # Flax [in, out], torch [out, in]
            assert tuple(got[mesh.shard_name(name, i)].shape) == piece.shape, name
            np.testing.assert_array_equal(got[mesh.shard_name(name, i)].numpy(), piece, err_msg=name)
    assert sharded == 2 * 10  # q, k, v (weight, bias), out_proj, the MLP's two and its up bias
    back = mesh.gather_params(got)
    assert set(back) == set(sd)
    for name, x in sd.items():
        assert torch.equal(back[name], x), name

    # A leaf whose split axis does not divide by tp stays whole (JAX replicates it).
    odd = np.arange(15, dtype=np.float32).reshape(5, 3)
    tree = {"audio_model": {"wavlm": {"encoder.layers.0": {"attention": {
        "q_proj": {"kernel": odd}, "k_proj": {"kernel": odd[:, :2]}}}}}}
    jax_odd = flatten_dict(jax_mesh.shard_params(
        jax_mesh.make_mesh((1, 2), devices=jax.devices()[:2]), tree))
    specs = {p[-2]: tuple(v.sharding.spec) for p, v in jax_odd.items()}
    assert "model" not in specs["q_proj"] and "model" in specs["k_proj"]
    flat = {"audio_model.wavlm.encoder.layers.0.attention.q_proj.weight": torch.from_numpy(odd.T.copy()),
            "audio_model.wavlm.encoder.layers.0.attention.k_proj.weight": torch.from_numpy(odd[:, :2].T.copy())}
    pieces = mesh.shard_params(mesh.make_mesh((1, 2), devices=CPU2), flat)[0]
    assert sorted(pieces) == ["audio_model.wavlm.encoder.layers.0.attention.k_proj.shards.0.weight",
                              "audio_model.wavlm.encoder.layers.0.attention.k_proj.shards.1.weight",
                              "audio_model.wavlm.encoder.layers.0.attention.q_proj.weight"]
    assert all(torch.equal(mesh.gather_params(pieces)[k], v) for k, v in flat.items())

    # The sharded module's parameters are `shard_params`' dict.
    model = shard_module_(_port_flagship(sd), CPU2)
    state = dict(model.named_parameters())
    assert set(state) == set(got)
    for name, x in got.items():
        assert torch.equal(state[name], x), name


def _port_flagship(sd):
    model = build_model(ModelConfig(fusion="xattn", use_wavlm=True, num_classes=8, spec_augment=False,
                                    xattn_d_model=32, wavlm_geometry=dict(SMALL)), device="cpu")
    model.load_state_dict(sd, strict=False)
    return model


def test_data_and_model_axes_of_a_mesh():
    m = mesh.make_mesh((2, 2), devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2}
    assert m.row(1) == (torch.device("cpu"),) * 2 and m.data_devices == [torch.device("cpu")] * 2
    assert mesh.unshard_name("a.b.shards.3.weight") == "a.b.weight"
    assert mesh.unshard_name("a.b.weight") == "a.b.weight"
    name = "audio_model.wavlm.encoder.layers.0.attention.out_proj.shards.1.weight"
    assert mesh.param_sharding_rules(name, True) == (None, "model")


# --------------------------------------------------------------------------- the encoder


@pytest.fixture(scope="module")
def encoder_case():
    """JAX's WavLM audio encoder at SMALL, its tp-2 forward on a (4, 2) mesh
    -> (params as the port's state dict, the waveforms, JAX's logits)."""
    model = JaxWavLMAudioEncoder(num_classes=8, embedding_dim=32, wavlm_config=JaxWavLMConfig(**SMALL))
    wav = np.random.RandomState(0).randn(4, 1, 8000).astype(np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(wav))
    m = jax_mesh.make_mesh((4, 2))
    params = jax_mesh.shard_params(m, variables["params"])
    with m:
        out = jax.jit(lambda p, x: model.apply({"params": p}, x))(params, jax_mesh.shard_batch(m, wav))
    sd = flax_params_to_state_dict(flatten_dict({"params": jax.device_get(variables["params"])}))
    return sd, wav, np.asarray(out)


@pytest.mark.parametrize("tp,heads", [(2, 4), (4, 2)], ids=["tp2", "tp4_heads_straddle"])
def test_tp_encoder_equals_jax_tp2_and_the_port_tp1(encoder_case, tp, heads):
    """tp 2 on JAX's weights; tp 4 over 2 heads (E divides by 4, H does not:
    the pieces' q/k/v join on the first device) on seeded weights."""
    sd, wav, want = encoder_case
    config = WavLMConfig(**{**SMALL, "num_attention_heads": heads})
    one = WavLMAudioEncoder(config, num_classes=8, head="full")
    if heads == SMALL["num_attention_heads"]:
        one.load_state_dict(sd, strict=True)
    else:
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in one.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    split = shard_module_(copy.deepcopy(one), ["cpu"] * tp)
    layer = split.wavlm.encoder.layers[0]
    assert isinstance(layer.attention.q_proj, ColumnParallelLinear)
    assert isinstance(layer.feed_forward.output_dense, RowParallelLinear)
    assert layer.attention.q_proj.shards[0].weight.shape == (32 // tp, 32)
    with torch.no_grad():
        got, base = split(torch.from_numpy(wav)).numpy(), one(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, base, atol=1e-5, rtol=1e-5)
    if heads == SMALL["num_attention_heads"]:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------- the runner


def test_tp_runner_equals_the_jax_dp_tp_runner(ckpt):  # noqa: F811
    """dp 2 x tp 2 in one process against JAX's runner on a (2, 2) mesh."""
    want = JaxModelRunner(ckpt, mesh=jax_mesh.make_mesh((2, 2), devices=jax.devices()[:4]),
                          batch_buckets=(1, 2, 4))
    port = TorchModelRunner(ckpt, device="cpu", mesh=mesh.make_mesh((2, 2), ["cpu"] * 4),
                            batch_buckets=(1, 2, 4))
    assert port.batch_buckets == want.batch_buckets == (2, 4)
    assert isinstance(port.replicas[1].forward.model.audio_model.wavlm.encoder.layers[1]
                      .feed_forward.intermediate_dense, ColumnParallelLinear)
    video, audio = _clips(3, seed=4)
    np.testing.assert_allclose(port.predict_probs(video, audio), want.predict_probs(video, audio),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(port.predict_probs_blank_video(audio),
                               want.predict_probs_blank_video(audio), atol=2e-5, rtol=0)


@pytest.mark.parametrize("options,tol", [(dict(quantize_int8=True), 1e-6),
                                         (dict(compute_dtype="bfloat16"), 1e-2)],
                         ids=["int8", "bf16"])
def test_tp_runner_options_equal_tp1(ckpt, options, tol):  # noqa: F811
    one = TorchModelRunner(ckpt, device="cpu", **options)
    two = TorchModelRunner(ckpt, device="cpu", mesh=mesh.make_mesh((1, 2), CPU2), **options)
    up = two.model.audio_model.wavlm.encoder.layers[0].feed_forward.intermediate_dense
    if options.get("quantize_int8"):
        assert all(isinstance(s, Int8Linear) for s in up.shards)
        assert up.shards[1].scale.shape == (32,)  # a column piece: its rows' scales
    video, audio = _clips(2, seed=6)
    np.testing.assert_allclose(two.predict_probs(video, audio), one.predict_probs(video, audio),
                               atol=tol, rtol=0)


def test_predictor_serves_a_tp_mesh_from_the_config(ckpt):  # noqa: F811
    predictor = EmotionPredictor(checkpoint_path=ckpt, config=ServeConfig(mesh_shape=(1, 2)),
                                 device="cpu")
    runner = predictor.runner
    assert runner.mesh.shape == {"data": 1, "model": 2} and runner.batch_buckets == (1, 2, 4, 8)
    _, audio = _clips(2, seed=8)
    single = TorchModelRunner(ckpt, device="cpu")
    np.testing.assert_allclose(runner.predict_probs_blank_video(audio),
                               single.predict_probs_blank_video(audio), atol=1e-5, rtol=0)


@pytest.mark.parametrize("option", ["fused", "fused_wavlm"])
def test_the_whole_width_kernels_refuse_a_tp_mesh(ckpt, option):  # noqa: F811
    with pytest.raises(ValueError, match="tensor parallelism"):
        TorchModelRunner(ckpt, device="cpu", mesh=mesh.make_mesh((1, 2), CPU2), **{option: True})
    encoder = shard_module_(WavLMAudioEncoder(WavLMConfig(**SMALL, fused_attention=True)), CPU2)
    with pytest.raises(ValueError, match="tensor parallelism"), torch.no_grad():
        encoder.encode_sequence(torch.zeros(1, 1, 8000))


# --------------------------------------------------------------------------- the trainer


def _flagship_trainer(tp, **train_kw):
    config = workers.flagship_small_config()
    config = dataclasses.replace(
        config, wavlm_geometry={**config.wavlm_geometry, "fused_attention": False})
    kw = {**workers.FLAGSHIP_TRAIN, **train_kw}
    trainer = EmotionTrainer(config, TrainConfig(**kw, mesh_shape=(1, tp)), device=["cpu"] * tp)
    return trainer, trainer.init_state()


def test_tp_flagship_step_draws_and_computes_as_tp1():
    batch = workers.flagship_batch(4)
    one = workers.trainer_step(*_flagship_trainer(1), batch)
    trainer, state = _flagship_trainer(2)
    assert trainer.row == (torch.device("cpu"),) * 2
    assert "audio_model.wavlm.encoder.layers.1.attention.q_proj.shards.1.weight" in state.opt_state.mu
    two = workers.trainer_step(trainer, state, batch)
    assert len(one[3]["draws"]) >= 8 and not one[3]["k1_masks"]
    two = (two[0], _gathered(two[1]), two[2], two[3])
    workers.assert_steps_agree(one, [two], loss_tol=1e-5, grad_rel=1e-4, stats_tol=(1e-5, 1e-4))


def test_tp_step_equals_jax_train_step_on_a_sharded_state(monkeypatch):
    """The deterministic stage-2 step of `tests/test_torch_trainer.py` with
    the modular attention on both sides, JAX's state `shard_params`'d over
    a (1, 2) mesh, the port at tp 2."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    jmesh = jax_mesh.make_mesh((1, 2), devices=jax.devices()[:2])
    jtrainer = jax_trainer.EmotionTrainer(_model_config(JaxModelConfig, False),
                                          JaxTrainConfig(**TRAIN_KW, mesh_shape=(1, 2)), mesh=jmesh)
    # `init_state` on the port's seeded initial weights (its own init, an
    # unjitted full-size `model.init`, is most of a minute on the CPU).
    trainer = EmotionTrainer(_model_config(ModelConfig, False),
                             TrainConfig(**TRAIN_KW, mesh_shape=(1, 2)), device=CPU2)
    pstate = trainer.init_state()
    sd = mesh.gather_params(pstate.model.state_dict())
    template = jax.eval_shape(jtrainer.model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 4, 3, 32, 32)), jnp.zeros((1, 1, 4000)))
    variables, _ = torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()}, template)
    jtrainer._build_steps()
    params = jax_mesh.shard_params(jmesh, variables["params"])
    state = jax_trainer.TrainState(
        params=params, batch_stats=jax_mesh.shard_params(jmesh, variables["batch_stats"]),
        opt_state=jtrainer._adam_core.init(params), rng=jax.random.PRNGKey(1),
        step=jnp.asarray(0, jnp.int32))
    q = flatten_dict(state.params)[("audio_model", "wavlm", "encoder.layers.1", "attention", "q_proj",
                                    "kernel")]
    assert "model" in str(q.sharding.spec)
    batch = _batches(1, seed=3)[0]
    mask = jax_freeze.trainable_mask(state.params, jtrainer.mc, jtrainer.tc, 2)
    lrs = jax_freeze.lr_tree(state.params, jtrainer.mc, jtrainer.tc, 2, {})
    with jmesh:
        new_state, total, cls_loss, _, _ = jtrainer._train_step(
            state, *(jnp.asarray(a) for a in (batch.video, batch.audio, batch.labels, batch.valid)),
            mask, lrs)
    params0 = flatten_dict(jax.device_get(state.params))
    want = adam_moments_to_state_dict({
        path: np.asarray(mu) / (1.0 - ADAM_B1) - TRAIN_KW["weight_decay"] * np.asarray(params0[path])
        for path, mu in flatten_dict(jax.device_get(new_state.opt_state.mu)).items()})

    monkeypatch.setattr(port_fusion, "dropout", lambda x, rate, generator: x)
    pmask = trainer.trainable_mask(2)
    ptotal, pcls, _, _ = trainer.loss_and_grads(pstate, *_tensors(batch), pmask)
    assert abs(float(ptotal) - float(total)) <= 1e-5 and abs(float(pcls) - float(cls_loss)) <= 1e-5
    grads = mesh.gather_params({n: p.grad for n, p in pstate.params.items() if p.grad is not None})
    assert set(grads) == {mesh.unshard_name(n) for n, on in pmask.items() if on}
    assert pmask["audio_model.wavlm.encoder.layers.1.attention.q_proj.shards.1.weight"]
    for name, g in grads.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * max(np.abs(ref).max(), 1e-3), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("write,read", [(2, 1), (1, 2)], ids=["tp2_to_tp1", "tp1_to_tp2"])
def test_resume_file_crosses_mesh_shapes(tmp_path, write, read):
    batch = workers.flagship_batch(4)
    trainer, state = _flagship_trainer(write)
    workers.trainer_step(trainer, state, batch)
    trainer.save_resume_state(tmp_path, state, epoch=1, best_f1=0.5)
    saved = torch.load(tmp_path / "resume.pt", weights_only=False)
    assert not any(".shards." in k for k in saved["model"])
    other, _ = _flagship_trainer(read)
    restored, epoch, best = other.restore_resume_state(tmp_path)
    assert (epoch, best, restored.step, restored.opt_state.count) == (1, 0.5, 1, 1)
    whole = mesh.gather_params(dict(restored.model.state_dict()))
    assert set(whole) == set(saved["model"])
    for name, x in saved["model"].items():
        assert torch.equal(whole[name], x), name
    for key in ("mu", "nu"):
        moments = mesh.gather_params(getattr(restored.opt_state, key))
        assert set(moments) == set(saved["opt_state"][key])
        for name, x in saved["opt_state"][key].items():
            assert torch.equal(moments[name], x), name
    # The next step from the file: the writer's own state against the reader's.
    after_write = workers.trainer_step(trainer, state, batch)
    after_read = workers.trainer_step(other, restored, batch)
    assert after_read[3]["layers_run"] == after_write[3]["layers_run"]
    np.testing.assert_allclose(after_read[0], after_write[0], atol=1e-5, rtol=0)


# --------------------------------------------------------------------------- entry points


def test_train_cli_with_a_model_axis_trains_one_rank_on_two_cpu_devices(tmp_path, monkeypatch):
    """`--mesh_data 1 --mesh_model 2`: no spawn; the trainer holds its row
    and the trunk's pieces; the checkpoint holds the whole tensors, which
    the single-device runner serves."""
    from multimodalemotionrecognition_torch.data import synthetic

    root = tmp_path / "corpus"
    synthetic.generate_synthetic_ravdess(root, actors=(1, 2, 3), emotions=(3, 5), seconds=0.5,
                                         size=64, seed=3)
    small = dict(SMALL)
    monkeypatch.setattr(cli, "ModelConfig", lambda **kw: ModelConfig(
        **{**kw, "xattn_d_model": 32, "wavlm_geometry": small}))
    made = []

    class Recorded(port_trainer.EmotionTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(port_trainer, "EmotionTrainer", Recorded)
    monkeypatch.setenv("EMO_NATIVE_DECODE", "0")
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    result = cli.main(["--data_root", str(root), "--fusion", "xattn", "--use_wavlm",
                       "--epochs", "1", "--batch_size", "2", "--frames", "2", "--img_size", "32",
                       "--split_mode", "actor", "--train_actors", "1", "--val_actors", "2",
                       "--test_actors", "3", "--output_dir", str(out), "--num_workers", "2",
                       "--mesh_data", "1", "--mesh_model", "2"], device="cpu")
    assert np.isfinite(result["history"][0]["train/loss"])
    (trainer,) = made
    assert trainer.row == (torch.device("cpu"),) * 2 and trainer.shard is None
    assert any(".shards.1." in n for n, _ in trainer.model.named_parameters())
    saved = torch.load(out / "best_xattn.pt", weights_only=False)
    assert not any(".shards." in k for k in saved["model"])
    runner = TorchModelRunner(out / "best_xattn.pt", device="cpu")
    assert runner.predict_probs_blank_video(np.zeros((1, 1, 8000), np.float32)).shape == (1, 8)


def test_dryrun_multichip_trains_on_a_dp_tp_mesh():
    """4 devices: two Gloo ranks, each on a row of two CPU devices."""
    report = dryrun_multichip(4, device="cpu")
    assert report["mesh"] == [2, 2] and report["backend"] == "gloo"
    assert report["losses"][1] < report["losses"][0]
    assert np.asarray(report["probs"]).shape == (4, 8)
    assert [len(r) for r in report["launches_per_rank"]] == [2, 2]
