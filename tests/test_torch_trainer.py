"""The port's training slice against the JAX package's trainer, on the CPU.

Small geometry: the `SMALL` WavLM of the JAX suite (2 layers), d_model 32,
4 frames of 32x32, batch 4.  One deterministic train step goes through the
JAX `_train_step` (its Pallas attention kernel and custom VJP in interpret
mode) and through the port (whose kernel wrappers run their plain versions
on the CPU) from the same converted state and batch.  Every stochastic rate
a config reaches is 0; the head MLP's dropout is a constant 0.2 in both
packages, so both are patched to the identity for that test.

Gradients are compared before the optimizer: the JAX step starts from zero
moments, so its first moment gives the gradient back, g = mu / (1 - b1) -
weight_decay * p.  Post-Adam parameters are compared only where both sides
are fed identical gradients (Adam amplifies rounding where a gradient is
numerically zero).
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from multimodalemotionrecognition_tpu.config import ModelConfig as JaxModelConfig
from multimodalemotionrecognition_tpu.config import TrainConfig as JaxTrainConfig
from multimodalemotionrecognition_tpu.models.factory import build_model as jax_build_model
from multimodalemotionrecognition_tpu.train import freeze as jax_freeze
from multimodalemotionrecognition_tpu.train import trainer as jax_trainer
from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig, WavLMConfig
from multimodalemotionrecognition_torch.convert.params import (
    adam_moments_to_state_dict,
    flax_params_to_state_dict,
    state_dict_key,
)
from multimodalemotionrecognition_torch.models import WavLMModel
from multimodalemotionrecognition_torch.models import fusion as port_fusion
from multimodalemotionrecognition_torch.models.resnet import EvalBatchNorm2d
from multimodalemotionrecognition_torch.ops.stochastic import (
    RNG_STREAMS,
    RngStreams,
    drop_path,
    dropout,
    modality_dropout_mask,
)
from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
from multimodalemotionrecognition_torch.train import (
    AdamState,
    EmotionTrainer,
    freeze,
    masked_adam_update,
)
from multimodalemotionrecognition_torch.train.trainer import (
    ADAM_B1,
    _nll_on_probs,
    _smoothed_cross_entropy,
)

from tests.test_wavlm_fused_attn import SMALL

NO_NOISE = dict(
    hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
    feat_proj_dropout=0.0, layerdrop=0.0, apply_spec_augment=False,
)
B, FRAMES, SIZE, SAMPLES, CLASSES = 4, 4, 32, 4000, 4


def _model_config(cls, fused_attention, **overrides):
    base = dict(
        fusion="xattn", use_wavlm=True, num_classes=CLASSES, spec_augment=False,
        xattn_d_model=32, xattn_attn_dropout=0.0, xattn_stochastic_depth=0.0,
        wavlm_geometry=dict(SMALL, **NO_NOISE, fused_attention=fused_attention),
    )
    return cls(**{**base, **overrides})


# Layer 1 of the 2-layer WavLM unfreezes in stage 2 (index >= 12 - 11).
TRAIN_KW = dict(
    two_stage_training=True, epochs=2, stage1_epochs=1, lr=1e-3, weight_decay=1e-4,
    fusion_unfreeze_wavlm_layers=11, fusion_unfreeze_video_blocks=1, donate_buffers=False,
)


@dataclasses.dataclass
class _Batch:
    video: np.ndarray
    audio: np.ndarray
    labels: np.ndarray
    valid: np.ndarray
    aug: object = None

    @property
    def size(self):
        return int(self.valid.sum())


def _batches(n, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return [
        _Batch(
            video=rng.standard_normal((b, FRAMES, 3, SIZE, SIZE)).astype(np.float32),
            audio=(rng.standard_normal((b, 1, SAMPLES)) * 0.05).astype(np.float32),
            labels=rng.integers(0, CLASSES, b).astype(np.int32),
            valid=np.ones(b, bool),
        )
        for _ in range(n)
    ]


def _port_names(flax_params):
    """Flax parameter tree -> {flattened path: the port's parameter name}."""
    return {path: state_dict_key(("params", *path)) for path in flatten_dict(flax_params)}


class _NoDropout:
    """Stands in for `flax.linen.Dropout` where a rate is not configurable."""

    def __init__(self, rate=0.0, deterministic=None, **_):
        pass

    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(scope="module")
def one_step():
    """One stage-2 train step of the JAX trainer from its seeded init ->
    (initial state as the port's state dict, batch, what came out)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _NoDropout)
    try:
        trainer = jax_trainer.EmotionTrainer(
            _model_config(JaxModelConfig, "interpret"), JaxTrainConfig(**TRAIN_KW)
        )
        state = trainer.init_state()
        sd = flax_params_to_state_dict(
            flatten_dict({"params": jax.device_get(state.params),
                          "batch_stats": jax.device_get(state.batch_stats)})
        )
        batch = _batches(1, seed=3)[0]
        mask = jax_freeze.trainable_mask(state.params, trainer.mc, trainer.tc, 2)
        lrs = jax_freeze.lr_tree(state.params, trainer.mc, trainer.tc, 2, {})
        new_state, total, cls_loss, _, preds = trainer._train_step(
            state, jnp.asarray(batch.video), jnp.asarray(batch.audio),
            jnp.asarray(batch.labels), jnp.asarray(batch.valid), mask, lrs,
        )
        new_state = jax.device_get(new_state)
    finally:
        mp.undo()
    wd = TRAIN_KW["weight_decay"]
    params0 = flatten_dict(jax.device_get(state.params))
    grads = {  # zero moments before the step: mu = (1 - b1) * (g + wd * p) * mask
        path: np.asarray(mu) / (1.0 - ADAM_B1) - wd * np.asarray(params0[path])
        for path, mu in flatten_dict(new_state.opt_state.mu).items()
    }
    out = dict(
        loss=float(total), cls_loss=float(cls_loss), preds=np.asarray(preds),
        mask={state_dict_key(("params", *p)): v for p, v in flatten_dict(mask).items()},
        grads=adam_moments_to_state_dict(grads),
        mu=adam_moments_to_state_dict(flatten_dict(new_state.opt_state.mu)),
        nu=adam_moments_to_state_dict(flatten_dict(new_state.opt_state.nu)),
        count=int(new_state.opt_state.count),
        new=flax_params_to_state_dict(
            flatten_dict({"params": new_state.params, "batch_stats": new_state.batch_stats})
        ),
    )
    return sd, batch, out


def _port_trainer(**train_kw):
    trainer = EmotionTrainer(
        _model_config(ModelConfig, True), TrainConfig(**{**TRAIN_KW, **train_kw}), device="cpu"
    )
    return trainer, trainer.init_state()


def _tensors(batch):
    return tuple(torch.from_numpy(a) for a in (batch.video, batch.audio, batch.labels, batch.valid))


def test_one_train_step_matches_jax(one_step, monkeypatch):
    sd, batch, want = one_step
    monkeypatch.setattr(port_fusion, "dropout", lambda x, rate, generator: x)
    trainer, state = _port_trainer()
    state.model.load_state_dict(sd, strict=True)
    mask = trainer.trainable_mask(2)
    assert mask == {k: bool(v) for k, v in want["mask"].items()}
    frozen_before = {n: p.detach().clone() for n, p in state.params.items() if not mask[n]}

    total, cls_loss, _, preds = trainer.loss_and_grads(state, *_tensors(batch), mask)
    assert abs(float(total) - want["loss"]) <= 1e-5
    assert abs(float(cls_loss) - want["cls_loss"]) <= 1e-5
    np.testing.assert_array_equal(preds.numpy(), want["preds"])

    # Pre-optimizer gradients of every trainable leaf, relative to the leaf's largest entry.
    n_trainable = 0
    for name, p in state.params.items():
        if not mask[name]:
            assert p.grad is None, name  # frozen: no gradient at all
            continue
        n_trainable += 1
        ref = want["grads"][name].numpy()
        tol = 1e-4 * max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=tol, rtol=0, err_msg=name)
    assert any("encoder.layers.1.attention.q_proj" in n and mask[n] for n in mask)
    assert not any("encoder.layers.0." in n and mask[n] for n in mask)
    assert n_trainable > 20

    # BatchNorm running statistics: Flax's rule (biased batch variance).
    n_stats = 0
    for name, buf in state.batch_stats.items():
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            np.testing.assert_allclose(buf.numpy(), want["new"][name].numpy(), atol=1e-5, err_msg=name)
            assert not np.allclose(buf.numpy(), sd[name].numpy()), name  # it moved
    assert n_stats == 40

    # The optimizer fed the JAX step's own gradients lands on its parameters.
    live = {n: p for n, p in state.params.items() if n in state.opt_state.mu}
    assert set(live) == {n for n, m in mask.items() if m}
    lrs = trainer.lr_tree(2, {})
    masked_adam_update(state.opt_state, live, want["grads"], mask, lrs, False, 1e-4)
    assert state.opt_state.count == want["count"] == 1
    for name, p in live.items():
        np.testing.assert_allclose(p.detach().numpy(), want["new"][name].numpy(), atol=1e-6, err_msg=name)
        np.testing.assert_allclose(state.opt_state.mu[name].numpy(), want["mu"][name].numpy(), atol=1e-7)
        np.testing.assert_allclose(state.opt_state.nu[name].numpy(), want["nu"][name].numpy(), atol=1e-9)
    for name, before in frozen_before.items():
        assert torch.equal(state.params[name], before), name


def test_train_step_updates_in_place_and_eval_is_deterministic(one_step):
    sd, batch, _ = one_step
    trainer, state = _port_trainer()
    state.model.load_state_dict(sd, strict=True)
    mask, lrs = trainer.trainable_mask(2), trainer.lr_tree(2, {})
    before = {n: p.detach().clone() for n, p in state.params.items()}
    loss0 = float(trainer.eval_step(state, *_tensors(batch))[0])
    for _ in range(3):
        trainer.train_step(state, *_tensors(batch), mask, lrs)
    assert state.step == 3 and state.opt_state.count == 3
    for name, p in state.params.items():
        assert torch.equal(p, before[name]) != mask[name], name
    loss1 = float(trainer.eval_step(state, *_tensors(batch))[0])
    assert np.isfinite(loss1) and loss1 != loss0
    assert float(trainer.eval_step(state, *_tensors(batch))[0]) == loss1


@pytest.mark.parametrize("reset_opt", [False, True], ids=["keep", "reset"])
def test_masked_adam_update_matches_jax(reset_opt):
    rng = np.random.default_rng(11)
    shapes = {("a", "kernel"): (5, 3), ("a", "bias"): (3,), ("b", "c", "kernel"): (2, 4, 6),
              ("frozen", "scale"): (7,)}
    tree = lambda scale, positive=False: {  # noqa: E731
        p: (np.abs(rng.standard_normal(s)) if positive else rng.standard_normal(s)).astype(np.float32)
        * scale for p, s in shapes.items()
    }
    params, grads, mu, nu = tree(1.0), tree(0.1), tree(0.01), tree(1e-4, positive=True)
    mask = {p: float(p[0] != "frozen") for p in shapes}
    lrs = {p: 1e-3 if p[0] == "a" else 3e-5 for p in shapes}
    nest = lambda flat: unflatten_dict({p: jnp.asarray(v) for p, v in flat.items()})  # noqa: E731
    new_params, new_opt = jax_trainer.masked_adam_update(
        optax.ScaleByAdamState(count=jnp.asarray(3, jnp.int32), mu=nest(mu), nu=nest(nu)),
        nest(params), nest(grads), unflatten_dict(mask), unflatten_dict(lrs),
        np.float32(reset_opt), 1e-2, flat=False,
    )

    key = lambda p: state_dict_key(("params", *p))  # noqa: E731
    port_params = adam_moments_to_state_dict(params)
    state = AdamState(count=3, mu=adam_moments_to_state_dict(mu), nu=adam_moments_to_state_dict(nu))
    masked_adam_update(
        state, port_params, adam_moments_to_state_dict(grads),
        {key(p): v for p, v in mask.items()}, {key(p): v for p, v in lrs.items()},
        reset_opt, 1e-2,
    )
    assert state.count == int(new_opt.count) == (1 if reset_opt else 4)
    want_p = adam_moments_to_state_dict(flatten_dict(jax.device_get(new_params)))
    want_mu = adam_moments_to_state_dict(flatten_dict(jax.device_get(new_opt.mu)))
    want_nu = adam_moments_to_state_dict(flatten_dict(jax.device_get(new_opt.nu)))
    for name in port_params:
        np.testing.assert_allclose(port_params[name].numpy(), want_p[name].numpy(), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(state.mu[name].numpy(), want_mu[name].numpy(), atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(state.nu[name].numpy(), want_nu[name].numpy(), atol=1e-9, rtol=1e-6)
    frozen = key(("frozen", "scale"))
    np.testing.assert_array_equal(port_params[frozen].numpy(), params[("frozen", "scale")])


def test_masked_adam_update_counts_a_missing_gradient_as_zero():
    p = {"w": torch.ones(3)}
    state = AdamState.zeros(p)
    masked_adam_update(state, p, {"w": None}, {"w": 1.0}, {"w": 0.1}, False, 0.5)
    # g = 0 + 0.5 * 1: the first Adam step moves by lr * g / (|g| + eps)
    torch.testing.assert_close(p["w"], torch.full((3,), 0.9))


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("fusion", ["audio", "video", "xattn"])
@pytest.mark.parametrize("wavlm_stage", [1, 2])
def test_freeze_policy_matches_jax(fusion, stage, wavlm_stage):
    mc = dict(fusion=fusion, use_wavlm=True, num_classes=CLASSES, spec_augment=False,
              wavlm_geometry=dict(SMALL, num_hidden_layers=12, fused_attention=False,
                                  fused_conv=False))
    tc = dict(two_stage_training=True, wavlm_stage=wavlm_stage, fusion_unfreeze_video_blocks=2)
    jmc, jtc = JaxModelConfig(**mc), JaxTrainConfig(**tc)
    pmc, ptc = ModelConfig(**mc), TrainConfig(**tc)
    video = jnp.zeros((1, 2, 3, SIZE, SIZE))
    audio = jnp.zeros((1, 1, SAMPLES))
    inputs = {"audio": (audio,), "video": (video,)}.get(fusion, (video, audio))
    params = jax.eval_shape(
        lambda: jax_build_model(jmc).init(jax.random.PRNGKey(0), *inputs)
    )["params"]
    names = _port_names(params)
    scale = {"fusion": 0.7, "audio": 0.5, "video": 0.3}

    want = flatten_dict(jax_freeze.trainable_mask(params, jmc, jtc, stage))
    got = freeze.trainable_mask(names.values(), pmc, ptc, stage)
    assert {names[p]: bool(v) for p, v in want.items()} == got
    if fusion == "xattn":
        assert set(got.values()) == ({True} if stage == 0 else {True, False})

    want = flatten_dict(jax_freeze.lr_tree(params, jmc, jtc, stage, scale))
    assert {names[p]: v for p, v in want.items()} == freeze.lr_tree(names.values(), pmc, ptc, stage, scale)
    want = flatten_dict(jax_freeze.label_params(params))
    assert {names[p]: v for p, v in want.items()} == freeze.label_params(names.values())
    assert freeze.wavlm_frozen_prefix(pmc, ptc) == jax_freeze.wavlm_frozen_prefix(jmc, jtc)


@pytest.mark.parametrize(
    "mc,tc",
    [
        (dict(fusion="xattn", use_wavlm=True), dict(two_stage_training=True)),
        (dict(fusion="xattn", use_wavlm=True), dict(two_stage_training=True, fusion_unfreeze_wavlm_layers=0)),
        (dict(fusion="xattn", use_wavlm=True), dict(two_stage_training=False)),
        (dict(fusion="xattn", use_wavlm=False), dict(two_stage_training=True)),
        (dict(fusion="xattn", use_wavlm=True, wavlm_geometry=dict(num_hidden_layers=2)),
         dict(two_stage_training=True, fusion_unfreeze_wavlm_layers=11)),
    ],
)
def test_wavlm_frozen_prefix_matches_jax(mc, tc):
    assert freeze.wavlm_frozen_prefix(ModelConfig(**mc), TrainConfig(**tc)) == \
        jax_freeze.wavlm_frozen_prefix(JaxModelConfig(**mc), JaxTrainConfig(**tc))


@pytest.mark.parametrize("epochs_in_stage", [1, 5, 20])
def test_cosine_factor_matches_jax(epochs_in_stage):
    for e in range(epochs_in_stage + 2):
        assert freeze.cosine_factor(e, epochs_in_stage) == jax_freeze.cosine_factor(e, epochs_in_stage)


@pytest.mark.parametrize(
    "tc",
    [
        dict(two_stage_training=True, epochs=20, stage1_epochs=5),
        dict(two_stage_training=True, epochs=3, stage1_epochs=5),
        dict(two_stage_training=True, epochs=1),
        dict(two_stage_training=False, epochs=7),
        dict(two_stage_training=True, epochs=6, stage1_epochs=2, use_cosine_annealing=True),
        dict(two_stage_training=True, epochs=6, stage1_epochs=2, use_cosine_annealing=True,
             cosine_stage2_only=True),
    ],
)
def test_stage_plan_and_lr_scale_match_jax(tc):
    port = EmotionTrainer(_model_config(ModelConfig, True), TrainConfig(**tc), device="cpu")
    ref = jax_trainer.EmotionTrainer(_model_config(JaxModelConfig, False), JaxTrainConfig(**tc))
    assert port._stage_plan() == ref._stage_plan()
    assert port.mc.wavlm_fused_train_layers == ref.mc.wavlm_fused_train_layers == 2
    assert port.mc.wavlm_fused_train_conv == ref.mc.wavlm_fused_train_conv
    for stage, e, n in ((1, 0, 2), (1, 1, 2), (2, 0, 4), (2, 3, 4), (0, 2, 7)):
        assert port._epoch_lr_scale(stage, e, n) == ref._epoch_lr_scale(stage, e, n)


def test_train_config_has_the_jax_fields_and_defaults():
    want = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    got = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert got == want
    assert TrainConfig() == TrainConfig(**dataclasses.asdict(JaxTrainConfig()))


@pytest.mark.parametrize(
    "mc_kw,tc_kw,error",
    [
        ({}, dict(grad_accum=0), ValueError),
        ({}, dict(flat_optimizer="yes"), ValueError),
        ({}, dict(rng_impl="philox"), ValueError),
        ({}, dict(remat="some"), ValueError),
    ],
)
def test_trainer_refuses_what_is_not_ported_and_bad_values(mc_kw, tc_kw, error):
    """Bad values of the mode strings and of `grad_accum`, as the JAX trainer refuses them."""
    with pytest.raises(error):
        EmotionTrainer(_model_config(ModelConfig, True, **mc_kw), TrainConfig(**tc_kw), device="cpu")


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 8)).astype(np.float32)
    labels = rng.integers(0, 8, 6)
    for smoothing in (0.0, 0.1):
        want = jax_trainer._smoothed_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing)
        got = _smoothed_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits)))
    want = jax_trainer._nll_on_probs(jnp.asarray(probs), jnp.asarray(labels))
    got = _nll_on_probs(torch.from_numpy(probs), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("with_aug", [False, True])
def test_device_video_matches_jax(with_aug):
    rng = np.random.default_rng(6)
    video = rng.integers(0, 256, (2, 2, 3, 8, 8)).astype(np.uint8)
    aug = np.array([[1.2, 0.0], [0.8, 0.0]], np.float32) if with_aug else None
    ref = jax_trainer.EmotionTrainer(_model_config(JaxModelConfig, False), JaxTrainConfig())
    want = ref._device_video(jnp.asarray(video), None if aug is None else jnp.asarray(aug), None)
    port = EmotionTrainer(_model_config(ModelConfig, True), TrainConfig(), device="cpu")
    got = port._device_video(
        torch.from_numpy(video), None if aug is None else torch.from_numpy(aug), None
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    floats = torch.randn(1, 2, 3, 8, 8)
    assert port._device_video(floats, None, None) is floats
    noisy = port._device_video(
        torch.from_numpy(video), torch.tensor([[1.0, 0.1], [1.0, 0.0]]),
        torch.Generator().manual_seed(0),
    )
    clean = port._device_video(torch.from_numpy(video), torch.tensor([[1.0, 0.0], [1.0, 0.0]]), None)
    assert not torch.equal(noisy[0], clean[0]) and torch.equal(noisy[1], clean[1])


def test_batchnorm_train_mode_follows_flax_not_stock_torch():
    """Batch statistics in float32; the running variance takes the biased
    batch variance (stock torch.nn.BatchNorm2d takes the unbiased one)."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 3, 5, 5)).astype(np.float32))
    bn, stock = EvalBatchNorm2d(3), torch.nn.BatchNorm2d(3)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
        stock.load_state_dict(bn.state_dict())
    y = bn(x, train=True)
    torch.testing.assert_close(y, stock.train()(x), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bn.running_mean, stock.running_mean, atol=1e-6, rtol=0)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased, atol=1e-6, rtol=0)
    n = x.numel() / 3
    torch.testing.assert_close(stock.running_var, 0.9 + 0.1 * biased * n / (n - 1), atol=1e-6, rtol=0)
    assert int(bn.num_batches_tracked) == 1
    bn16 = EvalBatchNorm2d(3)
    bn16.load_state_dict(stock.state_dict())
    assert bn16.to(torch.bfloat16)(x.bfloat16(), train=True).dtype == torch.bfloat16


def test_rng_streams_are_named_seeded_and_independent():
    a, b, c = RngStreams(1), RngStreams(1), RngStreams(2)
    assert len(RNG_STREAMS) == 7 == len(jax_trainer._RNG_STREAMS)
    assert tuple(RNG_STREAMS) == tuple(jax_trainer._RNG_STREAMS)
    for name in RNG_STREAMS:
        x = torch.rand(4, generator=a.device(name))
        assert torch.equal(x, torch.rand(4, generator=b.device(name)))
        assert not torch.equal(x, torch.rand(4, generator=c.device(name)))
    assert a.kernel_seed() == b.kernel_seed() and 0 <= a.kernel_seed() < 2**31 - 1
    assert a.uniform("layerdrop") == b.uniform("layerdrop")
    assert not torch.equal(torch.rand(4, generator=a.device("dropout")),
                           torch.rand(4, generator=a.device("droppath")))


def test_dropout_and_drop_path_distributions():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500)
    y = dropout(x, 0.2, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1.25))
    assert dropout(x, 0.0, g) is x and dropout(x, 1.0, g).abs().sum() == 0
    assert torch.equal(dropout(x, 0.3, torch.Generator().manual_seed(5)),
                       dropout(x, 0.3, torch.Generator().manual_seed(5)))

    z = drop_path(torch.ones(4000, 3, 2), 0.1, True, g)
    rows = z.flatten(1)
    assert ((rows == 0).all(dim=1) | torch.isclose(rows, torch.tensor(1 / 0.9)).all(dim=1)).all()
    assert abs((rows[:, 0] != 0).float().mean().item() - 0.9) < 0.02
    assert drop_path(x, 0.1, False, g) is x and drop_path(x, 0.0, True, g) is x
    assert drop_path(x, 1.0, True, g).abs().sum() == 0

    gates = [modality_dropout_mask(g, 0.2, 0.6) for _ in range(400)]
    keep_a = np.mean([float(a) for a, _ in gates])
    keep_v = np.mean([float(v) for _, v in gates])
    assert abs(keep_a - 0.8) < 0.08 and abs(keep_v - 0.4) < 0.08
    assert {float(a) for a, _ in gates} <= {0.0, 1.0}


def _small_wavlm(**overrides):
    model = WavLMModel(WavLMConfig(**{**SMALL, **NO_NOISE, **overrides}))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return model


def test_span_mask_coverage_and_determinism():
    model = _small_wavlm(mask_time_prob=0.05, mask_time_length=10)
    with torch.no_grad():
        model.masked_spec_embed.fill_(7.0)
        x = torch.zeros(64, 400, 32)
        masked = model._mask_time(x, torch.Generator().manual_seed(1))
        again = model._mask_time(x, torch.Generator().manual_seed(1))
    assert torch.equal(masked, again)
    rows = masked[..., 0] == 7.0
    assert torch.equal(rows, (masked == 7.0).all(dim=-1))
    # a frame is covered unless none of the 10 positions ending at it starts a span
    assert abs(rows.float().mean().item() - (1 - 0.95**10)) < 0.03
    starts = rows[:, 1:] & ~rows[:, :-1]
    runs = rows.sum().item() / max(starts.sum().item() + rows[:, 0].sum().item(), 1)
    assert runs >= 10.0  # every span is at least mask_time_length long


def test_layerdrop_rate_and_determinism():
    model = _small_wavlm(num_hidden_layers=4, layerdrop=0.5, fused_attention=True, fused_conv=False)
    wav = torch.randn(1, 800, generator=torch.Generator().manual_seed(2)) * 0.1

    def runs(seed):
        rng, out = RngStreams(seed), []
        with torch.no_grad():
            for _ in range(40):
                model(wav, train=True, rng=rng)
                out.append(tuple(model.layers_run))
        return out

    first = runs(3)
    assert first == runs(3) and first != runs(4)
    assert all(r[0] == 0 for r in first)  # layer 0 always runs
    kept = np.mean([len(r) - 1 for r in first]) / 3
    assert abs(kept - 0.5) < 0.15
    with torch.no_grad():
        model(wav)
    assert model.layers_run == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="rng"):
        model(wav, train=True)


def test_train_forward_never_reads_cached_kernel_operands():
    model = _small_wavlm(fused_attention=True, fused_conv=False)
    layer = model.encoder.layers[1]
    model.cache_kernel_operands()
    cached = layer._k1_operands
    with torch.no_grad():
        assert layer._k1_operands_for(train=False) is cached
        assert layer._k1_operands_for(train=True) is not cached
    assert layer._k1_operands_for(train=False) is not cached  # autograd records the weights
    layer.requires_grad_(False)
    assert layer._k1_operands_for(train=False) is cached


def test_two_stage_fit_writes_a_checkpoint_the_runner_loads(tmp_path):
    trainer = EmotionTrainer(
        _model_config(ModelConfig, True),
        TrainConfig(**{**TRAIN_KW, "output_dir": str(tmp_path), "use_cosine_annealing": True}),
        device="cpu",
    )
    train, val = _batches(2, seed=8), _batches(1, seed=9)
    val[0].valid[-1] = False  # a padded sample: not counted
    rows = []
    state, result = trainer.fit(train, val, test_loader=val, log_fn=rows.append)
    assert [r["stage"] for r in rows] == [1, 2]
    assert state.step == 4 and state.opt_state.count == 2  # Adam count reset at the flip
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["val/loss"]) for r in rows)
    assert 0.0 <= result["best_val_f1"] <= 1.0 and "test" in result
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 2

    ckpt = tmp_path / "best_xattn.pt"
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert set(saved) == {"model", "val_f1", "config"}
    assert "wavlm_fused_train_layers" not in saved["config"]
    runner = TorchModelRunner(ckpt, num_classes=CLASSES, batch_buckets=(4,), device="cpu")
    batch = val[0]
    assert runner.predict_probs(batch.video, batch.audio).shape == (B, CLASSES)
    # The state after the last epoch, saved the same way, serves what the trainer evaluates.
    trainer.save_checkpoint(tmp_path / "last.pt", state, 0.0)
    runner = TorchModelRunner(tmp_path / "last.pt", num_classes=CLASSES, batch_buckets=(4,),
                              device="cpu")
    with torch.no_grad():
        logits, _ = trainer._apply(torch.from_numpy(batch.video), torch.from_numpy(batch.audio),
                                   False, None)
    np.testing.assert_allclose(
        runner.predict_probs(batch.video, batch.audio), torch.softmax(logits, dim=1).numpy(),
        atol=1e-5,
    )


def test_bf16_compute_keeps_float32_parameters(one_step):
    sd, batch, want = one_step
    trainer = EmotionTrainer(
        _model_config(ModelConfig, True, compute_dtype="bfloat16"), TrainConfig(**TRAIN_KW),
        device="cpu",
    )
    state = trainer.init_state()
    state.model.load_state_dict(sd, strict=True)
    mask, lrs = trainer.trainable_mask(2), trainer.lr_tree(2, {})
    total, *_ = trainer.train_step(state, *_tensors(batch), mask, lrs)
    assert torch.isfinite(total) and abs(float(total) - want["loss"]) < 0.2
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in state.params.values())
    q = "audio_model.wavlm.encoder.layers.1.attention.q_proj.weight"
    assert not torch.equal(state.params[q], sd[q])
    # frozen casts are made once per version of the parameter
    frozen = "audio_model.wavlm.encoder.layers.0.attention.q_proj.weight"
    cast = trainer._cast_cache[frozen][1]
    trainer.eval_step(state, *_tensors(batch))
    assert trainer._cast_cache[frozen][1] is cast and cast.dtype == torch.bfloat16
    assert trainer._cast_cache[q][0] == state.params[q]._version


def test_mask_changed_in_place_takes_effect_and_drops_stale_casts(one_step):
    sd, batch, _ = one_step
    trainer = EmotionTrainer(
        _model_config(ModelConfig, True, compute_dtype="bfloat16"), TrainConfig(**TRAIN_KW),
        device="cpu",
    )
    state = trainer.init_state()
    state.model.load_state_dict(sd, strict=True)
    q = "audio_model.wavlm.encoder.layers.1.attention.q_proj.weight"
    mask, lrs = trainer.trainable_mask(1), trainer.lr_tree(2, {})
    assert not mask[q]
    trainer.train_step(state, *_tensors(batch), mask, lrs)
    assert not state.params[q].requires_grad and torch.equal(state.params[q], sd[q])
    assert q in trainer._cast_cache  # frozen in this stage: its cast is kept
    mask[q] = True  # the same dict, changed in place
    trainer.train_step(state, *_tensors(batch), mask, lrs)
    assert state.params[q].requires_grad and not torch.equal(state.params[q], sd[q])
    assert q not in trainer._cast_cache  # trainable: cast per step, nothing kept


# ---------------------------------------------------------------------------
# the other model families
# ---------------------------------------------------------------------------

MEL_KW = dict(
    fusion="gated", use_wavlm=False, use_resnet_audio=False, num_classes=CLASSES,
    spec_augment=False,
)
SINGLE_STAGE = dict(two_stage_training=False, epochs=1, lr=1e-3, weight_decay=1e-4,
                    donate_buffers=False)


def _one_family_step_against_jax(monkeypatch, overrides):
    """One deterministic single-stage step of the family `MEL_KW + overrides`
    through the JAX `_train_step` and through the port, from the same
    converted state and batch: the waveform goes through the log-mel front
    end inside the step on both sides.  The modality dropout (0.2 in both
    packages, not configurable) and the MLP and pooler dropouts are patched
    to the identity.  Loss 1e-5; pre-optimizer gradients 1e-4 of each leaf's
    largest entry, and never under 1e-6 (a conv bias in front of a train-mode
    BatchNorm has a gradient of exactly zero, and both sides return rounding
    noise of about 1e-7 there); BatchNorm statistics 1e-4 relative (the mel is in dB, so
    the first layer's variances are of order 1e3).  -> the number of
    BatchNorm statistics compared."""
    from multimodalemotionrecognition_tpu.models import fusion as jax_fusion
    from multimodalemotionrecognition_torch.models import temporal as port_temporal

    kw = {**MEL_KW, **overrides}
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(jax_fusion, "modality_dropout_mask",
                        lambda rng, a, v: (jnp.float32(1.0), jnp.float32(1.0)))
    jtrainer = jax_trainer.EmotionTrainer(JaxModelConfig(**kw), JaxTrainConfig(**SINGLE_STAGE))
    state = jtrainer.init_state()
    sd = flax_params_to_state_dict(
        flatten_dict({"params": jax.device_get(state.params),
                      "batch_stats": jax.device_get(state.batch_stats)}))
    batch = _batches(1, seed=5)[0]
    batch.audio = np.random.default_rng(6).standard_normal((B, 1, 8000)).astype(np.float32) * 0.05
    jmask = jax_freeze.trainable_mask(state.params, jtrainer.mc, jtrainer.tc, 0)
    jlrs = jax_freeze.lr_tree(state.params, jtrainer.mc, jtrainer.tc, 0, {})
    new_state, total, cls_loss, _, preds = jtrainer._train_step(
        state, jnp.asarray(batch.video), jnp.asarray(batch.audio),
        jnp.asarray(batch.labels), jnp.asarray(batch.valid), jmask, jlrs,
    )
    new_state = jax.device_get(new_state)
    params0 = flatten_dict(jax.device_get(state.params))
    want_grads = adam_moments_to_state_dict({
        path: np.asarray(mu) / (1.0 - ADAM_B1) - 1e-4 * np.asarray(params0[path])
        for path, mu in flatten_dict(new_state.opt_state.mu).items()
    })
    want_stats = flax_params_to_state_dict(flatten_dict({"batch_stats": new_state.batch_stats}))

    identity = lambda x, rate, generator: x  # noqa: E731
    monkeypatch.setattr(port_fusion, "dropout", identity)
    monkeypatch.setattr(port_temporal, "dropout", identity)
    trainer = EmotionTrainer(ModelConfig(**kw), TrainConfig(**SINGLE_STAGE), device="cpu")
    pstate = trainer.init_state()
    pstate.model.load_state_dict(sd, strict=True)
    if hasattr(pstate.model, "modality_dropout"):
        pstate.model.modality_dropout = (0.0, 0.0)
    mask = trainer.trainable_mask(0)
    assert all(mask.values()) and set(mask) == {
        state_dict_key(("params", *p)) for p in flatten_dict(jmask)}
    ptotal, pcls, _, ppreds = trainer.loss_and_grads(pstate, *_tensors(batch), mask)
    assert abs(float(ptotal) - float(total)) <= 1e-5
    assert abs(float(pcls) - float(cls_loss)) <= 1e-5
    np.testing.assert_array_equal(ppreds.numpy(), np.asarray(preds))
    assert set(pstate.params) == set(want_grads)
    for name, p in pstate.params.items():
        ref = want_grads[name].numpy()
        tol = 1e-4 * max(np.abs(ref).max(), 1e-2)
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=tol, rtol=0, err_msg=name)
    n_stats = 0
    for name, buf in pstate.batch_stats.items():
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            np.testing.assert_allclose(buf.numpy(), want_stats[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    return n_stats


def test_one_gated_mel_train_step_matches_jax(monkeypatch):
    """Gated fusion + `AudioCNN` (see `_one_family_step_against_jax`)."""
    n_stats = _one_family_step_against_jax(monkeypatch, {})
    assert n_stats == 2 * (3 + 20)  # AudioCNN's three norms, ResNet18's twenty


# The families `EmotionTrainer` trains beside the flagship and gated: each is
# held against the JAX trainer here; a family with no case here is not checked.
FAMILY_STEPS = {
    "late": (dict(fusion="late"), 2 * (3 + 20)),
    "concat": (dict(fusion="concat"), 2 * (3 + 20)),
    "audio_resnet18": (dict(fusion="audio", use_resnet_audio=True), 2 * 20),
    "video_attn_pool": (dict(fusion="video", temporal_pooling="attn"), 2 * 20),
    "xattn_mel": (dict(fusion="xattn", xattn_d_model=32, xattn_attn_dropout=0.0,
                       xattn_stochastic_depth=0.0), 2 * (3 + 20)),
}


@pytest.mark.parametrize("family", list(FAMILY_STEPS))
def test_one_train_step_of_each_family_matches_jax(monkeypatch, family):
    """late (NLL on probabilities), concat, a single-modality audio model on
    the non-residual `AudioResNet18`, a video model with the attention
    pooler, and cross-attention over the mel branch."""
    overrides, want_stats = FAMILY_STEPS[family]
    assert _one_family_step_against_jax(monkeypatch, overrides) == want_stats


@pytest.mark.parametrize(
    "overrides",
    [dict(fusion="late", use_resnet_audio=False), dict(fusion="concat", use_resnet_audio=False),
     dict(fusion="audio", use_resnet_audio=True), dict(fusion="video", temporal_pooling="attn"),
     dict(fusion="xattn", use_resnet_audio=False, xattn_d_model=32, spec_augment=True)],
    ids=["late", "concat", "audio_resnet18", "video", "xattn_mel_specaugment"],
)
def test_every_family_takes_train_steps(overrides):
    """A few real steps per family: finite losses, parameters and BatchNorm
    statistics that move, an eval step that repeats."""
    mc = ModelConfig(**{**MEL_KW, **overrides})
    trainer = EmotionTrainer(mc, TrainConfig(**SINGLE_STAGE), device="cpu")
    state = trainer.init_state()
    batch = _batches(1, seed=7)[0]
    batch.audio = np.random.default_rng(8).standard_normal((B, 1, 8000)).astype(np.float32) * 0.05
    mask, lrs = trainer.trainable_mask(0), trainer.lr_tree(0, {})
    before = {n: p.detach().clone() for n, p in state.params.items()}
    losses = [float(trainer.train_step(state, *_tensors(batch), mask, lrs)[0]) for _ in range(2)]
    assert np.isfinite(losses).all() and state.opt_state.count == 2
    moved = [n for n, p in state.params.items() if not torch.equal(p, before[n])]
    assert len(moved) > 0.9 * len(before)
    total, _, contrastive, preds = trainer.eval_step(state, *_tensors(batch))
    assert np.isfinite(float(total)) and float(contrastive) == 0.0 and preds.shape == (B,)
    assert float(trainer.eval_step(state, *_tensors(batch))[0]) == float(total)
    if mc.fusion == "late":  # NLL on probabilities: the output rows sum to 1
        with torch.no_grad():
            out, _ = trainer._apply(torch.from_numpy(batch.video),
                                    trainer._audio_features(torch.from_numpy(batch.audio)), False,
                                    None)
        np.testing.assert_allclose(out.sum(dim=1).numpy(), 1.0, atol=1e-5)
