"""The rest of the port's trainer against the JAX package, on the CPU: the
CLIP alignment loss, gradient accumulation, `convert/pretrained.py`, the
branch warm start, resume checkpoints and the test confusion matrix.

Small geometry, as `tests/test_torch_trainer.py`: mel models on 4 frames of
32 x 32 and 8,000 samples, batch 4, and the `SMALL` WavLM.  JAX and the port
get the same weights through `flax_params_to_state_dict` and the same numpy
inputs.  Every dropout a config cannot turn off (the head MLPs' 0.2, the
gated mode's modality dropout) is patched to the identity on both sides, so
a step is deterministic.

Gradient accumulation is compared before the optimizer, never on post-Adam
parameters: Adam turns the rounding of a gradient that is numerically zero
into a step of the full learning rate (F0 in ROADMAP queue 3).

"""

import warnings

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from transformers import WavLMModel as HFWavLMModel

from multimodalemotionrecognition_tpu.config import ModelConfig as JaxModelConfig
from multimodalemotionrecognition_tpu.config import TrainConfig as JaxTrainConfig
from multimodalemotionrecognition_tpu.convert import pretrained as jax_pretrained
from multimodalemotionrecognition_tpu.models import fusion as jax_fusion
from multimodalemotionrecognition_tpu.train import freeze as jax_freeze
from multimodalemotionrecognition_tpu.train import trainer as jax_trainer
from multimodalemotionrecognition_tpu.utils.metrics import confusion_matrix as jax_confusion_matrix
from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig
from multimodalemotionrecognition_torch.convert import pretrained
from multimodalemotionrecognition_torch.convert.checkpoint import load_reference_checkpoint
from multimodalemotionrecognition_torch.convert.params import (
    adam_moments_to_state_dict,
    flax_params_to_state_dict,
    state_dict_key,
)
from multimodalemotionrecognition_torch.models import fusion as port_fusion
from multimodalemotionrecognition_torch.models import temporal as port_temporal
from multimodalemotionrecognition_torch.models import wavlm as port_wavlm
from multimodalemotionrecognition_torch.ops.stochastic import RNG_STREAMS
from multimodalemotionrecognition_torch.train import EmotionTrainer
from multimodalemotionrecognition_torch.train.trainer import ADAM_B1
from multimodalemotionrecognition_torch.utils.metrics import confusion_matrix

from tests.test_pretrained_ingest import _raw_torchvision_sd
from tests.test_torch_trainer import (
    B,
    CLASSES,
    MEL_KW,
    SINGLE_STAGE,
    TRAIN_KW,
    _batches,
    _NoDropout,
    _tensors,
)
from tests.test_wavlm_fused_attn import SMALL
from tests.test_wavlm_parity import _hf_config
from tests.torch_ref import RefVideoNet

WD = SINGLE_STAGE["weight_decay"]
POS_CONV = "wavlm.encoder.pos_conv_embed.conv.weight"


def _deterministic(monkeypatch):
    """The dropouts no config reaches (the heads' 0.2, the gated mode's
    modality dropout), off in both packages."""
    identity = lambda x, rate, generator: x  # noqa: E731
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(jax_fusion, "modality_dropout_mask",
                        lambda rng, a, v: (jnp.float32(1.0), jnp.float32(1.0)))
    for module in (port_fusion, port_temporal, port_wavlm):
        monkeypatch.setattr(module, "dropout", identity)


def _with_kernels(kw, fused):
    """A WavLM config with `fused_attention` set: the port's encoder layers
    through the kernel wrapper (its plain version on the CPU), JAX's modular."""
    if "wavlm_geometry" not in kw:
        return kw
    return dict(kw, wavlm_geometry=dict(kw["wavlm_geometry"], fused_attention=fused))


def _mel_batch(seed, b=B):
    batch = _batches(1, seed=seed, b=b)[0]
    batch.audio = np.random.default_rng(seed + 100).standard_normal((b, 1, 8000)).astype(np.float32) * 0.05
    return batch


def _jax_state_dict(state):
    return flax_params_to_state_dict(flatten_dict(
        {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}))


def _port_trainer(kw, tc_kw, sd):
    trainer = EmotionTrainer(ModelConfig(**kw), TrainConfig(**tc_kw), device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(sd, strict=True)
    if hasattr(state.model, "modality_dropout"):
        state.model.modality_dropout = (0.0, 0.0)
    return trainer, state


def _assert_grads(params, want, rel, mask=None):
    """Each trainable leaf's gradient within `rel` of its largest entry; a
    leaf whose gradient is exactly zero in the math (a conv bias in front of
    a train-mode BatchNorm) holds rounding noise of ~1e-7 on both sides, so
    the bound never goes under 1e-6.  A frozen leaf has no `.grad`; neither
    has one that takes no part in the step (WavLM's `masked_spec_embed`
    with masking off), whose JAX gradient must then be zero.  -> the number
    of leaves with a gradient."""
    assert set(params) == set(want)
    n = 0
    for name, p in params.items():
        if mask is not None and not mask[name]:
            assert p.grad is None, name
            continue
        ref = want[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        n += p.grad is not None
        tol = max(rel * np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=name)
    return n


def _assert_stats(stats, want):
    """BatchNorm running statistics, 1e-4 relative (the mel is in dB)."""
    n = 0
    for name, buf in stats.items():
        if name.endswith(("running_mean", "running_var")):
            n += 1
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    return n


def _step_against_jax(monkeypatch, overrides, accum=1, n_stats=2 * (3 + 20)):
    """One deterministic single-stage step of `MEL_KW + overrides` with
    `grad_accum=accum` through the JAX `_train_step` and through the port's
    `train_step`, from the same converted state and batch.  Checks the
    freeze mask, the three losses (1e-5), the predictions, the
    pre-optimizer gradients (1e-4 of each leaf's largest entry) and the
    `n_stats` BatchNorm statistics.  -> (port trainer, port state, JAX
    results)."""
    _deterministic(monkeypatch)
    kw = {**MEL_KW, **overrides}
    tc_kw = {**SINGLE_STAGE, "grad_accum": accum}
    jtrainer = jax_trainer.EmotionTrainer(JaxModelConfig(**_with_kernels(kw, False)),
                                          JaxTrainConfig(**tc_kw))
    jstate = jtrainer.init_state()
    sd = _jax_state_dict(jstate)
    batch = _mel_batch(5)
    jmask = jax_freeze.trainable_mask(jstate.params, jtrainer.mc, jtrainer.tc, 0)
    jlrs = jax_freeze.lr_tree(jstate.params, jtrainer.mc, jtrainer.tc, 0, {})
    new, total, cls_loss, ctr, preds = jtrainer._train_step(
        jstate, *(jnp.asarray(a) for a in (batch.video, batch.audio, batch.labels, batch.valid)),
        jmask, jlrs,
    )
    new = jax.device_get(new)
    params0 = flatten_dict(jax.device_get(jstate.params))
    want = dict(
        total=float(total), cls=float(cls_loss), ctr=float(ctr), preds=np.asarray(preds),
        grads=adam_moments_to_state_dict({  # zero moments before: mu = (1 - b1) * (g + wd * p)
            path: np.asarray(mu) / (1.0 - ADAM_B1) - WD * np.asarray(params0[path])
            for path, mu in flatten_dict(new.opt_state.mu).items()}),
        mask={state_dict_key(("params", *p)): bool(v) for p, v in flatten_dict(jmask).items()},
        new=_jax_state_dict(new), sd=sd,
    )

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the grad_accum + alignment warning has its own test
        trainer, state = _port_trainer(_with_kernels(kw, True), tc_kw, sd)
    mask, lrs = trainer.trainable_mask(0), trainer.lr_tree(0, {})
    assert mask == want["mask"]
    ptotal, pcls, pctr, ppreds = trainer.train_step(state, *_tensors(batch), mask, lrs)
    for got, key in ((ptotal, "total"), (pcls, "cls"), (pctr, "ctr")):
        assert abs(float(got) - want[key]) <= 1e-5, (key, float(got), want[key])
    np.testing.assert_array_equal(ppreds.numpy(), want["preds"])
    assert _assert_grads(state.params, want["grads"], 1e-4, mask) >= 4
    assert _assert_stats(state.batch_stats, want["new"]) == n_stats
    return trainer, state, want


@pytest.mark.parametrize("fusion", ["gated", "concat"])
def test_alignment_loss_step_matches_jax(monkeypatch, fusion):
    """(a) `fusion_align_mode="clip"`: total = cls + 0.1 * InfoNCE, the
    alignment module's gradients, and the parameters after the step.  Those
    are compared (1e-6) where the step's gradient with weight decay, g, is
    above 1e-5: the first Adam step moves a parameter by lr * g / (|g| +
    eps), whose slope lr * eps / (|g| + eps)^2 turns the gradients' allowed
    difference into a larger one as |g| falls (10 per unit at |g| = 1e-6).
    Most elements of the alignment module are above it."""
    trainer, state, want = _step_against_jax(monkeypatch, dict(fusion=fusion,
                                                               fusion_align_mode="clip"))
    assert 0.5 < want["ctr"] < 5.0  # InfoNCE over 4 pairs: near ln 4
    assert abs(want["total"] - want["cls"] - 0.1 * want["ctr"]) < 1e-6
    compared = total = 0
    for name, p in state.params.items():
        g = want["grads"][name].numpy() + WD * want["sd"][name].numpy()
        sure = np.abs(g) > 1e-5
        compared += int(sure.sum())
        total += g.size
        if name.startswith("semantic_alignment."):
            assert sure.mean() > 0.5, name  # the alignment module takes part
        np.testing.assert_allclose(p.detach().numpy()[sure], want["new"][name].numpy()[sure],
                                   atol=1e-6, rtol=0, err_msg=name)
    assert any(n.startswith("semantic_alignment.") for n in state.params)
    assert compared > 0.3 * total, (compared, total)


def test_alignment_under_accumulation_matches_jax(monkeypatch):
    """(c) F2: with grad_accum=2 InfoNCE sees each microbatch's negatives
    and the two losses combine as their mean, the BatchNorm statistics
    update once per microbatch; against the JAX trainer's microbatch scan."""
    _, _, want = _step_against_jax(monkeypatch, dict(fusion="gated", fusion_align_mode="clip"),
                                   accum=2)
    assert abs(want["total"] - want["cls"] - 0.1 * want["ctr"]) < 1e-6


def test_alignment_under_accumulation_is_the_microbatch_mean_and_warns(monkeypatch):
    """(c) The port alone: the contrastive loss of an accum-2 step is the mean
    of the two microbatches' InfoNCE, and the trainer warns at construction."""
    _deterministic(monkeypatch)
    mc = ModelConfig(**MEL_KW, fusion_align_mode="clip")
    with pytest.warns(UserWarning, match="each microbatch's negatives"):
        trainer = EmotionTrainer(mc, TrainConfig(**SINGLE_STAGE, grad_accum=2), device="cpu")
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*microbatch")
        EmotionTrainer(mc, TrainConfig(**SINGLE_STAGE), device="cpu")
        EmotionTrainer(ModelConfig(**MEL_KW), TrainConfig(**SINGLE_STAGE, grad_accum=2), device="cpu")
    state = trainer.init_state()
    state.model.modality_dropout = (0.0, 0.0)
    video, audio, labels, valid = _tensors(_mel_batch(7))
    mel = trainer._audio_features(audio)
    with torch.no_grad():  # train-mode BatchNorm normalises with the microbatch's own statistics
        per_micro = [float(state.model(video[i:i + 2], mel[i:i + 2], True, state.rng,
                                       return_aux=True)[1]["alignment_loss"]) for i in (0, 2)]
    _, _, contrastive, _ = trainer.loss_and_grads(state, video, audio, labels, valid,
                                                   trainer.trainable_mask(0))
    assert abs(float(contrastive) - np.mean(per_micro)) < 1e-6, (float(contrastive), per_micro)


def test_accumulated_gradients_match_jax(monkeypatch):
    """(b) grad_accum in {2, 4} on batches whose microbatches differ: the
    port's accumulated `.grad` against the sum of the JAX gradients of each
    microbatch, taken through the JAX trainer's own `_apply` and `_losses`
    with the full batch's valid count, the BatchNorm statistics chained from
    one microbatch to the next; 1e-5 of each gradient's largest entry.

    The model is the late model's audio branch alone (`fusion="audio"`, mean
    pooling: no stochastic op in its train forward).  Late fusion itself
    adds ResNet18 in train mode, whose gradient at these sizes (32 x 32
    frames, microbatches of 2 to 4 clips) is chaotic: scaling the input by
    1 + 1e-6 moves the port's own layer-2 gradients by up to 10 % of their
    largest entry, so two float32 implementations part there by as much
    (ROADMAP queue 3).  The late model takes the accumulation check that
    involves the port alone: accum 2 on [m, m] against accum 1 on m, where
    both run the same shapes, within 1e-5."""
    _deterministic(monkeypatch)
    kw = {**MEL_KW, "fusion": "audio", "temporal_pooling": "mean"}
    jtrainer = jax_trainer.EmotionTrainer(JaxModelConfig(**kw), JaxTrainConfig(**SINGLE_STAGE))
    jstate = jtrainer.init_state()
    sd = _jax_state_dict(jstate)
    rngs = {name: jax.random.PRNGKey(i) for i, name in enumerate(RNG_STREAMS)}

    @jax.jit
    def micro(params, bstats, video, audio_wav, labels, valid, denom):
        def loss(p):
            out, aux, upd = jtrainer._apply({"params": p, "batch_stats": bstats}, video,
                                            jtrainer._audio_features(audio_wav), True, rngs,
                                            mutable=True)
            return jtrainer._losses(out, aux, labels, valid, denom=denom)[0], upd
        return jax.grad(loss, has_aux=True)(params)

    for accum, b, seed in ((2, 4, 11), (4, 8, 12)):  # microbatches of 2 clips: one trace
        batch = _mel_batch(seed, b=b)
        batch.valid[-1] = False  # a padded clip: the full batch's count is b - 1
        mb = b // accum
        denom = jnp.float32(batch.valid.sum())
        grads, bstats = None, jstate.batch_stats
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            g, upd = micro(jstate.params, bstats, *(jnp.asarray(a[rows]) for a in (
                batch.video, batch.audio, batch.labels, batch.valid)), denom)
            bstats = upd["batch_stats"]
            grads = g if grads is None else jax.tree_util.tree_map(jnp.add, grads, g)
        want = adam_moments_to_state_dict(flatten_dict(jax.device_get(grads)))
        stats = flax_params_to_state_dict(flatten_dict({"batch_stats": jax.device_get(bstats)}))

        trainer, state = _port_trainer(kw, {**SINGLE_STAGE, "grad_accum": accum}, sd)
        total, cls_loss, _, preds = trainer.loss_and_grads(state, *_tensors(batch),
                                                           trainer.trainable_mask(0))
        assert preds.shape == (b,) and float(total) == float(cls_loss)
        _assert_grads(state.params, want, 1e-5)
        assert _assert_stats(state.batch_stats, stats) == 2 * 3

    late = {**MEL_KW, "fusion": "late", "temporal_pooling": "mean"}
    sd = EmotionTrainer(ModelConfig(**late), TrainConfig(**SINGLE_STAGE),
                        device="cpu").init_state().model.state_dict()
    m = _tensors(_mel_batch(13))
    grads = {}
    for accum, inputs in ((1, m), (2, [torch.cat([x, x]) for x in m])):
        trainer, state = _port_trainer(late, {**SINGLE_STAGE, "grad_accum": accum}, sd)
        trainer.loss_and_grads(state, *inputs, trainer.trainable_mask(0))
        grads[accum] = {n: p.grad.numpy() for n, p in state.params.items()}
    for name, g in grads[1].items():
        np.testing.assert_allclose(grads[2][name], g, atol=1e-5 * np.abs(g).max(), rtol=0,
                                   err_msg=name)


def test_grad_accum_refuses_a_batch_it_does_not_divide():
    trainer = EmotionTrainer(ModelConfig(**MEL_KW), TrainConfig(**SINGLE_STAGE, grad_accum=3),
                             device="cpu")
    state = trainer.init_state()
    with pytest.raises(ValueError, match="not divisible by grad_accum 3"):
        trainer.loss_and_grads(state, *_tensors(_mel_batch(3)), trainer.trainable_mask(0))


# ---------------------------------------------------------------------------
# pretrained conversion and the warm start
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def raw_backbones():
    """Raw state dicts in the layouts the converters read: a random-init HF
    `WavLMModel` at the SMALL geometry (its positional conv under weight-norm
    parametrizations) and a torchvision resnet18 dict with its `fc.*` head."""
    torch.manual_seed(0)
    hf = HFWavLMModel(_hf_config(SMALL)).eval()
    return {"wavlm-base": hf.state_dict(),
            "resnet18": _raw_torchvision_sd(RefVideoNet(num_classes=8).eval())}


@pytest.fixture(scope="module")
def branch_ckpts(raw_backbones, tmp_path_factory):
    """The raw dicts on disk and their branch checkpoints written by the
    port's `convert_pretrained` -> {arch: (raw path, branch path)}."""
    out = {}
    tmp = tmp_path_factory.mktemp("pretrained")
    for arch, raw in raw_backbones.items():
        torch.save(raw, tmp / f"raw_{arch}.pth")
        out[arch] = (tmp / f"raw_{arch}.pth",
                     pretrained.convert_pretrained(arch, tmp / f"raw_{arch}.pth",
                                                   tmp / f"port_{arch}.pt"))
    return out


def test_pretrained_conversion_matches_jax(raw_backbones, branch_ckpts, tmp_path):
    """(d) The same keys and arrays as the JAX module, in memory and on disk;
    the positional conv's weight-norm merge within 1e-6 (the port takes the
    norm in float64)."""
    raw_hf, raw_tv = raw_backbones["wavlm-base"], raw_backbones["resnet18"]
    assert any("parametrizations.weight.original0" in k for k in raw_hf)
    assert "fc.weight" in raw_tv
    for port_fn, jax_fn, raw in (
        (pretrained.hf_wavlm_to_audio_branch, jax_pretrained.hf_wavlm_to_audio_branch, raw_hf),
        (pretrained.torchvision_resnet_to_video_branch,
         jax_pretrained.torchvision_resnet_to_video_branch, raw_tv),
    ):
        got, want = port_fn(raw), jax_fn(raw)
        assert list(got) == list(want)
        assert all(got[k] is want[k] for k in got)
    prefixed = {f"wavlm.{k}": v for k, v in raw_hf.items()}
    prefixed["lm_head.weight"] = torch.zeros(3, 3)
    assert list(pretrained.hf_wavlm_to_audio_branch(prefixed)) == list(
        jax_pretrained.hf_wavlm_to_audio_branch(prefixed))

    for arch, (raw_path, port_path) in branch_ckpts.items():
        jax_path = jax_pretrained.convert_pretrained(arch, raw_path, tmp_path / f"jax_{arch}.pt")
        (got, got_cfg), (want, want_cfg) = (load_reference_checkpoint(p) for p in (port_path, jax_path))
        assert got_cfg == want_cfg and list(got) == list(want)
        for key in got:
            assert got[key].dtype == want[key].dtype, key
            tol = 1e-6 if key == POS_CONV else 0.0
            assert (got[key].double() - want[key].double()).abs().max().item() <= tol, key
        assert not any(k.startswith("fc.") or "parametrizations" in k for k in got)

    # A .safetensors file reads the same state dict in both.
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in raw_tv.items()}, str(tmp_path / "rn.safetensors"))
    got = pretrained.load_raw_state_dict(tmp_path / "rn.safetensors")
    want = jax_pretrained.load_raw_state_dict(tmp_path / "rn.safetensors")
    assert set(got) == set(want) and all(np.array_equal(got[k].numpy(), want[k]) for k in got)


def test_pretrained_conversion_refuses_what_jax_refuses(raw_backbones, branch_ckpts, tmp_path):
    raw_path = branch_ckpts["resnet18"][0]
    errors = []
    for module in (pretrained, jax_pretrained):
        with pytest.raises(ValueError) as arch:
            module.convert_pretrained("vgg16", raw_path, tmp_path / "x.pt")
        with pytest.raises(KeyError) as key:
            module.torchvision_resnet_to_video_branch({"features.0.weight": torch.zeros(1)})
        with pytest.raises(ValueError) as wavlm:
            module.hf_wavlm_to_audio_branch(raw_backbones["resnet18"])
        errors.append((str(arch.value), str(key.value), str(wavlm.value)))
    assert errors[0] == errors[1]
    assert not (tmp_path / "x.pt").exists()


def _flagship_kw(fused):
    return dict(fusion="xattn", use_wavlm=True, num_classes=CLASSES, spec_augment=False,
                xattn_d_model=32, wavlm_geometry=dict(SMALL, fused_attention=fused, fused_conv=False))


def test_warm_start_matches_jax(branch_ckpts, capsys):
    """(e) The flagship at SMALL widths warm-started from the same branch
    checkpoints: equal parameters and BatchNorm statistics, the same
    missing / unused report, and with the rest of the model taken from the
    JAX init, the same eval logits within 1e-5.

    The JAX trainer's `_warm_start` cannot load the WavLM audio branch: the
    branch has no BatchNorm, `torch_state_dict_to_flax` then returns no
    `batch_stats` collection, and `filled["batch_stats"]` raises KeyError
    (F3, ROADMAP queue 3).  So the JAX trainer warm-starts the video branch,
    and the audio branch is held against what that function fills from the
    same checkpoint, the step `_warm_start` takes before it fails."""
    from multimodalemotionrecognition_tpu.convert.torch_import import torch_state_dict_to_flax

    audio_ckpt, video_ckpt = (str(branch_ckpts[a][1]) for a in ("wavlm-base", "resnet18"))
    jtrainer = jax_trainer.EmotionTrainer(JaxModelConfig(**_flagship_kw(False)),
                                          JaxTrainConfig(**TRAIN_KW, video_ckpt=video_ckpt))
    batch = _batches(1, seed=21)[0]
    # `init_state` is model.init at full-size dummies, then `_warm_start`:
    # the same two steps on this test's small shapes.
    init = jtrainer.model.init(jax.random.PRNGKey(0), jnp.asarray(batch.video[:1]),
                               jnp.asarray(batch.audio[:1]))
    params, bstats = jtrainer._warm_start(init["params"], init["batch_stats"])
    jax_report = [line for line in capsys.readouterr().out.splitlines() if "Loaded" in line]
    audio_sd, _ = load_reference_checkpoint(audio_ckpt)
    filled, report = torch_state_dict_to_flax(
        audio_sd, {"params": jax.device_get(params["audio_model"])}, strict=False)
    params = dict(jax.device_get(params), audio_model=filled["params"])
    variables = {"params": params, "batch_stats": jax.device_get(bstats)}
    want = flax_params_to_state_dict(flatten_dict(variables))
    jax_report.insert(0, f"[INFO] Loaded audio_model checkpoint: {audio_ckpt} "
                         f"(missing={len(report.missing_flax_paths)}, "
                         f"unused={len(report.unused_torch_keys)})")

    trainer = EmotionTrainer(ModelConfig(**_flagship_kw(True)),
                             TrainConfig(**TRAIN_KW, audio_ckpt=audio_ckpt, video_ckpt=video_ckpt),
                             device="cpu")
    state = trainer.init_state()
    port_report = [line for line in capsys.readouterr().out.splitlines() if "Loaded" in line]
    assert port_report == jax_report
    got = state.model.state_dict()
    assert set(got) == set(want)
    branch = [k for k in got if k.startswith(("audio_model.", "video_model."))]
    assert sum(k.startswith("video_model.backbone.") for k in branch) == 120
    source = {f"audio_model.{k}": v for k, v in audio_sd.items()}
    for key in branch:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
        if key in source:  # the branch came from the checkpoint, not from either init
            assert torch.equal(got[key], source[key]), key
    assert sum(k in source for k in branch) > 30

    state.model.load_state_dict({k: v for k, v in want.items() if k not in branch}, strict=False)
    ref = jtrainer.model.apply(variables, jnp.asarray(batch.video), jnp.asarray(batch.audio),
                               train=False)[0]
    with torch.no_grad():
        logits, _ = trainer._apply(*_tensors(batch)[:2], False, None)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# resume checkpoints and the confusion matrix
# ---------------------------------------------------------------------------


def _noisy_flagship(tmp_path, **train_kw):
    """The SMALL flagship with WavLM's default dropouts, LayerDrop and span
    masking on: every step draws from the generators."""
    kw = _flagship_kw(True)
    kw["wavlm_geometry"] = dict(kw["wavlm_geometry"], num_hidden_layers=3)
    return EmotionTrainer(ModelConfig(**kw), TrainConfig(**dict(
        TRAIN_KW, fusion_unfreeze_wavlm_layers=10, output_dir=str(tmp_path), **train_kw)),
        device="cpu")


def test_resume_is_bit_identical_to_the_run_that_went_on(tmp_path):
    """(f) Two accum-2 stage-2 steps, save, restore into a fresh trainer,
    one more step on both: parameters, buffers, moments, step and the
    generators' next draws bit-identical."""
    trainer = _noisy_flagship(tmp_path, grad_accum=2)
    state = trainer.init_state()
    batches = _batches(3, seed=30)
    mask, lrs = trainer.trainable_mask(2), trainer.lr_tree(2, {})
    assert any(mask.values()) and not all(mask.values())
    for batch in batches[:2]:
        trainer.train_step(state, *_tensors(batch), mask, lrs)
    trainer.save_resume_state(tmp_path / "resume", state, epoch=3, best_f1=0.375)

    fresh = _noisy_flagship(tmp_path, grad_accum=2)
    restored, epoch, best_f1 = fresh.restore_resume_state(tmp_path / "resume")
    assert (epoch, best_f1, restored.step, restored.opt_state.count) == (3, 0.375, 2, 2)
    went_on = trainer.train_step(state, *_tensors(batches[2]), mask, lrs)
    resumed = fresh.train_step(restored, *_tensors(batches[2]), fresh.trainable_mask(2),
                               fresh.lr_tree(2, {}))
    for a, b in zip(went_on, resumed):
        assert torch.equal(a, b)
    for name, t in state.model.state_dict().items():
        assert torch.equal(t, restored.model.state_dict()[name]), name
    for name in state.opt_state.mu:
        assert torch.equal(state.opt_state.mu[name], restored.opt_state.mu[name]), name
        assert torch.equal(state.opt_state.nu[name], restored.opt_state.nu[name]), name
    for name in RNG_STREAMS:
        assert torch.equal(torch.rand(3, generator=state.rng.device(name)),
                           torch.rand(3, generator=restored.rng.device(name))), name
        assert state.rng.uniform(name) == restored.rng.uniform(name), name
    # A file made for another set of trainable parameters is refused.
    other = _noisy_flagship(tmp_path, two_stage_training=False)
    with pytest.raises(ValueError, match="optimizer state"):
        other.restore_resume_state(tmp_path / "resume")


def test_confusion_matrix_matches_jax_and_fit_writes_it(tmp_path, capsys, monkeypatch):
    """(g) `utils/metrics.confusion_matrix` against the JAX function; `fit`
    with a test loader writes `confusion_matrix.csv` (and the PNG, as
    matplotlib is here) equal to the eval predictions' matrix, and a failure
    there prints a warning and leaves the run standing."""
    rng = np.random.default_rng(40)
    for n in (0, 1, 37):
        preds, targets = rng.integers(0, 8, n), rng.integers(0, 8, n)
        np.testing.assert_array_equal(confusion_matrix(preds, targets, 8),
                                      jax_confusion_matrix(preds, targets, 8))

    trainer = _noisy_flagship(tmp_path, epochs=1)
    test = _batches(2, seed=41)
    test[1].valid[-2:] = False
    state, result = trainer.fit(_batches(1, seed=42), _batches(1, seed=43), test_loader=test)
    cm = np.loadtxt(tmp_path / "confusion_matrix.csv", delimiter=",", dtype=np.int64)
    preds = [trainer.eval_step(state, *_tensors(b))[3].numpy()[b.valid] for b in test]
    want = confusion_matrix(np.concatenate(preds), np.concatenate([b.labels[b.valid] for b in test]),
                            CLASSES)
    np.testing.assert_array_equal(cm, want)
    assert cm.sum() == 2 * B - 2 and result["confusion_matrix"] == cm.tolist()
    assert (tmp_path / "confusion_matrix.png").stat().st_size > 0

    def broken(*_):
        raise OSError("disk full")

    monkeypatch.setattr(trainer, "_save_confusion_matrix", broken)
    capsys.readouterr()
    _, result = trainer.fit(_batches(1, seed=42), _batches(1, seed=43), test_loader=test, state=state)
    assert "[WARNING] confusion matrix failed: disk full" in capsys.readouterr().out
    assert "confusion_matrix" not in result and "test" in result
