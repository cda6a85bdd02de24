"""The serving slice: one checkpoint through `JaxModelRunner` and the port's
`TorchModelRunner(device="cpu")`, float32, atol 2e-5 on the probabilities.

The checkpoint is a reference-format .pt of the flagship cross-attention
model at small widths (the JAX suite's `SMALL` WavLM, d_model 32, full
ResNet18), saved by the JAX package (`save_torch_checkpoint`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalemotionrecognition_tpu.config import ModelConfig
from multimodalemotionrecognition_tpu.convert import torch_import
from multimodalemotionrecognition_tpu.convert import signature as jax_signature
from multimodalemotionrecognition_tpu.models.factory import build_model as jax_build_model
from multimodalemotionrecognition_tpu.runtime.runner import JaxModelRunner
from multimodalemotionrecognition_torch.convert import checkpoint
from multimodalemotionrecognition_torch.kernels import build
from multimodalemotionrecognition_torch.parallel.mesh import make_mesh
from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
from multimodalemotionrecognition_torch.serving.predictor import EmotionPredictor

from tests.test_wavlm_fused_attn import SMALL

FRAMES = (8, 3, 32, 32)
ATOL = 2e-5


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = ModelConfig(
        fusion="xattn", num_classes=8, use_wavlm=True, spec_augment=False,
        xattn_d_model=32, xattn_attn_dropout=0.0, xattn_stochastic_depth=0.0,
        wavlm_geometry=dict(SMALL),
    )
    model = jax_build_model(cfg)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1,) + FRAMES), jnp.zeros((1, 1, 48000))
    )
    path = tmp_path_factory.mktemp("torch_slice") / "best_xattn_wavlm.pt"
    torch_import.save_torch_checkpoint(path, variables, config=cfg.to_checkpoint_dict())
    return str(path)


@pytest.fixture(scope="module")
def runners(ckpt):
    """(JAX, port) runner pairs keyed by device_normalize."""
    return {
        dn: (
            JaxModelRunner(ckpt, device_normalize=dn),
            TorchModelRunner(ckpt, device="cpu", device_normalize=dn),
        )
        for dn in (False, True)
    }


def _clips(n, seed, wire=False):
    rng = np.random.RandomState(seed)
    if wire:
        video = rng.randint(0, 256, (n,) + FRAMES).astype(np.uint8)
        audio = rng.randint(-32768, 32767, (n, 1, 48000)).astype(np.int16)
    else:
        video = rng.randn(n, *FRAMES).astype(np.float32)
        audio = (rng.randn(n, 1, 48000) * 0.1).astype(np.float32)
    return video, audio


@pytest.mark.parametrize("n", [1, 3], ids=["b1", "b3_padded_to_4"])
def test_predict_probs_matches_jax(runners, n):
    jax_runner, port = runners[False]
    video, audio = _clips(n, seed=n)
    want = jax_runner.predict_probs(video, audio)
    got = port.predict_probs(video, audio)
    assert got.shape == (n, 8)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_uint8_video_and_int16_audio_wires_match_jax(runners):
    jax_runner, port = runners[True]
    video, audio = _clips(3, seed=7, wire=True)
    np.testing.assert_allclose(
        port.predict_probs(video, audio), jax_runner.predict_probs(video, audio), atol=ATOL
    )


@pytest.mark.parametrize("device_normalize", [True, False])
def test_blank_video_matches_jax(runners, device_normalize):
    jax_runner, port = runners[device_normalize]
    _, audio = _clips(3, seed=8)
    np.testing.assert_allclose(
        port.predict_probs_blank_video(audio),
        jax_runner.predict_probs_blank_video(audio),
        atol=ATOL,
    )


def test_runner_contract_and_staging(runners):
    _, port = runners[True]
    assert port.fusion_mode == "xattn" and port.use_wavlm and port.device_normalize
    assert port.labels[0] == "neutral" and len(port.labels) == 8
    video, audio = _clips(3, seed=9, wire=True)
    staged_v, staged_a, n = port.stage(video, audio)
    assert n == 3 and staged_v.shape[0] == 4 and staged_v.dtype == torch.uint8
    np.testing.assert_array_equal(
        port.predict_probs(staged_v, staged_a, n=n), port.predict_probs(video, audio)
    )
    staged, n = port.stage_audio(audio)
    assert n == 3 and staged.dtype == torch.int16
    np.testing.assert_array_equal(
        port.predict_probs_blank_video(staged, n=n), port.predict_probs_blank_video(audio)
    )


def test_predictor_json_contract(runners):
    _, port = runners[False]
    video, audio = _clips(1, seed=10)
    out = EmotionPredictor(runner=port).predict_tensors(video, audio)
    probs = port.predict_probs(video, audio)[0]
    assert out["labels"] == port.labels
    np.testing.assert_allclose(out["probs"], probs.astype(np.float64) * 100, rtol=1e-12)
    top = int(np.argmax(probs))
    assert out["top1"] == {"label": port.labels[top], "prob": out["probs"][top]}


def test_predictor_raises_instead_of_mocking(tmp_path):
    with pytest.raises(FileNotFoundError):
        EmotionPredictor(checkpoint_path=str(tmp_path / "missing.pt"), device="cpu")
    mocked = EmotionPredictor(mock_mode=True).predict_tensors(None, None)
    assert abs(sum(mocked["probs"]) - 100.0) < 1e-9


def test_cuda_runner_raises_without_cuda(ckpt):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchModelRunner(ckpt, device="cuda")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    if (build.Path("/usr/local/cuda/bin/nvcc")).is_file():
        pytest.skip("this host has /usr/local/cuda/bin/nvcc")
    build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.load_library()
    finally:
        build.load_library.cache_clear()


@pytest.mark.parametrize("option", ["donate", "mesh"])
def test_donate_changes_nothing_and_a_tp_mesh_serves_the_same_probabilities(ckpt, option):
    """`donate` (XLA buffer donation) is accepted and changes nothing; a
    tensor-parallel mesh (model 2, the WavLM trunk split over two CPU
    devices) gives one device's probabilities within 1e-5 (float32, the
    row-parallel sums in another order; tests/test_torch_tp.py holds it
    against JAX's tensor-parallel runner)."""
    video = np.random.default_rng(0).standard_normal((2, 8, 3, 112, 112)).astype(np.float32)
    audio = np.random.default_rng(1).standard_normal((2, 1, 48000)).astype(np.float32) * 0.1
    want = TorchModelRunner(ckpt, device="cpu").predict_probs(video, audio)
    if option == "donate":
        donated = TorchModelRunner(ckpt, device="cpu", donate=True)
        np.testing.assert_array_equal(donated.predict_probs(video, audio), want)
        return
    tp = TorchModelRunner(ckpt, device="cpu", mesh=make_mesh((1, 2), ["cpu", "cpu"]))
    assert tp.batch_buckets == (1, 2, 4, 8) and len(tp.replicas) == 1
    np.testing.assert_allclose(tp.predict_probs(video, audio), want, atol=1e-5, rtol=0)


def test_missing_keys_guard(ckpt, tmp_path):
    sd, config = checkpoint.load_reference_checkpoint(ckpt)
    few = {k: v for i, (k, v) in enumerate(sd.items()) if i >= 3}
    path = tmp_path / "few_missing.pt"
    torch.save({"model": few, "config": config}, path)
    runner = TorchModelRunner(path, device="cpu")
    dropped = [k for k in list(sd)[:3] if not k.endswith("num_batches_tracked")]
    state = runner.model.state_dict()
    assert all(not state[k].any() for k in dropped)
    many = {k: v for i, (k, v) in enumerate(sd.items()) if i >= 40}
    torch.save({"model": many, "config": config}, path)
    with pytest.raises(RuntimeError, match="Too many missing keys"):
        TorchModelRunner(path, device="cpu")


@pytest.mark.parametrize(
    "keys",
    [
        ["audio_model.wavlm.x", "video_model.backbone.0.weight", "xattn_mlp.0.weight"],
        ["audio_model.x", "video_model.x", "xattn_gate.0.weight"],
        ["audio_model.x", "video_model.x", "fusion.0.weight"],
        ["audio_model.x", "video_model.x", "gate.0.weight"],
        ["audio_model.x", "video_model.x"],
        ["wavlm.encoder.x"],
        ["backbone.0.weight"],
    ],
)
def test_signature_inference_matches_jax(keys):
    sd = dict.fromkeys(keys)
    assert checkpoint.infer_model_signature(sd) == jax_signature.infer_model_signature(sd)
    assert checkpoint.checkpoint_uses_wavlm(sd) == jax_signature.checkpoint_uses_wavlm(sd)


def test_weight_norm_merge_matches_jax():
    rng = np.random.RandomState(11)
    sd = {
        "enc.conv.weight_g": rng.rand(1, 1, 16).astype(np.float32),
        "enc.conv.weight_v": rng.randn(32, 8, 16).astype(np.float32),
        "enc.conv.bias": rng.randn(32).astype(np.float32),
    }
    want = torch_import.normalize_torch_state_dict(sd)
    got = checkpoint.normalize_torch_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the other model families: mel audio, gated, late, audio, video
# ---------------------------------------------------------------------------

FAMILY_ATOL = 5e-5  # float32 probabilities, other sum orders in the conv stacks
MEL = (1, 64, 301)
FAMILY_CONFIGS = {
    "xattn_mel": dict(fusion="xattn", use_resnet_audio=True),
    "gated": dict(fusion="gated", use_resnet_audio=False),
    "late": dict(fusion="late", use_resnet_audio=False),
    "audio": dict(fusion="audio", use_resnet_audio=False),
    "video": dict(fusion="video"),
}


@pytest.fixture(scope="module")
def family_runners(tmp_path_factory):
    """family -> (JAX runner, port runner) on one checkpoint saved by the
    JAX package, built on first use."""
    built = {}

    def get(family):
        if family not in built:
            cfg = ModelConfig(
                num_classes=8, use_wavlm=False, spec_augment=False, xattn_d_model=32,
                xattn_attn_dropout=0.0, xattn_stochastic_depth=0.0, **FAMILY_CONFIGS[family],
            )
            model = jax_build_model(cfg)
            video, mel = jnp.zeros((1,) + FRAMES), jnp.zeros((1,) + MEL)
            inputs = {"audio": (mel,), "video": (video,)}.get(family, (video, mel))
            variables = jax.jit(model.init)(jax.random.PRNGKey(1), *inputs)
            path = tmp_path_factory.mktemp(f"torch_{family}") / f"best_{family}.pt"
            torch_import.save_torch_checkpoint(path, variables, config=cfg.to_checkpoint_dict())
            built[family] = (
                JaxModelRunner(str(path), batch_buckets=(4,)),
                TorchModelRunner(str(path), device="cpu", batch_buckets=(4,)),
                str(path),
            )
        return built[family]

    return get


def _mel_clips(n, seed):
    rng = np.random.RandomState(seed)
    video = rng.randn(n, *FRAMES).astype(np.float32)
    mel = (rng.randn(n, *MEL) * 10.0 - 20.0).astype(np.float32)
    return video, mel


@pytest.mark.parametrize("family", FAMILY_CONFIGS)
def test_family_predict_probs_matches_jax(family_runners, family):
    jax_runner, port, _ = family_runners(family)
    assert port.fusion_mode == jax_runner.fusion_mode == FAMILY_CONFIGS[family]["fusion"]
    assert port.use_wavlm is False and jax_runner.use_wavlm is False
    video, mel = _mel_clips(3, seed=20)
    if family == "audio":
        video = video[:1]  # the bucket follows the audio batch
    want = jax_runner.predict_probs(video, mel)
    got = port.predict_probs(video, mel)
    assert got.shape == want.shape == (3, 8)
    np.testing.assert_allclose(got, want, atol=FAMILY_ATOL)
    # One softmax for every mode; late fusion's probabilities are not softmaxed again.
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    assert got.std(axis=0).max() > 1e-6


def test_mel_blank_video_and_warmup_shapes_match_jax(family_runners):
    jax_runner, port, _ = family_runners("xattn_mel")
    _, mel = _mel_clips(2, seed=21)
    np.testing.assert_allclose(
        port.predict_probs_blank_video(mel), jax_runner.predict_probs_blank_video(mel),
        atol=FAMILY_ATOL,
    )
    video, audio = port._example_inputs(4)
    jvideo, jaudio = jax_runner._example_inputs(4)
    assert video.shape == jvideo.shape and audio.shape == jaudio.shape == (4, 1, 64, 301)


def test_predictor_makes_the_mel_on_the_host_and_softmaxes_late_again(family_runners):
    from multimodalemotionrecognition_tpu.ops.mel import log_mel_spectrogram_np

    _, port, _ = family_runners("late")
    rng = np.random.RandomState(22)
    video = rng.randn(1, *FRAMES).astype(np.float32)
    wave = (rng.randn(1, 1, 48000) * 0.1).astype(np.float32)
    predictor = EmotionPredictor(runner=port)
    assert predictor.use_wavlm is False
    out = predictor.predict_waveform(video, wave)
    mel = log_mel_spectrogram_np(wave[:, 0, :])[:, None]
    probs = port.predict_probs(video, mel)[0]
    e = np.exp(probs - probs.max())  # the direct backend's second softmax
    np.testing.assert_allclose(out["probs"], (e / e.sum()).astype(np.float64) * 100, rtol=1e-5)


def test_fused_refuses_a_model_the_block_kernel_does_not_take(family_runners):
    """No quiet modular path: the JAX runner warns and serves the modules."""
    _, _, path = family_runners("gated")
    with pytest.raises(ValueError, match="fused=True"):
        TorchModelRunner(path, device="cpu", fused=True)
