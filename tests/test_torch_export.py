"""The port's model export (`runtime/export.py`) against its own runner and
the JAX package's StableHLO export, the kernels' registered operators, and
`utils/profiling.py::device_trace`, on the CPU.

Checkpoints: the gated mel model of `tests/test_export.py` (saved by the
JAX package), buckets (1, 2); and the xattn + WavLM model at the JAX suite's
`SMALL` widths with the kernel flags forced on, so that the exported graph
holds K1 and K3 as operator nodes (on the CPU they run their plain
versions).  Tolerances: the port's export against the port's runner 1e-6,
against the JAX export 1e-5 (float32 probabilities).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalemotionrecognition_tpu.config import ModelConfig as JaxModelConfig
from multimodalemotionrecognition_tpu.convert.torch_import import save_torch_checkpoint
from multimodalemotionrecognition_tpu.models.factory import build_model as jax_build_model
from multimodalemotionrecognition_tpu.runtime import export as jax_export
from multimodalemotionrecognition_torch.config import ModelConfig
from multimodalemotionrecognition_torch.kernels import conv_fe, wavlm_attn
from multimodalemotionrecognition_torch.models.factory import build_model
from multimodalemotionrecognition_torch.runtime import export
from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
from multimodalemotionrecognition_torch.utils.profiling import device_trace

from tests.test_wavlm_fused_attn import SMALL

ATOL_RUNNER, ATOL_JAX = 1e-6, 1e-5
K1, K3 = "emo.wavlm_attention_sublayer", "emo.fused_conv_layer"


@pytest.fixture(scope="module")
def gated_checkpoint(tmp_path_factory):
    cfg = JaxModelConfig(fusion="gated", num_classes=8, spec_augment=False)
    model = jax_build_model(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 3, 112, 112)),
                                    jnp.zeros((1, 1, 64, 301)))
    path = tmp_path_factory.mktemp("torch_export") / "best_gated.pt"
    save_torch_checkpoint(path, variables, config=cfg.to_checkpoint_dict())
    return str(path)


@pytest.fixture(scope="module")
def gated_export(gated_checkpoint, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_export_out") / "gated"
    path = export.export_program(gated_checkpoint, out, batch_sizes=(1, 2), device="cpu")
    return path, export.load_exported(path), TorchModelRunner(gated_checkpoint, device="cpu")


def _clips(n, seed, mel=True):
    rng = np.random.RandomState(seed)
    video = rng.randn(n, 8, 3, 112, 112).astype(np.float32)
    audio = rng.randn(n, 1, 64, 301) if mel else rng.randn(n, 1, 48000) * 0.1
    return video, audio.astype(np.float32)


@pytest.mark.parametrize("n", [1, 2])
def test_export_matches_runner(gated_export, n):
    _, exported, runner = gated_export
    video, audio = _clips(n, seed=n)
    probs = exported.predict_probs(video, audio)
    assert probs.shape == (n, 8)
    np.testing.assert_allclose(probs, runner.predict_probs(video, audio), atol=ATOL_RUNNER)


def test_export_matches_the_jax_export(gated_checkpoint, gated_export, tmp_path):
    path, exported, _ = gated_export
    jax_path = jax_export.export_stablehlo(gated_checkpoint, str(tmp_path / "gated"),
                                           batch_sizes=(1, 2))
    jax_exported = jax_export.load_exported(str(jax_path))
    video, audio = _clips(2, seed=3)
    np.testing.assert_allclose(exported.predict_probs(video, audio),
                               jax_exported.predict_probs(video, audio), atol=ATOL_JAX)
    # The sidecar: JAX's keys and values, but the format, plus the device.
    meta = json.loads(Path(str(path) + ".meta.json").read_text())
    jax_meta = json.loads(Path(str(jax_path) + ".meta.json").read_text())
    assert set(meta) == set(jax_meta) | {"device"}
    assert (meta["format"], meta["device"]) == ("torch.export", "cpu")
    assert {k: v for k, v in meta.items() if k not in ("format", "device")} == {
        k: v for k, v in jax_meta.items() if k != "format"}
    with np.load(path) as data, np.load(jax_path) as jax_data:
        assert sorted(data.files) == sorted(jax_data.files) == ["1", "2"]


def test_export_over_max_bucket_chunks(gated_export):
    _, exported, runner = gated_export
    video, audio = _clips(5, seed=5)  # > the largest bucket (2), not a multiple of it
    probs = exported.predict_probs(video, audio)
    assert probs.shape == (5, 8)
    np.testing.assert_allclose(probs, runner.predict_probs(video, audio), atol=ATOL_RUNNER)


def test_export_missing_files_raise(gated_export, tmp_path):
    np.savez(tmp_path / "nothing", **{"1": np.zeros(4, np.uint8)})
    with pytest.raises(FileNotFoundError, match="metadata"):
        export.load_exported(str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError, match="Export not found"):
        export.load_exported(str(tmp_path / "absent"))


def test_cuda_artifact_and_export_raise_without_a_card(gated_checkpoint, gated_export, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    path, _, _ = gated_export
    copy = tmp_path / "on_card.npz"
    copy.write_bytes(Path(path).read_bytes())
    meta = json.loads(Path(str(path) + ".meta.json").read_text())
    Path(str(copy) + ".meta.json").write_text(json.dumps(dict(meta, device="cuda")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.load_exported(copy)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.export_program(gated_checkpoint, tmp_path / "x")


def test_int8_export_matches_the_int8_runner(gated_checkpoint, tmp_path):
    # The command line, as the hub runs it (on the CPU here).
    path = export.main(["--checkpoint", gated_checkpoint, "--output", str(tmp_path / "int8"),
                        "--int8", "--batch-sizes", "2"], device="cpu")
    assert path == tmp_path / "int8.npz" and Path(str(path) + ".meta.json").exists()
    exported = export.load_exported(path)
    assert exported.meta["quantized_int8"] is True
    runner = TorchModelRunner(gated_checkpoint, device="cpu", quantize_int8=True)
    video, audio = _clips(3, seed=7)
    np.testing.assert_allclose(exported.predict_probs(video, audio),
                               runner.predict_probs(video, audio), atol=ATOL_RUNNER)


@pytest.fixture(scope="module")
def wavlm_checkpoint(tmp_path_factory):
    """xattn + SMALL WavLM (two encoder layers, conv layers L1 and L2) with
    K1 and K3 forced on: random weights from a seed, saved by the port."""
    cfg = ModelConfig(fusion="xattn", use_wavlm=True, spec_augment=False, xattn_d_model=32,
                      wavlm_geometry=dict(SMALL, fused_attention=True, fused_conv=True))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    path = tmp_path_factory.mktemp("torch_export_wavlm") / "best_xattn.pt"
    torch.save({"model": model.state_dict(), "config": cfg.to_checkpoint_dict()}, path)
    return str(path)


@pytest.mark.parametrize("int8, buckets", [(False, (1,)), (True, (2,))], ids=["float32", "int8"])
def test_wavlm_graph_holds_the_kernel_operators(wavlm_checkpoint, tmp_path, int8, buckets):
    path = export.export_program(wavlm_checkpoint, tmp_path / "wavlm", batch_sizes=buckets,
                                 quantize_int8=int8, device="cpu")
    exported = export.load_exported(path)
    layers, conv_layers = SMALL["num_hidden_layers"], len(SMALL["conv_kernel"]) - 1
    for program in exported.programs.values():
        assert export.kernel_nodes(program) == {K1: layers, K3: conv_layers}
    runner = TorchModelRunner(wavlm_checkpoint, device="cpu", quantize_int8=int8)
    video, audio = _clips(3, seed=11, mel=False)
    np.testing.assert_allclose(exported.predict_probs(video, audio),
                               runner.predict_probs(video, audio), atol=ATOL_RUNNER)


def test_wavlm_graph_without_kernel_flags_holds_no_operator(wavlm_checkpoint, tmp_path):
    """On the CPU the flags' "auto" takes the modular path: no operator node."""
    saved = torch.load(wavlm_checkpoint, weights_only=False)
    cfg = ModelConfig.from_checkpoint_dict(saved["config"])
    geometry = dict(cfg.wavlm_geometry, fused_attention="auto", fused_conv="auto")
    saved["config"] = dataclasses.replace(cfg, wavlm_geometry=geometry).to_checkpoint_dict()
    torch.save(saved, tmp_path / "auto.pt")
    path = export.export_program(tmp_path / "auto.pt", tmp_path / "auto", batch_sizes=(1,),
                                 device="cpu")
    assert export.kernel_nodes(export.load_exported(path).programs[1]) == {K1: 0, K3: 0}


def _k1_args(seed, b=2, t=7, e=16, h=4):
    g = torch.Generator().manual_seed(seed)
    x = [torch.randn(b, t, e, generator=g) for _ in range(4)]
    return (*x, torch.randn(b, h * t, 1, generator=g), torch.randn(h * t, t, generator=g),
            torch.randn(e, e, generator=g) * 0.1, torch.randn(1, e, generator=g),
            torch.ones(1, e), torch.zeros(1, e))


@pytest.mark.parametrize("dropout", [(0.0, 0.0, None), (0.1, 0.1, 1234)], ids=["eval", "train"])
def test_opcheck_k1(dropout):
    args = _k1_args(0)
    torch.library.opcheck(wavlm_attn._k1_op, (*args, 4, 6, 1e-5, *dropout))


@pytest.mark.parametrize("gelu_input", [False, True])
def test_opcheck_k3(gelu_input):
    g = torch.Generator().manual_seed(1)
    y = torch.randn(2, 9, 2 * 8, generator=g)  # stride 2, cin 8
    w_flat = torch.randn(3 * 8, 12, generator=g)
    torch.library.opcheck(conv_fe._k3_op, (y, w_flat, 3, 2, 8, gelu_input, True, 17, None))


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace("") as nothing:
        pass
    assert nothing is None
    with device_trace(str(tmp_path / "trace")) as path:
        torch.matmul(torch.randn(64, 64), torch.randn(64, 64))
    trace = json.loads(path.read_text())
    assert path.parent == tmp_path / "trace"
    assert any("matmul" in event.get("name", "") for event in trace["traceEvents"])
