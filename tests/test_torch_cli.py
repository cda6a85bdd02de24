"""The port's entry points against the JAX package's, on the CPU:
`train/cli.py` (flags and configs, one epoch through `main`), `train/eval.py`
(a checkpoint the JAX trainer wrote), `data/qa_export.py`, the hub's
dispatch, and the convergence gate (`bench/convergence_gate.py`).

Tolerances: configs, output file sets, QA artifacts and JSON keys are equal;
the evaluator's accuracy and macro-F1 are equal, and the two models' logits
on the test clips agree within 1e-4 (float32, other summation orders) with
the same argmax on every clip.
"""

import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodalemotionrecognition_tpu.config import DataConfig as JaxDataConfig
from multimodalemotionrecognition_tpu.config import VideoConfig as JaxVideoConfig
from multimodalemotionrecognition_tpu.convert.torch_import import (
    load_reference_checkpoint as jax_load_reference_checkpoint,
)
from multimodalemotionrecognition_tpu.data import face as jax_face
from multimodalemotionrecognition_tpu.data import qa_export as jax_qa_export
from multimodalemotionrecognition_tpu.data.pipeline import build_loaders as jax_build_loaders
from multimodalemotionrecognition_tpu.train import cli as jax_cli
from multimodalemotionrecognition_tpu.train import eval as jax_eval
from multimodalemotionrecognition_torch import __main__ as hub
from multimodalemotionrecognition_torch.bench import convergence_gate
from multimodalemotionrecognition_torch.config import DataConfig, VideoConfig
from multimodalemotionrecognition_torch.data import face, qa_export, synthetic
from multimodalemotionrecognition_torch.data.pipeline import build_loaders
from multimodalemotionrecognition_torch.train import cli
from multimodalemotionrecognition_torch.train import eval as port_eval

REPO = Path(__file__).resolve().parents[1]

GATE_ARGV = [
    "--data_root", "corpus", "--fusion", "gated", "--epochs", "12", "--batch_size", "16",
    "--frames", "4", "--img_size", "64", "--split_mode", "actor", "--train_actors",
    "1,2,3,4,5,6", "--val_actors", "7", "--test_actors", "8", "--early_stopping_patience", "0",
    "--seed", "42", "--output_dir", "corpus/outputs", "--no_face_crop",
]
FLAGSHIP_ARGV = [
    "--data_root", "corpus", "--fusion", "xattn", "--use_wavlm", "--two_stage_training",
    "--stage1_epochs", "1", "--epochs", "2", "--batch_size", "16", "--frames", "8",
    "--img_size", "112", "--split_mode", "actor", "--train_actors", "1,2", "--val_actors", "3",
    "--test_actors", "4",
]


@pytest.fixture(autouse=True)
def _cv2_decode_and_default_detector(monkeypatch):
    """The JAX package's cv2 video path, and each package's default detector."""
    monkeypatch.setenv("EMO_NATIVE_DECODE", "0")
    monkeypatch.delenv("EMO_FACE_DETECTOR", raising=False)
    monkeypatch.delenv("EMO_BLAZEFACE_WEIGHTS", raising=False)
    for module in (face, jax_face):
        monkeypatch.setattr(module, "_detector", None)
        monkeypatch.setattr(module, "_detector_initialized", False)


# --------------------------------------------------------------------------- (f) configs


@pytest.mark.parametrize("argv", [["--data_root", "corpus"], GATE_ARGV, FLAGSHIP_ARGV,
                                  FLAGSHIP_ARGV + ["--mesh_data", "2", "--video_wire", "uint8",
                                                   "--num_classes", "4", "--wandb"]],
                         ids=["defaults", "gate", "flagship", "mesh_wire_4class"])
def test_configs_from_args_equal_jax(argv):
    got = cli.configs_from_args(cli.build_arg_parser().parse_args(argv))
    want = jax_cli.configs_from_args(jax_cli.build_arg_parser().parse_args(argv))
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]
    assert vars(cli.build_arg_parser().parse_args(argv)) == vars(
        jax_cli.build_arg_parser().parse_args(argv))


def test_cli_refuses_meshes_and_picks_the_wire(tmp_path, monkeypatch):
    """`--mesh_model 2` (tensor parallelism, not ported) is refused, naming
    its ROADMAP item; `--mesh_data 2` started alone spawns two Gloo ranks on
    the CPU, which get as far as the data (an absent root: the ranks' own
    error comes back)."""
    with pytest.raises(NotImplementedError, match="queue 1, item 3"):
        cli.main(["--data_root", "absent", "--mesh_model", "2"], device="cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed(.|\n)*No audio-video pairs found"):
        cli.main(["--data_root", str(tmp_path / "absent"), "--mesh_data", "2"], device="cpu")
    assert cli.resolve_video_wire("auto", "cpu") == "float32"
    assert cli.resolve_video_wire("auto", torch.device("cuda", 0)) == "uint8"
    assert cli.resolve_video_wire("float32", "cuda") == "float32"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--data_root", "absent"])


# --------------------------------------------------------------------------- (g), (h) train, eval


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 actors x 2 emotions of 0.5 s."""
    root = tmp_path_factory.mktemp("corpus")
    synthetic.generate_synthetic_ravdess(root, actors=(1, 2, 3), emotions=(3, 5), seconds=0.5,
                                         size=64, seed=3)
    return root


def _train_argv(root, out):
    return ["--data_root", str(root), "--fusion", "gated", "--epochs", "1", "--batch_size", "2",
            "--frames", "2", "--img_size", "32", "--split_mode", "actor", "--train_actors", "1",
            "--val_actors", "2", "--test_actors", "3", "--output_dir", str(out),
            "--num_workers", "2"]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """One epoch of gated mel through each package's CLI -> {package: output dir}."""
    work = tmp_path_factory.mktemp("runs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMO_NATIVE_DECODE", "0")
        mp.chdir(work)
        cli.main(_train_argv(corpus, work / "port"), device="cpu")
        jax_cli.main(_train_argv(corpus, work / "jax"))
    return {"port": work / "port", "jax": work / "jax"}


def test_train_cli_writes_the_jax_output_files(runs):
    listing = {k: sorted(p.name for p in d.iterdir()) for k, d in runs.items()}
    assert listing["port"] == listing["jax"]
    assert {"best_gated.pt", "metrics.jsonl", "confusion_matrix.csv"} <= set(listing["port"])
    sd, config = jax_load_reference_checkpoint(str(runs["port"] / "best_gated.pt"))
    assert config["fusion"] == "gated" and len(sd) > 100
    _, _, jax_config = jax_eval.load_model_from_checkpoint(str(runs["port"] / "best_gated.pt"))
    _, port_config = port_eval.load_model_from_checkpoint(str(runs["port"] / "best_gated.pt"),
                                                          device="cpu")
    assert dataclasses.asdict(port_config) == dataclasses.asdict(jax_config)
    rows = [json.loads(line) for line in (runs["port"] / "metrics.jsonl").read_text().splitlines()]
    want = [json.loads(line) for line in (runs["jax"] / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == len(want) == 1 and rows[0].keys() == want[0].keys()


def test_evaluator_on_a_jax_checkpoint_equals_jax(runs, corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ckpt = str(runs["jax"] / "best_gated.pt")
    model, config = port_eval.load_model_from_checkpoint(ckpt, device="cpu")
    jax_model, variables, jax_config = jax_eval.load_model_from_checkpoint(ckpt)
    assert dataclasses.asdict(config) == dataclasses.asdict(jax_config)
    common = dict(data_root=str(corpus), split_mode="actor", train_actors=(), val_actors=(),
                  test_actors=(3,))
    got = port_eval.EmotionEvaluator(
        ckpt, DataConfig(**common, video=VideoConfig(num_frames=2, size=32)), device="cpu").run()
    want = jax_eval.EmotionEvaluator(
        ckpt, JaxDataConfig(**common, video=JaxVideoConfig(num_frames=2, size=32))).run()
    assert (got["acc"], got["f1"]) == (float(want["acc"]), float(want["f1"]))

    # The predictions behind those numbers, clip by clip.
    dc = DataConfig(**common, video=VideoConfig(num_frames=2, size=32))
    batch = next(iter(build_loaders(dc, 16)[2]))
    jbatch = next(iter(jax_build_loaders(
        JaxDataConfig(**common, video=JaxVideoConfig(num_frames=2, size=32)), 16)[2]))
    np.testing.assert_array_equal(batch.video, jbatch.video)
    from multimodalemotionrecognition_tpu.ops.mel import log_mel_spectrogram
    from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram as port_mel

    with torch.no_grad():
        logits = model(torch.from_numpy(batch.video),
                       port_mel(torch.from_numpy(batch.audio)[:, 0])[:, None], False, None).numpy()
    jax_out = jax_model.apply(variables, batch.video, log_mel_spectrogram(batch.audio[:, 0])[:, None])
    jax_logits = np.asarray(jax_out[0] if isinstance(jax_out, tuple) else jax_out)
    valid = batch.valid
    np.testing.assert_allclose(logits[valid], jax_logits[valid], rtol=0, atol=1e-4)
    assert (logits[valid].argmax(1) == jax_logits[valid].argmax(1)).all()


def test_eval_main_reads_the_test_actors(runs, corpus, tmp_path, monkeypatch, capsys):
    """`--test_actors 3` evaluates actor 3's two clips (the JAX `main` puts
    actor 3 into its default train actors and evaluates no clip)."""
    monkeypatch.chdir(tmp_path)
    ckpt = str(runs["port"] / "best_gated.pt")
    metrics = port_eval.main(["--checkpoint", ckpt, "--data_root", str(corpus),
                              "--test_actors", "3"], device="cpu")
    assert f"Test accuracy: {metrics['acc']:.4f}" in capsys.readouterr().out
    model, _ = port_eval.load_model_from_checkpoint(ckpt, device="cpu")
    dc = DataConfig(data_root=str(corpus), split_mode="actor", train_actors=(), val_actors=(),
                    test_actors=(3,))
    batch = next(iter(build_loaders(dc, 16)[2]))
    assert batch.size == 2
    from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram

    with torch.no_grad():
        logits = model(torch.from_numpy(batch.video),
                       log_mel_spectrogram(torch.from_numpy(batch.audio)[:, 0])[:, None], False, None)
    preds = logits.argmax(1).numpy()[batch.valid]
    assert metrics["acc"] == float((preds == batch.labels[batch.valid]).mean())


# --------------------------------------------------------------------------- qa-export, the hub


@pytest.mark.parametrize("visual", [False, True], ids=["augment", "visual"])
def test_qa_export_equals_jax(corpus, tmp_path, visual):
    port_out = qa_export.export_augmented_example(str(corpus), str(tmp_path / "port"), index=1,
                                                  visual=visual, seed=4)
    jax_out = jax_qa_export.export_augmented_example(str(corpus), str(tmp_path / "jax"), index=1,
                                                     visual=visual, seed=4)
    files = sorted(p.name for p in port_out.iterdir())
    assert files == sorted(p.name for p in jax_out.iterdir())
    assert "audio_augmented.wav" in files and "frame_07.png" in files
    for name in files:
        assert (port_out / name).read_bytes() == (jax_out / name).read_bytes(), name


@pytest.mark.parametrize("command, module", [
    ("train", "multimodalemotionrecognition_torch.train.cli"),
    ("eval", "multimodalemotionrecognition_torch.train.eval"),
    ("qa-export", "multimodalemotionrecognition_torch.data.qa_export"),
    ("make-data", "multimodalemotionrecognition_torch.data.synthetic"),
])
def test_hub_dispatches_the_data_commands(command, module, monkeypatch):
    import importlib

    seen = []
    monkeypatch.setattr(importlib.import_module(module), "main", seen.append)
    hub.main([command, "--data_root", "data"])
    assert seen == [["--data_root", "data"]]


# --------------------------------------------------------------------------- (i) the gate


def test_gate_prints_the_jax_report(tmp_path, capsys):
    root = tmp_path / "corpus"
    synthetic.generate_synthetic_ravdess(root, actors=range(1, 9), emotions=(4,), seconds=0.5,
                                         seed=7, strong_signal=True, signal_strength=0.4)
    with pytest.raises(SystemExit) as exit_info:
        convergence_gate.main(["--epochs", "1", "--device", "cpu", "--root", str(root)])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    report = json.loads(lines[-1])
    calibration = json.loads((REPO / "benchmarks" / "gate_r05_calibration.json").read_text())
    assert list(report) == list(calibration["calibration"][0])
    assert report["backend"] == "cpu" and report["epochs"] == 1 and report["fusion"] == "gated"
    assert exit_info.value.code == (0 if report["pass"] else 1)
    assert (root / "pairs.csv").exists() and (root / "outputs" / "best_gated.pt").exists()


@pytest.mark.parametrize("fails", [False, True], ids=["returns", "raises"])
def test_gate_trains_under_deterministic_algorithms_and_restores_the_settings(fails):
    def flags():
        return (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled(),
                torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)

    before = flags()
    with pytest.raises(RuntimeError) if fails else contextlib.nullcontext():
        with convergence_gate.deterministic_algorithms():
            assert flags() == (True, True, True, False)
            if fails:
                raise RuntimeError("a failing fit")
    assert flags() == before
