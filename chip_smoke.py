#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build, check and time its kernels,
then serve the flagship model at full width through `TorchModelRunner`.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (the first failure ends the run with a non-zero exit code):

  1. device  - the card's name and power limit (nvidia-smi); no CUDA, no run.
  2. build   - nvcc builds the kernels from `multimodalemotionrecognition_torch/
               kernels/csrc/` for sm_90a.
  3. kernels - each kernel against its plain PyTorch version at the serving
               path's shapes (K1: B=8, T=149, E=768, 12 heads; K3: layers
               L1..L6 at B=8), float32 and bfloat16, with TF32 off; max
               error, and kernel vs plain times from CUDA events.
  4. serve   - the flagship model (xattn + WavLM-base 12x768 + ResNet18,
               concat head, mean pooling, d_model 128) with random weights
               from a seeded generator, saved as a reference-format .pt and
               loaded by `TorchModelRunner` in bf16 and f32 (uint8 video,
               int16 audio).  Requests of 1, 3 and 8 clips, a blank-video
               request and an `EmotionPredictor` call, checked against the
               same weights on the plain (modular) path on the card, with
               the kernels' launch counts; then b1 latency and b8 clips/s.

The line before the last is the JSON kernel report; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
REPO = Path(__file__).resolve().parent
K1_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # abs, after the LayerNorm
K3_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (0.0, 2e-2)}  # abs, x max|ref|
PROBS_TOL = {"float32": 1e-3, "bfloat16": 2e-2}  # abs, kernel path vs plain path


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 10) -> float:
    """Median wall time of fn(), which ends in a device->host copy."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def check_k1(dev, gen):
    from multimodalemotionrecognition_torch.kernels import (
        wavlm_attention_sublayer,
        wavlm_attention_sublayer_plain,
    )

    b, t, e, h = 8, 149, 768, 12
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        def r(*shape, scale=1.0, shift=0.0, dt=dtype):
            return (torch.randn(*shape, generator=gen) * scale + shift).to(dev, dt)

        args = [
            r(b, t, e), r(b, t, e, scale=(e // h) ** -0.5), r(b, t, e), r(b, t, e),
            (1.0 + torch.rand(b, h * t, 1, generator=gen)).to(dev),
            r(h * t, t, dt=torch.float32), r(e, e, scale=e**-0.5),
            r(1, e, scale=0.1, dt=torch.float32),
            r(1, e, scale=0.1, shift=1.0, dt=torch.float32),
            r(1, e, scale=0.1, dt=torch.float32),
        ]
        got = wavlm_attention_sublayer(*args, num_heads=h, seq_len=t)
        want = wavlm_attention_sublayer_plain(*args, num_heads=h, seq_len=t)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: wavlm_attention_sublayer(*args, num_heads=h, seq_len=t))
        plain_ms = cuda_ms(lambda: wavlm_attention_sublayer_plain(*args, num_heads=h, seq_len=t))
        name = str(dtype).replace("torch.", "")
        print(f"K1 {name}: B={b} T={t} E={e} H={h} max_abs_err={err:.3e} "
              f"(tol {K1_TOL[dtype]}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not err <= K1_TOL[dtype]:
            raise AssertionError(f"K1 {name} disagrees with its plain version: {err}")
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return report


def check_k3(dev, gen):
    from multimodalemotionrecognition_torch.config import WavLMConfig
    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        fused_conv_layer_plain,
    )

    cfg = WavLMConfig()
    b = 8
    t_log = (48000 - cfg.conv_kernel[0]) // cfg.conv_stride[0] + 1
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        total = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
        t_in = t_log
        for i in range(1, len(cfg.conv_dim)):
            k, s, cin, cout = cfg.conv_kernel[i], cfg.conv_stride[i], cfg.conv_dim[i - 1], cfg.conv_dim[i]
            rows = -(-t_in // s)
            y = torch.randn(b, rows, s * cin, generator=gen).to(dev, dtype)
            w = (torch.randn(k * cin, cout, generator=gen) * (k * cin) ** -0.5).to(dev, dtype)

            def kernel():
                return fused_conv_layer(y, w, k, s, cin, gelu_output=True, t_in=t_in)

            def plain():
                return fused_conv_layer_plain(y, w, k, s, cin, gelu_output=True, t_in=t_in)

            t_out = (t_in - k) // s + 1
            got, want = kernel()[:, :t_out].float(), plain()[:, :t_out].float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            atol, rtol = K3_TOL[dtype]
            tol = max(atol, rtol * want.abs().max().item())
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            print(f"K3 {name} L{i}: B={b} t_in={t_in} t_out={t_out} k={k} s={s} "
                  f"max_abs_err={err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            if not err <= tol:
                raise AssertionError(f"K3 {name} L{i} disagrees with its plain version: {err}")
            total["max_abs_err"] = max(total["max_abs_err"], err)
            total["ms"] += ms
            total["plain_ms"] += plain_ms
            t_in = t_out
        print(f"K3 {name} L1-L6: kernel {total['ms']:.4f} ms plain {total['plain_ms']:.4f} ms")
        report[name] = total
    return report


def serve(dev, card):
    from multimodalemotionrecognition_torch.config import ModelConfig
    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        wavlm_attention_sublayer,
    )
    from multimodalemotionrecognition_torch.models.factory import build_model
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
    from multimodalemotionrecognition_torch.serving.predictor import EmotionPredictor

    cfg = ModelConfig(fusion="xattn", use_wavlm=True)
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    video = rng.randint(0, 256, (8, 8, 3, 112, 112)).astype(np.uint8)
    audio = (rng.randn(8, 1, 48000) * 3000).clip(-32768, 32767).astype(np.int16)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "flagship.pt"
        torch.save({"model": model.state_dict(), "config": cfg.to_checkpoint_dict(),
                    "val_f1": 0.0}, ckpt)
        del model
        runners = {}
        for dtype in ("bfloat16", "float32"):
            for fused in ("auto", False):
                runners[dtype, fused] = TorchModelRunner(
                    ckpt, device=dev, compute_dtype=dtype, device_normalize=True,
                    fused_wavlm=fused,
                )
    for r in runners.values():
        r.warmup((1, 4, 8))
    torch.cuda.synchronize()

    # The main path: counters from 0, every request through the kernel runners.
    wavlm_attention_sublayer.launches = 0
    fused_conv_layer.launches = 0
    served, forwards = {}, 0
    for dtype in ("bfloat16", "float32"):
        runner = runners[dtype, "auto"]
        out = {n: runner.predict_probs(video[:n], audio[:n]) for n in (1, 3, 8)}
        out["blank"] = runner.predict_probs_blank_video(audio[:3])
        predictor = EmotionPredictor(runner=runner)
        out["predictor"] = predictor.predict_tensors(video[:1], audio[:1])
        served[dtype] = out
        forwards += 5
    torch.cuda.synchronize()
    launches = {"wavlm_attention_sublayer": wavlm_attention_sublayer.launches,
                "fused_conv_layer": fused_conv_layer.launches}
    print(f"serve: {forwards} forwards, launches {launches} "
          f"(per forward: K1 {launches['wavlm_attention_sublayer'] / forwards:g}, "
          f"K3 {launches['fused_conv_layer'] / forwards:g})")
    if launches != {"wavlm_attention_sublayer": 12 * forwards,
                    "fused_conv_layer": 6 * forwards}:
        raise AssertionError(f"expected 12 K1 and 6 K3 launches per forward: {launches}")

    for dtype, out in served.items():
        plain = runners[dtype, False]
        want = {n: plain.predict_probs(video[:n], audio[:n]) for n in (1, 3, 8)}
        want["blank"] = plain.predict_probs_blank_video(audio[:3])
        for key, probs in want.items():
            got = out[key]
            expected_rows = 3 if key == "blank" else key
            if got.shape != (expected_rows, cfg.num_classes) or not np.isfinite(got).all():
                raise AssertionError(f"{dtype} {key}: bad output {got.shape}")
            if not np.allclose(got.sum(axis=1), 1.0, atol=1e-4):
                raise AssertionError(f"{dtype} {key}: probabilities do not sum to 1")
            err = float(np.abs(got - probs).max())
            print(f"serve {dtype} {key}: max |kernel - plain| = {err:.3e} "
                  f"(tol {PROBS_TOL[dtype]})")
            if not err <= PROBS_TOL[dtype]:
                raise AssertionError(f"{dtype} {key}: kernel path disagrees with plain path")
        if float(out[8].std(axis=0).max()) < 1e-6:
            raise AssertionError(f"{dtype}: probabilities constant across clips")
        pred = out["predictor"]
        if abs(sum(pred["probs"]) - 100.0) > 1e-2 or pred["top1"]["label"] not in pred["labels"]:
            raise AssertionError(f"{dtype}: malformed predictor output {pred}")
        print(f"serve {dtype}: b8 probs[0] {np.round(out[8][0], 4).tolist()} "
              f"predictor top1 {pred['top1']}")

    perf = {}
    for dtype in ("bfloat16", "float32"):
        for fused in ("auto", False):
            runner = runners[dtype, fused]
            b1 = host_ms(lambda: runner.predict_probs(video[:1], audio[:1]))
            b8 = host_ms(lambda: runner.predict_probs(video, audio))
            path = "kernels" if fused == "auto" else "plain"
            perf[f"{dtype}_{path}"] = {"b1_ms": b1, "b8_clips_per_s": 8e3 / b8}
            print(f"serve {dtype} {path}: b1 latency {b1:.2f} ms, b8 {8e3 / b8:.1f} clips/s "
                  f"[{card}]")
    return launches, perf


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from multimodalemotionrecognition_torch.kernels.build import BUILD_DIR, load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {Path(lib._name).relative_to(REPO)}")
    for log in BUILD_DIR.glob("*.log"):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas", line.split("info    :")[-1].strip())

    gen = torch.Generator().manual_seed(SEED)
    k1 = check_k1(dev, gen)
    k3 = check_k3(dev, gen)
    launches, perf = serve(dev, card)

    kernels = []
    for name, source, replaces, rep in (
        ("wavlm_attention_sublayer", "multimodalemotionrecognition_torch/kernels/csrc/wavlm_attn.cu",
         "multimodalemotionrecognition_tpu/ops/pallas_wavlm_attn.py:83", k1),
        ("fused_conv_layer", "multimodalemotionrecognition_torch/kernels/csrc/conv_fe.cu",
         "multimodalemotionrecognition_tpu/ops/pallas_conv_fe.py:46", k3),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "dtype": "bfloat16", **rep["bfloat16"],
            "float32": rep["float32"],
        })
    print(json.dumps({"kernels": kernels, "serve": perf, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
