#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build, check and time its kernels,
serve the flagship model at full width through `TorchModelRunner` and the
serving stack (dynamic batcher, HTTP apps, WebSocket streaming), run the
measurement entry points, serve the other model families, train the
flagship through `EmotionTrainer` (with gradient accumulation, the alignment
loss, the branch warm start, resume and the test confusion matrix), train
from a generated corpus through the data pipeline and the `train`, `eval`
and convergence-gate entry points, export the flagship with `torch.export`
and serve it from the artifact, and crop faces with the BlazeFace detector
in front of a flagship forward.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (the first failure ends the run with a non-zero exit code):

  1. device  - the card's name and power limit (nvidia-smi); no CUDA, no run.
  2. build   - nvcc builds the kernels from `multimodalemotionrecognition_torch/
               kernels/csrc/` for sm_90a, one process per source; the run
               fails if ptxas reports a spill in a tensor-core kernel.
  2a. media - the native libav loader (`native/`): whether pkg-config finds
               libav on this machine, and the behaviour that follows.
               Without libav: `medialoader.available()` is False, the build
               and `python -m multimodalemotionrecognition_torch build-native`
               fail with pkg-config's message, a container's audio raises
               with it, and video decode takes cv2 (phases 5a, 11 and 13
               decode through cv2).  With libav: the build and its seconds,
               then a 3 s .webm (vp8 + opus) and .mp4 (h264 + aac) of a
               synthetic face at 256 px with a 48 kHz tone, written by
               `encode_av`, decoded by the loader and by cv2: the sampled
               frames' mean and p99 difference (the JAX suite's bounds) and
               the tone's peak within 3 Hz.
  3. kernels - each kernel against its plain PyTorch version at the serving
               path's shapes, with TF32 off: K1 (B=8, T=149, E=768, 12 heads)
               and K3 (layers L1..L6 at B=8) in float32 and bfloat16; K4, the
               whole fusion block (B=8 and B=1, T=8, Ta=149, 512/768 -> 128),
               for the flagship spec and for (attn pool, gated head, prior),
               float and int8 matrices, float32 and bfloat16 tower outputs,
               on the route its shapes take (the tensor-core route here): 1, 3
               and 8 samples per block and a second run bit-identical, and
               its device time per launch by kernel name; K5, the attention core,
               with and without biases; K6, the batch-tiled attention sublayer
               (B=128 and B=8, Tp=160, seq_len 149, E=768, bfloat16 and
               float32) for G in {1, 2, 4, 8}: against its plain version,
               every G against G=1 bit for bit, against K1 on the same
               tensors, a time per G beside K1's.  Max error, kernel and plain times
               from CUDA events, the library call's time where one PyTorch
               call computes the same function (K3: conv1d + gelu), and each
               kernel's bound: the larger of its bytes over 3.35 TB/s and its
               operations over the peak rate of their type (float32: 3xTF32 on
               the tensor cores, 495 / 3 TFLOP/s, beside the 67 TFLOP/s of
               the CUDA cores).  K1's and K3's device time per launch by
               kernel name (`torch.profiler`), which also names the kernel
               each dtype ran.  K3, K1 and K2 run on the tensor cores in both
               dtypes (wgmma, mma.sync; float32 as 3xTF32 split products), K4's
               products as 3xTF32 on mma.sync.
  4. serve   - the flagship model (xattn + WavLM-base 12x768 + ResNet18,
               concat head, mean pooling, d_model 128) with random weights
               from a seeded generator, saved as a reference-format .pt and
               loaded by `TorchModelRunner` in bf16 and f32 (uint8 video,
               int16 audio).  Requests of 1, 3 and 8 clips, a blank-video
               request and an `EmotionPredictor` call, checked against the
               same weights on the plain (modular) path on the card, with
               the kernels' launch counts (12 K1 + 6 K3 per forward); then
               one b8 request per dtype under `torch.profiler` (device busy
               time, idle share, the largest kernels).
  5. fused   - the same checkpoint through `TorchModelRunner(fused=True)`,
               `(quantize_int8=True)` and both, bf16 and f32: fused against
               modular, int8 + fused against int8, int8 against float; 1 K4,
               12 K1 and 6 K3 launches per fused forward.
  5a. serve-stack - the serving stack on the same checkpoint.  Part a
               (stdlib, numpy, scipy, torch): a burst of 24 .wav uploads
               (scipy-written seeded noise: 3 s at 16 kHz, 2 s at 48 kHz,
               4 s at 22.05 kHz) through `InferenceGateway` +
               `DynamicBatcher` over `TorchModelRunner` (ServeConfig's
               defaults: batches of up to 8, 20 ms, buckets 1, 2, 4, 8, the
               int16 wire, the blank-video route) in float32, in bfloat16
               and with `fused_xattn` (float32), each after an untimed burst
               of 8: every result against
               `predict_probs_blank_video` on the same preprocessed audio
               called directly (the serve tolerances, the same argmax), the
               result keys, at least one batch of more than one request
               (StageTimer's batch sizes), exactly 12 K1 + 6 K3 (+ 1 K4
               fused) launches per batch forward; clips/s through the
               batcher, queue_delay_ms median and largest, StageTimer's
               preprocess and infer ms; `EmotionPredictor.predict` on a .wav
               file; the host time of entering and leaving the runner's
               stream (what each request of the existing paths gained).
               Part b (aiohttp, cv2): the direct and the queued app
               on 127.0.0.1 through AppRunner + TCPSite with the real
               runner: GET /health ("gpu"), POST /predict of a .wav,
               /queue/status and /metrics, one /ws/stream session (JPEG
               frames, PCM16 audio) until a prediction comes back.
  6. blocks  - K5's and K4's public entries on the served model's own
               tokens, against the modular fusion modules they stand for, with
               the modules' device and host times beside K4's.
  7. timing  - b1 latency and b8 clips/s of all ten runners, taking turns.
  7a. bench  - the measurement entry points through their normal entries:
               `bench.attn_tile.main` (K6 per G beside K1, B=128),
               `bench.forward.run_single` with BENCH_WAVLM=1 and 0 (batch 32)
               and `entry.entry()`; their JSON lines, K6's launch count, and
               12 K1 + 6 K3 launches per WavLM forward.  K1 and K3 against
               their plain versions at these entries' batches (32 and 1), and
               the measured WavLM forward and `entry()`'s against the same
               weights and inputs on the plain path.
  7b. families - xattn + mel, gated + AudioResNet18, late, concat, audio,
               video, and xattn + WavLM with the transformer pooler, at full
               width from checkpoints written here (random weights from the
               seed), through `TorchModelRunner` in bf16 and f32: b1 and b8,
               probabilities finite, rows summing to 1, varying across clips,
               the f32 b1 answer against the same checkpoint served on the
               CPU, b1 latency and b8 clips/s.
  8. train kernels - K1 with its two in-kernel dropouts (0.1, 0.1) and K2,
               its backward, at the training shapes (B=16, T=149, E=768), and
               K3 (L1..L6 at B=16, as phase 3 holds it at B=8), in
               float32 and bfloat16: both dropout masks read out of the
               kernel through crafted inputs and held bit for bit against
               the hash's plain version; K1's output and all ten of K2's
               gradients (with and without dropout, from a seeded cotangent)
               against the plain versions; two runs of K2 bit-identical;
               device times behind the plug, and K2's bound; K2's device
               time per launch by kernel name in both dtypes
               (`torch.profiler`), which also names the kernels of K2's route.
  9. train   - `EmotionTrainer` on the full-width flagship, two-stage, batch
               16 (uint8 video with brightness and noise replayed on the
               device, float32 audio), in float32 and in bfloat16 compute
               with float32 parameters: 3 stage-1 steps, the stage flip, 3
               stage-2 steps, each through `run_epoch` (and 8 more per stage
               for the step time).  Checks: finite
               losses; parameters frozen in a stage bit-identical after it
               and trainable ones changed; the Adam count reset at the flip;
               BatchNorm statistics moved; per step 12 K1 launches less the
               LayerDrop skips, 6 K3, and one K2 per trainable encoder layer
               that ran (none in stage 1); the saved checkpoint through
               `TorchModelRunner` gives the trainer's eval loss and
               predictions.  Step times (median) and peak device memory;
               then two more stage-2 steps under `torch.profiler` for the
               device's busy share and the device time of K1, K2 and K3.

  9a. train families - `EmotionTrainer` single-stage on gated +
               AudioResNet18, late and audio (mel input made inside the step)
               at full width, float32, batch 16: the eval step's loss against
               the same seeded state on the CPU, 3 steps with finite losses,
               every parameter and BatchNorm statistic moved, the saved
               checkpoint through `TorchModelRunner` gives the eval loss.

  10. train rest - the rest of `EmotionTrainer` at full width, batch 16, in
               float32 and bfloat16: the flagship two-stage with
               `grad_accum=2`, two stage-2 steps with launches counted per
               microbatch (12 K1 less the LayerDrop skips, 6 K3, one K2 per
               trainable layer that ran, twice a step); a resume file saved
               after them, restored into a fresh trainer, one more step on
               both (cuDNN's deterministic algorithms for that step):
               parameters, buffers and moments bit-identical; step time and
               peak memory with `grad_accum` 1 against 2, in turns; with
               every stochastic op of the train forward off, the gradients
               of accum 2 on [m, m] against accum 1 on m (8 clips: 1e-5 /
               1e-3 of each largest entry); gated + WavLM with the CLIP
               alignment loss, accum 2, three steps (the loss finite,
               non-zero, moving; the same launch counts); raw torchvision
               resnet18 (with `fc.*`) and HF WavLMModel (positional conv as
               weight-norm g and v) state dicts made here from seeded random
               tensors, converted by `convert/pretrained.py`, the flagship
               warm-started from them (every branch tensor bit-equal to its
               source, the positional conv within 1e-6 of g * v / |v|), one
               step; `fit` with a test loader: `confusion_matrix.csv` sums to
               the valid test clips and equals the eval predictions' matrix.
               The phase's wall time.

  11. data cli - in a temporary working directory: (a) `make-data`: the
               convergence gate's corpus (8 actors x 8 emotions x 4 clips of
               1 s at 10 fps, strong signal, s=0.4, seed 7) and the command's
               default corpus (4 actors x 8 emotions x 1 clip of 3 s), pair
               counts and seconds; (b) `bench.convergence_gate` at its
               defaults (gated, 12 epochs, batch 16, 4 frames of 64 px, the
               uint8 wire): its JSON line, the decode threads and CPUs, the
               train loader's median wait per batch beside the median host
               step; the run fails below 0.70 actor-held-out test accuracy;
               (b') the gate's trained checkpoint exported with `--int8`
               (buckets 1 and 8): its accuracy on the held-out actor's 32
               clips (decoded at 8 frames of 112 px, the export's input)
               beside the float32 runner's on the same clips;
               (c) the flagship two-stage (1 + 1 epochs, batch 16, 8 frames of
               112 px, face crop, float32) through `train.cli.main`: losses,
               accuracies, epoch times, loader waits, every K1, K2 and K3
               launch of the run against each WavLM forward's LayerDrop draws
               and trainable layers; then `train.eval.main` on its best
               checkpoint: accuracy equal to a float32 `TorchModelRunner` on
               the same 8 test clips, the same argmax on each.

  12. export - the flagship checkpoint (as phase 4 writes it) through
               `python -m multimodalemotionrecognition_torch export
               --batch-sizes 1,8`, plain and with `--int8`: each bucket's
               graph holds exactly 12 K1 and 6 K3 operator nodes; a fresh
               process that imports only the port loads the artifact and
               answers 1, 8 and 11 clips (11: two forwards of the 8 bucket)
               with exactly 12 K1 and 6 K3 launches per forward; its
               probabilities within 1e-5 of `TorchModelRunner` on the same
               checkpoint and inputs; b1 and b8 latency of the exported
               program and the runner (CUDA events, 8 alternating pairs) in
               that fresh process and in this one, from host arrays and from
               inputs on the card (here also with the cyclic collector
               paused); one b8 forward of each under `device_trace`, whose
               Chrome traces must name K1's and K3's kernels.
  13. blazeface - the bundled detector on the 24 held-out scenes of
               `make_scene(default_rng(4242), p_face=1.0)`, on the CPU and on
               the card: each finds >= 0.8 of the faces at mean IoU >= 0.5,
               the two devices' boxes within 1 px, ms per frame on each; then
               with EMO_FACE_DETECTOR=blazeface the preprocessing service's
               crops of a cv2-written .mp4 (one scene at 256 px, 16 frames)
               equal `crop_with_padding` on the detector's own box, and the
               clip through the float32 flagship runner with exactly 12 K1
               and 6 K3 launches.
  14. data parallel - two ranks of `torch.distributed` (`parallel.launch`):
               NCCL over two cards when there are two, else two Gloo ranks
               on cuda:0 (the line says which).  (a) The flagship's stage-2
               step at full width, batch 16 (8 a rank), float32 and
               bfloat16, WavLM's dropouts and LayerDrop on, through
               `run_epoch` on each rank against one rank on the 16 clips
               here: both ranks run one rank's `layers_run`, each launches
               12 K1 less the skips, 6 K3 and one K2 per trainable layer
               that ran; losses within 1e-5 (bf16 3e-2), every trainable
               gradient before the optimizer equal on both ranks and within
               K2's 1e-4 of its largest entry in float32, the ResNet's
               within 0.1; in bfloat16 within the larger of 3e-2 and twice
               how far bfloat16 moves that gradient from float32's on one
               rank, at most 0.5; the BatchNorm statistics within 1e-5
               (bf16 3e-2) of each largest entry; step times of one rank
               and of each rank.  (b)
               `TorchModelRunner(mesh=make_mesh((2, 1), ...))`, the kernels
               and the fused runner in float32, at 8 clips and at 1 (bucket
               2), against the single-card runner within 1e-5, with 12 K1 +
               6 K3 (+ 1 K4) launches per replica forward.  (c)
               `entry.dryrun_multichip(2)`.  The phase's own seconds.

  15. tensor parallel - the WavLM trunk split over a mesh row (`parallel/
               tensor.py`), every piece on cuda:0.  (a) `TorchModelRunner` on
               meshes (1, 2) (1, 3 and 8 clips and a blank-video request)
               and (2, 2) (8 clips), float32, bfloat16 and int8: against
               the single-card runner with `fused_wavlm=False` (the same
               modular attention; 1e-5, 2e-2, 1e-5) and against the kernels
               runner (1e-3, 2e-2); 6 K3, no K1 and no K4 launches per
               replica forward; each piece's parameter bytes beside the
               unsharded model's.  (b) The flagship's stage-2 step at batch
               16, float32 and bfloat16, WavLM's default rates, tp 2 in one
               process against tp 1, both with the modular attention: the
               same LayerDrop draw, 6 K3 and no K1 or K2 per step, the loss
               within 1e-5 (bf16 3e-2), every gathered trainable gradient
               within phase 14's bounds; a resume file written under tp 2
               read under tp 1 bit for bit; step times of tp 1 and tp 2.
               (c) `entry.dryrun_multichip(4)`: dp 2 x tp 2 on Gloo ranks
               whose rows share cuda:0.  The phase's own seconds.

The line before the last two is the JSON kernel report; then the card's
line; the last line is {"ok": true, "device": {...}}.

`python3 chip_smoke.py --dp-grad-spread` runs only a diagnostic of phase
14 (a)'s gradients: one rank twice on identical input, with PyTorch's
default and its deterministic algorithms, and 2 ranks against 1 with each
and with the train-mode BatchNorm variance taken in two passes; it writes
chiprun_out/dp_grad_spread.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as F

SEED = 0
REPO = Path(__file__).resolve().parent
K1_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # abs, after the LayerNorm
K3_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (0.0, 2e-2)}  # abs, x max|ref|
PROBS_TOL = {"float32": 1e-3, "bfloat16": 2e-2}  # abs, kernel path vs plain path
CPU_PROBS_TOL = 1e-3  # abs, float32 probabilities on the card (TF32 off) vs on the CPU
BENCH_BATCH, BENCH_ITERS = 32, 10  # `bench.forward` in this script (its defaults: 128, 40)
FUSION_TOL = 1e-4  # abs, K4 logits and K5 embeddings (float32 math, other sum order)
FUSED_PROBS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # abs, K4 (float32 math) vs modules
INT8_TOL = 0.05  # abs on probabilities, int8 weights vs float weights, same argmax
# K2's gradients, relative to each gradient's largest entry.  float32: another
# sum order.  bfloat16: kernel and plain version round the operands of every
# product to bfloat16 at values a float32 rounding apart, and K2 reads K1's
# context where the plain version recomputes it.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# The trainer's eval loss against the runner on the saved checkpoint: float32
# the same modules and weights; bfloat16 the runner casts the weights once,
# the trainer per step, and the towers round differently.
EVAL_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# Per stage: 3 steps, then the stage's checks, then 6 more steps whose median
# is the step time (the first steps of a stage pay cuDNN's algorithm choice).
TRAIN_BATCH, TRAIN_STEPS, TIMED_STEPS = 16, 3, 6
# Published H100 SXM peaks: HBM3 bytes/s; dense FLOP/s by operand type.
# float32 work: 3xTF32 on the tensor cores (three TF32 products of 495
# TFLOP/s for each float32 one), the least time the card takes for it; the
# CUDA cores' 67 TFLOP/s is reported beside it.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
F32_CUDA_CORE_FLOPS = 67e12


def _plug(ms_wanted: float) -> None:
    """Keep the card busy for about `ms_wanted`, so that launches queued
    behind it wait on the card and not on the host."""
    if not hasattr(_plug, "operand"):
        _plug.operand = torch.randn(4096, 4096, device="cuda")
        _timed(lambda: torch.matmul(_plug.operand, _plug.operand), 3)  # cuBLAS set-up
        _plug.ms = _timed(lambda: torch.matmul(_plug.operand, _plug.operand), 10)
    for _ in range(max(1, round(ms_wanted / _plug.ms))):
        torch.matmul(_plug.operand, _plug.operand)


def _timed(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of fn() in ms: CUDA events around `iters` calls queued
    behind a plug twice as long as the host needs to queue them (read from
    the warm-up calls), so the host's pace of launching does not show."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / warmup
    torch.cuda.synchronize()
    _plug(min(1000.0, max(20.0, 2.0 * iters * host)))
    return _timed(fn, iters)


def enqueue_ms(fn, iters: int = 20) -> float:
    """Host time of one fn() call in ms, not waiting for the card: what a
    request's host thread pays to launch it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host


def bound(flops: float, nbytes: float, dtype) -> dict:
    """The least time the card could take: each input read once, each output
    written once, against the operations at the peak rate of their type."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    out = {"bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    if dtype == torch.float32:
        out["bound_cuda_core_ms"] = max(by_bytes, flops / F32_CUDA_CORE_FLOPS * 1e3)
    return out


def _bound_text(limit: dict) -> str:
    text = f"bound {limit['bound_ms']:.5f} ms ({limit['bound_by']})"
    if "bound_cuda_core_ms" in limit:
        text += f", CUDA-core bound {limit['bound_cuda_core_ms']:.5f} ms"
    return text


# The kernels each route launches, by profiler name: K1's core and
# out-projection, K3, K2's products and attention passes, K4's and K5's four
# launches, K6's core and out-projection, per dtype (their tensor-core routes
# at these shapes).
ROUTE_KERNELS = {
    "K1": {torch.float32: ("attn_core_tf32", "out_proj_tf32"),
           torch.bfloat16: ("attn_core_mma", "out_proj_mma")},
    "K3": {torch.float32: ("conv_fe_tf32",), torch.bfloat16: ("conv_fe_wgmma",)},
    "K2": {torch.float32: ("bwd_transpose_tf32", "bwd_proj_tf32", "bwd_query_tf32",
                           "bwd_key_tf32"),
           torch.bfloat16: ("bwd_proj_mma", "bwd_attn_mma")},
    "K4": {dtype: ("fb_rows_tc", "fb_video_tc", "fb_audio_tc", "fb_head_tc")
           for dtype in (torch.float32, torch.bfloat16)},
    "K5": {torch.float32: ("xa_rows_tc", "xa_video_tc", "xa_audio_tc", "xa_pool")},
    "K6": {torch.float32: ("tiled_core_tf32", "tiled_proj_tf32"),
           torch.bfloat16: ("tiled_core_mma", "tiled_proj_mma")},
}


def _check_route(label: str, dtype, names) -> bool:
    """Fails unless the profiler saw the route's kernels and no CUDA-core
    one.  A profile with no device event names nothing (as the serve and
    train profiles, "not measured"): -> False, and the run goes on."""
    if not names:
        print(f"{label} {dtype}: the profiler saw no device time; kernels not named")
        return False
    want = ROUTE_KERNELS[label][dtype]
    cuda_core = ("wavlm_attn_core", "wavlm_attn_out_proj", "conv_fe_kernel", "bwd_gemm",
                 "bwd_attn_q", "bwd_attn_kv", "fused_block_core", "fused_block_audio_tokens",
                 "xattn_core", "xattn_audio_proj", "tiled_attn_core", "tiled_out_proj")
    if not all(any(w in n for n in names) for w in want) or any(
            c in n for c in cuda_core for n in names):
        raise AssertionError(f"{label} {dtype}: expected {want} by profiler, saw {sorted(names)}")
    return True


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _short_name(key: str) -> str:
    """A CUDA kernel's name without its namespaces, return type and arguments."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "", 1)
    return key.split("(")[0].split("::")[-1]


def _sublayer_inputs(dev, gen, dtype, b, t=149, e=768, h=12):
    """K1's ten operands at the WavLM-base widths, random from `gen`."""
    def r(*shape, scale=1.0, shift=0.0, dt=dtype):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev, dt)

    return [
        r(b, t, e), r(b, t, e, scale=(e // h) ** -0.5), r(b, t, e), r(b, t, e),
        (1.0 + torch.rand(b, h * t, 1, generator=gen)).to(dev),
        r(h * t, t, dt=torch.float32), r(e, e, scale=e**-0.5),
        r(1, e, scale=0.1, dt=torch.float32),
        r(1, e, scale=0.1, shift=1.0, dt=torch.float32),
        r(1, e, scale=0.1, dt=torch.float32),
    ]


def check_k1(dev, gen, b=8):
    """K1 at batch `b`: 8 is the serving bucket, BENCH_BATCH and 1 what the
    measurement entry points give it."""
    from multimodalemotionrecognition_torch.kernels import (
        wavlm_attention_sublayer,
        wavlm_attention_sublayer_plain,
    )

    t, e, h = 149, 768, 12
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = _sublayer_inputs(dev, gen, dtype, b)
        got = wavlm_attention_sublayer(*args, num_heads=h, seq_len=t)
        want = wavlm_attention_sublayer_plain(*args, num_heads=h, seq_len=t)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: wavlm_attention_sublayer(*args, num_heads=h, seq_len=t))
        plain_ms = cuda_ms(lambda: wavlm_attention_sublayer_plain(*args, num_heads=h, seq_len=t))
        name = str(dtype).replace("torch.", "")
        # q.k and p.v per head, then the out-projection; operands once + out.
        limit = bound(4 * b * t * t * e + 2 * b * t * e * e, nbytes(*args, got), dtype)
        print(f"K1 {name}: B={b} T={t} E={e} H={h} max_abs_err={err:.3e} "
              f"(tol {K1_TOL[dtype]}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"{_bound_text(limit)}")
        if not err <= K1_TOL[dtype]:
            raise AssertionError(f"K1 {name} disagrees with its plain version: {err}")
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **limit,
                        "library_ms": None}
        split = profile_steps(lambda: wavlm_attention_sublayer(*args, num_heads=h, seq_len=t),
                              n=5, want=ROUTE_KERNELS["K1"][dtype])["kernels"]
        _check_route("K1", dtype, split)
        print(f"K1 {name} B={b} per launch: "
              + ", ".join(f"{kernel} {ms:.4f} ms" for kernel, ms in split.items()))
        report[name]["split_ms"] = split
    return report


def check_k3(dev, gen, b=8):
    """K3's six layers at batch `b`: 8 is the serving bucket, TRAIN_BATCH what
    a train step gives the frozen feature extractor, BENCH_BATCH and 1 what
    the measurement entry points give it."""
    from multimodalemotionrecognition_torch.config import WavLMConfig
    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        fused_conv_layer_plain,
    )
    from multimodalemotionrecognition_torch.kernels.conv_fe import split_weight_tf32

    cfg = WavLMConfig()
    t_log = (48000 - cfg.conv_kernel[0]) // cfg.conv_stride[0] + 1
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        total = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
        if dtype == torch.float32:
            total["ms_cached_split"] = 0.0  # the weight's TF32 split made once, as when serving
        flops = moved = 0
        names = set()
        t_in = t_log
        for i in range(1, len(cfg.conv_dim)):
            k, s, cin, cout = cfg.conv_kernel[i], cfg.conv_stride[i], cfg.conv_dim[i - 1], cfg.conv_dim[i]
            rows = -(-t_in // s)
            y = torch.randn(b, rows, s * cin, generator=gen).to(dev, dtype)
            w = (torch.randn(k * cin, cout, generator=gen) * (k * cin) ** -0.5).to(dev, dtype)

            # Per call the float32 wrapper also splits the weight: counted in `ms`.
            def kernel(w_split=None):
                return fused_conv_layer(y, w, k, s, cin, gelu_output=True, t_in=t_in,
                                        w_split=w_split)

            def plain():
                return fused_conv_layer_plain(y, w, k, s, cin, gelu_output=True, t_in=t_in)

            t_out = (t_in - k) // s + 1
            got, want = kernel()[:, :t_out].float(), plain()[:, :t_out].float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            atol, rtol = K3_TOL[dtype]
            tol = max(atol, rtol * want.abs().max().item())
            # The one library call for the same function: conv1d + gelu (NCW).
            x_ncw = y.view(b, rows * s, cin)[:, :t_in].transpose(1, 2).contiguous()
            w_oik = w.view(k, cin, cout).permute(2, 1, 0).contiguous()

            def library():
                return F.gelu(F.conv1d(x_ncw, w_oik, stride=s))

            ms, plain_ms, library_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
            cached = ""
            if dtype == torch.float32:
                w_split = split_weight_tf32(w)
                cached_ms = cuda_ms(lambda: kernel(w_split))
                total["ms_cached_split"] += cached_ms
                cached = f" (weight split cached: {cached_ms:.4f} ms)"
            flops += 2 * b * t_out * k * cin * cout
            moved += (b * t_in * cin + k * cin * cout + b * t_out * cout) * y.element_size()
            print(f"K3 {name} L{i}: B={b} t_in={t_in} t_out={t_out} k={k} s={s} "
                  f"max_abs_err={err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms{cached} "
                  f"plain {plain_ms:.4f} ms conv1d+gelu {library_ms:.4f} ms")
            if i == 1:
                names |= set(
                    profile_steps(kernel, n=3, want=ROUTE_KERNELS["K3"][dtype])["kernels"])
            if not err <= tol:
                raise AssertionError(f"K3 {name} L{i} disagrees with its plain version: {err}")
            total["max_abs_err"] = max(total["max_abs_err"], err)
            total["ms"] += ms
            total["plain_ms"] += plain_ms
            total["library_ms"] += library_ms
            t_in = t_out
        total.update(bound(flops, moved, dtype))
        named = _check_route("K3", dtype, names)
        total["kernel_names"] = sorted(n for n in names if "conv_fe" in n) if named else None
        print(f"K3 {name} B={b} L1-L6 ({', '.join(total['kernel_names'] or ['not named'])}): kernel "
              f"{total['ms']:.4f} ms plain {total['plain_ms']:.4f} ms conv1d+gelu "
              f"{total['library_ms']:.4f} ms {_bound_text(total)}")
        report[name] = total
    return report


class _Tower(torch.nn.Module):
    """Stands in for a tower in the K4 check: the block only reads its width."""

    def __init__(self, width: int):
        super().__init__()
        self.embedding_dim = self.sequence_dim = width

    def encode_sequence(self, x, *train):
        return x


def _fusion_block(gen, dev, int8: bool, **options):
    """A full-width fusion block with random parameters (biases and norm
    scales too, so a misplaced operand shows) -> (FusionModel, params, spec)."""
    from multimodalemotionrecognition_torch.kernels import FusedBlockSpec, extract_block_params
    from multimodalemotionrecognition_torch.models.factory import init_parameters
    from multimodalemotionrecognition_torch.models.fusion import FusionModel
    from multimodalemotionrecognition_torch.runtime.quant import quantize_linears_int8

    model = FusionModel(_Tower(768), _Tower(512), num_classes=8, **options)
    init_parameters(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim < 2:
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    model = model.to(dev).eval()
    if int8:
        quantize_linears_int8(model)
    spec = FusedBlockSpec(
        num_heads=4, d_model=128, pooling=options.get("temporal_pooling", "mean"),
        head=options.get("xattn_head", "concat"),
        use_prior=options.get("xattn_use_emotion_prior", False), num_classes=8,
    )
    return model, extract_block_params(model.state_dict(), spec, device=dev), spec


def check_k4(dev, gen):
    """K4 at B=8 and B=1 for two specs, float and int8 matrices, both tower
    dtypes: against its plain version, bit-identical for 1, 3 and 8 samples
    per block and across two runs; the route its shapes take; device times
    (the whole call and, for the flagship in bfloat16, each launch)."""
    from multimodalemotionrecognition_torch.kernels import fused_block, fused_block_plain
    from multimodalemotionrecognition_torch.kernels.fused_block import tensor_core_route

    t, ta, dv, ds = 8, 149, 512, 768
    variants = {
        "flagship": {},
        "attn_gated_prior": dict(temporal_pooling="attn", xattn_head="gated",
                                 xattn_use_emotion_prior=True),
    }
    report, worst = {}, 0.0
    for variant, options in variants.items():
        for int8 in (False, True):
            _, params, spec = _fusion_block(gen, dev, int8, **options)
            for dtype in (torch.float32, torch.bfloat16):
                for b in (8, 1):
                    v_feat = torch.randn(b, t, dv, generator=gen).abs().to(dev, dtype)
                    a_seq = torch.randn(b, ta, ds, generator=gen).to(dev, dtype)
                    route = "tensor cores" if tensor_core_route(v_feat, a_seq, params, spec) else "CUDA cores"
                    runs = {per_block: fused_block(v_feat, a_seq, params, spec,
                                                   samples_per_block=per_block)
                            for per_block in (1, 3, 8)}
                    again = fused_block(v_feat, a_seq, params, spec)
                    want = fused_block_plain(v_feat, a_seq, params, spec)
                    torch.cuda.synchronize()
                    name = (f"{variant} {'int8' if int8 else 'float'} "
                            f"{str(dtype).replace('torch.', '')} B={b}")
                    identical = all(torch.equal(runs[1], out) for out in (runs[3], runs[8], again))
                    for per_block, got in runs.items():
                        err = (got - want).abs().max().item()
                        worst = max(worst, err)
                        if got.shape != (b, 8) or not err <= FUSION_TOL:
                            raise AssertionError(f"K4 {name} samples/block={per_block} disagrees "
                                                 f"with its plain version: {err}")
                    err = (runs[1] - want).abs().max().item()
                    line = (f"K4 {name}: route {route}, max_abs_err={err:.3e} (tol {FUSION_TOL}), "
                            f"samples/block 1, 3, 8 and a second run bit-identical: {identical}")
                    if not identical:
                        raise AssertionError(f"K4 {name}: logits differ across samples per block or runs")
                    if not int8:
                        ms = cuda_ms(lambda: fused_block(v_feat, a_seq, params, spec))
                        plain_ms = cuda_ms(lambda: fused_block_plain(v_feat, a_seq, params, spec))
                        line += f"; kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
                        if b == 8:
                            ms8 = cuda_ms(lambda: fused_block(v_feat, a_seq, params, spec,
                                                              samples_per_block=8))
                            line += f", 8 samples per block {ms8:.4f} ms"
                        if (variant, dtype) == ("flagship", torch.bfloat16):
                            split = profile_steps(
                                lambda: fused_block(v_feat, a_seq, params, spec), n=5,
                                want=ROUTE_KERNELS["K4"][dtype])["kernels"]
                            _check_route("K4", dtype, split)
                            print(f"K4 {name} per launch: "
                                  + ", ".join(f"{k} {x:.4f} ms" for k, x in split.items()))
                            key = "" if b == 8 else f"_b{b}"
                            d, c, hid = 128, 8, 256
                            flops = 2 * b * (t * dv * d + ta * ds * d + ta * d * d  # input proj
                                             + 4 * t * d * d + 4 * ta * d * d  # q, k, v, out x 2
                                             + 4 * t * ta * d  # scores and contexts x 2
                                             + 2 * d * hid + hid * c)  # head
                            moved = nbytes(v_feat, a_seq, want, *params.matrices.values(),
                                           *params.vectors.values())
                            limit = bound(flops, moved, torch.float32)
                            report.update({f"max_abs_err{key}": err, f"ms{key}": ms,
                                           f"plain_ms{key}": plain_ms, f"split_ms{key}": split,
                                           f"route{key}": route,
                                           **{f"{k}{key}": x for k, x in limit.items()}})
                            if b == 8:
                                report.update({
                                    "library_ms": None, "ms_8_samples_per_block": ms8,
                                    "host_enqueue_ms": enqueue_ms(
                                        lambda: fused_block(v_feat, a_seq, params, spec)),
                                    "plain_host_enqueue_ms": enqueue_ms(
                                        lambda: fused_block_plain(v_feat, a_seq, params, spec))})
                                line += (f"; host enqueue kernel {report['host_enqueue_ms']:.4f} ms"
                                         f" plain {report['plain_host_enqueue_ms']:.4f} ms")
                            line += (f"; bound {limit['bound_ms']:.5f} ms ({limit['bound_by']}; "
                                     f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB)")
                    print(line)
    report["max_abs_err_all_variants"] = worst
    return report


def check_k5(dev, gen):
    """K5 at the serving shapes (T=8, Ta=149, d=128, 4 heads), B=8 and B=1,
    with and without the external biases: against its plain version, one
    counted launch per call, the route its shapes take, a sample's
    embeddings at B=1 equal to the bit to its row at B=8 and across two
    runs; the tensor-core route's time beside the CUDA-core kernels' in the
    same call, and each launch's device time."""
    from multimodalemotionrecognition_torch.kernels import (
        fused_bidirectional_xattn,
        fused_bidirectional_xattn_plain,
        xattn_params_from_state_dict,
    )
    from multimodalemotionrecognition_torch.kernels import xattn

    t, ta, d, h = 8, 149, 128, 4
    model, _, _ = _fusion_block(gen, dev, int8=False)
    params = xattn_params_from_state_dict(model.state_dict(), device=dev)
    v8 = torch.randn(8, t, d, generator=gen).to(dev)
    a8 = torch.randn(8, ta, d, generator=gen).to(dev)
    bias8 = ((torch.randn(8, t, ta, generator=gen) * 0.5).to(dev),
             (torch.randn(8, ta, t, generator=gen) * 0.5).to(dev))
    report, full = {}, {}
    for b in (8, 1):
        for with_bias in (False, True):
            v, a = v8[:b].contiguous(), a8[:b].contiguous()
            biases = tuple(x[:b].contiguous() for x in bias8) if with_bias else (None, None)

            def kernel():
                return fused_bidirectional_xattn(params, v, a, *biases, num_heads=h)

            def cuda_cores():
                return xattn._launch(params, v, a, *biases, h, tensor_cores=False)

            def plain():
                return fused_bidirectional_xattn_plain(params, v, a, *biases, num_heads=h)

            route = "tensor cores" if xattn.tensor_core_route(v, a, h) else "CUDA cores"
            before = fused_bidirectional_xattn.launches
            got = kernel()
            launched = fused_bidirectional_xattn.launches - before
            again, want, core = kernel(), plain(), cuda_cores()
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            err_core = max((g - w).abs().max().item() for g, w in zip(core, want))
            name = f"B={b} bias={with_bias}"
            if b == 8:
                full[with_bias] = got
            same_b8 = all(torch.equal(x, y[:b]) for x, y in zip(got, full[with_bias]))
            same_run = all(torch.equal(x, y) for x, y in zip(got, again))
            if (got[0].shape != (b, d) or got[1].shape != (b, d) or not err <= FUSION_TOL
                    or not err_core <= FUSION_TOL):
                raise AssertionError(f"K5 {name} disagrees with its plain version: {err} "
                                     f"(CUDA-core kernels {err_core})")
            if launched != 1 or route != "tensor cores" or not (same_b8 and same_run):
                raise AssertionError(f"K5 {name}: {launched} launches, route {route}, bit-equal "
                                     f"to B=8 {same_b8}, across runs {same_run}")
            ms, core_ms, plain_ms = cuda_ms(kernel), cuda_ms(cuda_cores), cuda_ms(plain)
            split = profile_steps(kernel, n=5, want=ROUTE_KERNELS["K5"][torch.float32])["kernels"]
            _check_route("K5", torch.float32, split)
            print(f"K5 {name}: route {route}, max_abs_err={err:.3e} (tol {FUSION_TOL}; CUDA-core "
                  f"kernels {err_core:.3e}), one launch, bit-equal to its B=8 rows and across "
                  f"runs; kernel {ms:.4f} ms, CUDA-core kernels {core_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms; per launch " + ", ".join(
                      f"{kernel_name} {x:.4f} ms" for kernel_name, x in split.items()))
            report["max_abs_err_all_variants"] = max(report.get("max_abs_err_all_variants", 0.0), err)
            key = "" if (b, with_bias) == (8, False) else f"_b{b}" + ("_bias" if with_bias else "")
            report.update({f"ms{key}": ms, f"cuda_core_ms{key}": core_ms,
                           f"plain_ms{key}": plain_ms, f"split_ms{key}": split})
            if not key:
                flops = 2 * b * (4 * t * d * d + 4 * ta * d * d + 4 * t * ta * d)
                moved = nbytes(v, a, *got, *params)
                report.update({"max_abs_err": err, "route": route,
                               **bound(flops, moved, torch.float32), "library_ms": None})
                print(f"K5 {name}: bound {report['bound_ms']:.5f} ms ({report['bound_by']}; "
                      f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB)")
    return report


def check_k6(dev):
    """K6 on the bench's tensors (Tp=160, seq_len 149, E=768, 12 heads), at
    the experiment's batch and at the serving bucket, in both dtypes: every
    G against G=1 bit for bit, rows < seq_len against K1 (bit-equal where
    both run their tensor-core routes) and the plain version; per G the
    tensor-core route's time beside the CUDA-core kernels' in the same call
    and each launch's device time -> report keyed by (dtype name, batch)."""
    from multimodalemotionrecognition_torch.bench.attn_tile import EPS, H, SEQ, make_tensors
    from multimodalemotionrecognition_torch.kernels import (
        wavlm_attention_sublayer,
        wavlm_attention_sublayer_tiled,
        wavlm_attention_sublayer_tiled_plain,
    )
    from multimodalemotionrecognition_torch.kernels import wavlm_attn_tiled

    report = {}
    for b in (128, 8):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            args = [t.to(dtype) if t.dtype == torch.bfloat16 else t for t in make_tensors(b, dev)]
            tp, e = args[0].shape[1:]
            tail = (H, SEQ, EPS)
            route = ("tensor cores" if wavlm_attn_tiled.tensor_core_route(args[0], H, SEQ)
                     else "CUDA cores")
            ref = wavlm_attention_sublayer_tiled(1, *args, *tail)
            want = wavlm_attention_sublayer_tiled_plain(1, *args, *tail)
            k1 = wavlm_attention_sublayer(*args, *tail)
            torch.cuda.synchronize()
            err = (ref[:, :SEQ].float() - want[:, :SEQ].float()).abs().max().item()
            err_all = (ref.float() - want.float()).abs().max().item()
            err_k1 = (ref[:, :SEQ].float() - k1[:, :SEQ].float()).abs().max().item()
            same_as_k1 = torch.equal(ref[:, :SEQ], k1[:, :SEQ])
            if not (torch.isfinite(ref).all() and max(err, err_all, err_k1) <= K1_TOL[dtype]):
                raise AssertionError(
                    f"K6 {name} B={b} disagrees: plain {err} (all rows {err_all}), K1 {err_k1}")
            if route != "tensor cores" or not same_as_k1:
                raise AssertionError(f"K6 {name} B={b}: route {route}, bit-equal to K1 {same_as_k1}")
            per_tile, cuda_core, split = {}, {}, {}
            for g in (1, 2, 4, 8):
                if g != 1 and not torch.equal(wavlm_attention_sublayer_tiled(g, *args, *tail), ref):
                    raise AssertionError(f"K6 {name} B={b}: G={g} differs from G=1")
                per_tile[g] = cuda_ms(lambda: wavlm_attention_sublayer_tiled(g, *args, *tail))
                cuda_core[g] = cuda_ms(
                    lambda: wavlm_attn_tiled._launch(g, *args, *tail, tensor_cores=False), iters=5)
                split[g] = profile_steps(lambda: wavlm_attention_sublayer_tiled(g, *args, *tail),
                                         n=3, want=ROUTE_KERNELS["K6"][dtype])["kernels"]
                _check_route("K6", dtype, split[g])
            k1_ms = cuda_ms(lambda: wavlm_attention_sublayer(*args, *tail))
            k1_split = profile_steps(lambda: wavlm_attention_sublayer(*args, *tail), n=3)["kernels"]
            plain_ms = cuda_ms(
                lambda: wavlm_attention_sublayer_tiled_plain(1, *args, *tail), iters=5, warmup=1)
            # q.k and p.v over seq_len keys for all Tp rows, then the out-projection.
            flops = 4 * b * tp * SEQ * e + 2 * b * tp * e * e
            limit = bound(flops, nbytes(*args, ref), dtype)
            best = min(per_tile, key=per_tile.get)
            print(f"K6 {name}: B={b} Tp={tp} seq_len={SEQ} E={e} H={H} route {route} "
                  f"max_abs_err={err:.3e} (rows < seq_len; all rows {err_all:.3e}; tol "
                  f"{K1_TOL[dtype]}), G in (2, 4, 8) equal G=1 bit for bit, against K1 "
                  f"{err_k1:.3e} (bit-equal: {same_as_k1}); kernel "
                  + ", ".join(f"G={g} {ms:.4f}" for g, ms in per_tile.items())
                  + " ms; CUDA-core kernels "
                  + ", ".join(f"G={g} {ms:.4f}" for g, ms in cuda_core.items())
                  + f" ms; K1 {k1_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
                  f"{limit['bound_ms']:.5f} ms ({limit['bound_by']}; {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes(*args, ref) / 1e6:.2f} MB)")
            for g in per_tile:
                print(f"K6 {name} B={b} G={g} per launch: "
                      + ", ".join(f"{k} {x:.4f} ms" for k, x in split[g].items()))
            print(f"K1 {name} B={b} per launch (K6's tensors): "
                  + ", ".join(f"{k} {x:.4f} ms" for k, x in k1_split.items()))
            report[name, b] = {
                "max_abs_err": err, "ms": per_tile[best], "best_tile": best, "route": route,
                "ms_per_tile": {str(g): ms for g, ms in per_tile.items()},
                "cuda_core_ms_per_tile": {str(g): ms for g, ms in cuda_core.items()},
                "split_ms_per_tile": {str(g): x for g, x in split.items()}, "k1_ms": k1_ms,
                "k1_split_ms": k1_split,
                "plain_ms": plain_ms, **limit, "library_ms": None, "bit_equal_to_k1": same_as_k1,
            }
    return report


def _masks_from_kernel(dev, dtype, seed, rate, b=TRAIN_BATCH, t=149, e=768, h=12):
    """Both keep masks as the kernel draws them, read through its output.
    With q = k = 0 the probabilities are uniform; with W_o = I, b_o = 0,
    hidden = 0 and a one-hot v the pre-LayerNorm row holds one dropped
    probability per column, zero where dropped, so after the LayerNorm
    (scale 1, bias 0) its sign is the mask: dh - 1 key columns per pass, the
    head's last column staying zero so that a row never comes out constant.
    With v = 0 and b_o = 1 the row holds the hidden mask itself (E columns:
    a row with none dropped does not occur at a rate of 0.1)."""
    from multimodalemotionrecognition_torch.kernels import wavlm_attention_sublayer

    dh = e // h
    zeros = torch.zeros(b, t, e, device=dev, dtype=dtype)
    gate = torch.ones(b, h * t, 1, device=dev)
    bias = torch.zeros(h * t, t, device=dev)
    eye = torch.eye(e, device=dev, dtype=dtype)
    row0 = torch.zeros(1, e, device=dev)
    row1 = torch.ones(1, e, device=dev)
    attn = torch.zeros(b, h, t, t, dtype=torch.bool, device=dev)
    for j0 in range(0, t, dh - 1):
        n = min(dh - 1, t - j0)
        v = zeros.clone().view(b, t, h, dh)
        v[:, torch.arange(j0, j0 + n), :, torch.arange(n)] = 1.0
        out = wavlm_attention_sublayer(
            zeros, zeros, zeros, v.view(b, t, e), gate, bias, eye, row0, row1, row0,
            num_heads=h, seq_len=t, attn_dropout=rate, dropout_seed=seed)
        attn[:, :, :, j0:j0 + n] = (out.view(b, t, h, dh)[..., :n] > 0).permute(0, 2, 1, 3)
    out = wavlm_attention_sublayer(
        zeros, zeros, zeros, zeros, gate, bias, eye, row1, row1, row0,
        num_heads=h, seq_len=t, hidden_dropout=rate, dropout_seed=seed)
    return attn, out > 0


def check_train_kernels(dev, gen):
    """K1 with dropout and K2 at the training shapes -> (K1 report, K2 report)."""
    from multimodalemotionrecognition_torch.kernels import (
        hash_keep_plain,
        wavlm_attention_sublayer,
        wavlm_attention_sublayer_backward,
        wavlm_attention_sublayer_backward_plain,
        wavlm_attention_sublayer_forward,
        wavlm_attention_sublayer_plain,
    )
    from multimodalemotionrecognition_torch.kernels.wavlm_attn import drop_threshold

    b, t, e, h, rate, seed = TRAIN_BATCH, 149, 768, 12, 0.1, 20240917
    mask32 = 0xFFFFFFFF
    batch = (seed + torch.arange(b, device=dev) * 0x632BE59B) & mask32
    heads = (torch.arange(1, h + 1, device=dev) * 0x9E3779B9) & mask32
    want_attn = hash_keep_plain(batch[:, None] + heads[None, :], (t, t), drop_threshold(rate))
    want_hid = hash_keep_plain(batch + 0x7FEB352D, (t, e), drop_threshold(rate))
    k1_report, k2_report = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        got_attn, got_hid = _masks_from_kernel(dev, dtype, seed, rate)
        torch.cuda.synchronize()
        wrong = int((got_attn != want_attn).sum()) + int((got_hid != want_hid).sum())
        print(f"K1 dropout {name}: masks read from the kernel, {got_attn.numel()} attention + "
              f"{got_hid.numel()} hidden bits, {wrong} differ from the plain hash; kept "
              f"{got_attn.float().mean().item():.4f} / {got_hid.float().mean().item():.4f}")
        if wrong:
            raise AssertionError(f"K1 {name}: dropout masks differ from the plain hash")

        args = _sublayer_inputs(dev, gen, dtype, b)
        flops = 4 * b * t * t * e + 2 * b * t * e * e
        for label, kw in (("no dropout", {}),
                          ("dropout", dict(attn_dropout=rate, hidden_dropout=rate,
                                           dropout_seed=seed))):
            kw = dict(num_heads=h, seq_len=t, **kw)
            got = wavlm_attention_sublayer(*args, **kw)
            want = wavlm_attention_sublayer_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ms = cuda_ms(lambda: wavlm_attention_sublayer(*args, **kw))
            plain_ms = cuda_ms(lambda: wavlm_attention_sublayer_plain(*args, **kw))
            limit = bound(flops, nbytes(*args, got), dtype)
            print(f"K1 {name} B={b} {label}: max_abs_err={err:.3e} (tol {K1_TOL[dtype]}) "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms {_bound_text(limit)}")
            if not err <= K1_TOL[dtype]:
                raise AssertionError(f"K1 {name} {label} disagrees with its plain version: {err}")
            k1_report[f"{name}_b16_{label.replace(' ', '_')}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **limit}

        dout = torch.randn(b, t, e, generator=gen).to(dev, dtype)
        # dctx and dwo over the B*T rows; scores, dprobs, dv, dq and dk per head.
        flops = 4 * b * t * e * e + 10 * b * t * t * e
        for label, kw in (("no dropout", {}),
                          ("dropout", dict(attn_dropout=rate, hidden_dropout=rate,
                                           dropout_seed=seed))):
            kw = dict(num_heads=h, seq_len=t, **kw)
            leaves = [a.clone().requires_grad_() for a in args]
            got = torch.autograd.grad(wavlm_attention_sublayer(*leaves, **kw), leaves, dout)
            again = torch.autograd.grad(wavlm_attention_sublayer(*leaves, **kw), leaves, dout)
            want = wavlm_attention_sublayer_backward_plain(dout, *args, **kw)
            torch.cuda.synchronize()
            worst = 0.0
            for gname, x, y, z in zip(("hidden", "q", "k", "v", "gate", "bias", "wo", "bo",
                                       "lns", "lnb"), got, want, again):
                scale = y.float().abs().max().item()
                err = (x.float() - y.float()).abs().max().item() / scale
                worst = max(worst, err)
                if x.shape != y.shape or not torch.isfinite(x).all() or not err <= GRAD_TOL[dtype]:
                    raise AssertionError(
                        f"K2 {name} {label}: d{gname} disagrees with the plain backward: "
                        f"{err:.3e} of its largest entry {scale:.3e}")
                if not torch.equal(x, z):
                    raise AssertionError(f"K2 {name} {label}: d{gname} differs between two runs")
            _, ctx, pre = wavlm_attention_sublayer_forward(*args, **kw)

            def kernel():
                return wavlm_attention_sublayer_backward(dout, *args, ctx, pre, **kw)

            ms = cuda_ms(kernel)
            plain_ms = cuda_ms(lambda: wavlm_attention_sublayer_backward_plain(dout, *args, **kw))
            limit = bound(flops, nbytes(dout, *args[1:7], args[8], ctx, pre, *kernel()), dtype)
            print(f"K2 {name} B={b} {label}: ten gradients, worst error {worst:.3e} of the "
                  f"gradient's largest entry (tol {GRAD_TOL[dtype]}), two runs bit-identical; "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms {_bound_text(limit)} "
                  f"({flops / 1e9:.3f} GFLOP)")
            key = f"{name}_{label.replace(' ', '_')}"
            k2_report[key] = {
                "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **limit, "library_ms": None}
            split = profile_steps(kernel, n=5, want=ROUTE_KERNELS["K2"][dtype])["kernels"]
            _check_route("K2", dtype, split)
            print(f"K2 {name} B={b} {label} per launch: "
                  + ", ".join(f"{kernel_name} {t:.4f} ms" for kernel_name, t in split.items())
                  + f" (sum {sum(split.values()):.4f} ms; CUDA events {ms:.4f} ms)")
            k2_report[key]["split_ms"] = split
    return k1_report, k2_report


class _Batch:
    """What `EmotionTrainer.run_epoch` takes from a loader."""

    def __init__(self, video, audio, labels, aug):
        self.video, self.audio, self.labels, self.aug = video, audio, labels, aug
        self.valid = np.ones(len(labels), bool)
        self.size = len(labels)


def _train_batches(n, seed, augment=True):
    rng = np.random.default_rng(seed)
    b = TRAIN_BATCH
    out = []
    for _ in range(n):
        aug = np.stack([rng.uniform(0.8, 1.2, b), rng.uniform(0.0, 0.03, b)], axis=1)
        out.append(_Batch(
            rng.integers(0, 256, (b, 8, 3, 112, 112), dtype=np.uint8),
            (rng.standard_normal((b, 1, 48000)) * 0.1).astype(np.float32),
            rng.integers(0, 8, b).astype(np.int64),
            aug.astype(np.float32) if augment else None,
        ))
    return out


def profile_steps(step, n: int = 2, attempts: int = 3, want=()) -> dict:
    """Device time of `n` calls of step() by `torch.profiler` -> busy share
    of the wall time and the device time per step, by group and by kernel
    (`kernels`: short name -> ms).  A window in which the tracer recorded no
    device event at all, or none of a kernel named in `want`, is taken
    again, up to `attempts` windows: the tracer now and then returns an
    empty window on that card, or one without a step's first launches."""
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.5)
        out = _profile_window(step, n)
        if out["device_ms"] is not None and all(
                any(w in k for k in out["kernels"]) for w in want):
            break
    return out


def _profile_window(step, n: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    groups = {"K1": ("::wavlm_attn_", "attn_core_mma", "out_proj_mma", "attn_core_tf32",
                     "out_proj_tf32"),
              "K2": ("::bwd_",), "K3": ("conv_fe_kernel", "conv_fe_wgmma", "conv_fe_tf32"),
              "K4": ("fb_rows_tc", "fb_video_tc", "fb_audio_tc", "fb_head_tc", "fused_block_")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # Kernel and copy events only: an operator's row repeats its kernels' time.
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = [r for r in rows if r[1] > 0.0]
    kernels = {}
    for key, ms, _ in rows:
        kernels[_short_name(key)] = kernels.get(_short_name(key), 0.0) + ms
    if not rows:
        return {"wall_ms": wall_ms, "device_ms": None, "kernels": kernels}
    out = {"wall_ms": wall_ms, "device_ms": sum(r[1] for r in rows),
           "device_launches": sum(r[2] for r in rows), "kernels": kernels}
    out["idle_share"] = max(0.0, 1.0 - out["device_ms"] / wall_ms)
    for label, needle in groups.items():
        out[f"{label}_ms"] = sum(r[1] for r in rows if any(n in r[0] for n in needle))
    out["top"] = [(k[:60], round(ms, 4), c) for k, ms, c in sorted(rows, key=lambda r: -r[1])[:8]]
    return out


def train(dev, card, tmp):
    """Phase 9 -> (launch counts of the two trainers' train steps, report)."""
    from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig
    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        wavlm_attention_sublayer,
        wavlm_attention_sublayer_backward,
    )
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
    from multimodalemotionrecognition_torch.train import EmotionTrainer

    counters = {"wavlm_attention_sublayer": wavlm_attention_sublayer,
                "fused_conv_layer": fused_conv_layer,
                "wavlm_attention_sublayer_backward": wavlm_attention_sublayer_backward}
    trainers = {}
    for dtype in ("float32", "bfloat16"):
        trainer = EmotionTrainer(
            ModelConfig(fusion="xattn", use_wavlm=True, compute_dtype=dtype),
            TrainConfig(two_stage_training=True, seed=SEED, output_dir=str(tmp)), device=dev)
        trainers[dtype] = (trainer, trainer.init_state())
    warm = _train_batches(1, SEED + 1)
    for trainer, state in trainers.values():  # cuDNN algorithm choice, allocator
        trainer.run_epoch(state, warm, False)
    torch.cuda.synchronize()

    def check_stage(stage, state, mask, before, stats):
        """After the stage's first TRAIN_STEPS steps."""
        if state.opt_state.count != TRAIN_STEPS:
            raise AssertionError(f"stage {stage}: Adam count {state.opt_state.count}")
        for name, p in state.params.items():
            if mask[name] == torch.equal(p, before[name]):
                raise AssertionError(
                    f"train stage {stage}: {name} is "
                    f"{'unchanged though trainable' if mask[name] else 'changed though frozen'}")
        if any(torch.equal(t, state.batch_stats[n]) for n, t in stats.items()):
            raise AssertionError(f"train stage {stage}: a BatchNorm statistic did not move")
        print(f"train stage {stage}: after {TRAIN_STEPS} steps Adam count {state.opt_state.count}, "
              f"{sum(map(bool, mask.values()))} trainable parameters changed, "
              f"{len(mask) - sum(map(bool, mask.values()))} frozen ones bit-identical, "
              f"{len(stats)} BatchNorm statistics moved")

    # The main path: counters from 0, every step through `run_epoch`.
    for fn in counters.values():
        fn.launches = 0
    launches = dict.fromkeys(counters, 0)  # of the train steps alone
    report = {}
    for dtype, (trainer, state) in trainers.items():
        wavlm = state.model.audio_model.wavlm
        per_stage = TRAIN_STEPS + TIMED_STEPS
        batches = _train_batches(2 * per_stage, SEED + 2)
        torch.cuda.reset_peak_memory_stats()
        times, losses = {1: [], 2: []}, {1: [], 2: []}
        for stage in (1, 2):
            mask, lrs = trainer.trainable_mask(stage), trainer.lr_tree(stage, {})
            trainable_layers = {
                i for i in range(12)
                if mask[f"audio_model.wavlm.encoder.layers.{i}.attention.q_proj.weight"]}
            if trainable_layers != ({10, 11} if stage == 2 else set()):
                raise AssertionError(f"stage {stage}: trainable encoder layers {trainable_layers}")
            before = {n: p.detach().clone() for n, p in state.params.items()}
            stats = {n: t.clone() for n, t in state.batch_stats.items() if "running" in n}
            for i in range(per_stage):
                if i == TRAIN_STEPS:
                    check_stage(stage, state, mask, before, stats)
                seen = {name: fn.launches for name, fn in counters.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, metrics = trainer.run_epoch(
                    state, [batches[(stage - 1) * per_stage + i]], True, mask, lrs,
                    reset_opt_first=(stage == 2 and i == 0))
                torch.cuda.synchronize()
                times[stage].append((time.perf_counter() - t0) * 1e3)
                losses[stage].append(metrics["loss"])
                got = {name: fn.launches - seen[name] for name, fn in counters.items()}
                for name, n in got.items():
                    launches[name] += n
                ran = list(wavlm.layers_run)
                want = {"wavlm_attention_sublayer": len(ran), "fused_conv_layer": 6,
                        "wavlm_attention_sublayer_backward": len(trainable_layers & set(ran))}
                print(f"train {dtype} stage {stage} step {i}: loss {metrics['loss']:.4f} "
                      f"{times[stage][-1]:.1f} ms, layers run {ran}, launches {got}")
                if ran[0] != 0 or got != want:
                    raise AssertionError(f"train {dtype} stage {stage}: launches {got}, expected {want}")
                if not np.isfinite(metrics["loss"]):
                    raise AssertionError(f"train {dtype} stage {stage}: loss {metrics['loss']}")
        peak = torch.cuda.max_memory_allocated() / 2**20

        # The trained state, saved in the reference layout, serves what the trainer evaluates.
        ckpt = Path(tmp) / f"trained_{dtype}.pt"
        trainer.save_checkpoint(ckpt, state, 0.0)
        eval_batch = _train_batches(1, SEED + 3, augment=False)[0]
        to_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        forward = {"wavlm_attention_sublayer": 12, "fused_conv_layer": 6,
                   "wavlm_attention_sublayer_backward": 0}
        seen = {name: fn.launches for name, fn in counters.items()}
        _, cls_loss, _, preds = trainer.eval_step(
            state, to_dev(eval_batch.video), to_dev(eval_batch.audio),
            to_dev(eval_batch.labels), to_dev(eval_batch.valid))
        evaluated = {name: fn.launches - seen[name] for name, fn in counters.items()}
        runner = TorchModelRunner(ckpt, device=dev, compute_dtype=dtype, device_normalize=True)
        probs = runner.predict_probs(eval_batch.video, eval_batch.audio)
        served_by = {name: fn.launches - seen[name] - evaluated[name]
                     for name, fn in counters.items()}
        if evaluated != forward or served_by != forward:
            raise AssertionError(f"train {dtype}: the eval step launched {evaluated} and the "
                                 f"runner's request {served_by}, expected {forward} each")
        served = float(-np.log(probs[np.arange(TRAIN_BATCH), eval_batch.labels]).mean())
        err = abs(served - float(cls_loss))
        agree = float((probs.argmax(axis=1) == preds.cpu().numpy()).mean())
        print(f"train {dtype}: eval loss {float(cls_loss):.6f}, the runner on the saved checkpoint "
              f"{served:.6f} (|diff| {err:.2e}, tol {EVAL_TOL[dtype]}), same prediction on "
              f"{agree:.2f} of the clips")
        if probs.shape != (TRAIN_BATCH, 8) or not err <= EVAL_TOL[dtype] or (
                dtype == "float32" and agree != 1.0):
            raise AssertionError(f"train {dtype}: the runner disagrees with the trainer's eval step")
        report[dtype] = {
            "stage1_step_ms": float(np.median(times[1][TRAIN_STEPS:])),
            "stage2_step_ms": float(np.median(times[2][TRAIN_STEPS:])),
            "stage1_step_ms_all": times[1], "stage2_step_ms_all": times[2],
            "stage1_losses": losses[1], "stage2_losses": losses[2],
            "peak_memory_mib": peak, "batch": TRAIN_BATCH,
        }
        print(f"train {dtype}: step time, median of the last {TIMED_STEPS} of {per_stage} steps: "
              f"stage 1 {report[dtype]['stage1_step_ms']:.1f} ms, stage 2 "
              f"{report[dtype]['stage2_step_ms']:.1f} ms (batch {TRAIN_BATCH}), peak "
              f"device memory {peak:.0f} MiB [{card}]")
    print(f"train: launches over the {4 * per_stage} train steps {launches}; each eval step "
          f"and each runner request on a saved checkpoint launched {forward}")

    # Beside the main path: where a stage-2 step's time goes.
    for dtype, (trainer, state) in trainers.items():
        mask, lrs = trainer.trainable_mask(2), trainer.lr_tree(2, {})
        batch = _train_batches(1, SEED + 4)
        prof = profile_steps(lambda: trainer.run_epoch(state, batch, True, mask, lrs))
        report[dtype]["stage2_profile"] = {k: v for k, v in prof.items() if k != "kernels"}
        if prof["device_ms"] is None:
            print(f"train {dtype} stage 2 profile: the profiler saw no device time; not measured")
            continue
        print(f"train {dtype} stage 2 profile, per step: wall {prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_ms']:.1f} ms in {prof['device_launches']:.0f} launches (idle share "
              f"{prof['idle_share']:.2f}); K3 {prof['K3_ms']:.2f} ms, K1 {prof['K1_ms']:.2f} ms, "
              f"K2 {prof['K2_ms']:.2f} ms")
        for key, ms, count in prof["top"]:
            print(f"    {ms:8.3f} ms x{count:<6g} {key}")
    return launches, report


# Phase 9a: family -> ModelConfig overrides (single-stage; the waveform in, log-mel in the step)
TRAIN_FAMILIES = {
    "gated_resnet18": dict(fusion="gated", use_wavlm=False, use_resnet_audio=True),
    "late": dict(fusion="late", use_wavlm=False),
    "audio": dict(fusion="audio", use_wavlm=False),
}


def train_families(dev, card, tmp):
    """Phase 9a: `EmotionTrainer` on three of the other families at full
    width in float32, batch 16 -> report.  The eval step on the card against
    the same seeded state on the CPU, then TRAIN_STEPS steps through
    `run_epoch`, then the saved checkpoint through `TorchModelRunner`."""
    from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig
    from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram_np
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
    from multimodalemotionrecognition_torch.train import EmotionTrainer

    eval_batch = _train_batches(1, SEED + 5, augment=False)[0]
    batches = _train_batches(1 + TRAIN_STEPS, SEED + 6)
    report = {}
    for family, overrides in TRAIN_FAMILIES.items():
        def make(device):
            trainer = EmotionTrainer(
                ModelConfig(**overrides),
                TrainConfig(two_stage_training=False, seed=SEED, output_dir=str(tmp)),
                device=device)
            return trainer, trainer.init_state()

        def eval_loss(trainer, state, device):
            to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
            return trainer.eval_step(state, to(eval_batch.video), to(eval_batch.audio),
                                     to(eval_batch.labels), to(eval_batch.valid))

        want = float(eval_loss(*make("cpu"), "cpu")[1])
        trainer, state = make(dev)
        got = float(eval_loss(trainer, state, dev)[1])
        err = abs(got - want)
        print(f"train family {family}: eval loss on the card {got:.6f}, on the CPU {want:.6f} "
              f"(|diff| {err:.2e}, tol {CPU_PROBS_TOL})")
        if not err <= CPU_PROBS_TOL:
            raise AssertionError(f"train family {family}: the card disagrees with the CPU: {err}")

        mask, lrs = trainer.trainable_mask(0), trainer.lr_tree(0, {})
        trainer.run_epoch(state, batches[:1], True, mask, lrs)  # cuDNN algorithm choice
        before = {n: p.detach().clone() for n, p in state.params.items()}
        stats = {n: t.clone() for n, t in state.batch_stats.items() if "running" in n}
        count, times, losses = state.opt_state.count, [], []
        for batch in batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = trainer.run_epoch(state, [batch], True, mask, lrs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
        unchanged = [n for n, p in state.params.items() if torch.equal(p, before[n])]
        stuck = [n for n, t in stats.items() if torch.equal(t, state.batch_stats[n])]
        if (not np.isfinite(losses).all() or not all(mask.values()) or unchanged or stuck
                or state.opt_state.count != count + TRAIN_STEPS):
            raise AssertionError(f"train family {family}: losses {losses}, unchanged parameters "
                                 f"{unchanged[:5]}, BatchNorm statistics that stood {stuck[:5]}")

        ckpt = Path(tmp) / f"trained_{family}.pt"
        trainer.save_checkpoint(ckpt, state, 0.0)
        cls_loss = float(eval_loss(trainer, state, dev)[1])
        runner = TorchModelRunner(ckpt, device=dev, compute_dtype="float32", device_normalize=True)
        probs = runner.predict_probs(eval_batch.video,
                                     log_mel_spectrogram_np(eval_batch.audio[:, 0, :])[:, None])
        served = float(-np.log(probs[np.arange(TRAIN_BATCH), eval_batch.labels]).mean())
        if not abs(served - cls_loss) <= CPU_PROBS_TOL:
            raise AssertionError(f"train family {family}: the runner on the saved checkpoint gives "
                                 f"{served}, the trainer's eval step {cls_loss}")
        report[family] = {"step_ms": times, "losses": losses, "batch": TRAIN_BATCH,
                          "eval_loss_card_vs_cpu": err}
        print(f"train family {family} float32: {len(before)} parameters changed and {len(stats)} "
              f"BatchNorm statistics moved over {TRAIN_STEPS} steps, losses "
              f"{[round(x, 4) for x in losses]}, step times {[round(t, 1) for t in times]} ms "
              f"(batch {TRAIN_BATCH}), eval loss {cls_loss:.6f}, the runner on the saved "
              f"checkpoint {served:.6f} [{card}]")
        del trainer, state, runner
        torch.cuda.empty_cache()
    return report


# Phase 10: the duplicated-microbatch check's tolerance, relative to each
# gradient's largest entry.  `.grad` accumulates in float32 and the halved
# loss scale is a power of two, so the sum of two equal halves is exact;
# what is left is cuDNN's and cuBLAS's backward, whose sum order may vary
# between two calls.
ACCUM_GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# WavLM's stochastic ops off (dropouts, LayerDrop, span masking).
WAVLM_NO_NOISE = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                      feat_proj_dropout=0.0, layerdrop=0.0, apply_spec_augment=False)
RESUME_STEPS = 2


def _record_layers_run(model) -> list:
    """-> a list that gets WavLM's `layers_run` after each of its forwards
    (one per microbatch)."""
    runs: list = []
    model.audio_model.wavlm.register_forward_hook(lambda m, i, o: runs.append(list(m.layers_run)))
    return runs


def _accum_step(trainer, state, batch, counters, runs, trainable, label, reset=False) -> dict:
    """One train step through `run_epoch`, its launches checked against what
    each microbatch's forward ran: 12 K1 less the LayerDrop skips, 6 K3,
    one K2 per trainable encoder layer that ran.  -> metrics."""
    mask, lrs = trainer.trainable_mask(2), trainer.lr_tree(2, {})
    runs.clear()
    seen = {name: fn.launches for name, fn in counters.items()}
    _, metrics = trainer.run_epoch(state, [batch], True, mask, lrs, reset_opt_first=reset)
    got = {name: fn.launches - seen[name] for name, fn in counters.items()}
    want = {"wavlm_attention_sublayer": sum(len(r) for r in runs),
            "fused_conv_layer": 6 * len(runs),
            "wavlm_attention_sublayer_backward": sum(len(trainable & set(r)) for r in runs)}
    print(f"{label}: loss {metrics['loss']:.4f} contrastive {metrics['contrastive_loss']:.4f}, "
          f"layers run per microbatch {runs}, launches {got}")
    if len(runs) != trainer.tc.grad_accum or got != want or any(r[0] != 0 for r in runs):
        raise AssertionError(f"{label}: launches {got}, expected {want} over {len(runs)} microbatches")
    if not np.isfinite(metrics["loss"]):
        raise AssertionError(f"{label}: loss {metrics['loss']}")
    return metrics


def _raw_pretrained(model, gen):
    """Raw state dicts in the layouts the converters read, from seeded random
    tensors shaped like the flagship's branches: torchvision's resnet18 (with
    its 1000-class `fc.*`) and HF `WavLMModel`'s (the positional conv as
    weight-norm g and v).  -> (torchvision dict, HF dict)."""
    def rand_like(name, t):
        if t.dtype == torch.int64:
            return torch.tensor(3, dtype=torch.int64)
        if name.endswith("running_var"):
            return torch.rand(t.shape, generator=gen) + 0.5
        return torch.randn(t.shape, generator=gen) * 0.05

    children = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3", "7": "layer4"}
    video = {}
    for name, t in model.video_model.state_dict().items():
        head, index, rest = name.split(".", 2)
        if head != "backbone":
            raise AssertionError(f"the video branch has a key outside the backbone: {name}")
        video[f"{children[index]}.{rest}"] = rand_like(name, t)
    video["fc.weight"] = torch.randn(1000, 512, generator=gen) * 0.05
    video["fc.bias"] = torch.randn(1000, generator=gen) * 0.05
    audio = {}
    for name, t in model.audio_model.state_dict().items():
        key = name.removeprefix("wavlm.")
        if key == "encoder.pos_conv_embed.conv.weight":
            audio["encoder.pos_conv_embed.conv.weight_g"] = torch.rand(1, 1, t.shape[2], generator=gen) + 0.5
            audio["encoder.pos_conv_embed.conv.weight_v"] = torch.randn(t.shape, generator=gen) * 0.05
        else:
            audio[key] = rand_like(name, t)
    return video, audio


def train_rest(dev, card, tmp):
    """Phase 10 -> (launches of its train steps, report).  In float32 and
    bfloat16 at full width, batch 16: the flagship with `grad_accum=2` (two
    stage-2 steps, launches per microbatch), resumed from a file against the
    run that went on, the accumulated gradients of [m, m] against one
    microbatch m with every stochastic op off, step time and peak memory for
    accum 1 against accum 2; gated + WavLM with the CLIP alignment loss; the
    flagship warm-started from raw torchvision / HF layouts through
    `convert/pretrained.py`; `fit` with a test loader and its confusion
    matrix."""
    import dataclasses

    from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig
    from multimodalemotionrecognition_torch.convert.pretrained import convert_pretrained
    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        wavlm_attention_sublayer,
        wavlm_attention_sublayer_backward,
    )
    from multimodalemotionrecognition_torch.models import fusion, temporal
    from multimodalemotionrecognition_torch.train import EmotionTrainer
    from multimodalemotionrecognition_torch.utils.metrics import confusion_matrix

    t_phase = time.perf_counter()
    counters = {"wavlm_attention_sublayer": wavlm_attention_sublayer,
                "fused_conv_layer": fused_conv_layer,
                "wavlm_attention_sublayer_backward": wavlm_attention_sublayer_backward}
    trainable = {10, 11}  # the flagship's stage-2 encoder layers
    flagship = dict(fusion="xattn", use_wavlm=True)
    launches = dict.fromkeys(counters, 0)
    report = {}
    raw = None  # the warm start's raw state dicts, shaped like the flagship's branches
    for dtype in ("float32", "bfloat16"):
        rep = report[dtype] = {"batch": TRAIN_BATCH}

        def make(model_kw, **train_kw):
            trainer = EmotionTrainer(
                ModelConfig(**model_kw, compute_dtype=dtype),
                TrainConfig(two_stage_training=True, seed=SEED, output_dir=str(tmp), **train_kw),
                device=dev)
            return trainer, trainer.init_state()

        batches = _train_batches(RESUME_STEPS + 2, SEED + 10)

        # The main path: the flagship, grad_accum=2, counters from 0.
        trainer, state = make(flagship, grad_accum=2)
        if raw is None:
            raw = _raw_pretrained(state.model, torch.Generator().manual_seed(SEED + 12))
        runs = _record_layers_run(state.model)
        trainer.run_epoch(state, batches[-1:], False)  # cuDNN's algorithm choice
        for fn in counters.values():
            fn.launches = 0
        for i in range(RESUME_STEPS):
            _accum_step(trainer, state, batches[i], counters, runs, trainable,
                        f"train rest {dtype} flagship accum 2 step {i}", reset=i == 0)
        for name, fn in counters.items():
            launches[name] += fn.launches
        if state.opt_state.count != RESUME_STEPS:
            raise AssertionError(f"accum 2: {state.opt_state.count} optimizer steps for "
                                 f"{RESUME_STEPS} train steps")

        # Resume: save, restore into a fresh trainer, one more step on both.
        # cuDNN's deterministic algorithms for that step on both sides: the
        # default choice may sum with atomics, and then two runs of the same
        # step differ in the last bits.
        trainer.save_resume_state(Path(tmp) / f"resume_{dtype}", state, 1, 0.25)
        fresh = EmotionTrainer(trainer.mc, trainer.tc, device=dev)
        restored, epoch, best_f1 = fresh.restore_resume_state(Path(tmp) / f"resume_{dtype}")
        if (epoch, best_f1, restored.step, restored.opt_state.count) != (
                1, 0.25, state.step, state.opt_state.count):
            raise AssertionError(f"resume: epoch {epoch}, best F1 {best_f1}, step {restored.step}")
        fresh_runs = _record_layers_run(restored.model)
        torch.backends.cudnn.deterministic = True
        try:
            went_on = _accum_step(trainer, state, batches[RESUME_STEPS], counters, runs, trainable,
                                  f"train rest {dtype} step after the save, the run that went on")
            resumed = _accum_step(fresh, restored, batches[RESUME_STEPS], counters, fresh_runs,
                                  trainable, f"train rest {dtype} step after the save, resumed")
        finally:
            torch.backends.cudnn.deterministic = False
        diff = max((p - restored.params[n]).abs().max().item() for n, p in state.params.items())
        stats = max((t.float() - restored.batch_stats[n].float()).abs().max().item()
                    for n, t in state.batch_stats.items())
        moments = max((state.opt_state.mu[n] - restored.opt_state.mu[n]).abs().max().item()
                      for n in state.opt_state.mu)
        print(f"train rest {dtype} resume after {RESUME_STEPS} steps: the next step's loss "
              f"{went_on['loss']:.6f} / {resumed['loss']:.6f}, largest difference: parameters "
              f"{diff:.3e}, buffers {stats:.3e}, first moments {moments:.3e}, layers run "
              f"{runs} / {fresh_runs}")
        rep["resume_max_param_diff"] = diff
        if diff != 0.0 or stats != 0.0 or moments != 0.0 or went_on["loss"] != resumed["loss"]:
            raise AssertionError(f"train rest {dtype}: the resumed run is not bit-identical")
        del fresh, restored
        torch.cuda.empty_cache()

        # Step time and peak memory, accum 1 against accum 2: the same model
        # and optimizer state, only `grad_accum` turned, in turns.
        timing = {1: [], 2: []}
        memory = {1: [], 2: []}
        order = (1, 2, 2, 1, 1, 2, 2, 1)
        for i, accum in enumerate((1, 2) + order):
            trainer.tc = dataclasses.replace(trainer.tc, grad_accum=accum)
            mask, lrs = trainer.trainable_mask(2), trainer.lr_tree(2, {})
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            trainer.run_epoch(state, [batches[i % len(batches)]], True, mask, lrs)
            torch.cuda.synchronize()
            if i >= 2:  # after one warm-up step each
                timing[accum].append((time.perf_counter() - t0) * 1e3)
                memory[accum].append((torch.cuda.max_memory_allocated() / 2**20,
                                      (torch.cuda.max_memory_allocated() - base) / 2**20))
        trainer.tc = dataclasses.replace(trainer.tc, grad_accum=2)
        for accum in (1, 2):
            rep[f"accum{accum}_step_ms"] = float(np.median(timing[accum]))
            rep[f"accum{accum}_step_ms_all"] = timing[accum]
            rep[f"accum{accum}_peak_mib"] = max(m[0] for m in memory[accum])
            rep[f"accum{accum}_step_peak_above_start_mib"] = max(m[1] for m in memory[accum])
        print(f"train rest {dtype} stage 2, batch {TRAIN_BATCH}: accum 1 step "
              f"{rep['accum1_step_ms']:.1f} ms (median of {len(timing[1])}), peak "
              f"{rep['accum1_peak_mib']:.0f} MiB ({rep['accum1_step_peak_above_start_mib']:.0f} above "
              f"the step's start); accum 2 step {rep['accum2_step_ms']:.1f} ms, peak "
              f"{rep['accum2_peak_mib']:.0f} MiB ({rep['accum2_step_peak_above_start_mib']:.0f} "
              f"above the step's start) [{card}]")
        del trainer, state
        torch.cuda.empty_cache()

        # Duplicated microbatch: accum 2 on [m, m] against accum 1 on m, every
        # stochastic op of the train forward off, gradients before the optimizer.
        quiet = dict(flagship, xattn_attn_dropout=0.0, xattn_stochastic_depth=0.0,
                     temporal_dropout=0.0, wavlm_geometry=WAVLM_NO_NOISE)
        trainer, state = make(quiet)
        runs = _record_layers_run(state.model)
        one = _train_batches(1, SEED + 11, augment=False)[0]
        m = TRAIN_BATCH // 2
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        single = [to_dev(x[:m]) for x in (one.video, one.audio, one.labels, one.valid)]
        double = [torch.cat([x, x]) for x in single]
        identity = lambda x, rate, generator: x  # noqa: E731
        saved = fusion.dropout, temporal.dropout
        fusion.dropout = temporal.dropout = identity  # the head MLP's constant 0.2
        try:
            mask = trainer.trainable_mask(2)
            trainer.loss_and_grads(state, *single, mask)  # cuDNN's algorithm choice
            grads, losses = {}, {}
            for accum, inputs in ((1, single), (2, double)):
                trainer.tc = dataclasses.replace(trainer.tc, grad_accum=accum)
                runs.clear()
                seen = {name: fn.launches for name, fn in counters.items()}
                total, *_ = trainer.loss_and_grads(state, *inputs, mask)
                got = {name: fn.launches - seen[name] for name, fn in counters.items()}
                want = {"wavlm_attention_sublayer": 12 * accum, "fused_conv_layer": 6 * accum,
                        "wavlm_attention_sublayer_backward": 2 * accum}
                if got != want:
                    raise AssertionError(f"duplicated microbatch accum {accum}: launches {got}")
                losses[accum] = float(total)
                grads[accum] = {n: p.grad.detach().clone() for n, p in state.params.items()
                                if p.grad is not None}
        finally:
            fusion.dropout, temporal.dropout = saved
        if set(grads[1]) != set(grads[2]) or not grads[1]:
            raise AssertionError("duplicated microbatch: the two steps have other trainable sets")
        worst = max((grads[2][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                    for n, g in grads[1].items())
        exact = sum(torch.equal(grads[2][n], g) for n, g in grads[1].items())
        rep["accum_dup_grad_rel_err"] = worst
        print(f"train rest {dtype} duplicated microbatch (m = {m} clips): loss accum 1 "
              f"{losses[1]:.6f}, accum 2 on [m, m] {losses[2]:.6f}; {len(grads[1])} gradients, "
              f"{exact} bit-equal, worst {worst:.3e} of the gradient's largest entry "
              f"(tol {ACCUM_GRAD_TOL[dtype]})")
        if not worst <= ACCUM_GRAD_TOL[dtype] or abs(losses[1] - losses[2]) > 1e-5:
            raise AssertionError(f"train rest {dtype}: accumulated gradients disagree: {worst}")
        del trainer, state
        torch.cuda.empty_cache()

        # The CLIP alignment loss, gated + WavLM, grad_accum=2, counters from 0.
        trainer, state = make(dict(fusion="gated", use_wavlm=True, fusion_align_mode="clip"),
                              grad_accum=2)
        runs = _record_layers_run(state.model)
        trainer.run_epoch(state, batches[-1:], False)
        for fn in counters.values():
            fn.launches = 0
        align = [_accum_step(trainer, state, batch, counters, runs, trainable,
                             f"train rest {dtype} gated clip accum 2 step {i}",
                             reset=i == 0)["contrastive_loss"]
                 for i, batch in enumerate(batches[:3])]
        for name, fn in counters.items():
            launches[name] += fn.launches
        rep["alignment_losses"] = align
        # bfloat16 rounds the loss to 8 bits of mantissa: two steps may read
        # the same value, three must not.
        if not (np.isfinite(align).all() and min(align) > 0.0 and len(set(align)) > 1):
            raise AssertionError(f"train rest {dtype}: alignment losses {align}")
        del trainer, state
        torch.cuda.empty_cache()

        # Warm start from raw torchvision / HF layouts through convert/pretrained.py.
        raw_video, raw_audio = raw
        ckpts = {}
        for arch, state_dict in (("resnet18", raw_video), ("wavlm-base", raw_audio)):
            torch.save(state_dict, Path(tmp) / f"raw_{arch}.pth")
            ckpts[arch] = str(convert_pretrained(arch, Path(tmp) / f"raw_{arch}.pth",
                                                 Path(tmp) / f"branch_{arch}_{dtype}.pt"))
        trainer, state = make(flagship, audio_ckpt=ckpts["wavlm-base"], video_ckpt=ckpts["resnet18"])
        sd = state.model.state_dict()
        children = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6",
                    "layer4": "7"}
        checked = 0
        for key, want in raw_video.items():
            if key.startswith("fc."):
                continue
            root, rest = key.split(".", 1)
            if not torch.equal(sd[f"video_model.backbone.{children[root]}.{rest}"].cpu(), want):
                raise AssertionError(f"warm start: video {key} differs from its source")
            checked += 1
        pos = "encoder.pos_conv_embed.conv"
        for key, want in raw_audio.items():
            if key.startswith(pos):
                continue
            if not torch.equal(sd[f"audio_model.wavlm.{key}"].cpu(), want):
                raise AssertionError(f"warm start: audio {key} differs from its source")
            checked += 1
        g, v = raw_audio[pos + ".weight_g"].double(), raw_audio[pos + ".weight_v"].double()
        merged = g * v / v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
        pos_err = (sd[f"audio_model.wavlm.{pos}.weight"].cpu().double() - merged).abs().max().item()
        rep["warm_start"] = {"report": trainer.warm_start_report, "tensors_bit_equal": checked,
                             "pos_conv_err": pos_err}
        print(f"train rest {dtype} warm start: {checked} branch tensors bit-equal to their "
              f"sources, the positional conv within {pos_err:.3e} of g * v / |v| (tol 1e-6); "
              f"missing / unused keys per branch {trainer.warm_start_report}")
        if pos_err > 1e-6 or set(trainer.warm_start_report) != {"audio_model", "video_model"}:
            raise AssertionError(f"train rest {dtype}: warm start {rep['warm_start']}")
        runs = _record_layers_run(state.model)
        _accum_step(trainer, state, batches[0], counters, runs, trainable,
                    f"train rest {dtype} warm-started flagship step", reset=True)
        del trainer, state
        torch.cuda.empty_cache()

        # fit with a test loader: the confusion matrix against the eval predictions.
        out_dir = Path(tmp) / f"fit_{dtype}"
        trainer, state = make(flagship, epochs=1, grad_accum=2)
        trainer.tc = dataclasses.replace(trainer.tc, output_dir=str(out_dir))
        test = _train_batches(2, SEED + 13, augment=False)
        test[1].valid[-3:] = False
        state, result = trainer.fit(batches[:2], batches[2:3], test_loader=test, state=state)
        cm = np.loadtxt(out_dir / "confusion_matrix.csv", delimiter=",", dtype=np.int64)
        preds = [trainer.eval_step(state, *(to_dev(x) for x in (b.video, b.audio, b.labels, b.valid)))[3]
                 .cpu().numpy()[b.valid] for b in test]
        want = confusion_matrix(np.concatenate(preds),
                                np.concatenate([b.labels[b.valid] for b in test]), 8)
        n_valid = int(sum(b.valid.sum() for b in test))
        rep["confusion_matrix"] = cm.tolist()
        print(f"train rest {dtype} fit: confusion_matrix.csv sums to {cm.sum()} of {n_valid} valid "
              f"test clips, equal to the eval predictions' {np.array_equal(cm, want)}, PNG "
              f"{(out_dir / 'confusion_matrix.png').exists()}")
        if (cm.shape != (8, 8) or cm.sum() != n_valid or not np.array_equal(cm, want)
                or result.get("confusion_matrix") != cm.tolist()):
            raise AssertionError(f"train rest {dtype}: confusion matrix {cm.tolist()}")
        del trainer, state
        torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"train rest: launches of the main path's train steps {launches}; phase wall time "
          f"{report['phase_s']:.1f} s [{card}]")
    return launches, report


def media_loader(card: str) -> dict:
    """Phase 2a: the native libav loader on this machine (host work only)."""
    import os
    import subprocess

    import cv2

    from multimodalemotionrecognition_torch.data import media
    from multimodalemotionrecognition_torch.data.synthface import make_scene
    from multimodalemotionrecognition_torch.native import build as native_build
    from multimodalemotionrecognition_torch.native import medialoader

    started = time.perf_counter()
    absent = native_build.missing()
    report = {"libav": None if absent else native_build.libav_version().split(), "card": card}
    rng = np.random.default_rng(SEED)
    scene = make_scene(rng, size=256, p_face=1.0)[0]
    frames = np.stack([np.roll(scene, i, axis=1) for i in range(75)])  # 3 s at 25 fps
    t = np.arange(3 * 48000) / 48000
    tone = (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        if absent:
            # what cv2's own FFmpeg is (it ships no headers to build against)
            report["cv2_ffmpeg"] = [line.strip() for line in cv2.getBuildInformation().splitlines()
                                    if "avcodec" in line or "avformat" in line]
            print(f"media: libav absent ({absent.splitlines()[0]}); cv2 {cv2.__version__} "
                  f"{report['cv2_ffmpeg']} | {card}")
            if medialoader.available():
                raise AssertionError("medialoader available without libav")
            hub = subprocess.run([sys.executable, "-m", "multimodalemotionrecognition_torch",
                                  "build-native"], capture_output=True, text=True, cwd=REPO)
            if hub.returncode == 0 or "pkg-config" not in hub.stderr:
                raise AssertionError(f"build-native without libav: {hub.returncode} {hub.stderr}")
            clip = Path(tmp) / "clip.mp4"
            writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"), 25, (256, 256))
            for frame in frames[:25]:
                writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            writer.release()
            try:
                media.load_audio_wav(clip)
                raise AssertionError("container audio decoded without libav")
            except RuntimeError as e:
                if "pkg-config" not in str(e):
                    raise
            video = media.decode_video_frames_u8(clip)
            if video.shape != (8, 112, 112, 3) or not video.any():
                raise AssertionError(f"cv2 video decode without libav: {video.shape}")
            report["absent"] = absent
            report["build_native_rc"] = hub.returncode
        else:
            t0 = time.perf_counter()
            native_build.compile_to(Path(tmp) / "libmedialoader.so")
            report["build_s"] = time.perf_counter() - t0
            native_build.build()
            print(f"media: libav {' '.join(report['libav'])}, loader built in "
                  f"{report['build_s']:.2f} s | {card}")
            for ext in ("webm", "mp4"):
                clip = Path(tmp) / f"clip.{ext}"
                medialoader.encode_av(str(clip), frames, 25.0, tone, 48000)
                native = media.load_video_frames(clip)
                os.environ["EMO_NATIVE_DECODE"] = "0"
                try:
                    cv2_frames = media.load_video_frames(clip)
                finally:
                    del os.environ["EMO_NATIVE_DECODE"]
                diff = np.abs(native - cv2_frames)
                wav = media.load_audio_wav(clip)[0]
                peak = float(np.argmax(np.abs(np.fft.rfft(wav[:16000]))))
                report[ext] = {"frames_mean_diff": float(diff.mean()),
                               "frames_p99_diff": float(np.percentile(diff, 99)),
                               "tone_peak_hz": peak}
                print(f"media: {ext} frames libav - cv2 mean {diff.mean():.4f} p99 "
                      f"{np.percentile(diff, 99):.4f}, tone peak {peak:.0f} Hz | {card}")
                if diff.mean() >= 0.05 or np.percentile(diff, 99) >= 0.6 or abs(peak - 440) > 3:
                    raise AssertionError(f"media {ext}: {report[ext]}")
    report["seconds"] = time.perf_counter() - started
    return report


def make_checkpoint(path):
    """The flagship at full width, random weights from the seed -> (config,
    uint8 video [8,8,3,112,112], int16 audio [8,1,48000])."""
    from multimodalemotionrecognition_torch.config import ModelConfig
    from multimodalemotionrecognition_torch.models.factory import build_model

    cfg = ModelConfig(fusion="xattn", use_wavlm=True)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    torch.save({"model": model.state_dict(), "config": cfg.to_checkpoint_dict(),
                "val_f1": 0.0}, path)
    rng = np.random.RandomState(SEED)
    video = rng.randint(0, 256, (8, 8, 3, 112, 112)).astype(np.uint8)
    audio = (rng.randn(8, 1, 48000) * 3000).clip(-32768, 32767).astype(np.int16)
    return cfg, video, audio


def time_runners(runners, video, audio, card, rounds: int = 3, iters: int = 5):
    """b1 latency and b8 clips/s of every runner, host wall time of requests
    that end in a device->host copy.  The runners take turns, in an order
    that reverses each round, so a drift of the host's pace within the run
    falls on all alike; the median over all of a runner's samples is kept."""
    samples = {label: ([], []) for label in runners}
    for r in range(rounds):
        for label in (list(runners) if r % 2 == 0 else reversed(list(runners))):
            runner = runners[label]
            for n, out in ((1, samples[label][0]), (8, samples[label][1])):
                runner.predict_probs(video[:n], audio[:n])
                for _ in range(iters):
                    t0 = time.perf_counter()
                    runner.predict_probs(video[:n], audio[:n])
                    out.append((time.perf_counter() - t0) * 1e3)
    perf = {}
    for label, (b1, b8) in samples.items():
        b1_ms, b8_ms = float(np.median(b1)), float(np.median(b8))
        perf[label] = {"b1_ms": b1_ms, "b8_clips_per_s": 8e3 / b8_ms}
        print(f"serve {label}: b1 latency {b1_ms:.2f} ms, b8 {8e3 / b8_ms:.1f} clips/s [{card}]")
    return perf


def serve(dev, card, ckpt, cfg, video, audio):
    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        wavlm_attention_sublayer,
    )
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
    from multimodalemotionrecognition_torch.serving.predictor import EmotionPredictor

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

    # Beside the main path: where a b8 request's device time goes.
    for dtype in ("bfloat16", "float32"):
        runner = runners[dtype, "auto"]
        prof = profile_steps(lambda: runner.predict_probs(video, audio))
        if prof["device_ms"] is None:
            print(f"serve {dtype} b8 profile: the profiler saw no device time; not measured")
            continue
        print(f"serve {dtype} b8 profile, per request: wall {prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_ms']:.2f} ms in {prof['device_launches']:.0f} launches (idle share "
              f"{prof['idle_share']:.2f}); K3 {prof['K3_ms']:.3f} ms, K1 {prof['K1_ms']:.3f} ms")
        for key, ms, count in prof["top"]:
            print(f"    {ms:8.3f} ms x{count:<6g} {key}")

    return launches, {
        f"{dtype}_{'kernels' if fused == 'auto' else 'plain'}": runner
        for (dtype, fused), runner in runners.items()
    }


def serve_fused(dev, card, ckpt, cfg, video, audio, modular):
    """The fused, int8 and int8 + fused runners against `modular`, the
    float runners of the same checkpoint on the kernel path (K1, K3)."""
    from multimodalemotionrecognition_torch.kernels import (
        fused_block,
        fused_conv_layer,
        wavlm_attention_sublayer,
    )
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

    counters = {"fused_block": fused_block, "fused_conv_layer": fused_conv_layer,
                "wavlm_attention_sublayer": wavlm_attention_sublayer}
    options = {"fused": dict(fused=True), "int8": dict(quantize_int8=True),
               "int8_fused": dict(quantize_int8=True, fused=True)}
    runners = {
        (dtype, name): TorchModelRunner(ckpt, device=dev, compute_dtype=dtype,
                                        device_normalize=True, **kw)
        for dtype in ("bfloat16", "float32") for name, kw in options.items()
    }
    for r in runners.values():
        r.warmup((1, 4, 8))
    torch.cuda.synchronize()

    def requests(runner):
        out = {n: runner.predict_probs(video[:n], audio[:n]) for n in (1, 3, 8)}
        out["blank"] = runner.predict_probs_blank_video(audio[:3])
        return out

    # The fused paths: counters from 0, every request through K4.
    for fn in counters.values():
        fn.launches = 0
    served, forwards = {}, 0
    for key, runner in runners.items():
        if "fused" in key[1]:
            served[key] = requests(runner)
            forwards += 4
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"fused serve: {forwards} forwards, launches {launches}")
    if launches != {"fused_block": forwards, "wavlm_attention_sublayer": 12 * forwards,
                    "fused_conv_layer": 6 * forwards}:
        raise AssertionError(f"expected 1 K4, 12 K1 and 6 K3 launches per fused forward: {launches}")
    for key, runner in runners.items():
        if key not in served:
            served[key] = requests(runner)  # int8 on the modular path: no K4
    if fused_block.launches != forwards:
        raise AssertionError("the modular int8 path launched K4")

    for dtype in ("bfloat16", "float32"):
        want = requests(modular[dtype])
        pairs = (
            ("fused", served[dtype, "fused"], "float", want, FUSED_PROBS_TOL[dtype]),
            ("int8_fused", served[dtype, "int8_fused"], "int8", served[dtype, "int8"],
             FUSED_PROBS_TOL[dtype]),
            ("int8", served[dtype, "int8"], "float", want, INT8_TOL),
        )
        for got_name, got, want_name, ref, tol in pairs:
            for key, probs in ref.items():
                rows = 3 if key == "blank" else key
                out = got[key]
                if out.shape != (rows, cfg.num_classes) or not np.isfinite(out).all():
                    raise AssertionError(f"{dtype} {got_name} {key}: bad output {out.shape}")
                if not np.allclose(out.sum(axis=1), 1.0, atol=1e-4):
                    raise AssertionError(f"{dtype} {got_name} {key}: probabilities do not sum to 1")
                err = float(np.abs(out - probs).max())
                print(f"serve {dtype} {key}: max |{got_name} - {want_name}| = {err:.3e} (tol {tol})")
                if not err <= tol:
                    raise AssertionError(f"{dtype} {key}: {got_name} disagrees with {want_name}")
                if got_name == "int8" and not (out.argmax(axis=1) == probs.argmax(axis=1)).all():
                    raise AssertionError(f"{dtype} {key}: int8 changes the argmax")
            if float(got[8].std(axis=0).max()) < 1e-6:
                raise AssertionError(f"{dtype} {got_name}: probabilities constant across clips")

    return launches["fused_block"], {
        f"{dtype}_{name}": runner for (dtype, name), runner in runners.items()
    }


def block_entries(dev, modular, video, audio):
    """K5 and K4 through their public entries on the served model's own
    tokens, against the modular fusion modules they stand for; the modules'
    device and host times beside K4's.  -> (K5 launches, K4-vs-modules times)."""
    from multimodalemotionrecognition_torch.kernels import (
        FusedBlockSpec,
        extract_block_params,
        fused_bidirectional_xattn,
        fused_block,
        xattn_params_from_state_dict,
    )

    runner = modular["float32"]
    model = runner.model
    heads = model.v2a_attn.num_heads
    xattn_params = xattn_params_from_state_dict(model.state_dict(), device=dev)
    spec = FusedBlockSpec(num_heads=heads, d_model=128, pooling="mean", head="concat",
                          use_prior=False, num_classes=8)
    block_params = extract_block_params(model.state_dict(), spec, device=dev)
    times = {}
    fused_bidirectional_xattn.launches = 0
    with torch.inference_mode():
        for n in (8, 1):
            frames = (torch.from_numpy(video[:n]).to(dev).float() / 255.0 - runner._mean) / runner._std
            wave = torch.from_numpy(audio[:n]).to(dev).float() / 32768.0
            v_feat = model.video_model.encode_frames(frames).contiguous()
            a_seq = model.audio_model.encode_sequence(wave).contiguous()

            def modules():
                v = model.v_in_proj(v_feat)
                a = model.a_in_proj(model.audio_seq_proj(a_seq))
                v_new = model.v_norm(v + model.v2a_attn(v, a, a))
                a_new = model.a_norm(a + model.a2v_attn(a, v_new, v_new))
                v_emb, a_emb = v_new.mean(dim=1), a_new.mean(dim=1)
                return v, a, v_emb, a_emb, model.xattn_mlp(torch.cat([v_emb, a_emb], dim=1))

            v, a, v_want, a_want, logits_want = modules()
            v_emb, a_emb = fused_bidirectional_xattn(xattn_params, v, a, num_heads=heads)
            logits = fused_block(v_feat, a_seq, block_params, spec)
            torch.cuda.synchronize()
            err5 = max((v_emb - v_want).abs().max().item(), (a_emb - a_want).abs().max().item())
            err4 = (logits - logits_want).abs().max().item()
            print(f"block entries b{n}: max |K5 - modules| = {err5:.3e}, "
                  f"max |K4 - modules| = {err4:.3e} (tol {FUSION_TOL})")
            if (v_emb.shape != (n, 128) or logits.shape != (n, 8)
                    or not torch.isfinite(logits).all() or not max(err4, err5) <= FUSION_TOL):
                raise AssertionError(f"K4 or K5 disagrees with the modular fusion modules: {err4}, {err5}")
            times[f"b{n}"] = {
                "k4_ms": cuda_ms(lambda: fused_block(v_feat, a_seq, block_params, spec)),
                "modules_ms": cuda_ms(modules),
                "k4_host_enqueue_ms": enqueue_ms(lambda: fused_block(v_feat, a_seq, block_params, spec)),
                "modules_host_enqueue_ms": enqueue_ms(modules),
            }
            print(f"block entries b{n} (float32): " + ", ".join(
                f"{key} {value:.4f}" for key, value in times[f"b{n}"].items()))
    return fused_bidirectional_xattn.launches, times


def bench_entries(dev, gen):
    """Phase 7a: the three measurement entry points, each through its normal
    entry with the launch counts read around it, K1 and K3 held against their
    plain versions at the batches these entries give them, and each WavLM
    forward held against the same weights and inputs on the plain path
    -> (K6 launches, report)."""
    import os

    from multimodalemotionrecognition_torch import entry as port_entry
    from multimodalemotionrecognition_torch.bench import attn_tile, forward
    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        wavlm_attention_sublayer,
        wavlm_attention_sublayer_tiled,
    )

    counters = {"wavlm_attention_sublayer_tiled": wavlm_attention_sublayer_tiled,
                "wavlm_attention_sublayer": wavlm_attention_sublayer,
                "fused_conv_layer": fused_conv_layer}

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {name: c.launches for name, c in counters.items()}

    report = {}
    # K6's main path: the batch-tile experiment at its own size.
    report["attn_tile"], got = counted(lambda: attn_tile.main(["--batch", "128"]))
    k6_launches = got["wavlm_attention_sublayer_tiled"]
    print(f"bench attn_tile: launches {got}")
    tiles = report["attn_tile"]["results"]
    if (k6_launches < 1 or set(tiles) != {"1", "2", "4", "8"} or got["fused_conv_layer"]
            or report["attn_tile"]["route"] != "tensor cores"
            or not all(np.isfinite(ms) and ms > 0 for ms in tiles.values())
            or not report["attn_tile"]["k1_ms"] > 0):
        raise AssertionError(f"bench.attn_tile: {report['attn_tile']}, launches {got}")

    # K1 and K3 at the shapes of `bench.forward` here and of `entry()`.
    report["kernels_at_bench_shapes"] = {
        f"b{b}": {"wavlm_attention_sublayer": check_k1(dev, gen, b),
                  "fused_conv_layer": check_k3(dev, gen, b)}
        for b in (BENCH_BATCH, 1)}
    plain_path = dict(wavlm_geometry=dict(fused_attention=False, fused_conv=False))

    os.environ.update(BENCH_BATCH=str(BENCH_BATCH), BENCH_ITERS=str(BENCH_ITERS),
                      BENCH_DTYPE="bfloat16")
    forwards = 1 + 2 + 3 * BENCH_ITERS  # the check, the warm-up, best of 3
    for use_wavlm in (True, False):
        os.environ["BENCH_WAVLM"] = "1" if use_wavlm else "0"
        key = "forward_wavlm" if use_wavlm else "forward_mel"
        report[key], got = counted(forward.run_single)
        want = {"wavlm_attention_sublayer_tiled": 0,
                "wavlm_attention_sublayer": 12 * forwards if use_wavlm else 0,
                "fused_conv_layer": 6 * forwards if use_wavlm else 0}
        print(f"bench {key}: {forwards} forwards, launches {got}")
        name = f"torch_xattn{'_wavlm' if use_wavlm else ''}_fwd_throughput_b{BENCH_BATCH}_bfloat16"
        if got != want or report[key]["metric"] != name or not report[key]["value"] > 0:
            raise AssertionError(f"bench.forward {key}: {report[key]}, launches {got}, expected {want}")
    # The measured WavLM forward (same seed: same weights and inputs) on the
    # kernel path against the plain path.
    got = forward.make_step(BENCH_BATCH, True, "bfloat16", dev)()
    want = forward.make_step(BENCH_BATCH, True, "bfloat16", dev, **plain_path)()
    err = (got - want).abs().max().item()
    print(f"bench forward_wavlm b{BENCH_BATCH} bfloat16: max |kernel - plain| = {err:.3e} "
          f"(tol {PROBS_TOL['bfloat16']})")
    if not err <= PROBS_TOL["bfloat16"] or float(got.std(dim=0).max()) < 1e-6:
        raise AssertionError(f"bench.forward: kernel path disagrees with plain path: {err}")
    report["forward_wavlm"]["max_abs_err_vs_plain_path"] = err

    (forward_fn, args), built = counted(port_entry.entry)
    probs, got = counted(lambda: forward_fn(*args))
    print(f"entry: probabilities {tuple(probs.shape)} on {probs.device}, launches {got}")
    if (probs.shape != (1, 8) or probs.device.type != "cuda" or not torch.isfinite(probs).all()
            or abs(float(probs.sum()) - 1.0) > 1e-5 or any(built.values())
            or got != {"wavlm_attention_sublayer_tiled": 0, "wavlm_attention_sublayer": 12,
                       "fused_conv_layer": 6}):
        raise AssertionError(f"entry(): bad forward {probs}, launches {got}")
    # The same forward on the plain path, on entry()'s own arguments and on a
    # waveform that is not silence.
    plain_fn, plain_args = port_entry.entry(**plain_path)
    wave = (0.1 * torch.randn(1, 1, 48000, generator=gen)).to(dev)
    frames = torch.randn(1, 8, 3, 112, 112, generator=gen).to(dev)
    err = max(
        (forward_fn(args[0], *inputs) - plain_fn(plain_args[0], *inputs)).abs().max().item()
        for inputs in (args[1:], (frames, wave)))
    print(f"entry float32: max |kernel - plain| = {err:.3e} (tol {PROBS_TOL['float32']})")
    if not err <= PROBS_TOL["float32"]:
        raise AssertionError(f"entry(): kernel path disagrees with plain path: {err}")
    report["entry"] = {"max_abs_err_vs_plain_path": err}
    return k6_launches, report


# Phase 7b: family -> ModelConfig overrides (a mel model's audio input is the log-mel spectrogram)
FAMILIES = {
    "xattn_mel": dict(fusion="xattn", use_wavlm=False),
    "gated_resnet18": dict(fusion="gated", use_wavlm=False, use_resnet_audio=True),
    "late": dict(fusion="late", use_wavlm=False),
    "concat": dict(fusion="concat", use_wavlm=False),
    "audio": dict(fusion="audio", use_wavlm=False),
    "video": dict(fusion="video", use_wavlm=False),
    "xattn_wavlm_transformer": dict(fusion="xattn", use_wavlm=True,
                                    temporal_pooling="transformer"),
}


def serve_families(dev, card, tmp, video, audio, iters: int = 5):
    """The other model families at full width through `TorchModelRunner`
    -> (K1 and K3 launches of the transformer-pooler model, perf)."""
    from multimodalemotionrecognition_torch.config import ModelConfig
    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        wavlm_attention_sublayer,
    )
    from multimodalemotionrecognition_torch.models.factory import build_model
    from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram_np
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
    from multimodalemotionrecognition_torch.serving.predictor import EmotionPredictor

    wave = audio.astype(np.float32) / 32768.0
    mel = log_mel_spectrogram_np(wave[:, 0, :])[:, None]  # [8, 1, 64, 301]
    perf, launches = {}, {}
    for family, overrides in FAMILIES.items():
        cfg = ModelConfig(**overrides)
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
        ckpt = Path(tmp) / f"{family}.pt"
        torch.save({"model": model.state_dict(), "config": cfg.to_checkpoint_dict(),
                    "val_f1": 0.0}, ckpt)
        del model
        sound = audio if cfg.use_wavlm else mel
        reference = TorchModelRunner(ckpt, device="cpu", device_normalize=True).predict_probs(
            video[:1], sound[:1])
        for dtype in ("bfloat16", "float32"):
            runner = TorchModelRunner(ckpt, device=dev, compute_dtype=dtype,
                                      device_normalize=True)
            if runner.fusion_mode != cfg.fusion or runner.use_wavlm != cfg.use_wavlm:
                raise AssertionError(f"{family}: served as {runner.fusion_mode}")
            runner.warmup((1, 8))
            wavlm_attention_sublayer.launches = fused_conv_layer.launches = 0
            out = {n: runner.predict_probs(video[:n], sound[:n]) for n in (1, 8)}
            torch.cuda.synchronize()
            got = (wavlm_attention_sublayer.launches, fused_conv_layer.launches)
            if got != ((24, 12) if cfg.use_wavlm else (0, 0)):
                raise AssertionError(f"{family} {dtype}: K1 and K3 launches {got} over 2 forwards")
            if cfg.use_wavlm:
                launches[dtype] = got
            for n, probs in out.items():
                if (probs.shape != (n, cfg.num_classes) or not np.isfinite(probs).all()
                        or not np.allclose(probs.sum(axis=1), 1.0, atol=1e-3)
                        or (probs < 0).any()):
                    raise AssertionError(f"{family} {dtype} b{n}: bad probabilities {probs}")
            if float(out[8].std(axis=0).max()) < 1e-6:
                raise AssertionError(f"{family} {dtype}: probabilities constant across clips")
            line = ""
            if dtype == "float32":
                err = float(np.abs(out[1] - reference).max())
                line = f", b1 max |card - cpu| = {err:.3e} (tol {CPU_PROBS_TOL})"
                if not err <= CPU_PROBS_TOL:
                    raise AssertionError(f"{family}: the card disagrees with the CPU: {err}")
                if not cfg.use_wavlm:  # the waveform through the predictor's host mel
                    pred = EmotionPredictor(runner=runner).predict_waveform(video[:1], wave[:1])
                    if abs(sum(pred["probs"]) - 100.0) > 1e-2:
                        raise AssertionError(f"{family}: malformed predictor output {pred}")
            times = {}
            for n in (1, 8):
                samples = []
                for _ in range(iters):
                    t0 = time.perf_counter()
                    runner.predict_probs(video[:n], sound[:n])
                    samples.append((time.perf_counter() - t0) * 1e3)
                times[n] = float(np.median(samples))
            perf[f"{family}_{dtype}"] = {"b1_ms": times[1], "b8_clips_per_s": 8e3 / times[8]}
            print(f"family {family} {dtype}: b1 latency {times[1]:.2f} ms, b8 "
                  f"{8e3 / times[8]:.1f} clips/s, b8 probs[0] {np.round(out[8][0].astype(float), 4).tolist()}"
                  f"{line} [{card}]")
            del runner
        torch.cuda.empty_cache()
    return launches, perf


# --------------------------------------------------------------------------- phase 5a: serve-stack

STACK_REQUESTS = 24  # .wav uploads per burst
RESULT_KEYS = {"task_id", "worker_name", "labels", "probs", "top1", "queue_delay_ms", "processed_at"}


def _wav_uploads(n: int, seed: int):
    """.wav uploads of seeded noise, written by scipy: 3 s at 16 kHz, 2 s at
    48 kHz (resampled, then zero-padded) and 4 s at 22.05 kHz (resampled,
    then head-cropped), in turn."""
    import io

    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    uploads = []
    for i in range(n):
        sr, seconds = ((16000, 3.0), (48000, 2.0), (22050, 4.0))[i % 3]
        pcm = np.clip(rng.randn(int(sr * seconds)) * 4000, -32768, 32767).astype(np.int16)
        buf = io.BytesIO()
        wavfile.write(buf, sr, pcm)
        uploads.append((f"clip{i}_{sr}.wav", buf.getvalue()))
    return uploads


def _burst(runner, uploads, config):
    """All uploads submitted at once to `InferenceGateway` + `DynamicBatcher`
    over `runner` -> (results in submission order, the batcher's StageTimer,
    wall seconds from the first submit to the last result)."""
    import asyncio

    from multimodalemotionrecognition_torch.serving.batcher import DynamicBatcher, InferenceGateway

    async def scenario():
        gateway = InferenceGateway(config)
        batcher = DynamicBatcher(gateway, runner, config)
        task = asyncio.create_task(batcher.run())
        t0 = time.perf_counter()
        ids = await gateway.submit_many(uploads)
        results = await asyncio.gather(*(gateway.wait_for_result(t) for t in ids))
        wall = time.perf_counter() - t0
        batcher.stop()
        await task
        return list(results), batcher.timer, wall

    return asyncio.run(scenario())


def _direct_blank_video(runner, uploads):
    """Each upload's preprocessed audio through `predict_probs_blank_video`, alone."""
    from multimodalemotionrecognition_torch.serving.preprocess import EmotionPreprocessService

    pre = EmotionPreprocessService()
    rows = []
    for name, data in uploads:
        _, audio, blank = pre.preprocess_payload(name, data, use_wavlm=True, raw_uint8=True)
        if not blank:
            raise AssertionError(f"{name}: the .wav upload did not take the blank-video route")
        rows.append(runner.predict_probs_blank_video(audio)[0])
    return np.stack(rows)


def serve_stack_batcher(dev, card, ckpt, tmp):
    """Part a (stdlib, numpy, scipy, torch): bursts of .wav uploads through
    the gateway and the dynamic batcher over `TorchModelRunner`, each result
    against a direct call; the launches per batch forward; the predictor on
    a .wav file."""
    from multimodalemotionrecognition_torch.config import ServeConfig
    from multimodalemotionrecognition_torch.kernels import (
        fused_block,
        fused_conv_layer,
        wavlm_attention_sublayer,
    )
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
    from multimodalemotionrecognition_torch.serving.predictor import EmotionPredictor

    counters = {"wavlm_attention_sublayer": wavlm_attention_sublayer,
                "fused_conv_layer": fused_conv_layer, "fused_block": fused_block}
    uploads = _wav_uploads(STACK_REQUESTS, SEED)
    report, launches = {}, dict.fromkeys(counters, 0)
    # The host path once before the timed bursts: the first upload pays the
    # import of scipy.signal, seconds in a fresh process.
    from multimodalemotionrecognition_torch.serving.preprocess import EmotionPreprocessService

    for name, data in uploads[:3]:
        EmotionPreprocessService().preprocess_payload(name, data, use_wavlm=True, raw_uint8=True)
    for label, dtype, fused in (("float32", "float32", False), ("bfloat16", "bfloat16", False),
                                ("float32_fused", "float32", True)):
        config = ServeConfig(compute_dtype=dtype, fused_xattn=fused)  # batch 8, 20 ms, buckets 1-8
        runner = TorchModelRunner(ckpt, device=dev, batch_buckets=config.batch_buckets,
                                  compute_dtype=config.compute_dtype, fused=config.fused_xattn,
                                  device_normalize=config.device_normalize)
        runner.warmup()
        _burst(runner, uploads[:8], config)  # the batcher's first use: its threads, pinned buffers
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        results, timer, wall = _burst(runner, uploads, config)
        torch.cuda.synchronize()
        got_launches = {name: fn.launches for name, fn in counters.items()}
        sizes = [int(s) for s in timer.samples("batch_size")]
        forwards = len(sizes)
        want_launches = {"wavlm_attention_sublayer": 12 * forwards, "fused_conv_layer": 6 * forwards,
                         "fused_block": forwards if fused else 0}
        if got_launches != want_launches:
            raise AssertionError(f"serve-stack {label}: launches {got_launches}, expected "
                                 f"{want_launches} for {forwards} batch forwards {sizes}")
        for name in launches:
            launches[name] += got_launches[name]
        if sum(sizes) != len(uploads) or max(sizes) < 2:
            raise AssertionError(f"serve-stack {label}: batch sizes {sizes}: no batch of more than one")
        for r in results:
            if set(r) != RESULT_KEYS or r["labels"] != runner.labels or r["worker_name"] != config.worker_name:
                raise AssertionError(f"serve-stack {label}: malformed result {r}")
        got = np.array([r["probs"] for r in results])
        want = _direct_blank_video(runner, uploads)
        err = float(np.abs(got - want).max())
        same_top = bool((got.argmax(axis=1) == want.argmax(axis=1)).all())
        if not (np.isfinite(got).all() and err <= PROBS_TOL[dtype] and same_top):
            raise AssertionError(f"serve-stack {label}: batcher against direct calls max err {err:.3e} "
                                 f"(tol {PROBS_TOL[dtype]}), same argmax {same_top}")
        delays = np.array([r["queue_delay_ms"] for r in results])
        stages = timer.summary()
        report[label] = {
            "requests": len(uploads), "batch_sizes": sizes, "launches": got_launches,
            "max_abs_err_vs_direct": err, "clips_per_s": len(uploads) / wall,
            "queue_delay_ms_median": float(np.median(delays)), "queue_delay_ms_max": float(delays.max()),
            "preprocess_ms_p50": stages["preprocess"]["p50_ms"], "infer_ms_p50": stages["infer"]["p50_ms"],
        }
        print(f"serve-stack {label}: {len(uploads)} .wav requests in {forwards} batches {sizes}, "
              f"launches {got_launches}; max |batcher - direct| {err:.3e} (tol {PROBS_TOL[dtype]}), "
              f"same argmax; {len(uploads) / wall:.1f} clips/s, queue_delay_ms median "
              f"{np.median(delays):.2f} max {delays.max():.2f}; StageTimer p50 preprocess "
              f"{stages['preprocess']['p50_ms']} ms, infer {stages['infer']['p50_ms']} ms [{card}]")
        del runner
    # The direct backend's predictor on a .wav file (cv2 finds no frames: blank video).
    path = Path(tmp) / "upload.wav"
    path.write_bytes(uploads[0][1])
    predictor = EmotionPredictor(checkpoint_path=str(ckpt), device=str(dev),
                                 config=ServeConfig(checkpoint_path=str(ckpt)))
    out = predictor.predict(str(path))
    want = _direct_blank_video(predictor.runner, uploads[:1])[0] * 100
    err = float(np.abs(np.array(out.get("probs", [np.nan])) - want).max())
    if "error" in out or abs(sum(out["probs"]) - 100.0) > 1e-2 or not err <= 100 * PROBS_TOL["float32"]:
        raise AssertionError(f"serve-stack predictor: {out} (max |predict - direct| {err:.3e} %)")
    print(f"serve-stack predictor: predict(.wav) top1 {out['top1']}, max |predict - direct| {err:.3e} %")
    report["predictor_err_pct"] = err
    # What this slice added to every request of an existing path: `stage`
    # and the forward each enter the runner's stream (1-2 times a request).
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        with predictor.runner._on_stream():
            pass
    report["stream_enter_exit_us"] = (time.perf_counter() - t0) / n * 1e6
    print(f"serve-stack: entering and leaving the runner's stream {report['stream_enter_exit_us']:.2f} us "
          f"(host, mean of {n}) [{card}]")
    return launches, report


async def _serve_on_socket(app, talk):
    """`app` on 127.0.0.1 (a free port) through AppRunner + TCPSite; -> talk(base_url)."""
    from aiohttp import web

    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    try:
        host, port = runner.addresses[0][:2]
        return await talk(f"http://{host}:{port}")
    finally:
        await runner.cleanup()


async def _ws_stream_session(session, base):
    """One /ws/stream session: JPEG frames of a face-like scene and 3.5 s of
    PCM16 audio, until a prediction comes back."""
    import base64

    import cv2

    frame = np.full((120, 160, 3), 30, np.uint8)
    frame[30:80, 50:90] = (110, 140, 200)  # BGR skin tone
    jpeg = base64.b64encode(cv2.imencode(".jpg", frame)[1].tobytes()).decode()
    pcm = (np.random.RandomState(SEED).randn(56000) * 3000).astype(np.int16)
    messages = []
    async with session.ws_connect(base + "/ws/stream") as ws:
        messages.append(await ws.receive_json(timeout=60))
        await ws.send_json({"type": "start"})
        messages.append(await ws.receive_json(timeout=60))
        for i in range(4):
            await ws.send_json({"type": "frame", "image_b64": jpeg, "timestamp": 0.2 * i})
        for chunk in np.array_split(pcm, 4):
            await ws.send_json({"type": "audio", "sample_rate": 16000,
                                "pcm_b64": base64.b64encode(chunk.tobytes()).decode()})
        while messages[-1].get("type") != "prediction":
            messages.append(await ws.receive_json(timeout=60))
        await ws.send_json({"type": "stop"})
        messages.append(await ws.receive_json(timeout=60))
    kinds = [m["type"] for m in messages]
    if kinds[:2] != ["session_started", "ack"] or kinds[-2:] != ["prediction", "session_stopped"]:
        raise AssertionError(f"serve-stack ws: messages {kinds}")
    payload = messages[-2]["payload"]
    if "error" in payload or abs(sum(payload["probs"]) - 100.0) > 1e-2 or payload["num_audio_samples"] != 48000:
        raise AssertionError(f"serve-stack ws: bad prediction {payload}")
    return payload


def serve_stack_http(dev, card, ckpt):
    """Part b: both apps on a socket with the real runner: /health, POST
    /predict of a .wav, /queue/status, one WebSocket session each."""
    import asyncio

    import aiohttp
    import cv2  # noqa: F401  (the streaming frames' codec; a missing package fails the run)

    from multimodalemotionrecognition_torch.config import ServeConfig
    from multimodalemotionrecognition_torch.serving import server_direct, server_queued

    config = ServeConfig(checkpoint_path=str(ckpt))
    name, data = _wav_uploads(1, SEED + 1)[0]
    report = {}

    async def talk_direct(base):
        async with aiohttp.ClientSession() as session:
            async with session.get(base + "/health") as r:
                health = await r.json()
            form = aiohttp.FormData()
            form.add_field("file", data, filename=name)
            async with session.post(base + "/predict", data=form) as r:
                status, pred = r.status, await r.json()
            ws = await _ws_stream_session(session, base)
        if health["device"] != "gpu" or health["mock_mode"] is not False or status != 200 or "error" in pred:
            raise AssertionError(f"serve-stack direct app: health {health}, predict {status} {pred}")
        return {"health": health, "predict_top1": pred["top1"], "ws_top1": ws["top1"]}

    async def talk_queued(base):
        async with aiohttp.ClientSession() as session:
            async with session.get(base + "/health") as r:
                health = await r.json()
            form = aiohttp.FormData()
            form.add_field("file", data, filename=name)
            async with session.post(base + "/predict", data=form) as r:
                status, pred = r.status, await r.json()
            async with session.get(base + "/queue/status") as r:
                queue = await r.json()
            async with session.get(base + "/metrics") as r:
                metrics = await r.json()
            ws = await _ws_stream_session(session, base)
        if (health["status"] != "ok" or status != 200 or set(pred) != RESULT_KEYS
                or abs(sum(pred["probs"]) - 1.0) > 1e-4 or queue["queue_key"] != config.queue_name):
            raise AssertionError(f"serve-stack queued app: health {health}, predict {status} {pred}, "
                                 f"queue {queue}")
        return {"health_status": health["status"], "predict_top1": pred["top1"],
                "queue_status": queue, "stages": metrics["stages"], "ws_top1": ws["top1"]}

    for label, make, talk in (
        ("direct", lambda: server_direct.create_app(config=config, checkpoint=str(ckpt), device=str(dev)),
         talk_direct),
        ("queued", lambda: server_queued.create_app(config=config, device=str(dev)), talk_queued),
    ):
        t0 = time.perf_counter()
        app = make()
        report[label] = asyncio.run(_serve_on_socket(app, talk))
        report[label]["wall_s"] = time.perf_counter() - t0
        print(f"serve-stack http {label} app on 127.0.0.1: {report[label]} [{card}]")
    return report


# --------------------------------------------------------------------------- phase 11: data and train CLI

GATE_TARGET = 0.70  # actor-held-out test accuracy (the JAX gate's target)
FLAGSHIP_CLI_ARGV = [
    "--fusion", "xattn", "--use_wavlm", "--two_stage_training", "--stage1_epochs", "1",
    "--epochs", "2", "--batch_size", "16", "--frames", "8", "--img_size", "112",
    "--split_mode", "actor", "--train_actors", "1,2", "--val_actors", "3", "--test_actors", "4",
]


class _ForwardLog:
    """While entered, through a global module forward hook: after each WavLM
    forward its `layers_run` and the encoder layers trainable in it (none
    without autograd), and each fusion model's output."""

    def __enter__(self):
        from multimodalemotionrecognition_torch.models.fusion import FusionModel
        from multimodalemotionrecognition_torch.models.wavlm import WavLMModel

        self.wavlm, self.outputs = [], []

        def hook(module, args, out):
            if isinstance(module, WavLMModel):
                trainable = set()
                if torch.is_grad_enabled():
                    trainable = {i for i, layer in enumerate(module.encoder.layers)
                                 if layer.attention.q_proj.weight.requires_grad}
                self.wavlm.append((list(module.layers_run), trainable))
            elif isinstance(module, FusionModel):
                self.outputs.append((out[0] if isinstance(out, tuple) else out).detach())

        self._handle = torch.nn.modules.module.register_module_forward_hook(hook)
        return self

    def __exit__(self, *exc):
        self._handle.remove()

    def launches(self) -> dict:
        """What the logged forwards launch: 12 K1 less the LayerDrop skips and
        6 K3 each, one K2 per trainable encoder layer that ran."""
        return {"wavlm_attention_sublayer": sum(len(ran) for ran, _ in self.wavlm),
                "fused_conv_layer": 6 * len(self.wavlm),
                "wavlm_attention_sublayer_backward": sum(
                    len(set(ran) & trainable) for ran, trainable in self.wavlm)}


class _LoaderClock:
    """While entered: for every shuffled (train) `BatchedLoader`, the host
    seconds each `next()` waited for a batch and the host seconds between
    handing a batch out and asking for the next (the step's host side: the
    staged copy and the queued step; the device runs behind it)."""

    def __enter__(self):
        from multimodalemotionrecognition_torch.data import pipeline

        self.waits, self.steps = [], []
        self._cls, self._original = pipeline.BatchedLoader, pipeline.BatchedLoader.__iter__
        original, clock = self._original, self

        def timed(loader):
            it = original(loader)
            handed = None
            try:
                while True:
                    t0 = time.perf_counter()
                    if handed is not None and loader.shuffle:
                        clock.steps.append(t0 - handed)
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    handed = time.perf_counter()
                    if loader.shuffle:
                        clock.waits.append(handed - t0)
                    yield batch
            finally:
                it.close()

        self._cls.__iter__ = timed
        return self

    def __exit__(self, *exc):
        self._cls.__iter__ = self._original

    def summary(self) -> dict:
        waits, steps = np.array(self.waits), np.array(self.steps)
        return {"loader_wait_ms_median": float(np.median(waits)) * 1e3,
                "host_step_ms_median": float(np.median(steps)) * 1e3,
                "loader_wait_share": float(waits.sum() / (waits.sum() + steps.sum())),
                "train_batches": int(waits.size)}


def data_cli(dev, card):
    """Phase 11 -> (launches of the flagship's CLI training run, report).
    In a temporary working directory (pairs.csv and outputs/ land there)."""
    import os

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            return _data_cli(dev, card, Path(tmp))
        finally:
            os.chdir(cwd)


def _data_cli(dev, card, tmp):
    import os

    from multimodalemotionrecognition_torch.bench import convergence_gate
    from multimodalemotionrecognition_torch.config import DataConfig
    from multimodalemotionrecognition_torch.data import synthetic
    from multimodalemotionrecognition_torch.data.pipeline import auto_num_threads, build_loaders
    from multimodalemotionrecognition_torch.data.ravdess import build_pairs
    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        wavlm_attention_sublayer,
        wavlm_attention_sublayer_backward,
    )
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
    from multimodalemotionrecognition_torch.train import cli
    from multimodalemotionrecognition_torch.train import eval as train_eval

    t_phase = time.perf_counter()
    counters = {"wavlm_attention_sublayer": wavlm_attention_sublayer,
                "fused_conv_layer": fused_conv_layer,
                "wavlm_attention_sublayer_backward": wavlm_attention_sublayer_backward}
    report = {"card": card}

    # (a) make-data: the gate's corpus (the gate's own writer and
    # defaults), then the flagship's through the command's defaults.
    t0 = time.perf_counter()
    n_gate = convergence_gate.write_corpus(tmp / "gate", 0.4)
    gate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    synthetic.main(["--root", str(tmp / "flagship")])
    flagship_s = time.perf_counter() - t0
    n_flagship = len(build_pairs(tmp / "flagship"))
    report["make_data"] = {"gate_pairs": n_gate, "gate_s": gate_s, "flagship_pairs": n_flagship,
                           "flagship_s": flagship_s}
    print(f"data cli make-data: the gate's corpus {n_gate} pairs (1 s, 10 fps) in {gate_s:.2f} s, "
          f"the flagship's {n_flagship} pairs (3 s) in {flagship_s:.2f} s [{card}]")
    if (n_gate, n_flagship) != (256, 32):
        raise AssertionError(f"data cli make-data: {n_gate} and {n_flagship} pairs")

    # (b) the convergence gate at its defaults (gated, s=0.4, 12 epochs; the
    # uint8 wire on the card).  A miss ends the run.
    with _LoaderClock() as clock:
        gate = convergence_gate.gate(["--root", str(tmp / "gate")])
    loader = clock.summary()
    report["gate"] = {**gate, **loader, "auto_num_threads": auto_num_threads(),
                      "cpu_count": os.cpu_count()}
    print(f"data cli gate: actor-held-out test accuracy {gate['value']} (target {GATE_TARGET}; the "
          f"JAX calibration read 0.8125 on a TPU), margin {gate['mean_top1_margin']}, "
          f"{gate['train_seconds']} s for {gate['epochs']} epochs; {loader['train_batches']} train "
          f"batches on {auto_num_threads()} decode threads ({os.cpu_count()} CPUs): loader wait "
          f"median {loader['loader_wait_ms_median']:.1f} ms, host step median "
          f"{loader['host_step_ms_median']:.1f} ms, waited share {loader['loader_wait_share']:.2f} "
          f"[{card}]")
    if not (gate["pass"] and gate["value"] >= GATE_TARGET and gate["backend"] == "cuda"):
        raise AssertionError(f"data cli gate: {gate}")
    report["gate_int8"] = _gate_int8(dev, card, tmp, gate)

    # (c) the flagship through `train` at full width (face crop on, f32):
    # counters from 0, every kernel launch of the run held against the
    # LayerDrop draws of each forward.
    out_dir = tmp / "outputs"
    argv = ["--data_root", str(tmp / "flagship"), "--output_dir", str(out_dir), *FLAGSHIP_CLI_ARGV]
    for fn in counters.values():
        fn.launches = 0
    with _LoaderClock() as clock, _ForwardLog() as log:
        t0 = time.perf_counter()
        result = cli.main(argv, device=dev)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = log.launches()
    history = result["history"]
    flagship = {
        "train_losses": [float(row["train/loss"]) for row in history],
        "val_losses": [float(row["val/loss"]) for row in history],
        "val_acc": [float(row["val/acc"]) for row in history],
        "epoch_s": [row["epoch_time_sec"] for row in history],
        "test_acc": result["test"]["acc"], "test_f1": result["test"]["f1"],
        "best_val_f1": result["best_val_f1"], "wall_s": cli_s, "forwards": len(log.wavlm),
        "launches": launches, **clock.summary(),
    }
    report["flagship_cli"] = flagship
    print(f"data cli flagship train: losses {flagship['train_losses']} (val "
          f"{flagship['val_losses']}), val acc {flagship['val_acc']}, test acc "
          f"{flagship['test_acc']:.4f} f1 {flagship['test_f1']:.4f}; epochs "
          f"{flagship['epoch_s']} s, {cli_s:.1f} s in all; loader wait median "
          f"{flagship['loader_wait_ms_median']:.1f} ms, host step median "
          f"{flagship['host_step_ms_median']:.1f} ms [{card}]")
    print(f"data cli flagship train: {len(log.wavlm)} WavLM forwards, layers run and trainable "
          f"{log.wavlm}; launches {launches}, expected {want}")
    if launches != want or not all(np.isfinite(flagship["train_losses"] + flagship["val_losses"])):
        raise AssertionError(f"data cli flagship: launches {launches}, expected {want}; {flagship}")

    # `eval` on the best checkpoint against the runner on the same test clips.
    ckpt = out_dir / "best_xattn.pt"
    seen = {name: fn.launches for name, fn in counters.items()}
    with _ForwardLog() as log:
        metrics = train_eval.main(["--checkpoint", str(ckpt), "--data_root", str(tmp / "flagship"),
                                   "--test_actors", "4"], device=dev)
    evaluated = {name: fn.launches - seen[name] for name, fn in counters.items()}
    dc = DataConfig(data_root=str(tmp / "flagship"), split_mode="actor", train_actors=(),
                    val_actors=(), test_actors=(4,))
    batch = next(iter(build_loaders(dc, 16)[2]))  # the clips `eval` read
    valid, labels = batch.valid, batch.labels[batch.valid]
    eval_preds = log.outputs[0].argmax(dim=1).cpu().numpy()[valid] if log.outputs else None
    runner = TorchModelRunner(ckpt, device=dev, compute_dtype="float32")
    runner_preds = runner.predict_probs(batch.video[valid], batch.audio[valid]).argmax(axis=1)
    runner_acc = float((runner_preds == labels).mean())
    report["eval"] = {"acc": metrics["acc"], "f1": metrics["f1"], "runner_acc": runner_acc,
                      "clips": int(valid.sum()), "launches": evaluated}
    print(f"data cli eval: accuracy {metrics['acc']:.4f} f1 {metrics['f1']:.4f} on {valid.sum()} "
          f"test clips, the runner on the same checkpoint {runner_acc:.4f}; predictions eval "
          f"{eval_preds} runner {runner_preds}; launches {evaluated} over {len(log.wavlm)} forwards")
    if (len(log.outputs) != 1 or valid.sum() != 8 or evaluated != log.launches()
            or not np.array_equal(eval_preds, runner_preds) or metrics["acc"] != runner_acc):
        raise AssertionError(f"data cli eval: {report['eval']}, eval predictions {eval_preds}, "
                             f"runner {runner_preds}")
    del runner
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"data cli: phase wall time {report['phase_s']:.1f} s [{card}]")
    return launches, report


def _gate_int8(dev, card, tmp, gate):
    """(b') The gate's trained checkpoint exported with `--int8` against the
    float32 runner on the gate's held-out actor (8): accuracy of each on the
    same 32 clips, decoded at the export's input (8 frames of 112 px; the
    gate trained at 4 of 64, so both read the clips at another scale)."""
    from multimodalemotionrecognition_torch.config import DataConfig, VideoConfig
    from multimodalemotionrecognition_torch.data.pipeline import build_loaders
    from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram
    from multimodalemotionrecognition_torch.runtime import export
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

    ckpt = tmp / "gate" / "outputs" / "best_gated.pt"
    artifact = export.main(["--checkpoint", str(ckpt), "--output", str(tmp / "gate_int8"),
                            "--int8", "--batch-sizes", "1,8"], device=dev)
    exported = export.load_exported(artifact)
    runner = TorchModelRunner(ckpt, device=dev, compute_dtype="float32")
    dc = DataConfig(data_root=str(tmp / "gate"), split_mode="actor", train_actors=(),
                    val_actors=(), test_actors=(8,), use_face_crop=False,
                    video=VideoConfig(num_frames=8, size=112))
    int8_runner = TorchModelRunner(ckpt, device=dev, compute_dtype="float32", quantize_int8=True)
    # The int8 and float32 runners at the gate's own input (4 frames of 64 px).
    native = {"int8_runner": [], "float32_runner": []}
    native_labels = []
    for batch in build_loaders(dataclasses.replace(dc, video=VideoConfig(num_frames=4, size=64)),
                               16)[2]:
        valid = batch.valid
        with torch.no_grad():
            mel = log_mel_spectrogram(torch.from_numpy(batch.audio[valid][:, 0]).to(dev))
        mel = mel[:, None].cpu().numpy()
        for name, r in (("int8_runner", int8_runner), ("float32_runner", runner)):
            native[name].append(r.predict_probs(batch.video[valid], mel).argmax(axis=1))
        native_labels.append(batch.labels[valid])
    native_labels = np.concatenate(native_labels)
    at_64 = {name: float((np.concatenate(p) == native_labels).mean()) for name, p in native.items()}
    at_64["agree"] = float(np.mean(np.concatenate(native["int8_runner"])
                                   == np.concatenate(native["float32_runner"])))
    print(f"data cli gate int8: at the gate's input (4 frames of 64 px) the int8 runner "
          f"{at_64['int8_runner']:.4f}, the float32 runner {at_64['float32_runner']:.4f} on "
          f"{native_labels.size} clips, the same argmax on {at_64['agree']:.4f} [{card}]")
    preds = {"int8_export": [], "float32_runner": []}
    labels = []
    for batch in build_loaders(dc, 16)[2]:
        valid = batch.valid
        with torch.no_grad():
            mel = log_mel_spectrogram(torch.from_numpy(batch.audio[valid][:, 0]).to(dev))
        mel = mel[:, None].cpu().numpy()
        preds["int8_export"].append(exported.predict_probs(batch.video[valid], mel).argmax(axis=1))
        preds["float32_runner"].append(runner.predict_probs(batch.video[valid], mel).argmax(axis=1))
        labels.append(batch.labels[valid])
    labels = np.concatenate(labels)
    out = {name: float((np.concatenate(p) == labels).mean()) for name, p in preds.items()}
    out["agree"] = float(np.mean(np.concatenate(preds["int8_export"])
                                 == np.concatenate(preds["float32_runner"])))
    out["clips"] = int(labels.size)
    out["at_4x64"] = at_64
    print(f"data cli gate int8: actor-held-out test accuracy of the --int8 export "
          f"{out['int8_export']:.4f}, the float32 runner {out['float32_runner']:.4f} on the same "
          f"{labels.size} clips (8 frames of 112 px), the same argmax on {out['agree']:.4f} of them; "
          f"the gate's own reading at 4 frames of 64 px {gate['value']} [{card}]")
    if labels.size != 32 or native_labels.size != 32:
        raise AssertionError(f"data cli gate int8: {labels.size}, {native_labels.size} test clips")
    del runner, int8_runner, exported
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- phase 12: export

EXPORT_TOL = 1e-5  # abs, probabilities: the exported program against TorchModelRunner
# Run in a fresh interpreter that imports only the port: load an artifact,
# answer 1, 8 and 11 clips, count the kernels' launches per request.
_FRESH_LOAD = r"""
import json, sys
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from multimodalemotionrecognition_torch.runtime.export import load_exported
from multimodalemotionrecognition_torch.kernels import fused_conv_layer, wavlm_attention_sublayer
artifact, inputs, out, ckpt = sys.argv[1:5]
exported = load_exported(artifact)
data = np.load(inputs)
video, audio = data["video"], data["audio"]
probs, launches = {}, {}
for n in (1, 8, 11):
    wavlm_attention_sublayer.launches = fused_conv_layer.launches = 0
    probs[str(n)] = exported.predict_probs(video[:n], audio[:n])
    torch.cuda.synchronize()
    launches[str(n)] = [wavlm_attention_sublayer.launches, fused_conv_layer.launches]
np.savez(out, **probs)
heavy = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "multimodalemotionrecognition_tpu"))
# Latency in this short process beside a runner of the same checkpoint, as
# phase 12 reads it in the long one: from host arrays, and from inputs on the card.
from chip_smoke import _latency_pairs
from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
runner = TorchModelRunner(ckpt, device="cuda", quantize_int8=exported.meta["quantized_int8"])
staged = {n: (torch.from_numpy(video[:n]).cuda(), torch.from_numpy(audio[:n]).cuda()) for n in (1, 8)}
def on_card(fn, n):
    def call(v, a):
        with torch.inference_mode():
            return fn(*staged[n]).cpu()
    return call
latency = {f"b{n}": _latency_pairs({"runner": runner.predict_probs, "exported": exported.predict_probs},
                                   video, audio, n) for n in (1, 8)}
latency["on_card"] = {f"b{n}": _latency_pairs({"runner_on_card": on_card(runner.forward_module, n),
                                               "exported_on_card": on_card(exported._fns[n], n)},
                                              video, audio, n) for n in (1, 8)}
print(json.dumps({"launches": launches, "device": str(exported.device), "buckets": exported._buckets,
                  "heavy": heavy, "latency": latency}))
"""


def _trace_kernels(path: Path) -> list:
    """(name, device ms) of each kernel in a Chrome trace of `device_trace`."""
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e.get("dur", 0.0) / 1e3) for e in events if e.get("cat") == "kernel"]


def _latency_pairs(fns: dict, video, audio, n: int, pairs: int = 8) -> dict:
    """Median ms of one `predict_probs` of n clips per callable, CUDA events
    around each call; the callables take turns, in an order that reverses
    each pair."""
    samples = {name: [] for name in fns}
    for fn in fns.values():
        fn(video[:n], audio[:n])
    for i in range(pairs):
        for name in (list(fns) if i % 2 == 0 else reversed(list(fns))):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name](video[:n], audio[:n])
            end.record()
            torch.cuda.synchronize()
            samples[name].append(start.elapsed_time(end))
    return {name: float(np.median(ms)) for name, ms in samples.items()}


def export_phase(dev, card, ckpt, tmp):
    """Phase 12 -> (launches of the exported programs' forwards in the fresh
    processes, report)."""
    import subprocess

    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        wavlm_attention_sublayer,
    )
    from multimodalemotionrecognition_torch.runtime.export import kernel_nodes, load_exported
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
    from multimodalemotionrecognition_torch.utils.profiling import device_trace

    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 12)
    video = rng.randn(11, 8, 3, 112, 112).astype(np.float32)
    audio = (rng.randn(11, 1, 48000) * 0.1).astype(np.float32)
    inputs = tmp / "export_inputs.npz"
    np.savez(inputs, video=video, audio=audio)
    report = {"card": card}
    launches = {"wavlm_attention_sublayer": 0, "fused_conv_layer": 0}
    for label, flags in (("float32", []), ("int8", ["--int8"])):
        out = tmp / f"flagship_{label}"
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "multimodalemotionrecognition_torch", "export",
                        "--checkpoint", str(ckpt), "--output", str(out), "--batch-sizes", "1,8",
                        *flags], cwd=REPO, check=True)
        export_s = time.perf_counter() - t0
        artifact = Path(str(out) + ".npz")
        meta = json.loads(Path(str(artifact) + ".meta.json").read_text())
        exported = load_exported(artifact)
        nodes = {b: kernel_nodes(program) for b, program in exported.programs.items()}
        print(f"export {label}: {artifact.stat().st_size / 2**20:.1f} MiB in {export_s:.1f} s "
              f"(a process through the hub), meta {meta['format']} on {meta['device']}, "
              f"int8 {meta['quantized_int8']}; kernel operator nodes per bucket {nodes}")
        want_nodes = {"emo.wavlm_attention_sublayer": 12, "emo.fused_conv_layer": 6}
        if sorted(nodes) != [1, 8] or any(n != want_nodes for n in nodes.values()):
            raise AssertionError(f"export {label}: graph nodes {nodes}, expected {want_nodes}")

        # A fresh process that imports only the port loads and serves it.
        t0 = time.perf_counter()
        probs_path = tmp / f"export_probs_{label}.npz"
        proc = subprocess.run([sys.executable, "-c", _FRESH_LOAD, str(artifact), str(inputs),
                               str(probs_path), str(ckpt)], cwd=REPO, capture_output=True, text=True)
        if proc.returncode:
            raise AssertionError(f"export {label}: the fresh process failed:\n{proc.stderr[-4000:]}")
        fresh = json.loads(proc.stdout.strip().splitlines()[-1])
        fresh_s = time.perf_counter() - t0
        want_launches = {"1": [12, 6], "8": [12, 6], "11": [24, 12]}  # 11 = 8 + 3 padded to 8
        print(f"export {label}: fresh process {fresh_s:.1f} s on {fresh['device']}, buckets "
              f"{fresh['buckets']}, launches (K1, K3) per request {fresh['launches']}, expected "
              f"{want_launches}; modules of jax / the JAX package loaded: {fresh['heavy']}")
        if fresh["launches"] != want_launches or fresh["heavy"] or fresh["device"] != "cuda":
            raise AssertionError(f"export {label}: {fresh}")
        print(f"export {label}: latency ms in the fresh process (CUDA events, 8 alternating pairs, "
              f"median) {fresh['latency']} [{card}]")
        for n in (1, 8, 11):
            launches["wavlm_attention_sublayer"] += fresh["launches"][str(n)][0]
            launches["fused_conv_layer"] += fresh["launches"][str(n)][1]

        runner = TorchModelRunner(ckpt, device=dev, quantize_int8=bool(flags))
        errors = {}
        with np.load(probs_path) as got:
            for n in (1, 8, 11):
                want = runner.predict_probs(video[:n], audio[:n])
                if got[str(n)].shape != want.shape or not np.isfinite(got[str(n)]).all():
                    raise AssertionError(f"export {label} n={n}: {got[str(n)].shape}")
                errors[n] = float(np.abs(got[str(n)] - want).max())
        print(f"export {label}: max |exported - TorchModelRunner| by request size {errors} "
              f"(tol {EXPORT_TOL})")
        if not max(errors.values()) <= EXPORT_TOL:
            raise AssertionError(f"export {label}: {errors}")

        # Latency in this process: the runner and the exported program in
        # turns, from host arrays; then from inputs already on the card (the
        # graph's share), and both again with Python's cyclic collector
        # paused (a long process holds many objects).
        fns = {"runner": runner.predict_probs, "exported": exported.predict_probs}
        latency = {f"b{n}": _latency_pairs(fns, video, audio, n) for n in (1, 8)}
        print(f"export {label}: latency ms (CUDA events, 8 alternating pairs, median) "
              f"{latency} [{card}]")
        staged = {n: (torch.from_numpy(video[:n]).to(dev), torch.from_numpy(audio[:n]).to(dev))
                  for n in (1, 8)}

        def on_card(fn, n):
            def call(v, a):
                with torch.inference_mode():
                    return fn(*staged[n]).cpu()
            return call

        for paused in (False, True):
            if paused:
                gc.disable()
            try:
                split = {f"b{n}": _latency_pairs(
                    {"runner_on_card": on_card(runner.forward_module, n),
                     "exported_on_card": on_card(exported._fns[n], n)}, video, audio, n)
                    for n in (1, 8)}
            finally:
                gc.enable()
            print(f"export {label}: latency ms from inputs on the card"
                  f"{' with the cyclic collector paused' if paused else ''} {split} "
                  f"({len(gc.get_objects())} objects tracked) [{card}]")
            latency["on_card_gc_paused" if paused else "on_card"] = split
        report[label] = {"export_s": export_s, "fresh_s": fresh_s, "mib": artifact.stat().st_size
                         / 2**20, "nodes": nodes[8], "fresh_launches": fresh["launches"],
                         "max_abs_err": errors, "latency_ms": latency,
                         "latency_ms_fresh_process": fresh["latency"]}

        if label == "float32":
            # One b8 forward of each under `device_trace`: the exported
            # program's trace names K1's and K3's kernels; the device's busy
            # time beside the runner's (the tracer now and then records no
            # device event: up to three windows).
            want = ROUTE_KERNELS["K1"][torch.float32] + ROUTE_KERNELS["K3"][torch.float32]
            for name, fn in fns.items():
                for _ in range(3):
                    wavlm_attention_sublayer.launches = fused_conv_layer.launches = 0
                    with device_trace(str(tmp / "trace")) as trace:
                        fn(video[:8], audio[:8])
                    kernels = _trace_kernels(trace)
                    if kernels:
                        break
                names = {k for k, _ in kernels}
                seen = {w: any(w in k for k in names) for w in want}
                busy = sum(ms for _, ms in kernels)
                print(f"export trace of the {name}'s b8 forward: {trace.name} "
                      f"{trace.stat().st_size / 2**20:.1f} MiB, {len(kernels)} kernel launches "
                      f"busy {busy:.2f} ms, route kernels seen {seen}; launches K1 "
                      f"{wavlm_attention_sublayer.launches} K3 {fused_conv_layer.launches} [{card}]")
                if not all(seen.values()) or (wavlm_attention_sublayer.launches,
                                              fused_conv_layer.launches) != (12, 6):
                    raise AssertionError(f"export trace: {seen}, {sorted(names)[:20]}")
                report[f"trace_{name}"] = {"kernel_launches": len(kernels), "busy_ms": busy}
        del runner, exported
        torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"export: phase wall time {report['phase_s']:.1f} s [{card}]")
    return launches, report


# --------------------------------------------------------------------------- phase 13: BlazeFace

FACE_SCENES = 24  # held-out scenes, `tests/test_blazeface.py`'s bar


def _bbox_iou(a, b) -> float:
    """IoU of two (x, y, w, h) pixel boxes."""
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[0] + a[2], b[0] + b[2]), min(a[1] + a[3], b[1] + b[3])
    inter = max(0, x1 - x0) * max(0, y1 - y0)
    return inter / float(a[2] * a[3] + b[2] * b[3] - inter)


def blazeface_phase(dev, card, ckpt, tmp):
    """Phase 13 -> (launches of the flagship forward on the cropped clip, report)."""
    import os

    import cv2

    from multimodalemotionrecognition_torch.config import IMAGENET_MEAN, IMAGENET_STD
    from multimodalemotionrecognition_torch.data import face
    from multimodalemotionrecognition_torch.data.synthface import make_scene
    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        wavlm_attention_sublayer,
    )
    from multimodalemotionrecognition_torch.ops.image import uniform_frame_indices
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
    from multimodalemotionrecognition_torch.serving.preprocess import EmotionPreprocessService

    t_phase = time.perf_counter()
    report = {"card": card}
    rng = np.random.default_rng(4242)
    scenes = [make_scene(rng, p_face=1.0) for _ in range(FACE_SCENES)]
    boxes = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        detector = face.BlazeFaceDetector(face.BUNDLED_BLAZEFACE_WEIGHTS, device=device)
        detector.detect_face_bbox(scenes[0][0])  # warm-up (cuDNN's choice on the card)
        t0 = time.perf_counter()
        boxes[name] = [detector.detect_face_bbox(img) for img, _ in scenes]
        frame_ms = (time.perf_counter() - t0) * 1e3 / FACE_SCENES
        ious = [_bbox_iou(got, truth) for got, (_, truth) in zip(boxes[name], scenes) if got]
        found = len(ious) / FACE_SCENES
        report[name] = {"found": found, "mean_iou": float(np.mean(ious)), "frame_ms": frame_ms}
        print(f"blazeface {name}: found {found:.3f} of {FACE_SCENES} held-out faces, mean IoU "
              f"{np.mean(ious):.4f}; {frame_ms:.2f} ms per frame (resize, forward, decode, NMS) "
              f"[{card}]")
        if not (found >= 0.8 and np.mean(ious) >= 0.5):
            raise AssertionError(f"blazeface {name}: {report[name]}")
    apart = max((max(abs(a - b) for a, b in zip(x, y)) for x, y in zip(boxes["cpu"], boxes["cuda"])
                 if x and y), default=0)
    same_found = [bool(x) for x in boxes["cpu"]] == [bool(y) for y in boxes["cuda"]]
    report["card_vs_cpu_px"] = apart
    print(f"blazeface: card against CPU boxes at most {apart} px apart, the same faces found "
          f"{same_found}")
    if apart > 1 or not same_found:
        raise AssertionError(f"blazeface: card and CPU boxes differ: {boxes}")

    # The preprocessing service's face crop with EMO_FACE_DETECTOR=blazeface
    # on a cv2-written clip: the first held-out scene whose face the CPU
    # found at IoU >= 0.5, at 256 px, 16 frames.
    img, truth = next(scene for got, scene in zip(boxes["cpu"], scenes)
                      if got and _bbox_iou(got, scene[1]) >= 0.5)
    frames = [np.clip(cv2.resize(img, (256, 256), interpolation=cv2.INTER_LINEAR).astype(np.int16)
                      + rng.integers(-3, 4, (256, 256, 3)), 0, 255).astype(np.uint8)
              for _ in range(16)]
    path = tmp / "face_clip.mp4"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (256, 256))
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    saved = os.environ.get("EMO_FACE_DETECTOR")
    os.environ["EMO_FACE_DETECTOR"] = "blazeface"
    face.set_face_detector(None)
    face._detector_initialized = False
    try:
        service = EmotionPreprocessService()
        t0 = time.perf_counter()
        clip = service.load_video_frames(path)
        clip_ms = (time.perf_counter() - t0) * 1e3
        detector = face.get_face_detector()
    finally:
        if saved is None:
            os.environ.pop("EMO_FACE_DETECTOR", None)
        else:
            os.environ["EMO_FACE_DETECTOR"] = saved
        face.set_face_detector(None)
        face._detector_initialized = False
    cap = cv2.VideoCapture(str(path))
    decoded = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        decoded.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    sampled = [decoded[i] for i in uniform_frame_indices(len(decoded), 8)]
    bbox = detector.detect_face_bbox(sampled[0])
    if not isinstance(detector, face.BlazeFaceDetector) or bbox is None:
        raise AssertionError(f"blazeface clip: detector {type(detector).__name__}, bbox {bbox}")
    want = np.stack([cv2.resize(face.crop_with_padding(f, bbox, 0.3), (112, 112),
                                interpolation=cv2.INTER_LINEAR) for f in sampled])
    want = ((want.astype(np.float32) / 255.0 - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32)).transpose(0, 3, 1, 2)
    scale = 256 / 128
    iou = _bbox_iou(bbox, tuple(v * scale for v in truth))
    print(f"blazeface clip: {len(decoded)} frames decoded, the service's {clip.shape} crops in "
          f"{clip_ms:.1f} ms, box {bbox} on the first sampled frame (IoU {iou:.3f} with the "
          f"scene's face), crops equal to crop_with_padding on it: {np.array_equal(clip, want)}")
    if not np.array_equal(clip, want):
        raise AssertionError("blazeface clip: the service's crops differ from the detector's box")

    # The cropped clip through the flagship on the card.
    runner = TorchModelRunner(ckpt, device=dev, compute_dtype="float32")
    wav = (np.random.RandomState(SEED + 13).randn(1, 1, 48000) * 0.1).astype(np.float32)
    runner.predict_probs(clip[None], wav)
    wavlm_attention_sublayer.launches = fused_conv_layer.launches = 0
    probs = runner.predict_probs(clip[None], wav)
    torch.cuda.synchronize()
    launches = {"wavlm_attention_sublayer": wavlm_attention_sublayer.launches,
                "fused_conv_layer": fused_conv_layer.launches}
    print(f"blazeface clip through the flagship: probs {np.round(probs[0], 4).tolist()}, "
          f"launches {launches}")
    if launches != {"wavlm_attention_sublayer": 12, "fused_conv_layer": 6} or not (
            np.isfinite(probs).all() and abs(probs.sum() - 1.0) < 1e-4):
        raise AssertionError(f"blazeface clip: {launches}, {probs}")
    report.update(clip_ms=clip_ms, clip_iou=iou, phase_s=time.perf_counter() - t_phase)
    del runner
    torch.cuda.empty_cache()
    print(f"blazeface: phase wall time {report['phase_s']:.1f} s [{card}]")
    return launches, report


# --------------------------------------------------------------------------- phase 14: data parallel

# 2 ranks against 1 on the same global batch of 16 (8 a rank).  Losses: float32
# another sum order; bfloat16 the ranks' products round at other batch shapes.
# Gradients and BatchNorm statistics relative to each tensor's largest entry
# (floor 1e-6: a gradient that is zero in the math holds rounding noise), the
# gradients' bound being K2's (GRAD_TOL).
DP_WORLD = 2
DP_LOSS_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DP_STATS_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DP_PROBS_TOL = 1e-5  # abs, the dp runner against the single-card runner (float32)
DP_TIMED_STEPS = 3
# Two bounds are wider than K2's (`--dp-grad-spread` and PERF.md, PR 16): one
# rank's gradients repeat bit for bit (deterministic algorithms or not), but
# 2 ranks convolve 8 clips where 1 rank convolves 16, and the train-mode
# ResNet block 7 turns that other rounding into up to 5.8 % of a leaf's
# largest entry in float32 (0.4 % in the L2 norm), only part of it from the
# E[x^2] - E[x]^2 variance.  So in float32 the video tower's leaves
# (`video_model.`, listed when over GRAD_TOL) are held to DP_VIDEO_CAP,
# every other leaf to GRAD_TOL.  In bfloat16 the same rounding moves 50 of
# the 75 leaves past GRAD_TOL, each about as far as bfloat16 moves it from
# float32's gradient on one rank: each leaf is held to the larger of
# GRAD_TOL and DP_BF16_MOVE_FACTOR times that move, never above DP_BF16_CAP.
# A gradient left unreduced or halved misses these by 5x (float32).
DP_VIDEO_CAP = 0.1
DP_BF16_MOVE_FACTOR = 2.0
DP_BF16_CAP = 0.5


def _dp_counters():
    from multimodalemotionrecognition_torch.kernels import (
        fused_conv_layer,
        wavlm_attention_sublayer,
        wavlm_attention_sublayer_backward,
    )

    return {"wavlm_attention_sublayer": wavlm_attention_sublayer,
            "fused_conv_layer": fused_conv_layer,
            "wavlm_attention_sublayer_backward": wavlm_attention_sublayer_backward}


def _dp_trainer(dtype, device, world, tmp):
    from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig
    from multimodalemotionrecognition_torch.train import EmotionTrainer

    trainer = EmotionTrainer(
        ModelConfig(fusion="xattn", use_wavlm=True, compute_dtype=dtype),
        TrainConfig(two_stage_training=True, seed=SEED, output_dir=str(tmp),
                    mesh_shape=(world, 1)), device=device)
    return trainer, trainer.init_state()


def _dp_step(trainer, state, batch, grads_out: bool, timed: bool = True) -> dict:
    """The stage-2 step through `run_epoch` (the stage flip's optimizer
    reset), its launches counted from 0 and its LayerDrop draw recorded,
    then (`timed`) DP_TIMED_STEPS more on the same batch for the step time."""
    counters = _dp_counters()
    runs = _record_layers_run(state.model)
    mask, lrs = trainer.trainable_mask(2), trainer.lr_tree(2, {})
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    _, metrics = trainer.run_epoch(state, [batch], True, mask, lrs, reset_opt_first=True)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    trainable = {n for n, on in mask.items() if on}
    grads = {n: p.grad.detach().float().cpu() for n, p in state.model.named_parameters()
             if n in trainable and p.grad is not None}
    out = {
        "loss": metrics["loss"], "layers_run": runs[0], "launches": launches,
        "trainable_layers": sorted(i for i in range(12) if any(
            on for n, on in mask.items()
            if n.startswith(f"audio_model.wavlm.encoder.layers.{i}.attention.q_proj."))),
        "stats": {n: b.detach().float().cpu().numpy() for n, b in state.model.named_buffers()
                  if "running" in n},
        # Every rank's gradients are one all-reduce's result: rank 0 sends
        # them, the others a fingerprint of theirs.
        "grads": {n: g.numpy() for n, g in grads.items()} if grads_out else None,
        "grad_fingerprint": {n: (float(g.double().sum()), float(g.double().abs().sum()))
                             for n, g in grads.items()},
    }
    times = []
    for _ in range(DP_TIMED_STEPS if timed else 0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_epoch(state, [batch], True, mask, lrs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = times
    return out


def _dp_rank_batch(batch, rank, world):
    rows = slice(rank * TRAIN_BATCH // world, (rank + 1) * TRAIN_BATCH // world)
    return _Batch(batch.video[rows], batch.audio[rows], batch.labels[rows], batch.aug[rows])


def _deterministic(on: bool) -> None:
    """PyTorch's deterministic algorithms (cuDNN's included) on or off; an op
    without one warns.  cuBLAS needs CUBLAS_WORKSPACE_CONFIG set before its
    first call for this."""
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


class _TwoPassVariance:
    """Train-mode `EvalBatchNorm2d` with the variance taken as E[(x - mean)^2]
    (two passes, two all-reduces in a data-parallel step) in place of the
    port's E[x^2] - E[x]^2 (Flax's `use_fast_variance`), while the block is
    open: a diagnostic of where the ResNet's gradient spread comes from."""

    def __enter__(self):
        from multimodalemotionrecognition_torch.models.resnet import EvalBatchNorm2d
        from multimodalemotionrecognition_torch.parallel.distributed import current_shard

        self._cls, self._forward = EvalBatchNorm2d, EvalBatchNorm2d.forward
        original = self._forward

        def forward(bn, x, train=False):
            if not train:
                return original(bn, x, train)
            shape, xf, shard = (1, -1, 1, 1), x.float(), current_shard()
            count = torch.full_like(xf[0, :, 0, 0], xf.numel() // xf.shape[1])
            sums = shard.sum(torch.stack([xf.sum(dim=(0, 2, 3)), count]))
            mean = sums[0] / sums[1]
            centred = xf - mean.view(shape)
            var = shard.sum((centred * centred).sum(dim=(0, 2, 3))) / sums[1]
            with torch.no_grad():
                bn.running_mean.lerp_(mean.to(bn.running_mean.dtype), bn.momentum)
                bn.running_var.lerp_(var.to(bn.running_var.dtype), bn.momentum)
                bn.num_batches_tracked += 1
            mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
            return (centred * mul.view(shape) + bn.bias.float().view(shape)).to(x.dtype)

        EvalBatchNorm2d.forward = forward
        return self

    def __exit__(self, *exc):
        self._cls.forward = self._forward


def _dp_rank(rank, world, device, tmp, deterministic=False, timed=True, two_pass=False):
    """One rank of phase 14 (a): the flagship stage-2 step on its 8 rows, in
    float32 and bfloat16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _deterministic(deterministic)
    batch = _dp_rank_batch(_train_batches(1, SEED + 14)[0], rank, world)
    out = {}
    with _TwoPassVariance() if two_pass else contextlib.nullcontext():
        for dtype in ("float32", "bfloat16"):
            trainer, state = _dp_trainer(dtype, device, world, tmp)
            out[dtype] = _dp_step(trainer, state, batch, grads_out=rank == 0, timed=timed)
            del trainer, state
            torch.cuda.empty_cache()
    return out


def _grad_scale_leaf(name: str) -> str:
    """The leaf whose largest gradient entry scales `name`'s bound: itself,
    but for an attention key projection's bias, whose gradient is zero in
    exact arithmetic (a bias common to every key leaves the softmax as it
    is) and so holds rounding noise alone: there its layer's key weight."""
    if name.endswith("attention.k_proj.bias"):
        return name[:-len("bias")] + "weight"
    return name


def _rel_err(got, want) -> float:
    """max |got - want| as a share of want's largest entry."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def data_parallel(dev, card, tmp):
    """Phase 14 -> (launch counts of its main paths, report)."""
    from multimodalemotionrecognition_torch.entry import dryrun_multichip
    from multimodalemotionrecognition_torch.kernels import fused_block
    from multimodalemotionrecognition_torch.parallel import launch, make_mesh
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= DP_WORLD:
        backend, devices = "nccl", [torch.device("cuda", i) for i in range(DP_WORLD)]
    else:  # one card (or a rehearsal on the CPU): every rank on it
        backend, devices = "gloo", [dev] * DP_WORLD
    print(f"data parallel: {cards} card(s): {DP_WORLD} ranks over {backend} on "
          f"{[str(d) for d in devices]} [{card}]")
    report = {"cards": cards, "backend": backend, "devices": [str(d) for d in devices]}
    launches = {}

    # (a) The flagship's stage-2 step: one rank on the global batch here, then
    # DP_WORLD ranks on its rows.
    batch = _train_batches(1, SEED + 14)[0]
    one = {}
    for dtype in ("float32", "bfloat16"):
        trainer, state = _dp_trainer(dtype, dev, 1, tmp)
        one[dtype] = _dp_step(trainer, state, batch, grads_out=True)
        del trainer, state
        torch.cuda.empty_cache()
    # How far bfloat16 moves each gradient of one rank from float32's.
    bf16_move = _grad_errors(one["bfloat16"]["grads"], one["float32"]["grads"])
    bounds = {
        "float32": {n: DP_VIDEO_CAP if n.startswith("video_model.") else GRAD_TOL[torch.float32]
                    for n in bf16_move},
        "bfloat16": {n: min(DP_BF16_CAP, max(GRAD_TOL[torch.bfloat16], DP_BF16_MOVE_FACTOR * m))
                     for n, m in bf16_move.items()},
    }
    t0 = time.perf_counter()
    ranks = launch(_dp_rank, DP_WORLD, backend, devices, args=(str(tmp),), timeout_s=600)
    report["ranks_s"] = time.perf_counter() - t0
    for dtype in ("float32", "bfloat16"):
        want = one[dtype]
        tol = GRAD_TOL[getattr(torch, dtype)]
        grad_err = {n: float(np.abs(ranks[0][dtype]["grads"][n] - g).max()
                             / max(np.abs(want["grads"][_grad_scale_leaf(n)]).max(), 1e-6 / tol))
                    for n, g in want["grads"].items()}
        stats_err = [max(_rel_err(r[dtype]["stats"][n], s) for n, s in want["stats"].items())
                     for r in ranks]
        loss_err = [abs(r[dtype]["loss"] - want["loss"]) for r in ranks]
        worst = max(grad_err, key=grad_err.get)
        for r, got in enumerate(ranks):
            got = got[dtype]
            ran, trainable = got["layers_run"], set(got["trainable_layers"])
            expect = {"wavlm_attention_sublayer": len(ran), "fused_conv_layer": 6,
                      "wavlm_attention_sublayer_backward": len(trainable & set(ran))}
            print(f"data parallel {dtype} rank {r}: loss {got['loss']:.6f} (1 rank "
                  f"{want['loss']:.6f}, |diff| {loss_err[r]:.2e}, tol {DP_LOSS_TOL[dtype]}), layers "
                  f"run {ran} (1 rank {want['layers_run']}), launches {got['launches']}, BatchNorm "
                  f"statistics within {stats_err[r]:.2e} of each largest entry "
                  f"(tol {DP_STATS_TOL[dtype]})")
            if ran != want["layers_run"] or ran[0] != 0 or got["launches"] != expect:
                raise AssertionError(f"data parallel {dtype} rank {r}: layers run {ran}, launches "
                                     f"{got['launches']}, expected {expect} and 1 rank's "
                                     f"{want['layers_run']}")
            if not (loss_err[r] <= DP_LOSS_TOL[dtype] and stats_err[r] <= DP_STATS_TOL[dtype]):
                raise AssertionError(f"data parallel {dtype} rank {r}: the loss or the BatchNorm "
                                     "statistics disagree with one rank")
            if got["grad_fingerprint"] != ranks[0][dtype]["grad_fingerprint"]:
                raise AssertionError(f"data parallel {dtype}: rank {r}'s gradients differ from rank 0's")
            for name, count in got["launches"].items():
                launches[name] = launches.get(name, 0) + count
        print(f"data parallel {dtype}: {len(grad_err)} trainable gradients before the optimizer "
              f"within {grad_err[worst]:.2e} of each largest entry (worst {worst}; tol {tol}); "
              f"step ms, 1 rank on {TRAIN_BATCH} clips {np.median(want['step_ms']):.1f}, {DP_WORLD} "
              f"ranks on {TRAIN_BATCH // DP_WORLD} each {[round(float(np.median(r[dtype]['step_ms'])), 1) for r in ranks]} "
              f"({backend}) [{card}]")
        bound = bounds[dtype]
        over = {n: (e, bound[n]) for n, e in grad_err.items() if e > bound[n]}
        wider = {n: (round(e, 6), round(bound[n], 6)) for n, e in grad_err.items() if e > tol}
        print(f"data parallel {dtype}: {len(wider)} of {len(grad_err)} leaves over {tol}, held to "
              f"their own bound (error, bound): {wider}")
        if set(grad_err) != set(ranks[0][dtype]["grads"]) or over:
            raise AssertionError(f"data parallel {dtype}: gradients differ from one rank's "
                                 f"(relative error, bound): {over}")
        report[dtype] = {
            "loss_1_rank": want["loss"], "loss_ranks": [r[dtype]["loss"] for r in ranks],
            "layers_run": want["layers_run"], "launches_per_rank": [r[dtype]["launches"] for r in ranks],
            "grad_max_rel_err": grad_err[worst], "grad_worst": worst,
            "grad_rel_err": grad_err, "grad_bound": bound,
            "stats_max_rel_err": max(stats_err),
            "step_ms_1_rank": float(np.median(want["step_ms"])),
            "step_ms_ranks": [float(np.median(r[dtype]["step_ms"])) for r in ranks],
        }
    report["bf16_move"] = bf16_move
    del one, ranks

    # (b) The serving runner on a dp mesh against one card, float32.
    ckpt = Path(tmp) / "flagship.pt"
    _, video, audio = make_checkpoint(ckpt)
    counters = {**_dp_counters(), "fused_block": fused_block}
    mesh = make_mesh((DP_WORLD, 1), devices=devices)
    report["runner"] = {}
    for label, options in (("kernels", {}), ("fused", {"fused": True})):
        single = TorchModelRunner(ckpt, device=dev, device_normalize=True, **options)
        dp = TorchModelRunner(ckpt, device=dev, device_normalize=True, mesh=mesh, **options)
        for n in (8, 1):
            want = single.predict_probs(video[:n], audio[:n])
            dp.predict_probs(video[:n], audio[:n])  # warm: cuDNN's choice for the bucket
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            got = dp.predict_probs(video[:n], audio[:n])
            counted = {name: fn.launches for name, fn in counters.items()}
            per_replica = {"wavlm_attention_sublayer": 12, "fused_conv_layer": 6,
                           "wavlm_attention_sublayer_backward": 0,
                           "fused_block": 1 if options else 0}
            expect = {name: DP_WORLD * k for name, k in per_replica.items()}
            err = float(np.abs(got - want).max())
            print(f"data parallel runner {label} n={n} (bucket {dp.batch_buckets[0] if n == 1 else n}): "
                  f"{DP_WORLD} replicas against one card within {err:.2e} (tol {DP_PROBS_TOL}), "
                  f"launches {counted}")
            if got.shape != (n, 8) or not err <= DP_PROBS_TOL or counted != expect:
                raise AssertionError(f"data parallel runner {label} n={n}: error {err}, launches "
                                     f"{counted}, expected {expect}")
            for name, count in counted.items():
                launches[name] = launches.get(name, 0) + count
            report["runner"][f"{label}_n{n}"] = {"max_abs_err": err, "launches": counted}
        del single, dp
        torch.cuda.empty_cache()

    # (c) The dry run: its own ranks.
    t0 = time.perf_counter()
    report["dryrun"] = dryrun_multichip(DP_WORLD, device=dev)
    report["dryrun"]["seconds"] = time.perf_counter() - t0
    report["seconds"] = time.perf_counter() - t_phase
    print(f"data parallel: phase 14 in {report['seconds']:.1f} s (the ranks {report['ranks_s']:.1f} s, "
          f"the dry run {report['dryrun']['seconds']:.1f} s) [{card}]")
    return launches, report


# --------------------------------------------------------------------------- phase 15: tensor parallel

# The tensor-parallel runner against one device's: float32 and int8 the same
# modules with the row-parallel sums in another order; bfloat16 rounds the
# partial products before their sum.  Against the kernels runner, the
# kernel-vs-plain bounds (PROBS_TOL).
TP_PROBS_TOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 1e-5}
TP_TIMED_STEPS = 3


def _tp_runner_counters():
    from multimodalemotionrecognition_torch.kernels import fused_block

    return {**_dp_counters(), "fused_block": fused_block}


def _tp_bytes(model) -> dict:
    """Parameter and buffer bytes of a tensor-parallel model: each piece
    index's own, the replicated rest (on the row's first device) and the
    whole."""
    pieces, replicated = {}, 0
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        found = re.search(r"\.shards\.(\d+)\.", name)
        if found:
            pieces[int(found[1])] = pieces.get(int(found[1]), 0) + t.numel() * t.element_size()
        else:
            replicated += t.numel() * t.element_size()
    return {"replicated": replicated, "pieces": pieces}


def _tp_trainer(dtype, dev, tp, tmp):
    from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig
    from multimodalemotionrecognition_torch.train import EmotionTrainer

    trainer = EmotionTrainer(
        ModelConfig(fusion="xattn", use_wavlm=True, compute_dtype=dtype,
                    wavlm_geometry={"fused_attention": False}),
        TrainConfig(two_stage_training=True, seed=SEED, output_dir=str(tmp), mesh_shape=(1, tp)),
        device=[dev] * tp)
    return trainer, trainer.init_state()


def tensor_parallel(dev, card, tmp):
    """Phase 15 -> (launch counts of its main paths, report)."""
    from multimodalemotionrecognition_torch.entry import dryrun_multichip
    from multimodalemotionrecognition_torch.parallel import gather_params, make_mesh
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

    t_phase = time.perf_counter()
    report = {"runner": {}, "train": {}}
    launches = {}
    counters = _tp_runner_counters()

    # (a) The runners: one replica over (cuda:0, cuda:0), and two over a (2, 2) mesh.
    ckpt = Path(tmp) / "flagship.pt"
    _, video, audio = make_checkpoint(ckpt)
    for label, options in (("float32", {}), ("bfloat16", {"compute_dtype": "bfloat16"}),
                           ("int8", {"quantize_int8": True})):
        dtype = options.get("compute_dtype", "float32")
        plain = TorchModelRunner(ckpt, device=dev, device_normalize=True, fused_wavlm=False, **options)
        kernels = TorchModelRunner(ckpt, device=dev, device_normalize=True, **options)
        tps = {shape: TorchModelRunner(ckpt, device=dev, device_normalize=True,
                                       mesh=make_mesh(shape, [dev] * (shape[0] * shape[1])), **options)
               for shape in ((1, 2), (2, 2))}
        requests = {(1, 2): (1, 3, 8, "blank"), (2, 2): (8,)}
        for shape, runner in tps.items():
            for n in requests[shape]:  # warm: cuDNN's choice for each bucket
                (runner.predict_probs_blank_video(audio[:3]) if n == "blank"
                 else runner.predict_probs(video[:n], audio[:n]))
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            got, forwards = {}, 0
            for n in requests[shape]:
                got[n] = (runner.predict_probs_blank_video(audio[:3]) if n == "blank"
                          else runner.predict_probs(video[:n], audio[:n]))
                forwards += len(runner.replicas)
            torch.cuda.synchronize()
            counted = {name: fn.launches for name, fn in counters.items()}
            expect = {"wavlm_attention_sublayer": 0, "fused_conv_layer": 6 * forwards,
                      "wavlm_attention_sublayer_backward": 0, "fused_block": 0}
            for name, count in counted.items():
                launches[name] = launches.get(name, 0) + count
            errs = {}
            for n, probs in got.items():
                rows = 3 if n == "blank" else n
                want_plain = (plain.predict_probs_blank_video(audio[:3]) if n == "blank"
                              else plain.predict_probs(video[:n], audio[:n]))
                want_kernels = (kernels.predict_probs_blank_video(audio[:3]) if n == "blank"
                                else kernels.predict_probs(video[:n], audio[:n]))
                if probs.shape != (rows, 8) or not np.isfinite(probs).all():
                    raise AssertionError(f"tensor parallel {label} {shape} n={n}: output {probs.shape}")
                errs[n] = (float(np.abs(probs - want_plain).max()),
                           float(np.abs(probs - want_kernels).max()))
            worst_plain = max(e[0] for e in errs.values())
            worst_kernels = max(e[1] for e in errs.values())
            print(f"tensor parallel runner {label} mesh {shape} (buckets {runner.batch_buckets}): "
                  f"requests {list(got)} against the modular single-card runner within "
                  f"{worst_plain:.3e} (tol {TP_PROBS_TOL[label]}), against the kernels runner within "
                  f"{worst_kernels:.3e} (tol {PROBS_TOL[dtype]}); launches {counted} over "
                  f"{forwards} replica forwards [{card}]")
            if counted != expect or worst_plain > TP_PROBS_TOL[label] or worst_kernels > PROBS_TOL[dtype]:
                raise AssertionError(f"tensor parallel runner {label} {shape}: errors {errs}, "
                                     f"launches {counted}, expected {expect}")
            report["runner"][f"{label}_{shape[0]}x{shape[1]}"] = {
                "max_abs_err_plain": worst_plain, "max_abs_err_kernels": worst_kernels,
                "launches": counted, "forwards": forwards}
        size = _tp_bytes(tps[1, 2].forward_module.model)
        whole = sum(t.numel() * t.element_size() for t in itertools.chain(
            kernels.model.parameters(), kernels.model.buffers()))
        report["runner"][f"{label}_bytes"] = {**size, "unsharded": whole}
        print(f"tensor parallel runner {label}: parameter and buffer bytes, piece 0 "
              f"{size['pieces'][0] / 2**20:.1f} MiB + replicated {size['replicated'] / 2**20:.1f} "
              f"MiB on the row's first device, piece 1 {size['pieces'][1] / 2**20:.1f} MiB; the "
              f"unsharded model {whole / 2**20:.1f} MiB")
        del plain, kernels, tps
        torch.cuda.empty_cache()

    # (b) The flagship's stage-2 step, tp 2 in this process against tp 1, both
    # with the modular attention (K1 and K2 need a layer's every head).
    batch = _train_batches(1, SEED + 15)[0]
    steps = {}
    for dtype in ("float32", "bfloat16"):
        for tp in (1, 2):
            trainer, state = _tp_trainer(dtype, dev, tp, tmp)
            step = _dp_step(trainer, state, batch, grads_out=True, timed=False)
            times = []
            mask, lrs = trainer.trainable_mask(2), trainer.lr_tree(2, {})
            for _ in range(TP_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.run_epoch(state, [batch], True, mask, lrs)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            step["step_ms"] = times
            step["grads"] = {n: g.numpy() for n, g in gather_params(
                {n: torch.from_numpy(g) for n, g in step["grads"].items()}).items()}
            if dtype == "float32" and tp == 2:
                # A resume file written under tp 2, read under tp 1.
                resume = Path(tmp) / "tp_resume"
                trainer.save_resume_state(resume, state, epoch=2, best_f1=0.0)
                saved = torch.load(resume / "resume.pt", map_location="cpu", weights_only=False)
                reader, _ = _tp_trainer(dtype, dev, 1, tmp)
                restored, *_ = reader.restore_resume_state(resume)
                same = all(torch.equal(restored.model.state_dict()[k].cpu(), v)
                           for k, v in saved["model"].items())
                same &= all(torch.equal(getattr(restored.opt_state, key)[k].cpu(), v)
                            for key in ("mu", "nu") for k, v in saved["opt_state"][key].items())
                same &= not any(".shards." in k for k in saved["model"])
                print(f"tensor parallel: a resume file written under tp 2 ({len(saved['model'])} "
                      f"tensors, {len(saved['opt_state']['mu'])} moments) read under tp 1 bit for "
                      f"bit: {same}")
                if not same:
                    raise AssertionError("tensor parallel: the resume file read under tp 1 differs")
                report["train"]["resume_tp2_to_tp1_exact"] = same
                del reader, restored
            steps[dtype, tp] = step
            del trainer, state
            torch.cuda.empty_cache()
    bf16_move = _grad_errors(steps["bfloat16", 1]["grads"], steps["float32", 1]["grads"])
    for dtype in ("float32", "bfloat16"):
        one, two = steps[dtype, 1], steps[dtype, 2]
        tol = GRAD_TOL[getattr(torch, dtype)]
        bound = ({n: DP_VIDEO_CAP if n.startswith("video_model.") else tol for n in bf16_move}
                 if dtype == "float32" else
                 {n: min(DP_BF16_CAP, max(tol, DP_BF16_MOVE_FACTOR * m)) for n, m in bf16_move.items()})
        grad_err = _grad_errors(two["grads"], one["grads"])
        worst = max(grad_err, key=grad_err.get)
        over = {n: (e, bound[n]) for n, e in grad_err.items() if e > bound[n]}
        loss_err = abs(two["loss"] - one["loss"])
        ran = one["layers_run"]
        expect = {"wavlm_attention_sublayer": 0, "fused_conv_layer": 6,
                  "wavlm_attention_sublayer_backward": 0}
        print(f"tensor parallel train {dtype}: loss tp 2 {two['loss']:.6f}, tp 1 {one['loss']:.6f} "
              f"(|diff| {loss_err:.2e}, tol {DP_LOSS_TOL[dtype]}); layers run {two['layers_run']} "
              f"(tp 1 {ran}); launches tp 2 {two['launches']}, tp 1 {one['launches']}; "
              f"{len(grad_err)} trainable gradients within {grad_err[worst]:.2e} of each largest "
              f"entry (worst {worst}; tol {tol}, the video tower {DP_VIDEO_CAP} in float32); step ms "
              f"tp 1 {np.median(one['step_ms']):.1f}, tp 2 {np.median(two['step_ms']):.1f} "
              f"(both pieces on one card) [{card}]")
        if (two["layers_run"] != ran or two["launches"] != expect or one["launches"] != expect
                or loss_err > DP_LOSS_TOL[dtype] or over or set(grad_err) != set(one["grads"])
                or set(two["grads"]) != set(one["grads"])):
            raise AssertionError(f"tensor parallel train {dtype}: layers {two['layers_run']} / {ran}, "
                                 f"launches {two['launches']}, loss error {loss_err}, over {over}")
        for name, count in two["launches"].items():
            launches[name] = launches.get(name, 0) + count
        report["train"][dtype] = {
            "loss_tp1": one["loss"], "loss_tp2": two["loss"], "layers_run": ran,
            "launches_tp2": two["launches"], "grad_max_rel_err": grad_err[worst], "grad_worst": worst,
            "grad_rel_err": grad_err, "step_ms_tp1": float(np.median(one["step_ms"])),
            "step_ms_tp2": float(np.median(two["step_ms"]))}
    del steps

    # (c) The dry run on four devices: tp 2, dp 2.
    t0 = time.perf_counter()
    report["dryrun"] = dryrun_multichip(4, device=dev)
    report["dryrun"]["seconds"] = time.perf_counter() - t0
    report["seconds"] = time.perf_counter() - t_phase
    print(f"tensor parallel: phase 15 in {report['seconds']:.1f} s (the dry run "
          f"{report['dryrun']['seconds']:.1f} s) [{card}]")
    return launches, report


def _grad_errors(got: dict, want: dict) -> dict:
    """Each leaf's max |got - want| as a share of its scale leaf's largest
    entry in `want`."""
    return {n: float(np.abs(got[n] - g).max()
                     / max(np.abs(want[_grad_scale_leaf(n)]).max(), 1e-12))
            for n, g in want.items()}


def _grad_l2_errors(got: dict, want: dict) -> dict:
    """Each leaf's |got - want|_2 / |want|_2."""
    return {n: float(np.linalg.norm(got[n] - g) / max(np.linalg.norm(g), 1e-30))
            for n, g in want.items()}


def _grad_error_summary(errors: dict) -> dict:
    """-> the worst error overall and per family, and every leaf's."""
    families = {"resnet": "video_model.", "audio": "audio_model."}
    out = {"max": max(errors.values()), "leaves": errors}
    for family, prefix in families.items():
        out[family] = max((e for n, e in errors.items() if n.startswith(prefix)), default=0.0)
    out["fusion"] = max((e for n, e in errors.items()
                         if not n.startswith(tuple(families.values()))), default=0.0)
    return out


def dp_grad_spread() -> int:
    """`python chip_smoke.py --dp-grad-spread`: where phase 14's spread of the
    flagship's stage-2 gradients between 2 ranks and 1 rank comes from.  For
    float32 and bfloat16: one rank run twice on identical input, with the
    default algorithms and with PyTorch's deterministic ones; 2 ranks against
    1 rank with each; and 2 ranks against 1 rank with the train-mode
    BatchNorm variance taken in two passes (`_TwoPassVariance`).  Writes
    chiprun_out/dp_grad_spread.json."""
    import os
    import warnings

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before cuBLAS starts
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from multimodalemotionrecognition_torch.parallel import launch
    from multimodalemotionrecognition_torch.utils.device import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line(dev)
    print(card)
    batch = _train_batches(1, SEED + 14)[0]
    report = {"card": card, "cards": torch.cuda.device_count()}
    modes = ("default", "deterministic", "two_pass")
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for mode in modes:
            _deterministic(mode == "deterministic")
            with warnings.catch_warnings(record=True) as caught, \
                    _TwoPassVariance() if mode == "two_pass" else contextlib.nullcontext():
                warnings.simplefilter("always")
                for dtype in ("float32", "bfloat16"):
                    for k in range(2):
                        trainer, state = _dp_trainer(dtype, dev, 1, tmp)
                        runs[mode, dtype, k] = _dp_step(trainer, state, batch, True, timed=False)
                        del trainer, state
                        torch.cuda.empty_cache()
            report[f"nondeterministic_ops_{mode}"] = sorted(
                {str(w.message).split(".")[0] for w in caught if "deterministic" in str(w.message)})
        _deterministic(False)
        backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
        devices = ([torch.device("cuda", i) for i in range(2)] if backend == "nccl" else [dev] * 2)
        ranks = {mode: launch(_dp_rank, 2, backend, devices, timeout_s=600, args=(
            str(tmp), mode == "deterministic", False, mode == "two_pass")) for mode in modes}
    for mode in modes:
        for dtype in ("float32", "bfloat16"):
            a, b, r = runs[mode, dtype, 0], runs[mode, dtype, 1], ranks[mode][0][dtype]
            key = f"{dtype}_{mode}"
            report[key] = {
                "rerun_one_rank": _grad_error_summary(_grad_errors(b["grads"], a["grads"])),
                "two_ranks_vs_one": _grad_error_summary(_grad_errors(r["grads"], a["grads"])),
                "two_ranks_vs_one_l2": _grad_error_summary(_grad_l2_errors(r["grads"], a["grads"])),
                "layers_run": [a["layers_run"], b["layers_run"], r["layers_run"]],
                "loss": [a["loss"], b["loss"], r["loss"]],
                "stats_rerun": max(_rel_err(b["stats"][n], s) for n, s in a["stats"].items()),
                "stats_two_ranks": max(_rel_err(r["stats"][n], s) for n, s in a["stats"].items()),
            }
            if dtype == "bfloat16":  # how far bf16 moves each gradient from float32's, one rank
                f32 = runs[mode, "float32", 0]["grads"]
                report[key]["bf16_vs_f32_one_rank"] = _grad_error_summary(_grad_errors(a["grads"], f32))
            summary = {k: (v["max"], v["resnet"], v["audio"], v["fusion"])
                       for k, v in report[key].items() if isinstance(v, dict)}
            print(f"dp grad spread {key}: (max, resnet, audio, fusion) {summary}, losses "
                  f"{report[key]['loss']} [{card}]")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "dp_grad_spread.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items() if not isinstance(v, dict)}))
    return 0


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from multimodalemotionrecognition_torch.kernels.build import BUILD_DIR, load_library
    from multimodalemotionrecognition_torch.utils.device import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line(dev)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {Path(lib._name).relative_to(REPO)}")
    spills, function = {}, None
    for log in BUILD_DIR.glob("*.log"):
        for line in log.read_text().splitlines():
            if "Function properties for" in line:
                function = line.split("Function properties for")[-1].strip()
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if found and function:
                spills[function] = int(found[1]) + int(found[2])
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas", line.split("info    :")[-1].strip())
    tensor_core = {f: n for f, n in spills.items()
                   if any(k in f for k in ("conv_fe_wgmma", "attn_core_mma", "out_proj_mma",
                                           "bwd_proj_mma", "bwd_attn_mma", "conv_fe_tf32",
                                           "attn_core_tf32", "out_proj_tf32", "bwd_proj_tf32",
                                           "bwd_query_tf32", "bwd_key_tf32", "fb_rows_tc",
                                           "fb_video_tc", "fb_audio_tc", "fb_head_tc",
                                           "tc_product", "xa_rows_tc", "xa_video_tc",
                                           "xa_audio_tc", "tiled_core_mma", "tiled_proj_mma",
                                           "tiled_core_tf32", "tiled_proj_tf32"))}
    print(f"build: spill bytes of the tensor-core kernels {tensor_core}")
    # 7 bf16 instances, 10 float32 (3xTF32) ones, K4's 6 (3xTF32: the rows
    # kernel once per tower dtype, three more kernels, their product routine);
    # K5's 4 (three kernels and its copy of the product routine), K6's 6 (the
    # core for 64 and 160 keys and the out-projection, per dtype).
    if len(tensor_core) < 33 or any(tensor_core.values()):
        raise AssertionError(f"tensor-core kernels missing from the build log or spilling: {tensor_core}")
    media_report = media_loader(card)

    gen = torch.Generator().manual_seed(SEED)
    k1 = check_k1(dev, gen)
    k3 = check_k3(dev, gen)
    k4 = check_k4(dev, gen)
    t5 = time.perf_counter()
    k5 = check_k5(dev, gen)
    t6 = time.perf_counter()
    k6 = check_k6(dev)
    k5["phase_seconds"], k6_seconds = t6 - t5, time.perf_counter() - t6
    print(f"K5 phase {k5['phase_seconds']:.1f} s, K6 phase {k6_seconds:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "flagship.pt"
        cfg, video, audio = make_checkpoint(ckpt)
        launches, runners = serve(dev, card, ckpt, cfg, video, audio)
        modular = {dtype: runners[f"{dtype}_kernels"] for dtype in ("bfloat16", "float32")}
        launches["fused_block"], fused_runners = serve_fused(
            dev, card, ckpt, cfg, video, audio, modular)
        stack_launches, stack_report = serve_stack_batcher(dev, card, ckpt, tmp)
        stack_report["http"] = serve_stack_http(dev, card, ckpt)
    runners.update(fused_runners)
    launches["fused_bidirectional_xattn"], k4["against_modules"] = block_entries(
        dev, modular, video, audio)
    perf = time_runners(runners, video, audio, card, rounds=2)
    del runners, fused_runners, modular
    torch.cuda.empty_cache()
    launches["wavlm_attention_sublayer_tiled"], bench_report = bench_entries(dev, gen)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        family_launches, family_perf = serve_families(dev, card, tmp, video, audio)
    k1_train, k2 = check_train_kernels(dev, gen)
    k3_train = check_k3(dev, gen, TRAIN_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, train_report = train(dev, card, tmp)
        train_report["families"] = train_families(dev, card, tmp)
        rest_launches, train_report["rest"] = train_rest(dev, card, tmp)
    cli_launches, train_report["data_cli"] = data_cli(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "flagship.pt"
        make_checkpoint(ckpt)
        export_launches, export_report = export_phase(dev, card, ckpt, Path(tmp))
        face_launches, face_report = blazeface_phase(dev, card, ckpt, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        dp_launches, dp_report = data_parallel(dev, card, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        tp_launches, tp_report = tensor_parallel(dev, card, Path(tmp))

    csrc = "multimodalemotionrecognition_torch/kernels/csrc/"
    ops = "multimodalemotionrecognition_tpu/ops/"
    kernels = []
    for name, source, replaces, rep in (
        ("wavlm_attention_sublayer", "wavlm_attn.cu", ops + "pallas_wavlm_attn.py:83",
         k1["bfloat16"]),
        ("fused_conv_layer", "conv_fe_tc.cu", ops + "pallas_conv_fe.py:46", k3["bfloat16"]),
        # One kernel with a samples-per-block parameter for both TPU kernels
        # (_block_kernel :436, _block_kernel_batched :506).
        ("fused_block", "fused_block.cu", ops + "pallas_fused_block.py:436", k4),
        ("fused_bidirectional_xattn", "xattn.cu", ops + "pallas_xattn.py:102", k5),
        ("wavlm_attention_sublayer_backward", "wavlm_attn_bwd.cu",
         ops + "pallas_wavlm_attn.py:191", k2["bfloat16_dropout"]),
        # The experiment's own shape: B=128 in bfloat16, the best tile's time.
        ("wavlm_attention_sublayer_tiled", "wavlm_attn_tiled.cu",
         "benchmarks/bench_attn_tile.py:40", k6["bfloat16", 128]),
    ):
        launches.setdefault(name, train_launches.get(name, 0))
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda", "source": csrc + source,
                        "replaces": replaces, "launches": launches[name], **rep})
    # The rows above are bfloat16; float32 beside them (K1, K3 and K2 on the
    # tensor cores in 3xTF32; K2's variants, both dtypes, under "variants").
    kernels[0]["float32"], kernels[1]["float32"] = k1["float32"], k3["float32"]
    kernels[4]["float32"] = k2["float32_dropout"]
    kernels[0]["sources"] = [csrc + "wavlm_attn.cu", csrc + "wavlm_attn_tc.cuh",
                             csrc + "wavlm_attn_tf32.cuh", csrc + "hopper.cuh"]
    kernels[4]["sources"] = [csrc + "wavlm_attn_bwd.cu", csrc + "wavlm_attn_bwd_tc.cuh",
                             csrc + "wavlm_attn_bwd_tf32.cuh", csrc + "hopper.cuh"]
    kernels[1]["sources"] = [csrc + "conv_fe_tc.cu", csrc + "conv_fe_tf32.cu", csrc + "hopper.cuh",
                             csrc + "conv_fe.cu"]
    kernels[2]["sources"] = [csrc + "fused_block.cu", csrc + "fused_block_tc.cuh",
                             csrc + "tc_product.cuh", csrc + "fusion.cuh", csrc + "hopper.cuh"]
    kernels[3]["sources"] = [csrc + "xattn.cu", csrc + "xattn_tc.cuh", csrc + "tc_product.cuh",
                             csrc + "fusion.cuh", csrc + "hopper.cuh"]
    kernels[5]["sources"] = [csrc + "wavlm_attn_tiled.cu", csrc + "wavlm_attn_tiled_tc.cuh",
                             csrc + "wavlm_attn_tiled_tf32.cuh", csrc + "wavlm_sublayer.cuh",
                             csrc + "hopper.cuh"]
    # K6's float32 route (3xTF32) beside the bfloat16 row, at the experiment's batch.
    kernels[5]["float32"] = k6["float32", 128]
    kernels[5]["phase_seconds"] = k6_seconds
    # K1's device time per launch by dtype, at each batch it was held at.
    kernels[0]["split_ms"] = {
        name: {"b8": k1[name]["split_ms"], **{
            key: rep["wavlm_attention_sublayer"][name]["split_ms"]
            for key, rep in bench_report["kernels_at_bench_shapes"].items()}}
        for name in ("bfloat16", "float32")}
    kernels[2]["also_replaces"] = ops + "pallas_fused_block.py:506"
    # `launches` of K1 and K3 is the serving path's count; the training path's beside it.
    for entry in kernels[:2]:
        entry["launches_train"] = train_launches[entry["name"]]
        if entry["launches_train"] < 1:
            raise AssertionError(f"{entry['name']} was not launched on the training path")
    # ... and the rest of the trainer's (phase 10: grad_accum=2, the alignment loss).
    for entry in (kernels[0], kernels[1], kernels[4]):
        entry["launches_train_rest"] = rest_launches[entry["name"]]
        if entry["launches_train_rest"] < 1:
            raise AssertionError(f"{entry['name']} was not launched on phase 10's path")
    # ... and the flagship's run through `train` on a generated corpus (phase 11).
    for entry in (kernels[0], kernels[1], kernels[4]):
        entry["launches_train_cli"] = cli_launches[entry["name"]]
        if entry["launches_train_cli"] < 1:
            raise AssertionError(f"{entry['name']} was not launched on phase 11's path")
    # ... and the exported programs' forwards in fresh processes (phase 12),
    # and the flagship forward on the BlazeFace crop (phase 13).
    for entry in kernels[:2]:
        entry["launches_export"] = export_launches[entry["name"]]
        entry["launches_face_crop"] = face_launches[entry["name"]]
        if entry["launches_export"] < 1 or entry["launches_face_crop"] < 1:
            raise AssertionError(f"{entry['name']} was not launched on phase 12's or 13's path")
    # ... and phase 14's data-parallel paths: the ranks' train steps and the
    # dp runner's replica forwards.
    for entry in (kernels[0], kernels[1], kernels[2], kernels[4]):
        entry["launches_data_parallel"] = dp_launches[entry["name"]]
        if entry["launches_data_parallel"] < 1:
            raise AssertionError(f"{entry['name']} was not launched on phase 14's path")
    # ... and phase 15's tensor-parallel paths: K3 alone (the replicated conv
    # layers) in the runners' replica forwards and the train steps.
    kernels[1]["launches_tensor_parallel"] = tp_launches["fused_conv_layer"]
    if kernels[1]["launches_tensor_parallel"] < 1:
        raise AssertionError("fused_conv_layer was not launched on phase 15's path")
    kernels[0]["train_shapes"] = k1_train
    kernels[1]["train_shapes"] = {f"{name}_b16": rep for name, rep in k3_train.items()}
    kernels[4]["variants"] = k2
    kernels[5]["shapes"] = {f"{name}_b{b}": rep for (name, b), rep in k6.items()}
    # K1 and K3 on this slice's paths: the bench forward and the transformer-pooler model.
    kernels[0]["launches_families"] = {d: n[0] for d, n in family_launches.items()}
    kernels[1]["launches_families"] = {d: n[1] for d, n in family_launches.items()}
    # ... and the serve stack's bursts through the dynamic batcher (phase 5a).
    for entry in kernels[:3]:
        entry["launches_serve_stack"] = stack_launches[entry["name"]]
        if entry["launches_serve_stack"] < 1:
            raise AssertionError(f"{entry['name']} was not launched on the serve stack's path")
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels, "serve": perf, "serve_stack": stack_report,
                      "families": family_perf, "bench": bench_report, "train": train_report,
                      "export": export_report, "blazeface": face_report,
                      "data_parallel": dp_report, "tensor_parallel": tp_report,
                      "media": media_report, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(dp_grad_spread() if sys.argv[1:] == ["--dp-grad-spread"] else main())
