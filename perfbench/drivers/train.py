"""Training cells: `EmotionTrainer.run_epoch` over a pool of host batches.

The traffic file gives the batches (`gen.train_batches`), the stage (2: the
two-stage policy's second stage; 0: single-stage, everything trainable),
the TrainConfig fields it changes, and the traced epoch (`trace_start`, a
share of the window).

Set-up builds the trainer and its state, loads the seed's weights, and
drives its first epoch as the window drives every epoch: one `run_epoch`
call over `epoch_batches` distinct batches, each staged on the side stream
under the step before it, the first step zeroing the optimizer as the stage
flip does.  Each step's loss (the device total the epoch sums), the first
step's gradient as Adam holds it (first moment / (1 - beta1)) and the
parameters after the third step are kept.  The window is a sequence of
such epochs over the pool, each ending in its one fetch; clips of the
steps done over the time from the window's start to the last epoch's end.
Afterwards the program is freed and the plain reference follows the first
three steps from the same weights, batches and seeds (`reference/train.py`).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from perfbench import common, gen, trace, weights
from perfbench.reference import train as ref_train

ADAM_B1 = 0.9
CHECK_STEPS = 3


def build(run):
    """-> (trainer, state, mask, lrs) on the seed's weights."""
    from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig
    from multimodalemotionrecognition_torch.train.trainer import EmotionTrainer

    model_cfg = ModelConfig(**run.config["model"])
    if run.config.get("wavlm"):
        model_cfg = dataclasses.replace(model_cfg, wavlm_geometry=dict(run.config["wavlm"]))
    fields = {**run.config.get("train", {}), **run.traffic.get("train", {}),
              "seed": run.seed % 2**63, "batch_size": run.traffic["batches"]["batch"]}
    trainer = EmotionTrainer(model_cfg, TrainConfig(**fields), device=run.device)
    state = trainer.init_state(torch.Generator().manual_seed(run.seed % 2**63))
    state.model.load_state_dict(weights.make(run.config, run.seed, run.device), strict=True)
    stage = run.traffic["stage"]
    return trainer, state, trainer.trainable_mask(stage), trainer.lr_tree(stage, {})


def first_epoch(trainer, state, mask, lrs, batches) -> dict:
    """The first epoch, one `run_epoch` over `batches` -> the host readings
    of its first three steps.  The trainer's step is watched, not replaced:
    after each call its loss is kept, after the first Adam's first moment
    and after the third the trainable parameters, all copied on the device
    in stream order."""
    seen = {"loss": []}
    original = trainer.train_step

    def watched(*args, **kwargs):
        out = original(*args, **kwargs)
        seen["loss"].append(out[0].detach())
        if len(seen["loss"]) == 1:
            seen["grad"] = {n: m / (1.0 - ADAM_B1) for n, m in state.opt_state.mu.items()}
        if len(seen["loss"]) == CHECK_STEPS:
            params = dict(state.model.named_parameters())
            seen["params"] = {n: params[n].detach().clone() for n in state.opt_state.mu}
        return out

    trainer.train_step = watched
    try:
        trainer.run_epoch(state, batches, True, mask, lrs, reset_opt_first=True)
    finally:
        del trainer.train_step
    return {"loss": [float(v) for v in seen["loss"][:CHECK_STEPS]],
            "grad": {n: v.cpu() for n, v in seen["grad"].items()},
            "params": {n: v.cpu() for n, v in seen["params"].items()}}


def drive(run) -> None:
    common.precision(run.config)
    batches = gen.train_batches(run.traffic["batches"], run.seed)
    trainer, state, mask, lrs = build(run)
    pool, per_epoch = len(batches), run.traffic["epoch_batches"]
    if per_epoch < CHECK_STEPS:
        raise ValueError(f"epoch_batches must be at least {CHECK_STEPS}: the checked steps "
                         "are the first epoch's")
    readings = first_epoch(trainer, state, mask, lrs,
                           [batches[j % pool] for j in range(per_epoch)])
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - run.t0

    steps, start, session = 0, per_epoch, None
    t0 = time.perf_counter()
    while True:
        epoch = [batches[(start + j) % pool] for j in range(per_epoch)]
        start += per_epoch
        traced = run.trace_on and session is None and \
            time.perf_counter() - t0 >= run.traffic["trace_start"] * run.seconds
        if traced:
            session = trace.Session()
            session.start()
        trainer.run_epoch(state, epoch, True, mask, lrs)
        steps += per_epoch
        if traced:
            session.stop()
        elapsed = time.perf_counter() - t0
        if elapsed >= run.seconds and (session is not None or not run.trace_on):
            break
    batch = run.traffic["batches"]["batch"]
    run.end_to_end["train_clips_per_s"] = steps * batch / elapsed
    run.counts.update({"steps": steps, "window_s": elapsed, "batch": batch})
    for attempt in range(3 if session is not None else 0):
        # The profiler now and then returns a window with no device event:
        # profile one more epoch, after the timed window.
        if attempt:
            session = trace.Session()
            session.start()
            trainer.run_epoch(state, epoch, True, mask, lrs)
            session.stop()
        run.trace = trace.reduce(session)
        run.counts["traced_steps"] = per_epoch
        if run.trace["kernels"]:
            break
    run.memory_peak_bytes = common.memory_peak(run.device)
    run.attempted = steps + per_epoch
    print(f"{run.cell['name']}: {steps} steps in {elapsed:.3f} s", file=sys.stderr)
    del trainer, state
    common.release()
    check(run, readings, batches)


def check(run, readings: dict, batches) -> None:
    """The reference's three steps against the program's readings, the
    numbers the cell's limits file names (see `compare`)."""
    run.readings, run.batches = readings, batches
    run.reference = ref_train.three_steps(run, batches[:CHECK_STEPS])
    gaps = compare(readings, run.reference)
    for name in run.limits:
        run.check(name, gaps[name])


def control(run) -> dict:
    """The reference in TF32 put in the program's place -> every gap of `compare`."""
    got = ref_train.three_steps(run, run.batches[:CHECK_STEPS], tf32=True)
    return compare(got, run.reference)


def compare(got: dict, want: dict) -> dict:
    """-> `loss_gap`, the largest relative gap of a step's loss, and
    `loss1_gap`, the first step's; `grad_gap`, the worst leaf's gap of the
    first gradient's norms, against the larger of that leaf's reference norm
    and the median leaf's; `change_gap`, the same of the parameters' change
    after the steps, and `change_median_gap`, its median over the leaves."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])]
    names = sorted(want["grad"])
    g_ref = {n: float(want["grad"][n].double().norm()) for n in names}
    g_got = {n: float(got["grad"][n].double().norm()) for n in names}
    g_med = float(np.median(list(g_ref.values())))
    grad = max(abs(g_got[n] - g_ref[n]) / max(g_ref[n], g_med) for n in names)
    # Leaves whose reference gradient is nought to rounding (below a
    # thousandth of the median leaf's) move by round-off alone under Adam.
    moved = [n for n in names if g_ref[n] >= 1e-3 * g_med]
    d_ref = {n: float((want["params"][n].double() - want["initial"][n].double()).norm())
             for n in moved}
    d_got = {n: float((got["params"][n].double() - want["initial"][n].double()).norm())
             for n in moved}
    d_med = float(np.median(list(d_ref.values())))
    change = [abs(d_got[n] - d_ref[n]) / max(d_ref[n], d_med) for n in moved]
    return {"loss_gap": max(losses), "loss1_gap": losses[0], "grad_gap": grad,
            "change_gap": max(change), "change_median_gap": float(np.median(change))}
