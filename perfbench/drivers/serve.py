"""Serving cells: `.wav` uploads through `InferenceGateway` + `DynamicBatcher`
over one `TorchModelRunner`, built as the queued server builds them from
`ServeConfig`.

The traffic file gives the uploads (`gen.uploads`), the arrivals
(`{"kind": "closed", "clients": N}`: N clients, each submitting again as
soon as its result is in; `{"kind": "poisson", "rate": R}`: open-loop
arrivals at R per second, each request timed from when it was due), the
ServeConfig fields it changes, and the traced sub-window (`trace_start`, a
share of the window, and `trace_seconds`).

Set-up writes a checkpoint of the seed's weights under TMPDIR for the
runner (the runner loads only files), deletes it once loaded, warms every
bucket on both wires and pushes a short burst through the stack.  After
the window every request due in it is awaited (up to `grace_seconds`), the
program is freed, and every answer is held against the plain reference of
its upload: `probs_gap`, the largest absolute gap of a served probability.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench import common, gen, trace, weights
from perfbench.reference import host
from perfbench.reference.model import normalise_video


def _timer_class():
    from multimodalemotionrecognition_torch.utils.profiling import StageTimer

    class WindowTimer(StageTimer):
        """The batcher's stage timer keeping every sample of the run, with
        the host clock at which it was recorded."""

        def __init__(self):
            super().__init__(window=10**7)
            self.stamps = {}

        def record(self, name, ms):
            super().record(name, ms)
            self.stamps.setdefault(name, []).append((time.perf_counter(), ms))

    return WindowTimer


def serve_config(run):
    from multimodalemotionrecognition_torch.config import ServeConfig

    fields = {**run.config.get("serve", {}), **run.traffic.get("serve", {})}
    if "batch_buckets" in fields:
        fields["batch_buckets"] = tuple(fields["batch_buckets"])
    return ServeConfig(**fields)


def build_runner(run, cfg):
    """The runner on the seed's weights, as `serving/server_queued.py` builds it."""
    from multimodalemotionrecognition_torch.config import ModelConfig
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

    state = {k: v.cpu() for k, v in weights.make(run.config, run.seed, run.device).items()}
    model_cfg = ModelConfig(**run.config["model"])
    if run.config.get("wavlm"):
        model_cfg = dataclasses.replace(model_cfg, wavlm_geometry=dict(run.config["wavlm"]))
    fd, path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    try:
        torch.save({"model": state, "config": model_cfg.to_checkpoint_dict(), "val_f1": 0.0}, path)
        del state
        return TorchModelRunner(path, batch_buckets=cfg.batch_buckets,
                                compute_dtype=cfg.compute_dtype, fused=cfg.fused_xattn,
                                device_normalize=cfg.device_normalize, device=run.device)
    finally:
        os.unlink(path)


def warm(runner, cfg, pool, clients: int) -> None:
    """Every bucket once on each wire, then one closed-loop pass of the pool
    through the stack (thread pools, the event loop, the staged copies)."""
    runner.warmup()
    for b in cfg.batch_buckets:
        runner.predict_probs_blank_video(np.zeros((b, 1, host.TARGET_LEN), np.int16))
    asyncio.run(_drive(runner, cfg, pool, {"kind": "closed", "clients": clients},
                       seconds=0.0, warm_requests=len(pool)))
    if torch.cuda.is_available():
        torch.cuda.synchronize()


async def _drive(runner, cfg, pool, arrivals, seconds, grace=60.0, warm_requests=0,
                 on_trace=None):
    """One window -> (records, timer, t0, t_end).  A record: upload index,
    due time, completion time (None if the request failed), probabilities."""
    from multimodalemotionrecognition_torch.serving.batcher import (
        DynamicBatcher,
        GatewayError,
        InferenceGateway,
    )

    gateway = InferenceGateway(cfg)
    batcher = DynamicBatcher(gateway, runner, cfg)
    batcher.timer = _timer_class()()
    serving = asyncio.create_task(batcher.run())
    records = []
    counter = iter(range(10**9))

    async def one(index: int, due: float):
        rec = {"upload": index % len(pool), "due": due, "done": None, "probs": None}
        records.append(rec)
        try:
            rec["sent"] = time.perf_counter()
            task_id = await gateway.submit(*pool[rec["upload"]])
            result = await gateway.wait_for_result(task_id, timeout_sec=grace)
            rec["done"] = time.perf_counter()
            rec["probs"] = result["probs"]
        except GatewayError as exc:
            rec["error"] = str(exc.detail)

    t0 = time.perf_counter()
    t_end = t0 + seconds
    tracer = asyncio.create_task(on_trace(t0)) if on_trace else None
    tasks = []
    if arrivals["kind"] == "closed":
        async def client():
            while True:
                i = next(counter)
                if (warm_requests and i >= warm_requests) or (
                        not warm_requests and time.perf_counter() >= t_end):
                    return
                await one(i, time.perf_counter())

        tasks = [asyncio.create_task(client()) for _ in range(arrivals["clients"])]
    elif arrivals["kind"] == "poisson":
        async def schedule():
            for i, offset in enumerate(gen.poisson_offsets(arrivals["rate"], seconds)):
                delay = t0 + offset - time.perf_counter()
                if delay > 0:
                    await asyncio.sleep(delay)
                tasks.append(asyncio.create_task(one(i, t0 + offset)))

        await schedule()
    else:
        raise ValueError(f"unknown arrivals {arrivals['kind']!r}")
    await asyncio.gather(*tasks)
    if tracer is not None:
        await tracer
    batcher.stop()
    await serving
    batcher.pool.shutdown(wait=True)
    return records, batcher.timer, t0, t_end


def _trace_window(run, state):
    """A coroutine that profiles `trace_seconds` from `trace_start` of the
    window; the profile is read once the window has closed."""
    start, length = run.traffic["trace_start"], run.traffic["trace_seconds"]

    async def go(t0):
        await asyncio.sleep(max(0.0, t0 + start * run.seconds - time.perf_counter()))
        session = trace.Session()
        session.start()
        span0 = time.perf_counter()
        await asyncio.sleep(length)
        session.stop()
        state["span"] = (span0, time.perf_counter())
        state["session"] = session

    return go


def drive(run) -> None:
    common.precision(run.config)
    cfg = serve_config(run)
    pool = gen.uploads(run.traffic["uploads"], run.seed)
    runner = build_runner(run, cfg)
    arrivals = run.traffic["arrivals"]
    warm(runner, cfg, pool, arrivals.get("clients", cfg.batch_size * 4))
    run.setup_s = time.perf_counter() - run.t0

    state = {}
    records, timer, t0, t_end = asyncio.run(_drive(
        runner, cfg, pool, arrivals, run.seconds, run.traffic["grace_seconds"],
        on_trace=_trace_window(run, state) if run.trace_on else None))
    run.memory_peak_bytes = common.memory_peak(run.device)
    del runner
    common.release()

    due = [r for r in records if r["due"] < t_end]
    run.attempted = len(due)
    run.failed = sum(r["done"] is None for r in due)
    done_in_window = sum(r["done"] is not None and r["done"] <= t_end for r in records)
    grace_ms = run.traffic["grace_seconds"] * 1e3
    latency = sorted((r["done"] - r["due"]) * 1e3 if r["done"] is not None else grace_ms
                     for r in due)
    run.end_to_end["serve_clips_per_s"] = done_in_window / run.seconds
    if latency:
        run.end_to_end["serve_p95_ms"] = latency[max(0, -(-95 * len(latency) // 100) - 1)]
    run.timer = timer
    run.trace = trace.reduce(state["session"]) if "session" in state else None
    run.counts = {"clips": done_in_window, "window_s": run.seconds, "span": state.get("span"),
                  "buckets": tuple(cfg.batch_buckets), "latency_ms": latency}
    late = sorted(r["sent"] - r["due"] for r in due if "sent" in r)
    print(f"{run.cell['name']}: {run.attempted} due, {done_in_window} done in the window, "
          f"{run.failed} failed; the generator ran late by p95 "
          f"{1e3 * late[int(0.95 * (len(late) - 1))] if late else 0.0:.3f} ms", file=sys.stderr)
    check(run, records, pool)


def reference_probs(run, pool, uploads, tf32: bool = False, block: int = 8) -> dict:
    """{upload index: reference probabilities} for the blank-video route."""
    common.precision(run.config, tf32)
    model = common.reference_model(run.config, run.seed, run.device)
    out = {}
    order = sorted(uploads)
    with torch.no_grad():
        for i in range(0, len(order), block):
            idx = order[i:i + block]
            wire = np.stack([host.upload_to_wire(pool[j][1]) for j in idx])
            audio = torch.from_numpy(wire).to(run.device).float() / 32768.0
            video = normalise_video(torch.zeros((len(idx), 8, 3, 112, 112), dtype=torch.uint8,
                                                device=run.device))
            probs = torch.softmax(model(video, model.audio_input(audio)), dim=1)
            out.update(zip(idx, probs.double().cpu().numpy()))
    del model
    common.precision(run.config)
    common.release()
    return out


def probs_gap(records, ref) -> float:
    gap = 0.0
    for r in records:
        if r["probs"] is not None:
            gap = max(gap, float(np.abs(np.asarray(r["probs"]) - ref[r["upload"]]).max()))
    return gap


def check(run, records, pool) -> None:
    answered = [r for r in records if r["probs"] is not None]
    run.records, run.pool = answered, pool
    run.reference = reference_probs(run, pool, {r["upload"] for r in answered})
    run.check("probs_gap", probs_gap(answered, run.reference) if answered else float("inf"))


def control(run) -> dict:
    """The reference in TF32 put in the program's place, on the uploads the
    run answered -> its `probs_gap`."""
    ref = reference_probs(run, run.pool, set(run.reference), tf32=True)
    return {"probs_gap": max(float(np.abs(ref[u] - run.reference[u]).max()) for u in ref)}
