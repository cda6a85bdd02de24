"""Arithmetic the per-layer readers share (`metrics/<name>.py`).

Each returns None when the run holds nothing to read: no stage samples, no
traced window, no kernel of that name in it.  Kernels are found in the
trace by the profiler names of their launches (frozen here); a kernel's
roofline share is the least time its work could take on the card, from
its shapes (`flops.py`), over its device time per call.
"""

from __future__ import annotations

import statistics

from perfbench import flops, trace

# Launch names of each kernel's routes on the card, and the launch that
# happens once per call.
KERNELS = {
    "K1": {"needles": ("wavlm_attn_core", "wavlm_attn_out_proj", "wavlm_attn_ln", "attn_core_tf32",
                       "out_proj_tf32", "attn_core_mma", "out_proj_mma"),
           "per_call": "wavlm_attn_ln"},
    "K2": {"needles": ("bwd_ln", "bwd_colsum", "bwd_dbias_reduce", "bwd_gemm", "bwd_attn_q",
                       "bwd_attn_kv", "bwd_key_tf32", "bwd_query_tf32", "bwd_proj_tf32",
                       "bwd_transpose_tf32", "bwd_proj_mma", "bwd_attn_mma"),
           "per_call": "bwd_ln"},
    "K3": {"needles": ("conv_fe", "split_tf32"), "per_call": "conv_fe"},
}


def stage_ms(run, name: str, span=None) -> list:
    """The window's samples of one stage of the batcher (those in `span`)."""
    if run.timer is None:
        return []
    lo, hi = span or (float("-inf"), float("inf"))
    return [ms for t, ms in run.timer.stamps.get(name, []) if lo <= t <= hi]


def median_or_none(values):
    return statistics.median(values) if values else None


def traced(run):
    return run.trace if run.trace and run.trace.get("busy_s") is not None else None


def idle_percent(run):
    t = traced(run)
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def traced_batches(run) -> list:
    """Rows of each batch whose forward ended inside the traced span."""
    span = run.counts.get("span")
    if span is None:
        return []
    return [int(n) for n in stage_ms(run, "batch_size", span)]


def bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1] * -(-n // buckets[-1])


def _per_call(run, kernel: str):
    t = traced(run)
    if t is None:
        return None
    spec = KERNELS[kernel]
    seconds, _ = trace.kernel_time(t, spec["needles"])
    _, calls = trace.kernel_time(t, (spec["per_call"],))
    return (seconds, calls) if calls else None


def roofline(run, kernel: str, batches: list):
    """100 x the mean bound of a call at the `batches` rows, over the kernel's
    device time per call (K3: per L1..L6 chain)."""
    got = _per_call(run, kernel)
    if got is None or not batches:
        return None
    seconds, calls = got
    g = run.geometry()
    t = flops.wavlm_lengths(g)[-1]
    e, h = g["hidden_size"], g["num_attention_heads"]
    cost = {"K1": lambda b: flops.k1_cost(b, t, e, h), "K2": lambda b: flops.k2_cost(b, t, e, h),
            "K3": lambda b: flops.k3_cost(b, g)}[kernel]
    if kernel == "K3":
        calls = calls / (len(g["conv_dim"]) - 1)
    bound = statistics.fmean(flops.bound_s(*cost(b), run.config["dtype"]) for b in batches)
    return 100.0 * bound / (seconds / calls)


def serve_batches(run) -> list:
    return [bucket(n, run.counts["buckets"]) for n in traced_batches(run)]


def train_batches(run) -> list:
    return [run.counts["batch"]] if traced(run) is not None else []


def launches(run):
    t = traced(run)
    return None if t is None else len(t["kernels"])


def backward_reach(run) -> dict:
    """What a train step's backward goes through, by the cell's stage."""
    if run.traffic["stage"] == 2:
        tc = {"fusion_unfreeze_wavlm_layers": 2, "fusion_unfreeze_video_blocks": 1,
              **run.config.get("train", {}), **run.traffic.get("train", {})}
        return {"wavlm_layers": tc["fusion_unfreeze_wavlm_layers"],
                "video_stages": tc["fusion_unfreeze_video_blocks"], "audio_all": False}
    return {}


def mfu_serve(run):
    clips, window = run.counts.get("clips"), run.counts.get("window_s")
    if not clips or not window or run.device.type != "cuda":
        return None
    work = clips * flops.clip_forward_flops(run.config, run.geometry())
    return 100.0 * work / window / flops.PEAK_FLOPS[run.config["dtype"]]


def mfu_train(run):
    steps, window = run.counts.get("steps"), run.counts.get("window_s")
    if not steps or not window or run.device.type != "cuda":
        return None
    per_clip = flops.clip_train_flops(run.config, run.geometry(), backward_reach(run))
    work = steps * run.counts["batch"] * per_clip
    return 100.0 * work / window / flops.PEAK_FLOPS[run.config["dtype"]]
