"""Batch-tile experiment for the WavLM attention sublayer: K6 at G batch
elements per thread block, beside K1 on the same tensors.

Counterpart of the JAX package's `benchmarks/bench_attn_tile.py::main`.  Same
inputs (numpy `RandomState(0)`, the same draws in the same order: Tp = 160,
`seq_len` = 149, E = 768, 12 heads, bfloat16 activations and `wo`, float32
gate, bias, `bo` and LayerNorm) and the same two stages: every G must equal
G = 1 bit for bit before anything is timed; then one time per G.  The times
are CUDA events over launches queued after a warm-up.  K1
(`wavlm_attention_sublayer`, one block per batch element, head and query
tile) is timed on the same tensors: the comparison the experiment is for.

    python -m multimodalemotionrecognition_torch.bench.attn_tile [--batch 128] [--tiles 1,2,4,8]

Prints one JSON line.  Runs on the card; raises without one.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from multimodalemotionrecognition_torch.bench import card_line, events_ms, require_device
from multimodalemotionrecognition_torch.kernels import (
    wavlm_attention_sublayer,
    wavlm_attention_sublayer_tiled,
)

SEQ = 149  # WavLM-base tokens for 3 s at 16 kHz
PAD = 160
E = 768
H = 12
EPS = 1e-5


def make_tensors(batch: int, device, e: int = E):
    """The ten operands, drawn as the JAX script draws them (`e`: a
    narrower width for a rehearsal on the CPU)."""
    pad, h = PAD, H
    rng = np.random.RandomState(0)

    def draw(*shape, scale=1.0, dtype=torch.float32, uniform=False):
        values = rng.rand(*shape) if uniform else rng.randn(*shape)
        values = values.astype(np.float32)
        if scale != 1.0:
            values = values * np.float32(scale)
        return torch.from_numpy(values).to(device, dtype)

    bf16 = torch.bfloat16
    hidden = draw(batch, pad, e, dtype=bf16)
    q = draw(batch, pad, e, scale=0.1, dtype=bf16)
    k = draw(batch, pad, e, scale=0.1, dtype=bf16)
    v = draw(batch, pad, e, scale=0.1, dtype=bf16)
    gate = draw(batch, h * pad, 1, uniform=True)
    bias = draw(h * pad, pad, scale=0.05)
    wo = draw(e, e, scale=0.02, dtype=bf16)
    bo = draw(1, e, scale=0.01)
    lns = torch.ones(1, e, device=device)
    lnb = torch.zeros(1, e, device=device)
    return hidden, q, k, v, gate, bias, wo, bo, lns, lnb


def main(
    argv: Optional[Sequence[str]] = None, device="cuda", *, e: int = E, iters: int = 20,
) -> dict:
    """`e` and `iters` are the experiment's; a rehearsal on the CPU passes
    smaller ones."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--tiles", default="1,2,4,8")
    args = ap.parse_args(argv)
    device = require_device(device, "bench.attn_tile")
    b = args.batch
    tiles = [int(t) for t in args.tiles.split(",")]
    tensors = make_tensors(b, device, e)
    h, seq = H, SEQ

    with torch.no_grad():
        # -- numerics: every tile size must match G=1 exactly ---------------
        ref = wavlm_attention_sublayer_tiled(1, *tensors, h, seq, EPS)
        for g in tiles:
            if g != 1 and not torch.equal(wavlm_attention_sublayer_tiled(g, *tensors, h, seq, EPS), ref):
                raise AssertionError(f"G={g} differs from G=1")
        print(f"[attn_tile] numerics identical for G in {tiles}")

        # -- one time per G, and K1's on the same tensors --------------------
        results = {}
        for g in tiles:
            def call(g=g):
                return wavlm_attention_sublayer_tiled(g, *tensors, h, seq, EPS)

            events_ms(call, 3, device)  # warm-up
            results[g] = events_ms(call, iters, device)
            print(f"[attn_tile] G={g}: {results[g]:.3f} ms/layer (b{b})")

        def k1():
            return wavlm_attention_sublayer(*tensors, h, seq, EPS)

        events_ms(k1, 3, device)
        k1_ms = events_ms(k1, iters, device)
        print(f"[attn_tile] K1: {k1_ms:.3f} ms/layer (b{b})")

    best = min(results, key=results.get)
    report = {
        "metric": "wavlm_attn_sublayer_ms_per_layer",
        "value": results[best],
        "unit": f"ms_b{b}_bf16",
        "results": {str(g): ms for g, ms in results.items()},
        "best_tile": best,
        "baseline_g1": results.get(1),
        "k1_ms": k1_ms,
        "card": card_line(device),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
