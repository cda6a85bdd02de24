"""Library entries: the flagship forward with its example arguments, and a
data-parallel dry run.

Counterpart of the JAX package's `__graft_entry__.py`:

  * `entry` - the flagship (bidirectional cross-attention fusion, WavLM
    audio branch, ResNet18 video branch, raw waveform in) at batch 1, for a
    single-card start-up check;
  * `dryrun_multichip` - `__graft_entry__.py::dryrun_multichip` on ranks
    of a `torch.distributed` group: train steps on a (dp, tp) mesh, then a
    data-parallel forward over every device.

Both run on the card unless the caller passes `device="cpu"`; they raise
without one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multimodalemotionrecognition_torch.config import ModelConfig
from multimodalemotionrecognition_torch.models.factory import build_model

__all__ = ["dryrun_multichip", "entry"]


def entry(device="cuda", **config_overrides):
    """-> (forward, (model, video, audio)); forward(model, video, audio)
    gives the probabilities [1, 8]."""
    config = ModelConfig(**{**dict(
        fusion="xattn",
        use_wavlm=True,
        num_classes=8,
        xattn_attn_dropout=0.0,
        xattn_stochastic_depth=0.0,
    ), **config_overrides})
    model = build_model(config, device=device)
    device = next(model.parameters()).device
    video = torch.zeros(1, 8, 3, 112, 112, device=device)
    audio = torch.zeros(1, 1, 48000, device=device)

    def forward(model, video, audio):
        with torch.no_grad():
            return torch.softmax(model(video, audio), dim=1)

    return forward, (model, video, audio)


# The JAX dry run's tiny WavLM (hidden 32 over 4 heads, 2 layers, three conv layers).
_TINY_WAVLM = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
    conv_dim=(16, 16, 16), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
)


def _dryrun_rank(rank, world, device):
    """One rank of `dryrun_multichip`, on its device or its mesh row of tp
    devices -> (losses, probabilities of every clip, K1 and K3 launches of
    each of this rank's forwards)."""
    from multimodalemotionrecognition_torch.config import TrainConfig
    from multimodalemotionrecognition_torch.kernels import fused_conv_layer, wavlm_attention_sublayer
    from multimodalemotionrecognition_torch.parallel.distributed import all_gather_rows
    from multimodalemotionrecognition_torch.parallel.mesh import gather_params
    from multimodalemotionrecognition_torch.train import EmotionTrainer

    torch.set_num_threads(2)
    row = device if isinstance(device, tuple) else (device,)
    tp = len(row)
    model_cfg = ModelConfig(fusion="xattn", use_wavlm=True, num_classes=8, xattn_d_model=32,
                            xattn_heads=4, wavlm_geometry=dict(_TINY_WAVLM))
    trainer = EmotionTrainer(model_cfg, TrainConfig(lr=1e-3, seed=0, mesh_shape=(world, tp)),
                             device=row)
    state = trainer.init_state()

    # The JAX dry run's batch (2 clips a rank), each rank holding its rows.
    b = 2 * world
    rng = np.random.RandomState(0)
    batch = {
        "video": rng.randn(b, 2, 3, 32, 32).astype(np.float32),
        "audio": rng.randn(b, 1, 3200).astype(np.float32) * 0.1,
        "labels": rng.randint(0, 8, b).astype(np.int64),
        "valid": np.ones(b, bool),
    }
    mine = {k: torch.from_numpy(v[2 * rank:2 * rank + 2]).to(row[0]) for k, v in batch.items()}
    mask, lrs = trainer.trainable_mask(0), trainer.lr_tree(0, {})
    losses = []
    for _ in range(2):  # the same batch twice: the sharded step optimises
        total, *_ = trainer.train_step(state, mine["video"], mine["audio"], mine["labels"],
                                       mine["valid"], mask, lrs)
        losses.append(float(total))

    # One data-parallel forward over every device of the mesh through the
    # kernels' wrappers (the kernels on the card, their plain versions on
    # the CPU) on the trained weights: each device of the rank's row runs
    # its own clip on a whole copy of the model.
    geometry = dict(_TINY_WAVLM, fused_attention=True, fused_conv=True)
    config = dataclasses.replace(model_cfg, wavlm_geometry=geometry, xattn_attn_dropout=0.0,
                                 xattn_stochastic_depth=0.0)
    weights = gather_params(state.model.state_dict())
    clips = np.random.RandomState(1)
    n = world * tp
    videos = clips.randn(n, 2, 3, 32, 32).astype(np.float32)
    audios = clips.randn(n, 1, 3200).astype(np.float32) * 0.1
    models, probs, launches = {}, [], []
    for j, d in enumerate(row):
        if d not in models:
            models[d] = build_model(config, device=d)
            models[d].load_state_dict(weights)
        i = rank * tp + j
        seen = wavlm_attention_sublayer.launches, fused_conv_layer.launches
        with torch.no_grad():
            logits = models[d](torch.from_numpy(videos[i:i + 1]).to(d),
                               torch.from_numpy(audios[i:i + 1]).to(d))
        probs.append(torch.softmax(logits.float(), dim=1).to(row[0]))
        launches.append((wavlm_attention_sublayer.launches - seen[0],
                         fused_conv_layer.launches - seen[1]))
    return losses, all_gather_rows(torch.cat(probs)).cpu().numpy(), launches


def dryrun_multichip(n_devices: int = 2, device="cuda") -> dict:
    """The JAX dry run on `n_devices` devices with the tiny WavLM flagship:
    as JAX, tp = 2 when `n_devices` is even and at least 4, else 1, and dp =
    n_devices / tp.  dp ranks, each on a mesh row of tp devices (its WavLM
    trunk split over them: `parallel/tensor.py`), take two train steps on
    one global batch: the loss must fall and every rank must read the same
    losses.  Then a data-parallel forward over all `n_devices` devices, each
    on its own clip through the kernels' wrappers, whose gathered
    probabilities must be finite and sum to 1.  On the card the ranks take
    NCCL over distinct cards when there are `n_devices` of them, else Gloo
    with every row on `cuda:0` (said on the first line); on the CPU, Gloo.
    -> a report dict.

    Not ported from the JAX dry run: its `remat="dots"` step (remat is one
    of the TPU workarounds of ROADMAP queue 1 item 11, with no effect in the
    port)."""
    from multimodalemotionrecognition_torch.parallel.distributed import launch
    from multimodalemotionrecognition_torch.utils.device import require_device

    device = require_device(device, "dryrun_multichip")
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    dp = n_devices // tp
    if device.type == "cuda" and torch.cuda.device_count() >= n_devices:
        backend, flat = "nccl", [torch.device("cuda", i) for i in range(n_devices)]
    elif device.type == "cuda":
        backend, flat = "gloo", [torch.device("cuda", 0)] * n_devices
    else:
        backend, flat = "gloo", [torch.device("cpu")] * n_devices
    rows = [tuple(flat[r * tp:(r + 1) * tp]) for r in range(dp)]
    devices = rows if tp > 1 else [row[0] for row in rows]
    print(f"[dryrun] mesh: data={dp} x model={tp} over {n_devices} devices: {dp} ranks over "
          f"{backend}, rows {[[str(d) for d in row] for row in rows]}")
    results = launch(_dryrun_rank, dp, backend, devices, timeout_s=600.0)
    losses, probs, _ = results[0]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"the sharded train step did not reduce the loss: {losses}")
    if any(r[0] != losses for r in results):
        raise AssertionError(f"the ranks' losses differ: {[r[0] for r in results]}")
    print(f"[dryrun] two sharded train steps OK (data={dp} x model={tp}): loss {losses[0]:.4f} -> "
          f"{losses[1]:.4f}, global batch {2 * dp}")
    if probs.shape != (n_devices, 8) or not np.isfinite(probs).all():
        raise AssertionError(f"sharded forward: probabilities {probs}")
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    if not probs.std() > 1e-6:
        raise AssertionError("degenerate (constant) probabilities")
    launches = [r[2] for r in results]
    # On the card each forward launches K1 per encoder layer and K3 per conv
    # layer after the first; the plain versions count nothing.
    want = (_TINY_WAVLM["num_hidden_layers"], len(_TINY_WAVLM["conv_dim"]) - 1)
    if device.type == "cuda" and any(tuple(n) != want for r in launches for n in r):
        raise AssertionError(f"K1 / K3 launches per forward {launches}, expected {want} each")
    print(f"[dryrun] sharded forward OK over dp={n_devices}: probs[0]={probs[0].round(3)}, "
          f"K1 / K3 launches per forward, by rank, {launches}")
    return {"backend": backend, "mesh": [dp, tp], "devices": [str(d) for d in flat],
            "losses": losses, "probs": probs.tolist(), "launches_per_rank": launches}
