"""Library entries: the flagship forward with its example arguments, and a
data-parallel dry run.

Counterpart of the JAX package's `__graft_entry__.py`:

  * `entry` - the flagship (bidirectional cross-attention fusion, WavLM
    audio branch, ResNet18 video branch, raw waveform in) at batch 1, for a
    single-card start-up check;
  * `dryrun_multichip` - `__graft_entry__.py::dryrun_multichip`'s data
    parallel half on ranks of a `torch.distributed` group.

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
    """One rank of `dryrun_multichip` -> (losses, probabilities of every
    clip, K1 and K3 launches of this rank's forward)."""
    from multimodalemotionrecognition_torch.config import TrainConfig
    from multimodalemotionrecognition_torch.kernels import fused_conv_layer, wavlm_attention_sublayer
    from multimodalemotionrecognition_torch.parallel.distributed import all_gather_rows
    from multimodalemotionrecognition_torch.train import EmotionTrainer

    torch.set_num_threads(2)
    model_cfg = ModelConfig(fusion="xattn", use_wavlm=True, num_classes=8, xattn_d_model=32,
                            xattn_heads=4, wavlm_geometry=dict(_TINY_WAVLM))
    trainer = EmotionTrainer(model_cfg, TrainConfig(lr=1e-3, seed=0, mesh_shape=(world, 1)),
                             device=device)
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
    mine = {k: torch.from_numpy(v[2 * rank:2 * rank + 2]).to(device) for k, v in batch.items()}
    mask, lrs = trainer.trainable_mask(0), trainer.lr_tree(0, {})
    losses = []
    for _ in range(2):  # the same batch twice: the sharded step optimises
        total, *_ = trainer.train_step(state, mine["video"], mine["audio"], mine["labels"],
                                       mine["valid"], mask, lrs)
        losses.append(float(total))

    # One sharded forward through the kernels' wrappers (the kernels on the
    # card, their plain versions on the CPU) on the trained weights.
    geometry = dict(_TINY_WAVLM, fused_attention=True, fused_conv=True)
    model = build_model(dataclasses.replace(model_cfg, wavlm_geometry=geometry,
                                            xattn_attn_dropout=0.0, xattn_stochastic_depth=0.0),
                        device=device)
    model.load_state_dict(state.model.state_dict())
    clips = np.random.RandomState(1)
    video = torch.from_numpy(clips.randn(world, 2, 3, 32, 32).astype(np.float32)[rank:rank + 1])
    audio = torch.from_numpy(clips.randn(world, 1, 3200).astype(np.float32)[rank:rank + 1] * 0.1)
    seen = wavlm_attention_sublayer.launches, fused_conv_layer.launches
    with torch.no_grad():
        probs = torch.softmax(model(video.to(device), audio.to(device)).float(), dim=1)
    launches = (wavlm_attention_sublayer.launches - seen[0], fused_conv_layer.launches - seen[1])
    return losses, all_gather_rows(probs).cpu().numpy(), launches


def dryrun_multichip(n_devices: int = 2, device="cuda") -> dict:
    """Spawn `n_devices` ranks with the tiny WavLM flagship and check that
    data parallelism runs end to end: two data-parallel train steps on one
    global batch (the loss must fall), then one sharded forward, each rank
    on its own clip through the kernels' wrappers, whose gathered
    probabilities must be finite and sum to 1.  On the card the ranks take
    NCCL over distinct cards when there are `n_devices` of them, else Gloo
    with every rank on `cuda:0` (said on the first line); on the CPU, Gloo.
    -> a report dict.

    Not ported from the JAX dry run: its tensor-parallel half (TP waits for
    ROADMAP queue 1 item 3) and its `remat="dots"` step (remat is one of the
    TPU workarounds of queue 1 item 11, with no effect in the port)."""
    from multimodalemotionrecognition_torch.parallel.distributed import launch
    from multimodalemotionrecognition_torch.utils.device import require_device

    device = require_device(device, "dryrun_multichip")
    if device.type == "cuda" and torch.cuda.device_count() >= n_devices:
        backend, devices = "nccl", [torch.device("cuda", i) for i in range(n_devices)]
    elif device.type == "cuda":
        backend, devices = "gloo", [torch.device("cuda", 0)] * n_devices
    else:
        backend, devices = "gloo", ["cpu"] * n_devices
    print(f"[dryrun] {n_devices} data-parallel ranks over {backend} on {[str(d) for d in devices]}")
    results = launch(_dryrun_rank, n_devices, backend, devices, timeout_s=600.0)
    losses, probs, _ = results[0]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"the data-parallel train step did not reduce the loss: {losses}")
    if any(r[0] != losses for r in results):
        raise AssertionError(f"the ranks' losses differ: {[r[0] for r in results]}")
    print(f"[dryrun] two data-parallel train steps OK: loss {losses[0]:.4f} -> {losses[1]:.4f}, "
          f"global batch {2 * n_devices}")
    if probs.shape != (n_devices, 8) or not np.isfinite(probs).all():
        raise AssertionError(f"sharded forward: probabilities {probs}")
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    if not probs.std() > 1e-6:
        raise AssertionError("degenerate (constant) probabilities")
    launches = [r[2] for r in results]
    # On the card each rank's forward launches K1 per encoder layer and K3
    # per conv layer after the first; the plain versions count nothing.
    want = (_TINY_WAVLM["num_hidden_layers"], len(_TINY_WAVLM["conv_dim"]) - 1)
    if device.type == "cuda" and any(tuple(n) != want for n in launches):
        raise AssertionError(f"K1 / K3 launches per rank {launches}, expected {want} each")
    print(f"[dryrun] sharded forward OK over dp={n_devices}: probs[0]={probs[0].round(3)}, "
          f"K1 / K3 launches per rank {launches}")
    return {"backend": backend, "devices": [str(d) for d in devices], "losses": losses,
            "probs": probs.tolist(), "launches_per_rank": launches}
