"""Rank functions for the data-parallel tests (`tests/test_torch_parallel.py`,
`test_torch_dp_train.py`, `test_torch_dp_serve.py`, `test_torch_cuda.py`).

`parallel.launch` spawns processes that import these functions by name, so
they live in a module that imports torch, numpy and the port only (no JAX:
the spawned ranks stay light, and the card's machine has none).  Each takes
(rank, world, device, ...) and returns numpy values.
"""

import numpy as np
import torch

from multimodalemotionrecognition_torch.config import ModelConfig, TrainConfig
from multimodalemotionrecognition_torch.data.pipeline import rank_rows
from multimodalemotionrecognition_torch.kernels import wavlm_attn
from multimodalemotionrecognition_torch.models import wavlm as port_wavlm
from multimodalemotionrecognition_torch.models.fusion import ClipStyleAlignment
from multimodalemotionrecognition_torch.models.resnet import EvalBatchNorm2d
from multimodalemotionrecognition_torch.ops import stochastic
from multimodalemotionrecognition_torch.parallel.distributed import (
    BatchShard,
    all_gather_rows,
    all_reduce_sum,
    batch_shard,
)
from multimodalemotionrecognition_torch.train import EmotionTrainer
from multimodalemotionrecognition_torch.train import trainer as port_trainer


def _numpy(tensors):
    return {k: v.detach().float().cpu().numpy() for k, v in tensors.items()}


def _rows(rank, world, arrays, microbatches=1):
    """Rank `rank`'s rows of each array, as the loader cuts them for a step
    of `microbatches` (`rank_rows`)."""
    positions = rank_rows(rank, world, len(arrays["labels"]), microbatches)
    return {k: v[positions] for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# collectives and the CLIP term
# ---------------------------------------------------------------------------


def collectives_and_infonce(rank, world, device, clip_state, a_emb, v_emb, bn_state, bn_x, bn_w):
    """all_reduce_sum and all_gather_rows forward and backward, the CLIP
    alignment over the rank's rows of (a_emb, v_emb), and a train-mode
    BatchNorm over its rows of `bn_x` under the loss sum(y * bn_w).  The
    modules' states come as numpy arrays."""
    torch.set_num_threads(2)
    out = {}
    x = (torch.arange(6, dtype=torch.float32).view(2, 3) + 10.0 * rank).requires_grad_()
    y = all_reduce_sum(x)
    (y * (rank + 1.0)).sum().backward()
    out["reduce"], out["reduce_grad"] = y.detach().numpy(), x.grad.numpy()
    x = (torch.arange(6, dtype=torch.float32).view(2, 3) - 7.0 * rank).requires_grad_()
    z = all_gather_rows(x)
    weights = torch.arange(z.numel(), dtype=torch.float32).view_as(z) * (rank + 1.0)
    (z * weights).sum().backward()
    out["gather"], out["gather_grad"] = z.detach().numpy(), x.grad.numpy()
    out["gather_bf16_dtype"] = str(all_gather_rows(x.detach().bfloat16()).dtype)

    n = a_emb.shape[0] // world
    module = ClipStyleAlignment(a_emb.shape[1], v_emb.shape[1], clip_state["audio_proj.weight"].shape[0])
    module.load_state_dict({k: torch.from_numpy(v) for k, v in clip_state.items()})
    a = torch.from_numpy(a_emb[rank * n:(rank + 1) * n]).requires_grad_()
    v = torch.from_numpy(v_emb[rank * n:(rank + 1) * n]).requires_grad_()
    with batch_shard(BatchShard(rank, world)):
        _, _, loss = module(a, v)
    loss.backward()
    out["clip_loss"] = float(loss)
    out["clip_a_grad"], out["clip_v_grad"] = a.grad.numpy(), v.grad.numpy()
    out["clip_param_grads"] = {k: p.grad.numpy() for k, p in module.named_parameters()}

    bn = EvalBatchNorm2d(bn_x.shape[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in bn_state.items()})
    n = bn_x.shape[0] // world
    x = torch.from_numpy(bn_x[rank * n:(rank + 1) * n]).requires_grad_()
    with batch_shard(BatchShard(rank, world)):
        y = bn(x, True)
    (y * torch.from_numpy(bn_w[rank * n:(rank + 1) * n])).sum().backward()
    out["bn_y"], out["bn_x_grad"] = y.detach().numpy(), x.grad.numpy()
    out["bn_param_grads"] = {k: p.grad.numpy() for k, p in bn.named_parameters()}
    out["bn_stats"] = {k: b.numpy() for k, b in bn.named_buffers() if "running" in k}
    return out


# ---------------------------------------------------------------------------
# eval-mode gradients and train-mode BatchNorm (the JAX suite's protocol)
# ---------------------------------------------------------------------------


def eval_grads_and_stats(trainer, state, batch):
    """On `trainer`'s rows of `batch` (numpy dict): the eval-mode loss and
    every parameter's gradient (summed over the ranks), then one train-mode
    forward's BatchNorm statistics.  The audio input is the log-mel made from
    the waveform by the trainer, or `batch["mel"]` where the batch has one.
    Runs alone or as a rank."""
    t = {k: torch.from_numpy(v).to(trainer.device) for k, v in batch.items()}
    audio = t["mel"] if "mel" in t else trainer._audio_features(t["audio"])
    trainer._set_trainable({n: True for n, _ in state.model.named_parameters()})
    state.model.zero_grad(set_to_none=True)
    with batch_shard(trainer.shard):
        out, aux = trainer._apply(t["video"], audio, False, None)
        denom = trainer._global_sum(t["valid"].float().sum())
        total, *_ = trainer._losses(out, aux, t["labels"], t["valid"], denom)
    total.backward()
    trainer.reduce_gradients()
    loss = float(trainer._global_sum(total.detach()))
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    with torch.no_grad(), batch_shard(trainer.shard):
        trainer._apply(t["video"], audio, True, state.rng)
    stats = {n: b for n, b in state.model.named_buffers() if "running" in n}
    return loss, _numpy(grads), _numpy(stats)


def eval_grads_rank(rank, world, device, model_config, train_kw, state_dict, batch, mel):
    """`eval_grads_and_stats` on this rank's rows from `state_dict` (numpy
    arrays), with the trainer's own log-mel, then again with `mel`."""
    torch.set_num_threads(2)
    state_dict = {k: torch.from_numpy(v) for k, v in state_dict.items()}
    trainer = EmotionTrainer(model_config, TrainConfig(**train_kw, mesh_shape=(world, 1)), device=device)
    state = trainer.init_state()
    out = []
    for extra in ({}, {"mel": mel}):
        state.model.load_state_dict(state_dict, strict=True)
        out.append(eval_grads_and_stats(trainer, state, _rows(rank, world, {**batch, **extra})))
    return out


# ---------------------------------------------------------------------------
# one trainer step, with every random draw recorded
# ---------------------------------------------------------------------------


class DrawRecorder:
    """Records what a train step draws: every `draw_rows` result (dropout,
    drop path, WavLM's span mask, the video noise), every K1 / K2 plain
    dropout mask, and WavLM's `layers_run` per forward.  `install()` patches
    the port's modules, `remove()` puts them back."""

    def __init__(self):
        self.draws, self.k1_masks, self.layers_run = [], [], []
        self._saved = []

    def install(self, model):
        real_draw, real_masks = stochastic.draw_rows, wavlm_attn._keep_masks

        def draw_rows(draw, shape):
            out = real_draw(draw, shape)
            self.draws.append(out.detach().cpu().clone())
            return out

        def keep_masks(*args, **kwargs):
            out = real_masks(*args, **kwargs)
            self.k1_masks.append(tuple(None if m is None else m.cpu().clone() for m in out))
            return out

        for module, name, fn in ((stochastic, "draw_rows", draw_rows),
                                 (port_wavlm, "draw_rows", draw_rows),
                                 (port_trainer, "draw_rows", draw_rows),
                                 (wavlm_attn, "_keep_masks", keep_masks)):
            self._saved.append((module, name, getattr(module, name)))
            setattr(module, name, fn)
        wavlm = model.audio_model.wavlm
        self._hook = wavlm.register_forward_hook(
            lambda m, i, o: self.layers_run.append(list(m.layers_run)))
        return self

    def remove(self):
        for module, name, fn in self._saved:
            setattr(module, name, fn)
        self._hook.remove()


def trainer_step(trainer, state, batch, stage=2):
    """One stage-`stage` train step (the stage flip's optimizer reset) on
    `trainer`'s rows of `batch`, its draws recorded.  -> (losses, the
    pre-optimizer gradients of the trainable parameters, the BatchNorm
    statistics after the step, the recorder)."""
    t = {k: torch.from_numpy(v).to(trainer.device) for k, v in batch.items()}
    mask, lrs = trainer.trainable_mask(stage), trainer.lr_tree(stage, {})
    recorder = DrawRecorder().install(state.model)
    try:
        total, cls_loss, ctr, _ = trainer.train_step(
            state, t["video"], t["audio"], t["labels"], t["valid"], mask, lrs, True, t.get("aug"))
    finally:
        recorder.remove()
    grads = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
    stats = {n: b for n, b in state.model.named_buffers() if "running" in n}
    return ((float(total), float(cls_loss), float(ctr)), _numpy(grads), _numpy(stats),
            {"draws": [d.numpy() for d in recorder.draws],
             "k1_masks": [tuple(None if m is None else m.numpy() for m in ms)
                          for ms in recorder.k1_masks],
             "layers_run": recorder.layers_run})


def trainer_step_rank(rank, world, device, model_config, train_kw, batch):
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer = EmotionTrainer(model_config, TrainConfig(**train_kw, mesh_shape=(world, 1)), device=device)
    state = trainer.init_state()
    return trainer_step(trainer, state, _rows(rank, world, batch, trainer.tc.grad_accum))


def flagship_small_config(**geometry) -> ModelConfig:
    """The flagship at SMALL widths, K1 and K2 through their wrappers,
    WavLM's dropouts at their 0.1, LayerDrop raised to 0.3 and span masking
    to 0.2 x 3 frames (from 0.1 and 0.05 x 10) so the short sequences of
    these sizes do mask spans and may drop a layer."""
    small = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                 conv_dim=(16, 16, 16), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2),
                 num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                 mask_time_prob=0.2, mask_time_length=3, layerdrop=0.3)
    return ModelConfig(fusion="xattn", use_wavlm=True, num_classes=8, xattn_d_model=32,
                       spec_augment=False,
                       wavlm_geometry=dict(small, fused_attention=True, **geometry))


# Layer 1 of the 2-layer WavLM and ResNet block 7 unfreeze in stage 2.
FLAGSHIP_TRAIN = dict(two_stage_training=True, epochs=2, stage1_epochs=1, lr=1e-3, seed=3,
                      fusion_unfreeze_wavlm_layers=11, fusion_unfreeze_video_blocks=1)


def flagship_batch(b, seed=11, frames=2, size=32, samples=8000):
    """A uint8-wire batch (noise replayed on the device) of `b` clips."""
    rng = np.random.default_rng(seed)
    aug = np.stack([rng.uniform(0.8, 1.2, b), rng.uniform(0.01, 0.05, b)], axis=1)
    return {
        "video": rng.integers(0, 256, (b, frames, 3, size, size), dtype=np.uint8),
        "audio": (rng.standard_normal((b, 1, samples)) * 0.1).astype(np.float32),
        "labels": rng.integers(0, 8, b).astype(np.int64),
        "valid": np.ones(b, bool),
        "aug": aug.astype(np.float32),
    }


def fail_on_rank_one(rank, world, device):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 gives up")
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    return float(t)


def dp_train_rank(rank, world, device, eval_args, *steps_args):
    """`eval_grads_rank`, then `trainer_step_rank` on each of `steps_args`,
    in one spawn."""
    return (eval_grads_rank(rank, world, device, *eval_args),
            *(trainer_step_rank(rank, world, device, *args) for args in steps_args))


# The flagship's trainable leaves outside the video tower: the ResNet's
# train-mode gradients at the tests' sizes are chaotic (ROADMAP queue 3),
# so the video tower is held by the loss and its statistics.
FLAGSHIP_STABLE = ("audio_model.", "v_in_proj", "a_in_proj", "v2a", "a2v", "v_norm", "a_norm",
                   "v_temporal", "a_temporal", "xattn_")


def assert_steps_agree(one, ranks, loss_tol, grad_rel, stats_tol):
    """Each rank's `trainer_step` against one rank's on the global batch:
    the same `layers_run`, every draw the global draw's rows bit for bit,
    losses within `loss_tol`, the stable leaves' gradients within
    `grad_rel` of each leaf's largest entry (floor 1e-6), the BatchNorm
    statistics within `stats_tol` (atol, rtol)."""
    losses, grads, stats, draws = one
    stable = [n for n in grads if n.startswith(FLAGSHIP_STABLE)]
    assert any(n.startswith("audio_model.wavlm.encoder.layers.1.") for n in stable)
    for r, (got_losses, got_grads, got_stats, got_draws) in enumerate(ranks):
        assert got_draws["layers_run"] == draws["layers_run"], r
        assert len(got_draws["draws"]) == len(draws["draws"])
        assert len(got_draws["k1_masks"]) == len(draws["k1_masks"])
        for i, (g, w) in enumerate(zip(got_draws["draws"], draws["draws"])):
            n = g.shape[0]
            np.testing.assert_array_equal(g, w[r * n:(r + 1) * n], err_msg=f"rank {r} draw {i}")
        for i, (g, w) in enumerate(zip(got_draws["k1_masks"], draws["k1_masks"])):
            for gm, wm in zip(g, w):
                assert (gm is None) == (wm is None)
                if gm is not None:
                    n = gm.shape[0]
                    np.testing.assert_array_equal(gm, wm[r * n:(r + 1) * n], err_msg=f"K1 call {i}")
        np.testing.assert_allclose(got_losses, losses, atol=loss_tol, rtol=0)
        assert set(got_grads) == set(grads)
        for name in stable:
            tol = max(grad_rel * np.abs(grads[name]).max(), 1e-6)
            np.testing.assert_allclose(got_grads[name], grads[name], atol=tol, rtol=0,
                                       err_msg=f"rank {r} {name}")
        assert set(got_stats) == set(stats)
        for name in stats:
            np.testing.assert_allclose(got_stats[name], stats[name], atol=stats_tol[0],
                                       rtol=stats_tol[1], err_msg=f"rank {r} {name}")
