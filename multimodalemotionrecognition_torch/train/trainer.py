"""Training harness: two-stage finetuning on one CUDA device per rank.

Counterpart of the JAX package's `train/trainer.py` (the reference
`EmotionTrainer`, `src/train.py:675-1201`), with the same training semantics:

  * torch-Adam-equivalent optimizer (L2 added to the gradients before Adam,
    on trainable leaves only) with per-group learning rates;
  * two-stage fusion training, the stage flip at epoch stage1_epochs + 1
    rebuilding the optimizer state (`:1071-1082`);
  * per-group cosine factor with eta_min = 0.1 * base, stepped per epoch;
  * NLL on log-probabilities for late fusion, cross entropy with label
    smoothing otherwise;
  * best-val-macro-F1 checkpoints to `output_dir/best_{fusion}.pt` in the
    reference's .pt layout, and early stopping.

What differs from the JAX trainer, in PyTorch's idiom: the model is an
`nn.Module` that owns its parameters and BatchNorm statistics, and a step
updates them IN PLACE (`TrainState` holds references, not copies); the stage
policy becomes `requires_grad` per parameter, so a frozen parameter gets no
gradient at all and autograd never runs the frozen backward; the optimizer
keeps moments only for parameters trainable in some stage of the run; every
random draw of a step comes from a named `torch.Generator` (`RngStreams`).
With `compute_dtype="bfloat16"` the parameters stay float32, as the JAX
trainer keeps them: each step's forward runs on bfloat16 casts of them
(`torch.func.functional_call`), the casts of frozen parameters are made once
per version of the parameter, and the loss is taken in float32.

Every family of `build_model` trains: the single-modality models take their
own input, the mel models get the log-mel spectrogram made on the device
inside the step, late fusion's probabilities go through the NLL.  One
deterministic step is held against the JAX trainer for every family.

The WavLM encoder layers run the hand-written attention kernel in the train
step too (forward with its in-kernel dropouts, and its backward kernel for
trainable layers), and the frozen conv feature extractor runs the conv
kernel; see `kernels/wavlm_attn.py`, `kernels/conv_fe.py`.  On the card,
the WavLM front end and layers that the freeze policy keeps frozen in every
stage are replayed from CUDA graphs after the step's first (`PrefixGraphs`,
`train/prefix_graph.py`), with the same draws and the same results.

As in the JAX trainer: the CLIP alignment term (`fusion_align_mode="clip"`,
total = cls + fusion_align_weight * InfoNCE); gradient accumulation
(`grad_accum` equal microbatches, one forward and backward each so `.grad`
sums them, each classification loss normalised by the full batch's valid
count, ONE optimizer step; BatchNorm statistics chain from microbatch to
microbatch and InfoNCE sees each microbatch's negatives, combined as the
mean); the branch warm start from `audio_ckpt` / `video_ckpt`
(`convert/pretrained.py` makes them from raw torchvision / HF state dicts);
the test confusion matrix (`confusion_matrix.csv`, and a PNG when matplotlib
imports); resume checkpoints (`save_resume_state` / `restore_resume_state`:
one `torch.save` file where the JAX trainer writes an orbax tree).

Data parallelism (`TrainConfig.mesh_shape`,
one process per rank in a `torch.distributed` group, as JAX shards the batch
over the mesh's "data" axis): each rank holds its rows of the global batch
(`data/pipeline.py` with `rank`, `world`) and the same parameters and
`RngStreams`.  The step runs inside `parallel.distributed.batch_shard`, so
per-sample draws are the global batch's rows, train-mode BatchNorm takes the
global statistics and the CLIP term the global negatives; the
classification loss is normalised by the global valid count, and after the
backward the trainable gradients are all-reduced as a SUM (each rank's loss
is its share of the global loss), one flat buffer per dtype, by an explicit
all-reduce (no `DistributedDataParallel`: the bf16 step runs on casts through
`functional_call` and LayerDrop leaves layers without gradients).  Losses,
predictions and labels are reduced or gathered, so every rank computes the
same metrics, early stopping and confusion matrix; rank 0 alone prints and
writes checkpoints, resume files and logs, and a barrier follows each write.

Tensor parallelism (`mesh_shape` (dp, tp) with tp > 1, as JAX shards the
WavLM trunk over the mesh's "model" axis): a rank owns a mesh row of tp
devices and splits its model over them (`parallel/tensor.py::
shard_module_`; one host thread drives the row).  Parameters are the
pieces, named `<module>.shards.<i>.<leaf>`, which the freeze policy and the
learning rates read as they read the whole tensors' names; Adam keeps one
moment per piece (its update is elementwise), the bf16 casts are made per
piece, and the gradient all-reduce runs over the data group only, one flat
buffer per (device, dtype).  K1 and K2 need a layer's every head on one
device, so the attention takes the modular sublayer (JAX's tensor-parallel
step runs no kernel either); K3 runs as before.  Checkpoints and resume
files hold the whole tensors (`parallel/mesh.py::gather_params`, as the JAX
trainer gathers its state into one tree), so a file written under one mesh
restores under any other.

`fit` takes any loaders whose batches carry numpy `video`, `audio`,
`labels`, `valid`, `aug` and `size`: `data/pipeline.py::build_loaders`
makes them from a RAVDESS-style directory, and `train/cli.py` drives the
whole run from the command line (W&B logging there, through `log_fn`).
"""

from __future__ import annotations

import dataclasses
import json
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn import functional as F

from multimodalemotionrecognition_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ModelConfig,
    TrainConfig,
    labels_for,
)
from multimodalemotionrecognition_torch.convert.checkpoint import (
    load_reference_checkpoint,
    normalize_torch_state_dict,
)
from multimodalemotionrecognition_torch.models.factory import build_model
from multimodalemotionrecognition_torch.models.wavlm import WavLMModel
from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram
from multimodalemotionrecognition_torch.ops.stochastic import RngStreams, draw_rows
from multimodalemotionrecognition_torch.parallel.distributed import (
    BatchShard,
    batch_shard,
    local_row,
    rank,
    world_size,
)
from multimodalemotionrecognition_torch.parallel.mesh import (
    Mesh,
    gather_params,
    shard_params,
    unshard_name,
)
from multimodalemotionrecognition_torch.parallel.tensor import shard_module_
from multimodalemotionrecognition_torch.train.freeze import (
    cosine_factor,
    lr_tree,
    trainable_mask,
    wavlm_frozen_prefix,
)
from multimodalemotionrecognition_torch.train.prefix_graph import PrefixGraphs
from multimodalemotionrecognition_torch.utils.device import require_device
from multimodalemotionrecognition_torch.utils.metrics import (
    accuracy,
    confusion_matrix,
    macro_f1,
)
from multimodalemotionrecognition_torch.utils.profiling import span
from multimodalemotionrecognition_torch.utils.seed import set_seed

__all__ = ["AdamState", "EmotionTrainer", "TrainState", "masked_adam_update"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# torch.optim.Adam's defaults, which the reference uses (`src/train.py:855-872`).
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


@dataclasses.dataclass
class AdamState:
    """Step count and first/second moments, by parameter name."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]

    @classmethod
    def zeros(cls, params: Dict[str, torch.Tensor]) -> "AdamState":
        return cls(
            count=0,
            mu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        )


@dataclasses.dataclass
class TrainState:
    """References to what a step updates in place."""

    model: torch.nn.Module
    opt_state: AdamState
    rng: RngStreams
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


def _smoothed_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, smoothing: float
) -> torch.Tensor:
    """torch CrossEntropyLoss(label_smoothing=s) per-sample losses."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels, num_classes).to(logits.dtype)
    targets = onehot * (1.0 - smoothing) + smoothing / num_classes
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def _nll_on_probs(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Late fusion: NLLLoss over log(p + 1e-8) (reference `:212-214`)."""
    log_probs = torch.log(probs + 1e-8)
    return -log_probs.gather(1, labels[:, None])[:, 0]


@torch.no_grad()
def masked_adam_update(
    opt_state: AdamState,
    params: Dict[str, torch.Tensor],
    grads: Dict[str, Optional[torch.Tensor]],
    mask: Dict[str, Any],
    lrs: Dict[str, float],
    reset_opt: bool,
    weight_decay: float,
) -> None:
    """Masked Adam + L2 weight-decay step over `params`, in place.

    torch Adam semantics (reference `src/train.py:227-228` + param groups):
    the L2 decay is added to the gradient before Adam, on trainable leaves
    only (`mask` is 0/1 per name); a frozen leaf gets exactly zero update.  A
    missing gradient (None: the leaf did not take part in the step, e.g. a
    layer LayerDrop skipped) counts as zero.  `reset_opt` first zeroes
    (count, mu, nu), as a freshly built optimizer at the stage flip.

    Same scalar operations in the same order as the JAX package's
    `masked_adam_update` (optax `scale_by_adam`), as `torch._foreach_*`
    passes over all leaves at once."""
    names = list(params)
    if not names:
        return
    ps = [params[n] for n in names]
    mu = [opt_state.mu[n] for n in names]
    nu = [opt_state.nu[n] for n in names]
    if reset_opt:
        opt_state.count = 0
        torch._foreach_zero_(mu)
        torch._foreach_zero_(nu)
    m = [float(mask[n]) for n in names]
    gs = [grads.get(n) for n in names]
    gs = [torch.zeros_like(p) if g is None else g.to(p.dtype) for g, p in zip(gs, ps)]
    g = torch._foreach_add(gs, ps, alpha=weight_decay)
    torch._foreach_mul_(g, m)
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
    opt_state.count += 1
    denom = torch._foreach_div(nu, 1.0 - ADAM_B2**opt_state.count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    delta = torch._foreach_div(mu, 1.0 - ADAM_B1**opt_state.count)
    torch._foreach_div_(delta, denom)
    torch._foreach_mul_(delta, [-float(lrs[n]) * mk for n, mk in zip(names, m)])
    torch._foreach_add_(ps, delta)


class EmotionTrainer:
    def __init__(
        self,
        model_config: ModelConfig,
        train_config: TrainConfig,
        device: Any = "cuda",
    ):
        """`device` is this rank's device, or its mesh row (a sequence of
        devices).  `train_config.mesh_shape` (else every rank on "data")
        sets the data-parallel size, which must be 1 or the process group's
        size, and the model axis tp: with tp > 1 the model is split over the
        row given, or over `local_row(tp)` when one device is given."""
        row = tuple(device) if isinstance(device, (list, tuple)) else (device,)
        row = tuple(require_device(d, "EmotionTrainer") for d in row)
        self.device = row[0]
        if model_config.compute_dtype not in _DTYPES:
            raise ValueError(f"Unsupported compute dtype: {model_config.compute_dtype}")
        if model_config.use_wavlm:
            # Train-path kernels: the attention sublayer has a backward kernel,
            # so every encoder layer runs it in the train step; trainable
            # layers differentiate through it, frozen ones never ask for it.
            # The conv kernel has no backward, so it runs only when the freeze
            # policy keeps the feature extractor frozen in every stage.
            # wavlm_geometry keys of the same name win (tests).
            _, conv_frozen = wavlm_frozen_prefix(model_config, train_config)
            geometry = model_config.wavlm_geometry or {}
            model_config = dataclasses.replace(
                model_config,
                wavlm_fused_train_layers=int(geometry.get("num_hidden_layers", 12)),
                wavlm_fused_train_conv=conv_frozen,
            )
        self.mc = model_config
        self.tc = train_config
        self.dtype = _DTYPES[model_config.compute_dtype]
        self._validate_train_config()
        self.shard, self.row = self._mesh(row)
        self.is_main = self.shard is None or self.shard.rank == 0
        self.is_single_modality = model_config.fusion in {"audio", "video"}
        self.model: Optional[torch.nn.Module] = None
        self.prefix_graphs: Optional[PrefixGraphs] = None
        self.metrics_log: list = []
        self._cast_cache: Dict[str, Tuple[int, torch.Tensor]] = {}
        self._active_mask: Optional[Dict[str, bool]] = None
        self.warm_start_report: Dict[str, Tuple[int, int]] = {}
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device).view(1, 1, 3, 1, 1)
        self._std = torch.tensor(IMAGENET_STD, device=self.device).view(1, 1, 3, 1, 1)

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------

    def _validate_train_config(self) -> None:
        """Fail fast on mode-string typos, as the JAX trainer does."""
        tc = self.tc
        if tc.flat_optimizer not in ("auto", "on", "off"):
            raise ValueError(
                f"TrainConfig.flat_optimizer must be 'auto', 'on' or 'off'; got {tc.flat_optimizer!r}"
            )
        if tc.rng_impl not in ("auto", "rbg", "threefry"):
            raise ValueError(
                f"TrainConfig.rng_impl must be 'auto', 'rbg' or 'threefry'; got {tc.rng_impl!r}"
            )
        if tc.remat not in (False, True, "full", "dots", "off"):
            raise ValueError(
                f"TrainConfig.remat must be False, True, 'full', 'dots' or 'off'; got {tc.remat!r}"
            )
        if not isinstance(tc.grad_accum, int) or tc.grad_accum < 1:
            raise ValueError(f"TrainConfig.grad_accum must be an int >= 1; got {tc.grad_accum!r}")
        if tc.grad_accum > 1 and self.mc.fusion_align_mode != "none":
            warnings.warn(
                f"grad_accum={tc.grad_accum} with fusion_align_mode={self.mc.fusion_align_mode!r}: "
                "the alignment loss sees each microbatch's negatives only (combined as the mean "
                "over microbatches), and BatchNorm statistics update once per microbatch",
                stacklevel=3,
            )

    def _mesh(self, row: Tuple[torch.device, ...]) -> Tuple[Optional[BatchShard], Tuple[torch.device, ...]]:
        """-> (this rank's `BatchShard` when the data axis spans several
        ranks, else None; this rank's mesh row of tp devices)."""
        if self.tc.mesh_shape is not None:
            dp, tp = (tuple(self.tc.mesh_shape) + (1,))[:2]
        else:
            dp, tp = 0, 1  # JAX: every device on "data"; here every rank
        if tp > 1 and len(row) == 1:
            row = local_row(tp, self.device.type)
        if len(row) != tp:
            raise ValueError(f"a model axis of {tp} takes a row of {tp} devices, not {len(row)}")
        world = world_size()
        dp = dp or world
        if dp == 1:
            return None, row
        if dp != world:
            raise ValueError(f"a data axis of {dp} needs {dp} ranks; the process group has {world}")
        return BatchShard(rank(), world), row

    def _global_sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the ranks (not recorded by autograd); itself alone."""
        if self.shard is None:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.shard.group)
        return t

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (equal shapes) concatenated in rank order."""
        if self.shard is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.shard.world)]
        dist.all_gather(parts, t.contiguous(), group=self.shard.group)
        return torch.cat(parts)

    def reduce_gradients(self) -> None:
        """Sum the `.grad` of every parameter over the data axis's ranks, in
        place: one all-reduce of a flat buffer per (device, dtype) (a
        tensor-parallel row's pieces on different cards cannot share one).
        Every rank runs the same layers, so the same parameters hold a
        gradient."""
        if self.shard is None:
            return
        groups: Dict[Tuple[torch.device, torch.dtype], list] = {}
        for p in self.model.parameters():
            if p.grad is not None:
                groups.setdefault((p.grad.device, p.grad.dtype), []).append(p.grad)
        for grads in groups.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.shard.group)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def _barrier(self) -> None:
        if self.shard is not None:
            dist.barrier(group=self.shard.group)

    def _log(self, text: str) -> None:
        if self.is_main:
            print(text)

    def _stages(self) -> Tuple[int, ...]:
        return (1, 2) if (self.tc.two_stage_training and not self.is_single_modality) else (0,)

    def trainable_mask(self, stage: int) -> Dict[str, bool]:
        return trainable_mask(
            [n for n, _ in self.model.named_parameters()], self.mc, self.tc, stage
        )

    def lr_tree(self, stage: int, scale: Dict[str, float]) -> Dict[str, float]:
        return lr_tree(
            [n for n, _ in self.model.named_parameters()], self.mc, self.tc, stage, scale
        )

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """Build the model on the device with parameters drawn from
        `generator` (default: seeded with `TrainConfig.seed`), warm-start
        its branches from `audio_ckpt` / `video_ckpt`, zero moments for every
        parameter trainable in some stage of the run, and the step's random
        streams from the same seed."""
        state = self._fresh_state(generator)
        self.warm_start_report = self._warm_start()
        return state

    def _fresh_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        generator = generator or torch.Generator().manual_seed(self.tc.seed)
        self.model = build_model(self.mc, device=self.device, generator=generator)
        if len(self.row) > 1:
            shard_module_(self.model, self.row)
        self.prefix_graphs = PrefixGraphs(*wavlm_frozen_prefix(self.mc, self.tc))
        for module in self.model.modules():
            if isinstance(module, WavLMModel):
                module.prefix_graphs = self.prefix_graphs
        self._cast_cache.clear()
        self._active_mask = None
        masks = [self.trainable_mask(s) for s in self._stages()]
        live = {
            n: p for n, p in self.model.named_parameters() if any(m[n] for m in masks)
        }
        return TrainState(
            model=self.model,
            opt_state=AdamState.zeros(live),
            rng=RngStreams(self.tc.seed, self.device),
        )

    def _warm_start(self) -> Dict[str, Tuple[int, int]]:
        """Branch checkpoint warm start (reference `src/train.py:913-947`):
        standalone audio / video checkpoints load into the fusion model's
        branches, parameters and BatchNorm statistics, tolerating missing
        and extra keys like `load_state_dict(strict=False)`.  Single-modality
        models skip it, as in the JAX trainer.  -> {branch: (missing,
        unused)} key counts, as the JAX trainer reports them (BatchNorm's
        `num_batches_tracked` counted on neither side)."""
        report: Dict[str, Tuple[int, int]] = {}
        if self.is_single_modality:
            return report
        for attr, branch in (("audio_ckpt", "audio_model"), ("video_ckpt", "video_model")):
            path = getattr(self.tc, attr)
            if not path:
                continue
            sd, _ = load_reference_checkpoint(path)
            result = getattr(self.model, branch).load_state_dict(
                self._shard_state(normalize_torch_state_dict(sd)), strict=False
            )
            counted = lambda keys: len({  # noqa: E731 - whole tensors, not pieces
                unshard_name(k) for k in keys if not k.endswith("num_batches_tracked")})
            report[branch] = (counted(result.missing_keys), counted(result.unexpected_keys))
            self._log(
                f"[INFO] Loaded {branch} checkpoint: {path} "
                f"(missing={report[branch][0]}, unused={report[branch][1]})"
            )
        return report

    # ------------------------------------------------------------------
    # model application
    # ------------------------------------------------------------------

    def _set_trainable(self, mask: Dict[str, Any]) -> None:
        """`requires_grad` from the stage's mask.  Masks are compared by
        value, so one changed in place takes effect; a parameter that turns
        trainable gives up its cached compute-dtype cast."""
        flags = {name: bool(on) for name, on in mask.items()}
        if flags == self._active_mask:
            return
        for name, p in self.model.named_parameters():
            p.requires_grad_(flags[name])
            if flags[name]:
                self._cast_cache.pop(name, None)
        self._active_mask = flags

    def _cast_params(self) -> Dict[str, torch.Tensor]:
        """Compute-dtype casts of the float32 parameters: recorded by
        autograd for a parameter that takes a gradient in this step, else
        made once per version of the parameter."""
        out = {}
        record = torch.is_grad_enabled()
        for name, p in self.model.named_parameters():
            if record and p.requires_grad:
                out[name] = p.to(self.dtype)
                continue
            cached = self._cast_cache.get(name)
            if cached is None or cached[0] != p._version:
                cached = (p._version, p.detach().to(self.dtype))
                self._cast_cache[name] = cached
            out[name] = cached[1]
        return out

    def _apply(self, video, audio, train: bool, rng: Optional[RngStreams]):
        """-> (the model's output in float32: logits, probabilities for late
        fusion; aux with the alignment loss, None where the model has none).
        The single-modality models take their own input alone."""
        inputs = {"audio": (audio,), "video": (video,)}.get(self.mc.fusion, (video, audio))
        kwargs = {} if self.is_single_modality else {"return_aux": True}
        if self.dtype == torch.float32:
            out = self.model(*inputs, train, rng, **kwargs)
        else:
            args = (*(x.to(self.dtype) for x in inputs), train, rng)
            out = torch.func.functional_call(self.model, self._cast_params(), args, kwargs)
        out, aux = out if kwargs else (out, {"alignment_loss": None})
        align = aux["alignment_loss"]
        return out.float(), {"alignment_loss": None if align is None else align.float()}

    def _audio_features(self, audio_wav: torch.Tensor) -> torch.Tensor:
        """Waveform [B, 1, T] -> the model's audio input: WavLM takes it as
        it is; for the mel models the log-mel front end runs on the device
        inside the step."""
        if self.mc.use_wavlm:
            return audio_wav
        return log_mel_spectrogram(audio_wav[:, 0, :])[:, None, :, :]

    def _device_video(self, video, aug, generator: Optional[torch.Generator]):
        """uint8-wire replay of the reference's float augmentation tail on
        the device (`src/data/ravdess.py:366-387`): /255, brightness x
        factor, + Gaussian noise, clip to [0, 1], ImageNet normalise.  `aug`
        is [B, 2] = (factor, sigma), (1, 0) on eval batches.  float32-wire
        batches pass through untouched (normalised on the host)."""
        if video.dtype != torch.uint8:
            return video
        v = video.float() / 255.0
        if aug is not None:
            factor = aug[:, 0].view(-1, 1, 1, 1, 1)
            sigma = aug[:, 1].view(-1, 1, 1, 1, 1)
            v = v * factor
            if generator is not None:
                noise = draw_rows(
                    lambda s: torch.randn(s, generator=generator, device=v.device), v.shape)
                v = v + sigma * noise
            v = v.clamp(0.0, 1.0)
        return (v - self._mean) / self._std

    def _losses(self, outputs, aux, labels, valid, denom=None):
        """-> (total, cls_loss, contrastive).  `denom` overrides the
        valid-count normaliser: gradient accumulation passes the FULL
        batch's count, so the microbatches' contributions sum to the full
        batch's classification loss and gradient."""
        labels = labels.long()
        if self.mc.fusion == "late":
            per_sample = _nll_on_probs(outputs, labels)
        else:
            per_sample = _smoothed_cross_entropy(
                outputs, labels, max(0.0, self.tc.label_smoothing)
            )
        weight = valid.to(per_sample.dtype)
        if denom is None:
            denom = weight.sum().clamp_min(1.0)
        cls_loss = (per_sample * weight).sum() / denom
        align = aux.get("alignment_loss")
        contrastive = align if align is not None else torch.zeros_like(cls_loss)
        total = cls_loss + self._align_weight() * contrastive
        return total, cls_loss, contrastive

    def _align_weight(self) -> float:
        return self.mc.fusion_align_weight if self.mc.fusion_align_mode != "none" else 0.0

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def loss_and_grads(self, state: TrainState, video, audio_wav, labels, valid, mask, aug=None):
        """Train-mode forward and backward: leaves the gradients on the
        trainable parameters' `.grad` and updates the BatchNorm statistics
        in place.  -> (total, cls_loss, contrastive, preds) over the whole
        batch, on the device.

        With `grad_accum` = n > 1 the batch is cut into n equal microbatches
        (JAX `trainer.py:490-584`), each run forward and backward in turn so
        only one microbatch's activations are live and `.grad` sums their
        gradients: each classification loss is normalised by the FULL
        batch's valid count, the alignment term enters as weight * loss / n,
        BatchNorm statistics chain from microbatch to microbatch, and each
        microbatch draws its own dropout masks from the step's streams.

        Data parallel: the batch is this rank's rows as
        `data/pipeline.py::rank_rows` lays them out for `grad_accum`
        microbatches (its i-th microbatch is its share of the global i-th),
        the valid count and the returned losses are the global batch's, and
        the gradients left on `.grad` are the global ones (summed over the
        ranks)."""
        accum = self.tc.grad_accum
        bsz = video.shape[0]
        if bsz % accum:
            raise ValueError(f"batch size {bsz} not divisible by grad_accum {accum}")
        self._set_trainable(mask)
        self.model.zero_grad(set_to_none=True)
        mb = bsz // accum
        denom = self._global_sum(valid.float().sum()).clamp_min(1.0)
        a_w = self._align_weight()
        cls_loss = contrastive = None
        preds = []
        with batch_shard(self.shard):
            for i in range(accum):
                rows = slice(i * mb, (i + 1) * mb)
                with span("trainer.forward"):
                    mv = self._device_video(
                        video[rows], None if aug is None else aug[rows],
                        state.rng.device("videoaug"),
                    )
                    out, aux = self._apply(
                        mv, self._audio_features(audio_wav[rows]), True, state.rng)
                    _, cls_i, ctr_i = self._losses(out, aux, labels[rows], valid[rows], denom)
                with span("trainer.backward"):
                    (cls_i + a_w * ctr_i / accum).backward()
                cls_i, ctr_i = cls_i.detach(), ctr_i.detach() / accum
                cls_loss = cls_i if cls_loss is None else cls_loss + cls_i
                contrastive = ctr_i if contrastive is None else contrastive + ctr_i
                preds.append(out.detach().argmax(dim=1))
        with span("trainer.reduce"):
            self.reduce_gradients()
            cls_loss, contrastive = self._global_sum(torch.stack([cls_loss, contrastive]))
        total = cls_loss + a_w * contrastive
        return total, cls_loss, contrastive, torch.cat(preds)

    def train_step(
        self, state: TrainState, video, audio_wav, labels, valid, mask, lrs,
        reset_opt: bool = False, aug=None,
    ):
        """One optimizer step on device tensors; `state` is updated in place.
        `mask` and `lrs` are the stage's `trainable_mask` and `lr_tree`;
        `reset_opt` zeroes the optimizer state first (the stage flip)."""
        out = self.loss_and_grads(state, video, audio_wav, labels, valid, mask, aug)
        with span("trainer.optimizer"):
            live = {n: p for n, p in state.model.named_parameters() if n in state.opt_state.mu}
            masked_adam_update(
                state.opt_state, live, {n: p.grad for n, p in live.items()}, mask, lrs,
                reset_opt, self.tc.weight_decay,
            )
        state.step += 1
        return out

    @torch.no_grad()
    def eval_step(self, state: TrainState, video, audio_wav, labels, valid, aug=None):
        """Eval forward -> (total, cls_loss, contrastive, predictions): the
        losses of the global batch, the predictions of this rank's rows."""
        with span("trainer.forward"):
            video = self._device_video(video, aug, None)
            denom = self._global_sum(valid.float().sum()).clamp_min(1.0)
            with batch_shard(self.shard):
                outputs, aux = self._apply(video, self._audio_features(audio_wav), False, None)
                losses = self._losses(outputs, aux, labels, valid, denom)
            total, cls_loss, contrastive = self._global_sum(torch.stack(losses))
            return total, cls_loss, contrastive, outputs.argmax(dim=1)

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------

    def _stage_plan(self) -> Tuple[bool, int, int]:
        two_stage = self.tc.two_stage_training and not self.is_single_modality
        if not two_stage:
            return False, 0, self.tc.epochs
        if self.tc.epochs <= 1:
            stage1 = self.tc.epochs
        else:
            stage1 = min(max(1, self.tc.stage1_epochs), self.tc.epochs - 1)
        return True, stage1, self.tc.epochs - stage1

    def _epoch_lr_scale(
        self, stage: int, epoch_in_stage: int, epochs_in_stage: int
    ) -> Dict[str, float]:
        if not self.tc.use_cosine_annealing:
            return {}
        if self.tc.cosine_stage2_only and stage == 1:
            return {}
        f = cosine_factor(epoch_in_stage, epochs_in_stage)
        return {"fusion": f, "audio": f, "video": f}

    @staticmethod
    def _fetch(it):
        """The loader's next batch, None when it is exhausted."""
        with span("trainer.fetch"):
            return next(it, None)

    def _stage_batch(self, batch):
        """Host arrays -> device tensors.  On CUDA the copies go from pinned
        memory on a side stream without blocking; the event marks their end."""
        with span("trainer.stage"):
            arrays = {"video": batch.video, "audio": batch.audio, "labels": batch.labels,
                      "valid": batch.valid}
            if batch.aug is not None:
                arrays["aug"] = batch.aug
            tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
            if self._copy_stream is None:
                return tensors, None
            with torch.cuda.stream(self._copy_stream):
                tensors = {
                    k: t.pin_memory().to(self.device, non_blocking=True)
                    for k, t in tensors.items()
                }
                event = torch.cuda.Event()
                event.record()
            return tensors, event

    def run_epoch(
        self,
        state: TrainState,
        loader: Iterable,
        train: bool,
        mask=None,
        lrs=None,
        reset_opt_first: bool = False,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """One pass over `loader`, whose batches carry `video`, `audio`,
        `labels`, `valid`, `aug` (or None) and `size` as numpy arrays.

        Batch N+1 is fetched and its host->device copies are started on a
        side stream right after step N is queued, so decode and transfer
        ride under step N's compute; per-step scalars and predictions stay
        on the device until ONE fetch at the epoch's end, so the loop never
        waits for the device between steps.  Data parallel: the losses and
        metrics are the global batches' on every rank.

        Under a profiler each phase is a `trainer.*` span on the profiler's
        clock (`utils/profiling.py::span`): step, fetch, stage, forward,
        backward, reduce, optimizer, epoch_sync."""
        totals_dev, preds_dev = [], []
        sizes, valids, labels_list = [], [], []
        first = True
        it = iter(loader)
        batch = self._fetch(it)
        staged = self._stage_batch(batch) if batch is not None else None
        while batch is not None:
            with span("trainer.step"):
                sb, event = staged
                if event is not None:
                    torch.cuda.current_stream(self.device).wait_event(event)
                    for t in sb.values():
                        t.record_stream(torch.cuda.current_stream(self.device))
                args = (sb["video"], sb["audio"], sb["labels"], sb["valid"])
                if train:
                    reset = reset_opt_first and first
                    first = False
                    total, cls_l, ctr_l, preds = self.train_step(
                        state, *args, mask, lrs, reset, sb.get("aug")
                    )
                else:
                    total, cls_l, ctr_l, preds = self.eval_step(state, *args, sb.get("aug"))
                totals_dev.append(torch.stack([total, cls_l, ctr_l]))
                preds_dev.append(preds)
                sizes.append(batch.size)
                valids.append(np.asarray(batch.valid))
                labels_list.append(np.asarray(batch.labels))
                batch = self._fetch(it)
                staged = self._stage_batch(batch) if batch is not None else None

        totals = np.zeros(3)
        n = 0
        preds = labels = np.zeros(0)
        if totals_dev:
            with span("trainer.epoch_sync"):  # the one sync per epoch
                fetched = torch.stack(totals_dev).double().cpu().numpy()
            if self.shard is not None:
                sizes = self._global_sum(
                    torch.tensor(sizes, dtype=torch.int64, device=self.device)).tolist()
            for row, bs in zip(fetched, sizes):
                totals += row * bs
                n += bs
            preds, labels = self._valid_predictions(torch.cat(preds_dev), valids, labels_list)
        metrics = {
            "loss": totals[0] / max(n, 1),
            "cls_loss": totals[1] / max(n, 1),
            "contrastive_loss": totals[2] / max(n, 1),
            "acc": accuracy(preds, labels),
            "f1": macro_f1(preds, labels),
        }
        return state, metrics

    def _valid_predictions(self, preds: torch.Tensor, valids, labels_list):
        """Predictions (a device tensor) and the batches' host `valid` and
        `labels` -> (predictions, labels) of the valid rows as numpy, every
        rank's rows gathered."""
        valid = torch.from_numpy(np.concatenate(valids)).to(preds.device)
        labels = torch.from_numpy(np.concatenate(labels_list).astype(np.int64)).to(preds.device)
        preds, valid, labels = (self._gather_rows(t) for t in (preds, valid, labels))
        valid = valid.cpu().numpy()
        return preds.cpu().numpy()[valid], labels.cpu().numpy()[valid]

    def fit(
        self,
        train_loader,
        val_loader,
        test_loader=None,
        state: Optional[TrainState] = None,
        log_fn=None,
    ) -> Tuple[TrainState, Dict[str, Any]]:
        set_seed(self.tc.seed)
        if state is None:
            state = self.init_state()
        two_stage, stage1_epochs, stage2_epochs = self._stage_plan()
        current_stage = 1 if two_stage else 0

        mask = self.trainable_mask(current_stage)
        best_f1 = -1.0
        patience = 0
        out_dir = Path(self.tc.output_dir)
        history = []

        for epoch in range(1, self.tc.epochs + 1):
            reset_opt = False
            if (
                two_stage
                and current_stage == 1
                and stage1_epochs < self.tc.epochs
                and epoch == stage1_epochs + 1
            ):
                current_stage = 2
                mask = self.trainable_mask(2)
                # The stage flip rebuilds the optimizer like the reference's
                # fresh torch.optim.Adam (`:1080`): the first step of the
                # stage zeroes count and moments.
                reset_opt = True
                self._log(f"[INFO] Switched to stage-2 at epoch {epoch}.")

            epoch_in_stage = epoch - 1 if current_stage != 2 else epoch - 1 - stage1_epochs
            epochs_in_stage = (
                self.tc.epochs
                if not two_stage
                else (stage1_epochs if current_stage == 1 else stage2_epochs)
            )
            scale = self._epoch_lr_scale(current_stage, epoch_in_stage, epochs_in_stage)
            lrs = self.lr_tree(current_stage, scale)

            t0 = time.time()
            state, train_m = self.run_epoch(
                state, train_loader, True, mask, lrs, reset_opt_first=reset_opt
            )
            state, val_m = self.run_epoch(state, val_loader, False)
            dt = time.time() - t0

            row = {
                "epoch": epoch,
                "stage": current_stage,
                "epoch_time_sec": round(dt, 2),
                **{f"train/{k}": v for k, v in train_m.items()},
                **{f"val/{k}": v for k, v in val_m.items()},
            }
            history.append(row)
            self._log(
                f"Epoch {epoch:02d} | stage {current_stage or '-'} | "
                f"train loss {train_m['loss']:.4f} acc {train_m['acc']:.4f} "
                f"f1 {train_m['f1']:.4f} | val loss {val_m['loss']:.4f} "
                f"acc {val_m['acc']:.4f} f1 {val_m['f1']:.4f} | {dt:.1f}s"
            )
            if log_fn and self.is_main:
                log_fn(row)
            self.metrics_log.append(row)

            if val_m["f1"] > best_f1:
                best_f1 = val_m["f1"]
                patience = 0
                self.save_checkpoint(out_dir / f"best_{self.mc.fusion}.pt", state, best_f1)
            else:
                patience += 1
                if (
                    self.tc.early_stopping_patience > 0
                    and patience >= self.tc.early_stopping_patience
                ):
                    self._log(
                        f"\nEarly stopping triggered! No improvement for "
                        f"{self.tc.early_stopping_patience} epochs."
                    )
                    break

        result: Dict[str, Any] = {"best_val_f1": best_f1, "history": history}
        if test_loader is not None and getattr(test_loader, "num_samples", 1) > 0:
            _, test_m = self.run_epoch(state, test_loader, False)
            result["test"] = test_m
            self._log(
                f"Test | loss {test_m['loss']:.4f} acc {test_m['acc']:.4f} f1 {test_m['f1']:.4f}"
            )
            # Test confusion matrix (the reference plots it to W&B,
            # `src/train.py:304-326,1186-1197`): saved as CSV, and PNG.
            try:
                cm = self._test_confusion_matrix(state, test_loader)
                if self.is_main:
                    self._save_confusion_matrix(cm, out_dir)
                result["confusion_matrix"] = cm.tolist()
            except Exception as exc:  # plotting must never kill a run
                print(f"[WARNING] confusion matrix failed: {exc}")
        if self.is_main:
            out_dir.mkdir(parents=True, exist_ok=True)
            with (out_dir / "metrics.jsonl").open("w") as f:
                for row in history:
                    f.write(json.dumps(row) + "\n")
        self._barrier()
        return state, result

    def _test_confusion_matrix(self, state: TrainState, loader) -> np.ndarray:
        """Eval predictions over `loader` -> [num_classes, num_classes]
        counts, rows the true class, valid samples only."""
        preds, valids, labels = [], [], []
        for batch in loader:
            sb, event = self._stage_batch(batch)
            if event is not None:
                torch.cuda.current_stream(self.device).wait_event(event)
                for t in sb.values():
                    t.record_stream(torch.cuda.current_stream(self.device))
            *_, p = self.eval_step(state, sb["video"], sb["audio"], sb["labels"], sb["valid"])
            preds.append(p)
            valids.append(np.asarray(batch.valid))
            labels.append(np.asarray(batch.labels))
        return confusion_matrix(
            *self._valid_predictions(torch.cat(preds), valids, labels), self.mc.num_classes
        )

    def _save_confusion_matrix(self, cm: np.ndarray, out_dir: Path) -> None:
        out_dir.mkdir(parents=True, exist_ok=True)
        np.savetxt(out_dir / "confusion_matrix.csv", cm, fmt="%d", delimiter=",")
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        labels = list(labels_for(self.mc.num_classes))
        fig, ax = plt.subplots(figsize=(8, 8))
        im = ax.imshow(cm, cmap="Blues")
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_xticks(range(len(labels)), labels, rotation=45, ha="right")
        ax.set_yticks(range(len(labels)), labels)
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                ax.text(
                    j, i, int(cm[i, j]), ha="center", va="center",
                    color="w" if cm[i, j] > cm.max() / 2 else "black",
                )
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(out_dir / "confusion_matrix.png", dpi=120)
        plt.close(fig)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _shard_state(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors by name -> this rank's pieces of them (its mesh
        row's), the names the sharded model's state dict has."""
        if len(self.row) == 1:
            return tensors
        return shard_params(Mesh([self.row]), tensors)[0]

    @staticmethod
    def _whole_cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Pieces gathered into whole tensors, on the CPU."""
        return {k: v.detach().cpu() for k, v in gather_params(tensors).items()}

    def save_resume_state(
        self, directory: Path | str, state: TrainState, epoch: int, best_f1: float
    ) -> None:
        """Everything a run needs to go on where it stopped, as one
        `torch.save` file `directory/resume.pt` (the JAX trainer writes an
        orbax tree): the model's parameters and buffers, the Adam count and
        moments, the state of every generator of `RngStreams` (device and
        host), step, epoch and best F1.  Data parallel: rank 0 writes, then
        every rank waits for it.  Tensor parallel: the whole tensors, so
        the file restores under any mesh."""
        if not self.is_main:
            self._barrier()
            return
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        whole = self._whole_cpu
        payload = {
            "model": whole(state.model.state_dict()),
            "opt_state": {"count": state.opt_state.count, "mu": whole(state.opt_state.mu),
                          "nu": whole(state.opt_state.nu)},
            "rng": state.rng.get_state(),
            "step": int(state.step),
            "epoch": int(epoch),
            "best_f1": float(best_f1),
        }
        torch.save(payload, directory / "resume.pt")
        self._barrier()

    def restore_resume_state(self, directory: Path | str) -> Tuple[TrainState, int, float]:
        """-> (TrainState, epoch, best_f1) from `save_resume_state`'s file,
        on a model built anew (no warm start: the file has every tensor) and
        split by this trainer's mesh row."""
        payload = torch.load(Path(directory) / "resume.pt", map_location="cpu", weights_only=False)
        state = self._fresh_state()
        state.model.load_state_dict(self._shard_state(payload["model"]), strict=True)
        opt = payload["opt_state"]
        mu, nu = self._shard_state(opt["mu"]), self._shard_state(opt["nu"])
        if set(mu) != set(state.opt_state.mu):
            raise ValueError("the resume file's optimizer state is for another set of parameters")
        state.opt_state.count = int(opt["count"])
        for name in state.opt_state.mu:
            state.opt_state.mu[name].copy_(mu[name])
            state.opt_state.nu[name].copy_(nu[name])
        state.rng.set_state(payload["rng"])
        state.step = int(payload["step"])
        return state, int(payload["epoch"]), float(payload["best_f1"])

    def save_checkpoint(self, path: Path | str, state: TrainState, val_f1: float) -> None:
        """Reference-format .pt: {"model": state_dict, "val_f1", "config"}
        (`src/train.py:1138-1144`), which `TorchModelRunner`, the JAX
        package's runner and the reference framework load.  Data parallel:
        rank 0 writes, then every rank waits for it.  Tensor parallel: the
        whole tensors."""
        if not self.is_main:
            self._barrier()
            return
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        model = self._whole_cpu(state.model.state_dict())
        torch.save(
            {"model": model, "val_f1": float(val_f1), "config": self.mc.to_checkpoint_dict()},
            path,
        )
        self._barrier()
