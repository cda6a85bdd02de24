"""Training harness: two-stage finetuning on one CUDA device.

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
kernel; see `kernels/wavlm_attn.py`, `kernels/conv_fe.py`.

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

Not ported yet: W&B logging (`TrainConfig.wandb`), the CLI and the data
pipeline that feeds `fit` (ROADMAP queue 1, "`data/`" and "`train/eval.py`,
`train/cli.py`").
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
from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram
from multimodalemotionrecognition_torch.ops.stochastic import RngStreams
from multimodalemotionrecognition_torch.train.freeze import (
    cosine_factor,
    lr_tree,
    trainable_mask,
    wavlm_frozen_prefix,
)
from multimodalemotionrecognition_torch.utils.device import require_device
from multimodalemotionrecognition_torch.utils.metrics import (
    accuracy,
    confusion_matrix,
    macro_f1,
)
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
        device: str | torch.device = "cuda",
    ):
        self.device = require_device(device, "EmotionTrainer")
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
        self.is_single_modality = model_config.fusion in {"audio", "video"}
        self.model: Optional[torch.nn.Module] = None
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
                normalize_torch_state_dict(sd), strict=False
            )
            counted = lambda keys: sum(not k.endswith("num_batches_tracked") for k in keys)  # noqa: E731
            report[branch] = (counted(result.missing_keys), counted(result.unexpected_keys))
            print(
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
                v = v + sigma * torch.randn(v.shape, generator=generator, device=v.device)
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
        microbatch draws its own dropout masks from the step's streams."""
        accum = self.tc.grad_accum
        bsz = video.shape[0]
        if bsz % accum:
            raise ValueError(f"batch size {bsz} not divisible by grad_accum {accum}")
        self._set_trainable(mask)
        self.model.zero_grad(set_to_none=True)
        mb = bsz // accum
        denom = valid.float().sum().clamp_min(1.0)
        a_w = self._align_weight()
        cls_loss = contrastive = None
        preds = []
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            mv = self._device_video(
                video[rows], None if aug is None else aug[rows], state.rng.device("videoaug")
            )
            out, aux = self._apply(mv, self._audio_features(audio_wav[rows]), True, state.rng)
            _, cls_i, ctr_i = self._losses(out, aux, labels[rows], valid[rows], denom)
            (cls_i + a_w * ctr_i / accum).backward()
            cls_i, ctr_i = cls_i.detach(), ctr_i.detach() / accum
            cls_loss = cls_i if cls_loss is None else cls_loss + cls_i
            contrastive = ctr_i if contrastive is None else contrastive + ctr_i
            preds.append(out.detach().argmax(dim=1))
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
        live = {n: p for n, p in state.model.named_parameters() if n in state.opt_state.mu}
        masked_adam_update(
            state.opt_state, live, {n: p.grad for n, p in live.items()}, mask, lrs,
            reset_opt, self.tc.weight_decay,
        )
        state.step += 1
        return out

    @torch.no_grad()
    def eval_step(self, state: TrainState, video, audio_wav, labels, valid, aug=None):
        video = self._device_video(video, aug, None)
        outputs, aux = self._apply(video, self._audio_features(audio_wav), False, None)
        total, cls_loss, contrastive = self._losses(outputs, aux, labels, valid)
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

    def _stage_batch(self, batch):
        """Host arrays -> device tensors.  On CUDA the copies go from pinned
        memory on a side stream without blocking; the event marks their end."""
        arrays = {"video": batch.video, "audio": batch.audio, "labels": batch.labels,
                  "valid": batch.valid}
        if batch.aug is not None:
            arrays["aug"] = batch.aug
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
        if self._copy_stream is None:
            return tensors, None
        with torch.cuda.stream(self._copy_stream):
            tensors = {
                k: t.pin_memory().to(self.device, non_blocking=True) for k, t in tensors.items()
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
        waits for the device between steps."""
        totals_dev, preds_dev = [], []
        sizes, valids, labels_list = [], [], []
        first = True
        it = iter(loader)
        batch = next(it, None)
        staged = self._stage_batch(batch) if batch is not None else None
        while batch is not None:
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
            batch = next(it, None)
            staged = self._stage_batch(batch) if batch is not None else None

        totals = np.zeros(3)
        n = 0
        all_preds, all_labels = [], []
        if totals_dev:
            fetched = torch.stack(totals_dev).double().cpu().numpy()  # the one sync per epoch
            preds_host = torch.cat(preds_dev).cpu().numpy()
            offset = 0
            for row, bs, valid_np, labels in zip(fetched, sizes, valids, labels_list):
                totals += row * bs
                n += bs
                all_preds.append(preds_host[offset:offset + len(valid_np)][valid_np])
                all_labels.append(labels[valid_np])
                offset += len(valid_np)
        preds = np.concatenate(all_preds) if all_preds else np.zeros(0)
        labels = np.concatenate(all_labels) if all_labels else np.zeros(0)
        metrics = {
            "loss": totals[0] / max(n, 1),
            "cls_loss": totals[1] / max(n, 1),
            "contrastive_loss": totals[2] / max(n, 1),
            "acc": accuracy(preds, labels),
            "f1": macro_f1(preds, labels),
        }
        return state, metrics

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
                print(f"[INFO] Switched to stage-2 at epoch {epoch}.")

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
            print(
                f"Epoch {epoch:02d} | stage {current_stage or '-'} | "
                f"train loss {train_m['loss']:.4f} acc {train_m['acc']:.4f} "
                f"f1 {train_m['f1']:.4f} | val loss {val_m['loss']:.4f} "
                f"acc {val_m['acc']:.4f} f1 {val_m['f1']:.4f} | {dt:.1f}s"
            )
            if log_fn:
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
                    print(
                        f"\nEarly stopping triggered! No improvement for "
                        f"{self.tc.early_stopping_patience} epochs."
                    )
                    break

        result: Dict[str, Any] = {"best_val_f1": best_f1, "history": history}
        if test_loader is not None and getattr(test_loader, "num_samples", 1) > 0:
            _, test_m = self.run_epoch(state, test_loader, False)
            result["test"] = test_m
            print(
                f"Test | loss {test_m['loss']:.4f} acc {test_m['acc']:.4f} f1 {test_m['f1']:.4f}"
            )
            # Test confusion matrix (the reference plots it to W&B,
            # `src/train.py:304-326,1186-1197`): saved as CSV, and PNG.
            try:
                cm = self._test_confusion_matrix(state, test_loader)
                self._save_confusion_matrix(cm, out_dir)
                result["confusion_matrix"] = cm.tolist()
            except Exception as exc:  # plotting must never kill a run
                print(f"[WARNING] confusion matrix failed: {exc}")
        out_dir.mkdir(parents=True, exist_ok=True)
        with (out_dir / "metrics.jsonl").open("w") as f:
            for row in history:
                f.write(json.dumps(row) + "\n")
        return state, result

    def _test_confusion_matrix(self, state: TrainState, loader) -> np.ndarray:
        """Eval predictions over `loader` -> [num_classes, num_classes]
        counts, rows the true class, valid samples only."""
        preds, labels = [], []
        for batch in loader:
            sb, event = self._stage_batch(batch)
            if event is not None:
                torch.cuda.current_stream(self.device).wait_event(event)
                for t in sb.values():
                    t.record_stream(torch.cuda.current_stream(self.device))
            *_, p = self.eval_step(state, sb["video"], sb["audio"], sb["labels"], sb["valid"])
            valid_np = np.asarray(batch.valid)
            preds.append(p.cpu().numpy()[valid_np])
            labels.append(np.asarray(batch.labels)[valid_np])
        return confusion_matrix(
            np.concatenate(preds), np.concatenate(labels), self.mc.num_classes
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

    def save_resume_state(
        self, directory: Path | str, state: TrainState, epoch: int, best_f1: float
    ) -> None:
        """Everything a run needs to go on where it stopped, as one
        `torch.save` file `directory/resume.pt` (the JAX trainer writes an
        orbax tree): the model's parameters and buffers, the Adam count and
        moments, the state of every generator of `RngStreams` (device and
        host), step, epoch and best F1."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
        payload = {
            "model": cpu(state.model.state_dict()),
            "opt_state": {"count": state.opt_state.count, "mu": cpu(state.opt_state.mu),
                          "nu": cpu(state.opt_state.nu)},
            "rng": state.rng.get_state(),
            "step": int(state.step),
            "epoch": int(epoch),
            "best_f1": float(best_f1),
        }
        torch.save(payload, directory / "resume.pt")

    def restore_resume_state(self, directory: Path | str) -> Tuple[TrainState, int, float]:
        """-> (TrainState, epoch, best_f1) from `save_resume_state`'s file,
        on a model built anew (no warm start: the file has every tensor)."""
        payload = torch.load(Path(directory) / "resume.pt", map_location="cpu", weights_only=False)
        state = self._fresh_state()
        state.model.load_state_dict(payload["model"], strict=True)
        opt = payload["opt_state"]
        if set(opt["mu"]) != set(state.opt_state.mu):
            raise ValueError("the resume file's optimizer state is for another set of parameters")
        state.opt_state.count = int(opt["count"])
        for name in state.opt_state.mu:
            state.opt_state.mu[name].copy_(opt["mu"][name])
            state.opt_state.nu[name].copy_(opt["nu"][name])
        state.rng.set_state(payload["rng"])
        state.step = int(payload["step"])
        return state, int(payload["epoch"]), float(payload["best_f1"])

    def save_checkpoint(self, path: Path | str, state: TrainState, val_f1: float) -> None:
        """Reference-format .pt: {"model": state_dict, "val_f1", "config"}
        (`src/train.py:1138-1144`), which `TorchModelRunner`, the JAX
        package's runner and the reference framework load."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        model = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        torch.save(
            {"model": model, "val_f1": float(val_f1), "config": self.mc.to_checkpoint_dict()},
            path,
        )
