"""Faults planted under the timed path, to show that `correct` catches them.

Each is a context manager that patches the port while a run is driven:

  * `unchanged`: the optimizer step returns the state unchanged;
  * `half_batch`: a train step sees only the first half of its rows (the
    mean is taken over them);
  * `stale_batch`: the trainer stages the first batch it is given again for
    every later one, as a staging buffer reused too early would;
  * `altered`: the runner's answer for the first row of every batch is
    altered where it is produced (its probabilities reversed).

The benchmark's own runs never plant one; `calibrate.py` and the tests do.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def unchanged():
    from multimodalemotionrecognition_torch.train import trainer

    def make(original):
        def step(opt_state, *args, **kwargs):
            return None
        return step

    return _patched(trainer, "masked_adam_update", make)


def half_batch():
    from multimodalemotionrecognition_torch.train.trainer import EmotionTrainer

    def make(original):
        def loss_and_grads(self, state, video, audio_wav, labels, valid, mask, aug=None):
            n = video.shape[0] // 2
            *losses, preds = original(self, state, video[:n], audio_wav[:n], labels[:n],
                                      valid[:n], mask, None if aug is None else aug[:n])
            return (*losses, preds.repeat(2))  # a prediction per row, as the epoch expects
        return loss_and_grads

    return _patched(EmotionTrainer, "loss_and_grads", make)


def stale_batch():
    from multimodalemotionrecognition_torch.train.trainer import EmotionTrainer

    def make(original):
        first = []

        def stage(self, batch):
            if not first:
                first.append(original(self, batch))
            return first[0]
        return stage

    return _patched(EmotionTrainer, "_stage_batch", make)


def altered():
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

    def make(original):
        def predict(self, *args, **kwargs):
            probs = original(self, *args, **kwargs).copy()
            probs[0] = probs[0][::-1]
            return probs
        return predict

    return _patched(TorchModelRunner, "predict_probs_blank_video", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "stale_batch": stale_batch,
          "altered": altered}
BY_DRIVER = {"train": ("unchanged", "half_batch", "stale_batch"), "serve": ("altered",)}
