"""Checkpoint evaluation (reference `src/eval.py:218-275`).

The port's copy of the JAX package's `train/eval.py`: loads a
reference-format .pt checkpoint, rebuilds the model from the embedded config
(with state-dict signature inference as the fallback), and evaluates
accuracy + macro-F1 on the actor-held-out test split, on the card unless the
caller passes `device="cpu"`.

Usage: python -m multimodalemotionrecognition_torch eval \\
         --checkpoint outputs/best_xattn.pt --data_root data
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch

from multimodalemotionrecognition_torch.config import DataConfig, ModelConfig, TrainConfig

__all__ = ["EmotionEvaluator", "load_model_from_checkpoint", "main"]


def load_model_from_checkpoint(
    checkpoint_path: str, num_classes: int = 8, device: str | torch.device = "cuda"
) -> Tuple[torch.nn.Module, ModelConfig]:
    """-> (model holding the checkpoint's weights on `device`, model_config).
    The architecture comes from the checkpoint's config dict, else from its
    key signature (`src/optimized_runtime.py:51-57`); more than 32 missing
    keys raise (`:87-94`), fewer are zeros, as in the runner."""
    from multimodalemotionrecognition_torch.convert.checkpoint import (
        checkpoint_uses_wavlm,
        infer_model_signature,
        load_reference_checkpoint,
        normalize_torch_state_dict,
    )
    from multimodalemotionrecognition_torch.models.factory import build_model

    sd, config = load_reference_checkpoint(checkpoint_path)
    sd = normalize_torch_state_dict(sd)
    if "fusion" in config:
        model_config = ModelConfig.from_checkpoint_dict(config, num_classes=num_classes)
    else:
        fusion, head = infer_model_signature(sd)
        model_config = ModelConfig(
            num_classes=num_classes,
            fusion=fusion,
            xattn_head=head,
            use_wavlm=checkpoint_uses_wavlm(sd),
        )

    model = build_model(model_config, device=device)
    missing, _unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if len(missing) > 32:
        raise RuntimeError(f"Too many missing keys when loading checkpoint ({len(missing)}).")
    state = model.state_dict()
    with torch.no_grad():
        for key in missing:
            state[key].zero_()
    return model, model_config


class EmotionEvaluator:
    def __init__(self, checkpoint: str, data_config: DataConfig, device: str | torch.device = "cuda"):
        self.checkpoint = checkpoint
        self.dc = data_config
        self.device = device

    def run(self) -> Dict[str, float]:
        from multimodalemotionrecognition_torch.data.pipeline import build_loaders
        from multimodalemotionrecognition_torch.ops.stochastic import RngStreams
        from multimodalemotionrecognition_torch.train.trainer import (
            AdamState,
            EmotionTrainer,
            TrainState,
        )

        model, model_config = load_model_from_checkpoint(
            self.checkpoint, num_classes=self.dc.num_classes, device=self.device
        )
        train_config = TrainConfig()
        trainer = EmotionTrainer(model_config, train_config, device=self.device)
        trainer.model = model
        state = TrainState(
            model=model, opt_state=AdamState.zeros({}),
            rng=RngStreams(train_config.seed, trainer.device),
        )
        from multimodalemotionrecognition_torch.parallel.distributed import rank, world_size

        # Inside a process group the trainer evaluates data parallel: each
        # rank decodes its rows and the metrics are the global ones.
        _, _, test_loader = build_loaders(self.dc, batch_size=16, rank=rank(), world=world_size())
        _, metrics = trainer.run_epoch(state, test_loader, train=False)
        if rank() == 0:
            print(f"Test accuracy: {metrics['acc']:.4f} | macro-F1: {metrics['f1']:.4f}")
        return metrics


def main(argv=None, device="cuda") -> Dict[str, float]:
    p = argparse.ArgumentParser(prog="eval")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--num_classes", type=int, default=8, choices=[4, 8])
    p.add_argument("--test_actors", type=str, default="22,23,24")
    args = p.parse_args(argv)
    # Only the test actors: with DataConfig's default train actors (1-18) a
    # test actor among them would land in the train split and leave the
    # test split empty, as it does in the JAX package's `main`.
    dc = DataConfig(
        data_root=args.data_root,
        num_classes=args.num_classes,
        split_mode="actor",
        train_actors=(),
        val_actors=(),
        test_actors=tuple(int(x) for x in args.test_actors.split(",")),
    )
    return EmotionEvaluator(args.checkpoint, dc, device=device).run()


if __name__ == "__main__":
    main()
