"""Training CLI with the reference's flag surface
(`src/train.py:473-672`) mapped onto the unified config schema.

The port's copy of the JAX package's `train/cli.py`: the same flags,
defaults and configs.  `--video_wire auto` is uint8 when the trainer runs
on the card and float32 on the CPU.

Data parallelism: `--batch_size` is the global batch.  Inside a torchrun
group (`maybe_initialize_distributed`, the same `[INFO]` line as JAX's)
every rank trains its share, and `--mesh_data N` must be the group's size
(0: all ranks).  Started alone, `--mesh_data N` above 1 spawns N ranks on
N cards (NCCL; on the CPU, N Gloo ranks) through `parallel.launch`, so the
JAX command line runs unchanged; fewer cards raise.

Tensor parallelism: `--mesh_data D --mesh_model M` trains on a (D, M)
mesh: D ranks (one process when D is 1), each splitting the WavLM trunk
over a row of M cards (`parallel/tensor.py`); rank r takes cards r * M ..
r * M + M - 1, so the run needs D * M cards and fewer raise (on the CPU,
M CPU devices a rank).  Under torchrun each rank's row starts at card
LOCAL_RANK * M.  As in the JAX package's config, `--mesh_model` takes
effect with `--mesh_data` set (0 puts every device on "data").

Usage: python -m multimodalemotionrecognition_torch train --data_root data \
         --fusion xattn --use_wavlm --two_stage_training --use_cosine_annealing
       torchrun --nproc_per_node 2 -m multimodalemotionrecognition_torch train \
         --mesh_data 2 --data_root data --fusion xattn --use_wavlm --two_stage_training
       python -m multimodalemotionrecognition_torch train --mesh_data 1 --mesh_model 2 \
         --data_root data --fusion xattn --use_wavlm --two_stage_training
"""

from __future__ import annotations

import argparse
import sys

import torch

from multimodalemotionrecognition_torch.config import (
    DataConfig,
    ModelConfig,
    TrainConfig,
    VideoConfig,
)

__all__ = ["build_arg_parser", "configs_from_args", "main", "resolve_video_wire"]


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Emotion recognition trainer (PyTorch port)")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--num_classes", type=int, default=8, choices=[4, 8])
    p.add_argument(
        "--fusion",
        type=str,
        default="audio",
        choices=[
            "audio", "video", "late", "concat", "gated",
            "xattn", "xattn_concat", "xattn_gated",
        ],
    )
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--img_size", type=int, default=112)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--split_mode", type=str, default="stratified", choices=["actor", "stratified"])
    p.add_argument("--train_actors", type=str, default=",".join(map(str, range(1, 19))))
    p.add_argument("--val_actors", type=str, default="19,20,21")
    p.add_argument("--test_actors", type=str, default="22,23,24")
    p.add_argument("--train_ratio", type=float, default=0.7)
    p.add_argument("--val_ratio", type=float, default=0.15)
    p.add_argument("--use_cosine_annealing", action="store_true")
    p.add_argument("--cosine_stage2_only", action="store_true")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--xattn_head", type=str, choices=["concat", "gated"], default="concat")
    p.add_argument("--xattn_d_model", type=int, default=128)
    p.add_argument("--xattn_heads", type=int, default=4)
    p.add_argument("--xattn_attn_dropout", type=float, default=0.1)
    p.add_argument("--xattn_stochastic_depth", type=float, default=0.1)
    p.add_argument("--xattn_use_emotion_prior", action="store_true")
    p.add_argument("--xattn_emotion_prior_dim", type=int, default=8)
    p.add_argument("--xattn_emotion_prior_hidden_dim", type=int, default=64)
    p.add_argument("--xattn_emotion_prior_dropout", type=float, default=0.1)
    p.add_argument("--temporal_pooling", type=str, default="mean", choices=["mean", "attn", "transformer"])
    p.add_argument("--temporal_num_heads", type=int, default=4)
    p.add_argument("--temporal_num_layers", type=int, default=1)
    p.add_argument("--temporal_dropout", type=float, default=0.1)
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--audio_n_mels", type=int, default=64)
    p.add_argument("--fusion_align_mode", type=str, default="none", choices=["none", "clip"])
    p.add_argument("--fusion_align_dim", type=int, default=256)
    p.add_argument("--fusion_align_temperature", type=float, default=0.07)
    p.add_argument("--fusion_align_weight", type=float, default=0.1)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--early_stopping_patience", type=int, default=10)
    p.add_argument("--use_resnet_audio", action="store_true")
    p.add_argument("--two_stage_training", action="store_true")
    p.add_argument("--use_wavlm", action="store_true")
    p.add_argument("--wavlm_stage", type=int, default=1, choices=[1, 2])
    p.add_argument("--backbone_lr", type=float, default=3e-5)
    p.add_argument("--stage1_epochs", type=int, default=5)
    p.add_argument("--audio_backbone_lr", type=float, default=1e-5)
    p.add_argument("--video_backbone_lr", type=float, default=1e-5)
    p.add_argument("--fusion_unfreeze_wavlm_layers", type=int, default=2)
    p.add_argument("--fusion_unfreeze_video_blocks", type=int, default=1)
    p.add_argument("--fusion_unfreeze_audio", action="store_true", default=True)
    p.add_argument("--no_fusion_unfreeze_audio", dest="fusion_unfreeze_audio", action="store_false")
    p.add_argument("--audio_ckpt", type=str, default="")
    p.add_argument("--video_ckpt", type=str, default="")
    p.add_argument("--use_face_crop", action="store_true", default=True)
    p.add_argument("--no_face_crop", dest="use_face_crop", action="store_false")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument(
        "--video_wire", type=str, default="auto",
        choices=["auto", "uint8", "float32"],
        help="host->device video format: uint8 = post-blur pixels + "
        "on-device augment tail (4x less transfer); auto = uint8 on the card",
    )
    p.add_argument("--mesh_data", type=int, default=0, help="data-parallel mesh size (0 = all devices)")
    p.add_argument("--mesh_model", type=int, default=1, help="tensor-parallel mesh size")
    p.add_argument(
        "--num_workers",
        type=int,
        default=-1,
        help="decode threads (-1: auto = min(8, max(2, cpus//2)); reference "
        "src/train.py:45-73 policy, threads instead of worker processes)",
    )
    return p


def _actors(text: str):
    return tuple(int(x) for x in text.split(",")) if text else ()


def configs_from_args(args: argparse.Namespace):
    model = ModelConfig(
        num_classes=args.num_classes,
        fusion=args.fusion,
        use_wavlm=args.use_wavlm,
        xattn_head=args.xattn_head,
        xattn_d_model=args.xattn_d_model,
        xattn_heads=args.xattn_heads,
        xattn_attn_dropout=args.xattn_attn_dropout,
        xattn_stochastic_depth=args.xattn_stochastic_depth,
        xattn_use_emotion_prior=args.xattn_use_emotion_prior,
        xattn_emotion_prior_dim=args.xattn_emotion_prior_dim,
        xattn_emotion_prior_hidden_dim=args.xattn_emotion_prior_hidden_dim,
        xattn_emotion_prior_dropout=args.xattn_emotion_prior_dropout,
        temporal_pooling=args.temporal_pooling,
        temporal_num_heads=args.temporal_num_heads,
        temporal_num_layers=args.temporal_num_layers,
        temporal_dropout=args.temporal_dropout,
        audio_n_mels=args.audio_n_mels,
        use_resnet_audio=args.use_resnet_audio,
        fusion_align_mode=args.fusion_align_mode,
        fusion_align_dim=args.fusion_align_dim,
        fusion_align_temperature=args.fusion_align_temperature,
        fusion_align_weight=args.fusion_align_weight,
        compute_dtype=args.compute_dtype,
    )
    train = TrainConfig(
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        seed=args.seed,
        weight_decay=args.weight_decay,
        label_smoothing=args.label_smoothing,
        early_stopping_patience=args.early_stopping_patience,
        use_cosine_annealing=args.use_cosine_annealing,
        cosine_stage2_only=args.cosine_stage2_only,
        two_stage_training=args.two_stage_training,
        stage1_epochs=args.stage1_epochs,
        audio_backbone_lr=args.audio_backbone_lr,
        video_backbone_lr=args.video_backbone_lr,
        backbone_lr=args.backbone_lr,
        wavlm_stage=args.wavlm_stage,
        fusion_unfreeze_wavlm_layers=args.fusion_unfreeze_wavlm_layers,
        fusion_unfreeze_video_blocks=args.fusion_unfreeze_video_blocks,
        fusion_unfreeze_audio=args.fusion_unfreeze_audio,
        audio_ckpt=args.audio_ckpt,
        video_ckpt=args.video_ckpt,
        output_dir=args.output_dir,
        wandb=args.wandb,
        mesh_shape=(args.mesh_data, args.mesh_model) if args.mesh_data else None,
        video_wire=args.video_wire,
    )
    data = DataConfig(
        data_root=args.data_root,
        num_classes=args.num_classes,
        split_mode=args.split_mode,
        train_actors=_actors(args.train_actors),
        val_actors=_actors(args.val_actors),
        test_actors=_actors(args.test_actors),
        train_ratio=args.train_ratio,
        val_ratio=args.val_ratio,
        seed=args.seed,
        use_wavlm=args.use_wavlm,
        use_face_crop=args.use_face_crop,
        video=VideoConfig(num_frames=args.frames, size=args.img_size),
    )
    return model, train, data


def resolve_video_wire(wire: str, device) -> str:
    """`--video_wire`: "auto" is uint8 on the card, float32 on the CPU."""
    if wire != "auto":
        return wire
    return "uint8" if torch.device(device).type == "cuda" else "float32"


def _rank_main(rank, world, device, argv):
    """One rank that `main` spawned: the group is up, so `main` trains this
    rank's share (on its device, or its mesh row)."""
    return main(argv, device=device)


def _rows(dp: int, tp: int, device) -> list:
    """The mesh rows of `dp` ranks of `tp` devices each: cards r * tp ..
    r * tp + tp - 1, or the CPU; fewer cards raise."""
    if device.type != "cuda":
        return [(torch.device("cpu"),) * tp for _ in range(dp)]
    count = torch.cuda.device_count()
    if dp * tp > count:
        raise RuntimeError(f"a ({dp}, {tp}) mesh needs {dp * tp} CUDA cards; {count} here")
    return [tuple(torch.device("cuda", r * tp + i) for i in range(tp)) for r in range(dp)]


def main(argv=None, device="cuda"):
    """Train from the command line on `device` (the card unless the caller
    passes "cpu"; a rank that `main` spawned gets its mesh row).  ->
    `EmotionTrainer.fit`'s result (rank 0's when `main` spawned the ranks)."""
    args = build_arg_parser().parse_args(argv)
    model_cfg, train_cfg, data_cfg = configs_from_args(args)

    from multimodalemotionrecognition_torch.parallel.distributed import (
        launch,
        local_device,
        maybe_initialize_distributed,
        rank,
        world_size,
    )
    from multimodalemotionrecognition_torch.utils.device import require_device

    tp = (train_cfg.mesh_shape or (0, 1))[1]
    row = tuple(device) if isinstance(device, (list, tuple)) else None
    device = require_device(row[0] if row else device, "train")
    if maybe_initialize_distributed(device_type=device.type):
        print(
            f"[INFO] multi-host: process {rank()}/{world_size()}, "
            f"{world_size()} global devices"
        )
        if args.mesh_data not in (0, world_size()):
            raise ValueError(f"--mesh_data {args.mesh_data} in a group of {world_size()} ranks")
        if device.type == "cuda" and device.index is None:
            device = local_device("cuda")
    elif args.mesh_data > 1:
        n = args.mesh_data
        rows = _rows(n, tp, device)
        devices = rows if tp > 1 else [r[0] for r in rows]
        backend = "nccl" if device.type == "cuda" else "gloo"
        argv = list(sys.argv[1:] if argv is None else argv)
        return launch(_rank_main, n, backend, devices, args=(argv,), timeout_s=7 * 24 * 3600.0)[0]

    from multimodalemotionrecognition_torch.data.pipeline import build_loaders
    from multimodalemotionrecognition_torch.train.trainer import EmotionTrainer

    main_rank = rank() == 0
    wire = resolve_video_wire(train_cfg.video_wire, device)
    train_loader, val_loader, test_loader = build_loaders(
        data_cfg, train_cfg.batch_size, num_workers=args.num_workers, wire=wire,
        rank=rank(), world=world_size(), microbatches=train_cfg.grad_accum,
    )
    if main_rank:
        print(
            f"Train pairs: {train_loader.num_samples} | "
            f"Val pairs: {val_loader.num_samples} | Test pairs: {test_loader.num_samples}"
        )

    log_fn = None
    if train_cfg.wandb and main_rank:
        try:
            import wandb

            wandb.init(
                project="multimodal-emotion-recognition",
                name=f"{model_cfg.fusion}_epochs{train_cfg.epochs}_bs{train_cfg.batch_size}_{data_cfg.split_mode}",
                config=model_cfg.to_checkpoint_dict(),
            )
            log_fn = wandb.log
        except ImportError:
            print("[WARNING] wandb not installed; falling back to JSONL metrics log.")

    # Alone or under torchrun with tp > 1, the trainer takes `local_row(tp)`.
    trainer = EmotionTrainer(model_cfg, train_cfg, device=row or device)
    _, result = trainer.fit(train_loader, val_loader, test_loader, log_fn=log_fn)
    if main_rank:
        print(
            f"Best val macro-F1: {result['best_val_f1']:.4f} | checkpoint: "
            f"{train_cfg.output_dir}/best_{model_cfg.fusion}.pt"
        )
    return result


if __name__ == "__main__":
    main()
