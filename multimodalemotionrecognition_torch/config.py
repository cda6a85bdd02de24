"""Configuration for the port.

The port's own copy of what it uses from the JAX package's `config` module:
`ModelConfig`, `TrainConfig`, `ServeConfig`, `labels_for` and the ImageNet
constants, with the same field names, defaults and environment variables, so
a checkpoint's config dict builds either package's model.
`AudioConfig`, `VideoConfig` (the preprocessing constants) and `DataConfig`
(the dataset, its splits and its loaders) are copied too.
`ServeConfig.make_mesh` builds the port's own `parallel.mesh.Mesh`.
`WavLMConfig` is copied from the JAX package's `models/wavlm.py`: a
checkpoint's `wavlm_geometry` dict builds either package's model.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

__all__ = [
    "AudioConfig",
    "DataConfig",
    "EMOTION_LABELS_4",
    "EMOTION_LABELS_8",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "ModelConfig",
    "ServeConfig",
    "TrainConfig",
    "VideoConfig",
    "WavLMConfig",
    "labels_for",
]

# 8-class RAVDESS labels (reference backend/app/config.py:35-44).
EMOTION_LABELS_8 = [
    "neutral",
    "calm",
    "happy",
    "sad",
    "angry",
    "fearful",
    "disgust",
    "surprised",
]
# 4-class grouping (reference src/data/ravdess.py:189-202, src/optimized_runtime.py:13-14).
EMOTION_LABELS_4 = ["neutral_calm", "positive", "negative", "surprise"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def labels_for(num_classes: int) -> Sequence[str]:
    if num_classes == 8:
        return EMOTION_LABELS_8
    if num_classes == 4:
        return EMOTION_LABELS_4
    raise ValueError("num_classes must be 8 or 4")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters.

    Field names/defaults mirror the reference checkpoint config
    (`src/train.py:697-720`) plus a few structural constants the reference
    hardcodes (common_dim=256 at `src/models/fusion.py:194`, audio
    embedding_dim=128 at `src/models/audio.py:161`).
    """

    num_classes: int = 8
    fusion: str = "xattn"
    use_wavlm: bool = False
    xattn_head: str = "concat"
    xattn_d_model: int = 128
    xattn_heads: int = 4
    xattn_attn_dropout: float = 0.1
    xattn_stochastic_depth: float = 0.1
    xattn_use_emotion_prior: bool = False
    xattn_emotion_prior_dim: int = 8
    xattn_emotion_prior_hidden_dim: int = 64
    xattn_emotion_prior_dropout: float = 0.1
    temporal_pooling: str = "mean"
    temporal_num_heads: int = 4
    temporal_num_layers: int = 1
    temporal_dropout: float = 0.1
    audio_n_mels: int = 64
    use_resnet_audio: bool = True
    fusion_align_mode: str = "none"
    fusion_align_dim: int = 256
    fusion_align_temperature: float = 0.07
    fusion_align_weight: float = 0.1
    # Structural constants (hardcoded in the reference model code).
    common_dim: int = 256
    audio_embedding_dim: int = 128
    wavlm_hidden_size: int = 768
    # Optional WavLMConfig field overrides (hidden_size, num_hidden_layers,
    # conv_dim, ...).  None = microsoft/wavlm-base geometry (the reference's,
    # `src/models/wavlm_audio.py:30-41`).  Saved additively in the checkpoint
    # config so non-base WavLM checkpoints reconstruct without flags.
    wavlm_geometry: Optional[Dict[str, Any]] = None
    # Train-path fused kernels for the frozen WavLM prefix (set by the
    # trainer from the freeze policy — see train/freeze.py::
    # wavlm_frozen_prefix; NOT part of the checkpoint config: it describes a
    # training run, not the architecture).  wavlm_geometry keys of the same
    # name take precedence (explicit test/user control).
    wavlm_fused_train_layers: int = 0
    wavlm_fused_train_conv: bool = False
    spec_augment: bool = True
    # Compute dtype for the forward pass ("float32" | "bfloat16"). Params stay fp32.
    compute_dtype: str = "float32"

    # --- checkpoint config interop (reference src/train.py:697-720) ---

    _CHECKPOINT_KEYS = (
        "fusion",
        "use_wavlm",
        "xattn_head",
        "xattn_d_model",
        "xattn_heads",
        "xattn_attn_dropout",
        "xattn_stochastic_depth",
        "xattn_use_emotion_prior",
        "xattn_emotion_prior_dim",
        "xattn_emotion_prior_hidden_dim",
        "xattn_emotion_prior_dropout",
        "temporal_pooling",
        "temporal_num_heads",
        "temporal_num_layers",
        "temporal_dropout",
        "audio_n_mels",
        "use_resnet_audio",
        "fusion_align_mode",
        "fusion_align_dim",
        "fusion_align_temperature",
        "fusion_align_weight",
    )

    def to_checkpoint_dict(self) -> Dict[str, Any]:
        """Serialize to the reference's checkpoint `config` dict format."""
        out = {k: getattr(self, k) for k in self._CHECKPOINT_KEYS}
        if self.wavlm_geometry is not None:  # additive, absent in reference
            out["wavlm_geometry"] = dict(self.wavlm_geometry)
        return out

    @classmethod
    def from_checkpoint_dict(
        cls, config: Mapping[str, Any], num_classes: int = 8, **overrides: Any
    ) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in dict(config).items() if k in known}
        kwargs["num_classes"] = num_classes
        kwargs.update(overrides)
        return cls(**kwargs)

    @property
    def canonical_fusion(self) -> str:
        """Resolve the `xattn_concat` / `xattn_gated` aliases (src/train.py:449-453)."""
        if self.fusion in {"xattn_concat", "xattn_gated"}:
            return "xattn"
        return self.fusion

    @property
    def resolved_xattn_head(self) -> str:
        if self.fusion == "xattn_concat":
            return "concat"
        if self.fusion == "xattn_gated":
            return "gated"
        return self.xattn_head

    @property
    def effective_audio_n_mels(self) -> int:
        """WavLM replaces n_mels with its hidden size (src/train.py:462)."""
        if self.use_wavlm:
            return int(
                (self.wavlm_geometry or {}).get("hidden_size", self.wavlm_hidden_size)
            )
        return self.audio_n_mels


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Audio preprocessing constants (reference backend/app/config.py:9-15)."""

    sample_rate: int = 16000
    duration_sec: float = 3.0
    n_mels: int = 64
    win_length: int = 400
    hop_length: int = 160
    n_fft: int = 400

    @property
    def target_len(self) -> int:
        return int(self.sample_rate * self.duration_sec)

    @property
    def num_frames(self) -> int:
        # center=True STFT framing (torchaudio semantics).
        return 1 + self.target_len // self.hop_length


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """Video preprocessing constants (reference backend/app/config.py:9-12)."""

    num_frames: int = 8
    size: int = 112
    face_crop: bool = True
    face_pad_ratio: float = 0.3


@dataclasses.dataclass(frozen=True)
class DataConfig:
    data_root: str = "data"
    num_classes: int = 8
    split_mode: str = "stratified"  # "actor" | "stratified"
    train_actors: Tuple[int, ...] = tuple(range(1, 19))
    val_actors: Tuple[int, ...] = (19, 20, 21)
    test_actors: Tuple[int, ...] = (22, 23, 24)
    train_ratio: float = 0.7
    val_ratio: float = 0.15
    seed: int = 42
    vocal_channel: int = 1
    use_wavlm: bool = False
    train_augment: bool = True
    use_face_crop: bool = True
    noise_wav: str = "data/Noise/noise.wav"
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    video: VideoConfig = dataclasses.field(default_factory=VideoConfig)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference src/train.py:473-672 defaults),
    field for field the JAX package's `TrainConfig`.

    `donate_buffers`, `remat`, `rng_impl` and `flat_optimizer` steer XLA
    (buffer donation, rematerialisation, the PRNG implementation, the
    optimizer's buffer layout).  They are kept, and validated as the JAX
    trainer validates them, so one set of settings builds either trainer,
    and they have no effect here: PyTorch frees and reuses buffers itself,
    and the optimizer runs `torch._foreach_*` passes over the trainable
    leaves.  `mesh_shape` (data, model) sets the data-parallel size over
    the ranks of a `torch.distributed` group (None or data 0: every rank)
    and the model axis: with model > 1 each rank splits the WavLM trunk
    over its row of that many devices (`parallel/tensor.py`).
    """

    epochs: int = 20
    batch_size: int = 16
    lr: float = 1e-3
    seed: int = 42
    weight_decay: float = 1e-4
    label_smoothing: float = 0.0
    early_stopping_patience: int = 10
    use_cosine_annealing: bool = False
    cosine_stage2_only: bool = False
    two_stage_training: bool = False
    stage1_epochs: int = 5
    audio_backbone_lr: float = 1e-5
    video_backbone_lr: float = 1e-5
    backbone_lr: float = 3e-5  # WavLM single-modality stage-2 backbone LR
    wavlm_stage: int = 1
    fusion_unfreeze_wavlm_layers: int = 2
    fusion_unfreeze_video_blocks: int = 1
    fusion_unfreeze_audio: bool = True
    audio_ckpt: str = ""
    video_ckpt: str = ""
    output_dir: str = "outputs"
    wandb: bool = False
    donate_buffers: bool = True
    # Video wire format between the host loader and the step: "uint8" ships
    # post-blur uint8 pixels and per-sample (brightness, noise sigma) scalars
    # and replays the float augmentation tail on the device; "float32" ships
    # host-augmented normalised frames.  The step takes either, by the
    # batch's dtype.
    video_wire: str = "auto"
    mesh_shape: Optional[Tuple[int, ...]] = None
    remat: object = False
    grad_accum: int = 1
    rng_impl: str = "auto"
    flat_optimizer: str = "auto"


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs; env var names kept from the reference
    (`src/inference_server.py:39-50`, `src/inference_worker.py:23-43`)."""

    host: str = "0.0.0.0"
    port: int = 8000
    batch_size: int = 8
    batch_timeout_ms: float = 20.0
    poll_interval_ms: float = 50.0
    predict_timeout_sec: float = 60.0
    result_ttl_sec: int = 3600
    payload_ttl_sec: int = 600
    queue_name: str = "emo:inference:queue"
    task_prefix: str = "emo:task:"
    worker_name: str = "worker-1"
    # When set, the queued API becomes a multi-host *gateway*: tasks go over
    # Redis (RPUSH/HSET, reference `src/inference_server.py:69-89`) to remote
    # RedisWorker hosts instead of the in-process batcher.
    redis_url: Optional[str] = None
    checkpoint_path: str = "checkpoints/best.pt"
    mock: bool = False
    # "float32" preserves reference logit parity; "bfloat16" for throughput.
    compute_dtype: str = "float32"
    # The whole-fusion-block kernel (`TorchModelRunner(fused=True)`) for xattn
    # checkpoints; read by `serving/server_queued.py`.
    fused_xattn: bool = False
    # uint8 video wire format with on-device normalization.
    device_normalize: bool = True
    # int16 PCM audio wire format for WavLM (lossless for 16-bit uploads).
    audio_int16_wire: bool = True
    # Fixed batch shapes for the dynamic batcher.
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    # Multi-chip inference: (data, model) mesh shape, e.g. (8, 1) to shard
    # request batches over 8 chips, or (4, 2) for 4 replicas whose WavLM
    # trunks each span 2 (`EMO_MESH_SHAPE=4,2`).  None = single device (the
    # default; matches the reference's single-device worker).
    mesh_shape: Optional[Tuple[int, int]] = None
    # Streaming (backend/app/config.py:16-19)
    stream_window_sec: float = 3.0
    stream_step_sec: float = 0.5
    stream_max_buffer_sec: float = 6.0

    @classmethod
    def from_env(cls) -> "ServeConfig":
        return cls(
            host=_env("EMO_API_HOST", "0.0.0.0"),
            port=int(_env("EMO_API_PORT", "8000")),
            batch_size=int(_env("EMO_BATCH_SIZE", "8")),
            batch_timeout_ms=float(_env("EMO_BATCH_TIMEOUT_MS", "20")),
            poll_interval_ms=float(_env("EMO_POLL_INTERVAL_MS", "50")),
            predict_timeout_sec=float(_env("EMO_PREDICT_TIMEOUT_SEC", "60")),
            result_ttl_sec=int(_env("EMO_RESULT_TTL_SEC", "3600")),
            payload_ttl_sec=int(_env("EMO_PAYLOAD_TTL_SEC", "600")),
            queue_name=_env("EMO_QUEUE_NAME", "emo:inference:queue"),
            task_prefix=_env("EMO_TASK_PREFIX", "emo:task:"),
            worker_name=_env("EMO_WORKER_NAME", "worker-1"),
            redis_url=_env("EMO_REDIS_URL", "") or None,
            checkpoint_path=_env("CHECKPOINT_PATH", "checkpoints/best.pt"),
            mock=_env("EMO_MOCK", "0") == "1",
            compute_dtype=_env("EMO_COMPUTE_DTYPE", "float32"),
            fused_xattn=_env("EMO_FUSED_XATTN", "0") == "1",
            device_normalize=_env("EMO_DEVICE_NORMALIZE", "1") == "1",
            audio_int16_wire=_env("EMO_AUDIO_INT16_WIRE", "1") == "1",
            mesh_shape=_parse_mesh_shape(_env("EMO_MESH_SHAPE", "")),
        )

    def make_mesh(self, device: Any = "cuda"):
        """The serving mesh from `mesh_shape` (None when unset): the first
        dp * tp CUDA cards, as the JAX config takes the first devices, or
        with `device="cpu"` dp * tp replicas on the CPU.  Fewer cards raise."""
        if self.mesh_shape is None:
            return None
        import torch

        from multimodalemotionrecognition_torch.parallel.mesh import make_mesh

        dp, tp = self.mesh_shape
        n = dp * tp
        if torch.device(device).type == "cpu":
            return make_mesh((dp, tp), devices=["cpu"] * n)
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise RuntimeError(f"EMO_MESH_SHAPE {dp},{tp} needs {n} CUDA cards; {count} here")
        return make_mesh((dp, tp), devices=[torch.device("cuda", i) for i in range(n)])


def _parse_mesh_shape(spec: str) -> Optional[Tuple[int, int]]:
    """"8" -> (8, 1); "4,2" / "4x2" -> (4, 2); "" -> None."""
    spec = spec.strip()
    if not spec:
        return None
    parts = [p for p in spec.replace("x", ",").split(",") if p.strip()]
    if len(parts) == 1:
        return (int(parts[0]), 1)
    if len(parts) == 2:
        return (int(parts[0]), int(parts[1]))
    raise ValueError(f"EMO_MESH_SHAPE must be 'dp' or 'dp,tp', got {spec!r}")


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """microsoft/wavlm-base hyperparameters (HF WavLMConfig defaults).

    `fused_attention` / `fused_conv` select the hand-written kernels
    (`kernels/wavlm_attn.py`, `kernels/conv_fe.py`): "auto" runs them when
    the activations are on CUDA and the modular PyTorch path otherwise; True
    always goes through the kernel wrapper (which runs the kernel's plain
    PyTorch version for CPU tensors); False is the modular path.  In a
    train-mode forward the first `fused_train_layers` encoder layers take
    the attention kernel (K1 with its in-kernel dropouts, K2 as its
    backward), and the conv kernel runs only when `fused_train_conv` says
    the feature extractor is frozen (it has no backward); the trainer sets
    both from the freeze policy.
    """

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    apply_spec_augment: bool = True
    layerdrop: float = 0.1
    fused_attention: object = "auto"
    fused_conv: object = "auto"
    fused_train_layers: int = 0
    fused_train_conv: bool = False
