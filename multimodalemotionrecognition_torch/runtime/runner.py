"""Inference runner: checkpoint -> bucketed `predict_probs` on one device.

Counterpart of the JAX package's `runtime/runner.py::JaxModelRunner`, with
the duck-typed contract that `serving/batcher.py` relies on:
`predict_probs`, `predict_probs_blank_video`, `stage`, `stage_audio`,
`labels`, `use_wavlm`, `device_normalize`, `fusion_mode`, `warmup`.

  * The model comes from the checkpoint's embedded config, falling back to
    state-dict signature inference (reference `src/optimized_runtime.py:51-57`),
    with the same guard: more than 32 missing keys raise.
  * Each request batch is padded up to the nearest bucket of
    `batch_buckets`, so the device sees a few fixed shapes.
  * Wires: uint8 video normalised on the device (`device_normalize`), and
    int16 PCM audio dequantised on the device.
  * One CUDA stream: `stage` (the host->device copy, started without
    waiting) and the forward run on the stream the runner was made on,
    whichever thread calls them, so a copy staged on one thread is ordered
    before the forward another thread runs on it (`serving/batcher.py`).
  * float32 or bfloat16 compute (the model's weights are cast once).
  * `quantize_int8=True`: weight-only int8 for the `nn.Linear` matrices
    (`runtime/quant.py`), stored int8 on the device and dequantised where
    they are used.
  * `fused=True`: everything between the two towers and the logits runs in
    one call of the whole-fusion-block kernel (`runtime/fused.py`, K4); with
    `quantize_int8` the block's matrices stay int8 and K4 dequantises them.
    A model the kernel does not take (not xattn, or the transformer pooler)
    raises `ValueError`: no quiet modular path (the JAX runner warns and
    serves the modular one).
  * Every mode of `build_model` is served: with `use_wavlm` false the audio
    input is a log-mel spectrogram [B, 1, n_mels, 301]; the `audio` and
    `video` modes run single-input forwards (the bucket follows the audio
    batch in `audio` mode); `late` already returns probabilities and is not
    softmaxed again.

No fallback: `device="cuda"` on a host without CUDA raises, and so does a
kernel that does not build or launch.  `mesh` and `donate` are not ported
yet and raise `NotImplementedError`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from pathlib import Path
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multimodalemotionrecognition_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ModelConfig,
    labels_for,
)
from multimodalemotionrecognition_torch.convert.checkpoint import (
    checkpoint_uses_wavlm,
    infer_model_signature,
    load_reference_checkpoint,
    normalize_torch_state_dict,
)
from multimodalemotionrecognition_torch.models.factory import build_model
from multimodalemotionrecognition_torch.runtime.fused import (
    build_fused_xattn_forward,
    supports_fused,
)
from multimodalemotionrecognition_torch.runtime.quant import quantize_linears_int8
from multimodalemotionrecognition_torch.utils.device import require_device

__all__ = ["ProbsForward", "TorchModelRunner"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FRAMES, _FRAME_SIZE, _SAMPLES, _MEL_FRAMES = 8, 112, 48000, 301


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1] * (-(-n // buckets[-1]))  # multiples of the largest bucket


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """Zero rows appended up to `rows` (the bucket size)."""
    if arr.shape[0] == rows:
        return arr
    return np.concatenate([arr, np.zeros((rows - arr.shape[0],) + arr.shape[1:], arr.dtype)])


def _host_audio(audios) -> np.ndarray:
    """int16 PCM stays int16 (dequantised on the device); anything else is float32."""
    audios = np.asarray(audios)
    return audios if audios.dtype == np.int16 else audios.astype(np.float32)


class ProbsForward(nn.Module):
    """The runner's forward as a module that owns the model: the wires
    (uint8 video normalised, int16 PCM dequantised), the cast to the
    compute dtype, the model (or K4's fused forward) and the softmax.
    `runtime/export.py` exports it."""

    def __init__(self, model: nn.Module, fusion_mode: str, dtype: torch.dtype,
                 fused_forward=None):
        super().__init__()
        self.model = model
        self.fusion_mode = fusion_mode
        self.dtype = dtype
        self.fused_forward = fused_forward
        device = next(model.parameters()).device
        for name, values in (("mean", IMAGENET_MEAN), ("std", IMAGENET_STD)):
            self.register_buffer(name, torch.tensor(values, device=device).view(1, 1, 3, 1, 1),
                                 persistent=False)

    def forward(self, video: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        if audio.dtype == torch.int16:
            # int16 PCM wire (lossless for 16-bit uploads), dequantised here.
            audio = audio.float() / 32768.0
        if video.dtype == torch.uint8:
            video = (video.float() / 255.0 - self.mean) / self.std
        video, audio = video.to(self.dtype), audio.to(self.dtype)
        if self.fused_forward is not None:
            return self.fused_forward(video, audio)
        if self.fusion_mode == "audio":
            out = self.model(audio)
        elif self.fusion_mode == "video":
            out = self.model(video)
        else:
            out = self.model(video, audio)
        # Late fusion already returns probabilities (`src/optimized_runtime.py:107`).
        if self.fusion_mode == "late":
            return out.float()
        return torch.softmax(out.float(), dim=1)


class TorchModelRunner:
    def __init__(
        self,
        checkpoint_path: str | Path,
        fallback_fusion: str = "xattn",
        num_classes: Optional[int] = None,
        batch_buckets: Sequence[int] = (1, 2, 4, 8),
        compute_dtype: str = "float32",
        quantize_int8: bool = False,
        fused: bool = False,
        device_normalize: bool = False,
        donate: bool = False,
        mesh: Optional[Any] = None,
        fused_wavlm: Any = "auto",
        device: str | torch.device = "cuda",
    ):
        for name, value in (("donate", donate), ("mesh", mesh)):
            if value:
                raise NotImplementedError(
                    f"TorchModelRunner({name}=...) is not ported yet (ROADMAP queue 1, item 7)"
                )
        self.device = require_device(device, "TorchModelRunner")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"Unsupported compute dtype: {compute_dtype}")
        self.dtype = _DTYPES[compute_dtype]

        sd, config = load_reference_checkpoint(checkpoint_path)
        sd = normalize_torch_state_dict(sd)
        self.config = config
        if "fusion" in config:
            fusion = str(config.get("fusion", fallback_fusion))
            xattn_head = str(config.get("xattn_head", "concat"))
        else:
            fusion, xattn_head = infer_model_signature(sd)
            # Env overrides for config-less checkpoints (reference
            # backend/app/model_loader.py:198-205).
            fusion = os.environ.get("MODEL_FUSION", fusion)
            xattn_head = os.environ.get("MODEL_XATTN_HEAD", xattn_head)
        self.fusion_mode = fusion
        self.num_classes = int(
            num_classes if num_classes is not None else config.get("num_classes", 8)
        )
        self.use_wavlm = bool(config.get("use_wavlm", checkpoint_uses_wavlm(sd)))
        self.labels = list(labels_for(self.num_classes))
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.device_normalize = device_normalize

        model_config = ModelConfig.from_checkpoint_dict(
            {**config, "fusion": fusion, "xattn_head": xattn_head},
            num_classes=self.num_classes,
            use_wavlm=self.use_wavlm,
            compute_dtype=compute_dtype,
            spec_augment=False,
        )
        if fused_wavlm != "auto":
            geometry = dict(model_config.wavlm_geometry or {})
            geometry["fused_attention"] = geometry["fused_conv"] = fused_wavlm
            model_config = dataclasses.replace(model_config, wavlm_geometry=geometry)
        self.model_config = model_config
        if fused and not supports_fused(model_config):
            raise ValueError(
                "TorchModelRunner(fused=True) takes an xattn model with mean or attn "
                f"pooling, not fusion={model_config.canonical_fusion!r} with "
                f"temporal_pooling={model_config.temporal_pooling!r}"
            )
        self.model = build_model(model_config, device=self.device)

        missing, _unexpected = self.model.load_state_dict(sd, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if len(missing) > 32:
            raise RuntimeError(
                f"Too many missing keys when loading checkpoint ({len(missing)}). "
                "Checkpoint architecture does not match the runtime model."
            )
        # Tolerated missing leaves are zeros, as in the JAX runner.
        state = self.model.state_dict()
        with torch.no_grad():
            for key in missing:
                state[key].zero_()
        # Quantise from the float32 weights; K4's operands (float32 or int8)
        # are taken before the model is cast to the compute dtype, as the
        # kernel computes in float32 whatever the towers' dtype.
        self.quantized = quantize_linears_int8(self.model) if quantize_int8 else {}
        self._fused_forward = None
        if fused:
            self._fused_forward = build_fused_xattn_forward(self.model, model_config)
        self.model.to(self.dtype)
        if self.use_wavlm and fusion != "video":
            encoder = self.model if fusion == "audio" else self.model.audio_model
            encoder.wavlm.cache_kernel_operands()
        self._stream = (
            torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        )
        self.forward_module = ProbsForward(self.model, fusion, self.dtype, self._fused_forward)
        self._mean, self._std = self.forward_module.mean, self.forward_module.std

    # ------------------------------------------------------------------

    def _example_inputs(self, batch: int) -> Tuple[np.ndarray, np.ndarray]:
        video_dtype = np.uint8 if self.device_normalize else np.float32
        video = np.zeros((batch, _FRAMES, 3, _FRAME_SIZE, _FRAME_SIZE), video_dtype)
        if self.use_wavlm:
            audio = np.zeros((batch, 1, _SAMPLES), np.float32)
        else:
            audio = np.zeros((batch, 1, self.model_config.audio_n_mels, _MEL_FRAMES), np.float32)
        return video, audio

    @torch.inference_mode()
    def _forward(self, video: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        return self.forward_module(video, audio)

    def _on_stream(self):
        """The runner's stream as the calling thread's current one."""
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    def _put_batch(self, arr) -> torch.Tensor:
        """Host array -> device tensor; staged tensors pass through."""
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _pad_to_bucket(self, videos, audios):
        """Bucket-pad host arrays; -> (videos, audios, n)."""
        videos = np.asarray(videos)
        if not (self.device_normalize and videos.dtype == np.uint8):
            videos = videos.astype(np.float32)
        audios = _host_audio(audios)
        n = videos.shape[0] if self.fusion_mode != "audio" else audios.shape[0]
        bucket = _bucket_for(n, self.batch_buckets)
        return _pad_rows(videos, bucket), _pad_rows(audios, bucket), n

    def stage(self, videos, audios) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Bucket-pad and start the host->device copy without waiting; pass
        the result to `predict_probs` (with its `n`)."""
        videos, audios, n = self._pad_to_bucket(videos, audios)
        with self._on_stream():
            return self._put_batch(videos), self._put_batch(audios), n

    def stage_audio(self, audios) -> Tuple[torch.Tensor, int]:
        """`stage` for blank-video (audio-only) batches."""
        audios = _host_audio(audios)
        n = audios.shape[0]
        with self._on_stream():
            return self._put_batch(_pad_rows(audios, _bucket_for(n, self.batch_buckets))), n

    def predict_probs(self, videos, audios, n: Optional[int] = None) -> np.ndarray:
        """[B, ...] inputs -> [B, num_classes] probabilities (host numpy).
        Inputs may be pre-staged tensors from `stage` (pass its `n`)."""
        if n is None:
            videos, audios, n = self._pad_to_bucket(videos, audios)
        with self._on_stream():
            probs = self._forward(self._put_batch(videos), self._put_batch(audios))
            return probs.cpu().numpy()[:n]

    def predict_probs_blank_video(self, audios, n: Optional[int] = None) -> np.ndarray:
        """Audio-only batches (e.g. bare .wav uploads): the blank video is
        made on the device instead of being shipped from the host.  `audios`
        may be pre-staged by `stage_audio` (pass its `n`)."""
        if n is None:
            audios, n = self.stage_audio(audios)
        with self._on_stream():
            audio = self._put_batch(audios)
            shape = (audio.shape[0], _FRAMES, 3, _FRAME_SIZE, _FRAME_SIZE)
            if self.device_normalize:
                video = torch.zeros(shape, dtype=torch.uint8, device=self.device)
            else:
                video = (-self._mean / self._std).expand(shape)
            return self._forward(video, audio).cpu().numpy()[:n]

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run each bucket once (kernel builds, cuDNN algorithm choice)."""
        for b in buckets or self.batch_buckets:
            self.predict_probs(*self._example_inputs(b))
