"""Pretrained-backbone ingestion: raw torchvision / HF state dicts -> branch
checkpoints.

Counterpart of the JAX package's `convert/pretrained.py`, on torch alone.
The reference starts training from pretrained backbones,
`resnet18(weights=IMAGENET1K_V1)` for video (`src/models/video.py:21-23`) and
`microsoft/wavlm-base` for audio (`src/models/wavlm_audio.py:30-34`).  No hub
download is assumed: this module converts a raw downloaded state dict
(torchvision `resnet18-*.pth`, HF `pytorch_model.bin` / `model.safetensors`)
into the branch-checkpoint key space, which `TrainConfig.audio_ckpt` /
`video_ckpt` then warm-start from (`train/trainer.py::_warm_start`):

  torchvision resnet18:  conv1.* bn1.* layerK.I.*  ->  backbone.N.* with the
      children[:-1] Sequential indexing of the reference's VideoNet
      (conv1=0, bn1=1, relu=2, maxpool=3, layer1..4=4..7, avgpool=8);
      the 1000-class `fc.*` head is dropped.
  HF wavlm-base (WavLMModel): keys pass through under the `wavlm.` prefix
      (the reference holds the HF module at attribute `wavlm`,
      `src/models/wavlm_audio.py:43`); the weight-norm parts of the
      positional conv are merged into its `weight` on the way out
      (`convert/checkpoint.py::normalize_torch_state_dict`).

The output is the reference-format `.pt` container, {"model": state_dict,
"val_f1": 0.0, "config": {"pretrained_init", "branch"}}.

    python -m multimodalemotionrecognition_torch.convert.pretrained \\
        --arch resnet18   --state-dict resnet18-f37072fd.pth --output video_imagenet.pt
    python -m multimodalemotionrecognition_torch.convert.pretrained \\
        --arch wavlm-base --state-dict pytorch_model.bin      --output audio_wavlm.pt
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Mapping

import torch

from multimodalemotionrecognition_torch.convert.checkpoint import normalize_torch_state_dict

__all__ = [
    "convert_pretrained",
    "hf_wavlm_to_audio_branch",
    "load_raw_state_dict",
    "main",
    "torchvision_resnet_to_video_branch",
]

# torchvision resnet18 module -> children[:-1] Sequential index
# (reference VideoNet backbone, `src/models/video.py:21-23`).
_RESNET_CHILD_INDEX = {
    "conv1": "0",
    "bn1": "1",
    "layer1": "4",
    "layer2": "5",
    "layer3": "6",
    "layer4": "7",
}
_RESNET_KEY_RE = re.compile(r"^(conv1|bn1|layer[1-4])\.(.*)$")
_WAVLM_TRUNK = {"feature_extractor", "feature_projection", "encoder", "masked_spec_embed", "adapter"}


def torchvision_resnet_to_video_branch(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Raw torchvision `resnet18().state_dict()` -> VideoNet branch keys
    (`backbone.N.*`); the ImageNet `fc.*` head is dropped (the classifier
    head trains from scratch).  Raises if the input is not a torchvision
    resnet."""
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        if key.startswith("fc."):
            continue
        m = _RESNET_KEY_RE.match(key)
        if m is None:
            raise KeyError(
                f"Unexpected key {key!r}: not a torchvision resnet state dict "
                "(expected conv1/bn1/layer1..4/fc prefixes)"
            )
        root, rest = m.groups()
        out[f"backbone.{_RESNET_CHILD_INDEX[root]}.{rest}"] = value
    if len(out) < 20:
        raise ValueError(f"Only {len(out)} resnet keys found — wrong or truncated state dict?")
    return out


def hf_wavlm_to_audio_branch(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Raw HF `WavLMModel.state_dict()` (or a `wavlm.*`-prefixed wrapper dump)
    -> AudioNet branch keys under the `wavlm.` prefix; anything outside the
    trunk (an LM head) is dropped."""
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        if key.startswith("wavlm."):
            out[key] = value
        elif key.split(".", 1)[0] in _WAVLM_TRUNK:
            out[f"wavlm.{key}"] = value
    if not any(k.startswith("wavlm.encoder.layers.") for k in out):
        raise ValueError("No WavLM encoder layers found — is this a WavLMModel state dict?")
    return out


def load_raw_state_dict(path: str | Path) -> Dict[str, Any]:
    """Load a raw state-dict file: torch .pt/.pth/.bin or .safetensors."""
    p = Path(path).expanduser()
    if p.suffix == ".safetensors":
        try:
            from safetensors.torch import load_file
        except ImportError as exc:
            raise RuntimeError("safetensors is required for .safetensors input") from exc
        return dict(load_file(str(p)))
    obj = torch.load(p, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:  # lightning-style wrapper
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    if not (isinstance(obj, dict) and all(isinstance(k, str) for k in obj)):
        raise RuntimeError(f"{p} does not contain a state dict")
    return obj


def convert_pretrained(arch: str, state_dict_path: str | Path, output_path: str | Path) -> Path:
    """Raw state-dict file -> branch checkpoint at `output_path` (CPU
    tensors, weight norm merged)."""
    raw = load_raw_state_dict(state_dict_path)
    if arch in {"resnet18", "resnet"}:
        branch = torchvision_resnet_to_video_branch(raw)
        config = {"pretrained_init": "torchvision/resnet18", "branch": "video"}
    elif arch in {"wavlm-base", "wavlm"}:
        branch = hf_wavlm_to_audio_branch(raw)
        config = {"pretrained_init": "microsoft/wavlm-base", "branch": "audio"}
    else:
        raise ValueError(f"Unknown arch {arch!r} (expected resnet18 or wavlm-base)")
    state = {k: v.detach().cpu().clone() for k, v in normalize_torch_state_dict(branch).items()}
    out = Path(output_path).expanduser()
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": state, "val_f1": 0.0, "config": config}, out)
    print(f"[convert-pretrained] {arch}: {len(state)} tensors -> {out}")
    return out


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="convert-pretrained", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", required=True, choices=["resnet18", "wavlm-base"])
    p.add_argument("--state-dict", required=True, help="raw .pth/.bin/.safetensors")
    p.add_argument("--output", required=True, help="branch checkpoint .pt to write")
    args = p.parse_args(argv)
    convert_pretrained(args.arch, args.state_dict, args.output)


if __name__ == "__main__":
    main()
