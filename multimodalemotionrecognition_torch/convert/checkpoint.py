"""Reference `.pt` checkpoints: load, normalise, and infer the model signature.

Counterpart of the JAX package's `convert/signature.py` and of
`convert/torch_import.py::{load_reference_checkpoint,
normalize_torch_state_dict}`.  Those modules cannot be imported without flax
(`convert/__init__.py` pulls in `torch_import.py`), so their framework-free
logic is carried here on torch tensors.

Container format (reference `src/train.py:1141-1144`): {"model": state_dict,
"val_f1": float, "config": {...}}, with a raw-state-dict fallback.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import torch

__all__ = [
    "checkpoint_uses_wavlm",
    "infer_model_signature",
    "load_reference_checkpoint",
    "normalize_torch_state_dict",
]

_WEIGHT_NORM_G_RE = re.compile(
    r"^(?P<mod>.*)\.(?:weight_g|parametrizations\.weight\.original0)$"
)
_WEIGHT_NORM_V_RE = re.compile(
    r"^(?P<mod>.*)\.(?:weight_v|parametrizations\.weight\.original1)$"
)


def load_reference_checkpoint(
    path: str | Path,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a reference .pt checkpoint -> (state_dict, config).

    Accepts both {"model": sd, "config": ...} and raw state_dicts
    (reference `src/train.py:904-911`)."""
    obj = torch.load(Path(path).expanduser(), map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        return obj["model"], dict(obj.get("config", {}))
    if isinstance(obj, dict) and obj and all(isinstance(k, str) for k in obj):
        return obj, {}
    raise RuntimeError(
        "Checkpoint format not supported. Expected {'model': state_dict} or raw state_dict."
    )


def normalize_torch_state_dict(
    state_dict: Mapping[str, Any],
) -> Dict[str, torch.Tensor]:
    """Values as tensors, with weight-norm parametrizations (WavLM's
    positional conv) merged into plain `weight` entries."""
    out: Dict[str, torch.Tensor] = {}
    g_parts: Dict[str, torch.Tensor] = {}
    v_parts: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        value = torch.as_tensor(value)
        m_g = _WEIGHT_NORM_G_RE.match(key)
        if m_g:
            g_parts[m_g.group("mod")] = value
            continue
        m_v = _WEIGHT_NORM_V_RE.match(key)
        if m_v:
            v_parts[m_v.group("mod")] = value
            continue
        out[key] = value
    for mod, v in v_parts.items():
        g = g_parts.get(mod)
        if g is None:
            out[f"{mod}.weight"] = v
            continue
        # torch weight_norm with dim=2 (WavLM pos conv): w = g * v / ||v||,
        # the norm taken over every axis where g has size 1.
        norm_axes = tuple(i for i in range(v.ndim) if g.shape[i] == 1)
        norm = torch.sqrt(torch.sum(v.double() ** 2, dim=norm_axes, keepdim=True))
        out[f"{mod}.weight"] = (g * v / norm.clamp_min(1e-12)).to(v.dtype)
    return out


def infer_model_signature(state_dict: Mapping[str, object]) -> Tuple[str, str]:
    """State-dict key prefixes -> (fusion_mode, xattn_head), by the
    reference's rules (`src/optimized_runtime.py:22-42`)."""
    keys = list(state_dict.keys())

    def has(prefix: str) -> bool:
        return any(k.startswith(prefix) for k in keys)

    if has("audio_model.") and has("video_model."):
        if has("xattn_gate."):
            return "xattn", "gated"
        if has("xattn_mlp."):
            return "xattn", "concat"
        if has("fusion."):
            return "concat", "concat"
        if has("gate."):
            return "gated", "gated"
        return "late", "concat"
    if has("encoder.") or has("wavlm."):
        return "audio", "concat"
    if has("backbone."):
        return "video", "concat"
    raise RuntimeError("Unable to infer model type from checkpoint state_dict keys.")


def checkpoint_uses_wavlm(state_dict: Mapping[str, object]) -> bool:
    return any(
        k.startswith("audio_model.wavlm.") or k.startswith("wavlm.")
        for k in state_dict
    )
