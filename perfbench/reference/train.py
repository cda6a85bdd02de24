"""Plain PyTorch train steps: the loss, autograd's backward and Adam.

The configuration's training semantics, written out: the video tail of
augmentation (brightness, Gaussian noise from the "videoaug" stream,
clipping, ImageNet normalisation), cross entropy averaged over the valid
rows, torch Adam (beta 0.9 / 0.999, eps 1e-8) with the L2 weight decay
added to the gradient before the moments, on the stage's trainable leaves
with a learning rate per group (two-stage finetuning, stage 2: the fusion
block at `lr`, the audio and video backbones at their own rates, WavLM's
top `fusion_unfreeze_wavlm_layers` of 12 layers and the last
`fusion_unfreeze_video_blocks` of ResNet18's parameterised blocks
trainable; stage 0: everything at `lr`).  A trainable leaf that took no part
in a step (a layer LayerDrop skipped) counts a zero gradient.
"""

from __future__ import annotations

import re

import torch

from perfbench import common
from perfbench.reference import stochastic
from perfbench.reference.model import normalise_video

DEFAULTS = dict(lr=1e-3, weight_decay=1e-4, audio_backbone_lr=1e-5, video_backbone_lr=1e-5,
                fusion_unfreeze_wavlm_layers=2, fusion_unfreeze_video_blocks=1,
                fusion_unfreeze_audio=True)
VIDEO_BLOCKS = ("0", "1", "4", "5", "6", "7")
B1, B2, EPS = 0.9, 0.999, 1e-8


def _group(name: str) -> str:
    if name.startswith("audio_model."):
        return "audio"
    return "video" if name.startswith("video_model.") else "fusion"


def trainable(name: str, stage: int, tc: dict, use_wavlm: bool) -> bool:
    if stage == 0 or _group(name) == "fusion":
        return True
    if _group(name) == "audio":
        if not use_wavlm:
            return bool(tc["fusion_unfreeze_audio"])
        m = re.match(r"audio_model\.wavlm\.encoder\.layers\.(\d+)\.", name)
        n = tc["fusion_unfreeze_wavlm_layers"]
        # Counted from 12, WavLM-base's depth, as the reference repository counts.
        return bool(m) and n > 0 and int(m.group(1)) >= 12 - n
    n = tc["fusion_unfreeze_video_blocks"]
    parts = name.split(".")
    return n > 0 and parts[1] == "backbone" and parts[2] in VIDEO_BLOCKS[-n:]


def learning_rate(name: str, stage: int, tc: dict) -> float:
    if stage == 2:
        return {"audio": tc["audio_backbone_lr"], "video": tc["video_backbone_lr"]}.get(
            _group(name), tc["lr"])
    return tc["lr"]


def three_steps(run, batches, tf32: bool = False, dtype=torch.float32) -> dict:
    """The reference's steps on `batches` -> {"loss": [...], "grad": the first
    step's gradient as Adam takes it, "params": after the last step,
    "initial": before the first}, by trainable leaf, on the host.  `dtype`
    float64 carries the same float32 weights, inputs and draws in float64."""
    common.precision(run.config, tf32)
    device = run.device
    tc = {**DEFAULTS, **run.config.get("train", {}), **run.traffic.get("train", {})}
    stage = run.traffic["stage"]
    model = common.reference_model(run.config, run.seed, device).to(dtype)
    live = {}
    for name, p in model.named_parameters():
        on = trainable(name, stage, tc, model.use_wavlm)
        p.requires_grad_(on)
        if on:
            live[name] = p
    initial = {n: p.detach().cpu().clone() for n, p in live.items()}
    mu = {n: torch.zeros_like(p) for n, p in live.items()}
    nu = {n: torch.zeros_like(p) for n, p in live.items()}
    streams = stochastic.Streams(run.seed % 2**63, device)
    out = {"loss": [], "initial": initial}
    for step, batch in enumerate(batches, start=1):
        video = torch.from_numpy(batch.video).to(device)
        aug = torch.from_numpy(batch.aug).to(device) if batch.aug is not None else None
        video = normalise_video(video, aug, streams.device_gen["videoaug"]).to(dtype)
        audio = model.audio_input(torch.from_numpy(batch.audio).to(device)).to(dtype)
        labels = torch.from_numpy(batch.labels).to(device)
        valid = torch.from_numpy(batch.valid).to(device).float()
        for p in live.values():
            p.grad = None
        logits = model(video, audio, streams)
        per_row = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
        loss = (per_row * valid).sum() / valid.sum().clamp_min(1.0)
        loss.backward()
        out["loss"].append(loss.item())
        with torch.no_grad():
            for name, p in live.items():
                g = (torch.zeros_like(p) if p.grad is None else p.grad) + tc["weight_decay"] * p
                if step == 1:
                    out.setdefault("grad", {})[name] = g.cpu()
                mu[name].mul_(B1).add_(g, alpha=1.0 - B1)
                nu[name].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                denom = (nu[name] / (1.0 - B2**step)).sqrt_().add_(EPS)
                p.add_((mu[name] / (1.0 - B1**step)) / denom,
                       alpha=-learning_rate(name, stage, tc))
    out["params"] = {n: p.detach().cpu() for n, p in live.items()}
    del model, live, mu, nu
    common.precision(run.config)
    common.release()
    return out
