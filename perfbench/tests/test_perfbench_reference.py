"""The plain reference against the port's plain paths, on the CPU at small
widths: the same weights, inputs and seeds give the same outputs."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import gen, weights
from perfbench.reference import host, stochastic
from perfbench.reference.model import Model, log_mel, normalise_video
from perfbench.tests.tiny import TINY_WAVLM


def _config(use_wavlm: bool) -> dict:
    cfg = {"model": {"fusion": "xattn", "use_wavlm": use_wavlm}}
    if use_wavlm:
        cfg["wavlm"] = dict(TINY_WAVLM)
    return cfg


def _port(cfg):
    from multimodalemotionrecognition_torch.config import ModelConfig
    from multimodalemotionrecognition_torch.models.factory import build_model

    mc = ModelConfig(**cfg["model"])
    if "wavlm" in cfg:
        mc = dataclasses.replace(mc, wavlm_geometry=dict(cfg["wavlm"]),
                                 wavlm_fused_train_layers=cfg["wavlm"]["num_hidden_layers"])
    return build_model(mc, device="cpu")


def _pair(use_wavlm: bool, seed: int = 3):
    cfg = _config(use_wavlm)
    sd = weights.make(cfg, seed, "cpu")
    ref = Model(cfg)
    ref.load_state_dict(sd, strict=True)
    port = _port(cfg)
    port.load_state_dict(sd, strict=True)
    return cfg, ref, port


@pytest.mark.parametrize("use_wavlm", [True, False])
def test_state_dict_layout_matches_the_port(use_wavlm):
    from multimodalemotionrecognition_torch.config import ModelConfig
    from multimodalemotionrecognition_torch.models.factory import _build

    with torch.device("meta"):
        ref = Model({"model": {"fusion": "xattn", "use_wavlm": use_wavlm}}).state_dict()
        port = _build(ModelConfig(fusion="xattn", use_wavlm=use_wavlm)).state_dict()
    assert {k: tuple(v.shape) for k, v in ref.items()} == {k: tuple(v.shape) for k, v in port.items()}


def test_weights_repeat_for_a_seed():
    cfg = _config(True)
    a, b, c = (weights.make(cfg, s, "cpu") for s in (2**31 + 5, 2**31 + 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["v_in_proj.weight"], c["v_in_proj.weight"])
    assert (a["video_model.backbone.1.running_var"] > 0).all()


@pytest.mark.parametrize("use_wavlm", [True, False])
def test_eval_forward_matches(use_wavlm):
    _, ref, port = _pair(use_wavlm)
    g = torch.Generator().manual_seed(0)
    video = torch.randint(0, 256, (2, 8, 3, 112, 112), generator=g, dtype=torch.uint8)
    wav = torch.randn(2, 1, 48000, generator=g) * 0.1
    v = normalise_video(video)
    with torch.no_grad():
        audio = ref.audio_input(wav)
        got = port(v, audio)
        want = ref(v, audio)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("use_wavlm", [True, False])
def test_train_forward_and_draws_match(use_wavlm):
    from multimodalemotionrecognition_torch.ops.stochastic import RngStreams

    _, ref, port = _pair(use_wavlm)
    g = torch.Generator().manual_seed(1)
    video = normalise_video(torch.randint(0, 256, (2, 8, 3, 112, 112), generator=g,
                                          dtype=torch.uint8))
    audio = ref.audio_input(torch.randn(2, 1, 48000, generator=g) * 0.1)
    got = port(video, audio, True, RngStreams(2**31 + 3, "cpu"))
    want = ref(video, audio, stochastic.Streams(2**31 + 3, "cpu"))
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    if use_wavlm:
        assert port.audio_model.wavlm.layers_run == ref.audio_model.wavlm.layers_run


def test_log_mel_matches_the_port():
    from multimodalemotionrecognition_torch.ops.mel import log_mel_spectrogram

    wav = torch.randn(2, 48000, generator=torch.Generator().manual_seed(2)) * 0.1
    assert torch.allclose(log_mel(wav), log_mel_spectrogram(wav), atol=1e-4)


def test_host_path_matches_the_batcher_wire():
    from scipy.signal import resample_poly

    from multimodalemotionrecognition_torch.serving.preprocess import EmotionPreprocessService

    pre = EmotionPreprocessService()
    for name, data in gen.uploads({"pool": 3, "level": 4000,
                                   "kinds": [[16000, 3.0], [48000, 2.0], [22050, 4.0]]}, 4):
        _, audio, blank = pre.preprocess_payload(name, data, use_wavlm=True, raw_uint8=True)
        assert blank
        wire = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
        assert np.abs(wire[0].astype(int) - host.upload_to_wire(data).astype(int)).max() <= 1
    x = np.random.default_rng(0).standard_normal(22050)
    assert np.abs(host.resample(x, 22050, 16000) - resample_poly(x, 320, 441)).max() < 1e-12
    assert host.decode_wav(gen.wav_bytes(np.array([0, 16384, -32768], np.int16), 8000))[1] == 8000
