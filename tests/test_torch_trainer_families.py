"""One deterministic train step of the families `tests/test_torch_trainer.py`
does not hold against the JAX trainer: WavLM under late, concat, gated and
audio, the transformer pooler (on the video model), SpecAugment, and xattn_concat / xattn_gated
over mel.  Each is one single-stage step through the JAX `_train_step` and
the port's `train_step` from the same converted state and batch
(`tests/test_torch_trainer_rest.py::_step_against_jax`: the freeze mask,
losses 1e-5, pre-optimizer gradients 1e-4 of each leaf's largest entry,
never under 1e-6, BatchNorm statistics 1e-4 relative).  The WavLM audio
model keeps its backbone frozen in a single stage, as in JAX.

WavLM at the `SMALL` geometry with every rate 0; the port runs its encoder
layers through the attention kernel's wrapper (its plain version on the
CPU), the JAX trainer through its modular path.  SpecAugment draws its masks
from each package's own generator, so both sides get the same fixed mask in
its place: what is held is where the model applies it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalemotionrecognition_tpu.models import audio as jax_audio
from multimodalemotionrecognition_torch.models import audio as port_audio

from tests.test_torch_trainer import NO_NOISE
from tests.test_torch_trainer_rest import _step_against_jax
from tests.test_wavlm_fused_attn import SMALL

WAVLM = dict(use_wavlm=True, wavlm_geometry=dict(SMALL, **NO_NOISE, fused_conv=False))
XATTN = dict(xattn_d_model=32, xattn_attn_dropout=0.0, xattn_stochastic_depth=0.0)

# family -> (ModelConfig overrides of the mel gated base, BatchNorm statistics)
FAMILY_STEPS = {
    "wavlm_late": (dict(fusion="late", **WAVLM), 2 * 20),
    "wavlm_concat": (dict(fusion="concat", **WAVLM), 2 * 20),
    "wavlm_gated": (dict(fusion="gated", **WAVLM), 2 * 20),
    "wavlm_audio": (dict(fusion="audio", **WAVLM), 0),
    "video_transformer_pooler": (
        dict(fusion="video", temporal_pooling="transformer", temporal_dropout=0.0), 2 * 20),
    "gated_mel_spec_augment": (dict(fusion="gated", spec_augment=True), 2 * (3 + 20)),
    "xattn_concat_mel": (dict(fusion="xattn_concat", **XATTN), 2 * (3 + 20)),
    "xattn_gated_mel": (dict(fusion="xattn_gated", **XATTN), 2 * (3 + 20)),
}


def _fixed_mask(shape):
    """SpecAugment's stand-in: mel bins 5-12 and frames 10-29 zeroed."""
    keep = np.ones(shape[-2:], np.float32)
    keep[5:13, :] = 0.0
    keep[:, 10:30] = 0.0
    return keep


@pytest.mark.parametrize("family", list(FAMILY_STEPS))
def test_one_train_step_of_each_family_matches_jax(monkeypatch, family):
    overrides, n_stats = FAMILY_STEPS[family]
    calls = []
    monkeypatch.setattr(jax_audio, "spec_augment",
                        lambda rng, x: calls.append("jax") or x * jnp.asarray(_fixed_mask(x.shape)))
    monkeypatch.setattr(port_audio, "spec_augment",
                        lambda g, x: calls.append("port") or x * torch.from_numpy(_fixed_mask(x.shape)))
    _step_against_jax(monkeypatch, overrides, n_stats=n_stats)
    assert ("port" in calls and "jax" in calls) == overrides.get("spec_augment", False)
