"""Operation and byte counts against hand counts at small shapes."""

from __future__ import annotations

import pytest

from perfbench import flops

SMALL = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
         "intermediate_size": 16, "conv_dim": [4, 4, 4], "conv_stride": [5, 2, 2],
         "conv_kernel": [10, 3, 2], "num_conv_pos_embeddings": 4,
         "num_conv_pos_embedding_groups": 2, "layerdrop": 0.0}


def test_wavlm_lengths():
    # 100 samples: (100 - 10) // 5 + 1 = 19, (19 - 3) // 2 + 1 = 9, (9 - 2) // 2 + 1 = 4
    assert flops.wavlm_lengths(SMALL, 100) == [19, 9, 4]


def test_wavlm_parts_by_hand():
    w = flops.wavlm_flops(SMALL, 100)
    assert w["conv_l0"] == 2 * 19 * 10 * 1 * 4
    assert w["conv_l1_l6"] == 2 * 9 * 3 * 4 * 4 + 2 * 4 * 2 * 4 * 4
    assert w["projection"] == 2 * 4 * 4 * 8
    assert w["pos_conv"] == 2 * 4 * 8 * 4 * 4  # 8 channels, 4 per group, 4 taps
    # q, k, v, out: 4 * 2*T*E*E; QK and PV: 2 * 2*T*T*E; gate: 2*T*H*dh*8; FFN: 2 * 2*T*E*F
    assert w["layer"] == 4 * 2 * 4 * 64 + 2 * 2 * 16 * 8 + 2 * 4 * 2 * 4 * 8 + 2 * 2 * 4 * 8 * 16


def test_wavlm_base_clip_is_about_43_gflop():
    from perfbench.reference.model import WAVLM_BASE

    w = flops.wavlm_flops(WAVLM_BASE)
    total = w["conv_l0"] + w["conv_l1_l6"] + w["projection"] + w["pos_conv"] + 12 * w["layer"]
    assert 42e9 < total < 43.5e9


def test_resnet18_frame_by_hand():
    r = flops.resnet18_flops(112)
    assert r["conv1"] == 2 * 56 * 56 * 7 * 7 * 3 * 64
    assert r["layer1"] == 4 * 2 * 28 * 28 * 9 * 64 * 64
    assert r["layer2"] == (2 * 14 * 14 * 9 * 64 * 128 + 3 * 2 * 14 * 14 * 9 * 128 * 128
                           + 2 * 14 * 14 * 64 * 128)
    assert 0.8e9 < sum(r.values()) < 1.0e9


def test_kernel_costs_by_hand():
    f, b = flops.k1_cost(2, 3, 4, 2)
    assert f == 4 * 2 * 9 * 4 + 2 * 2 * 3 * 16
    assert b == 4 * (4 * 24 + 2 * 2 * 3 + 2 * 9 + 16 + 12 + 24)
    f2, b2 = flops.k2_cost(2, 3, 4, 2)
    assert f2 == 4 * 2 * 3 * 16 + 10 * 2 * 9 * 4
    assert b2 == 4 * (24 + 2 * (4 * 24 + 12 + 18 + 16 + 12))
    f3, b3 = flops.k3_cost(1, SMALL, 100)
    assert f3 == 2 * 9 * 3 * 16 + 2 * 4 * 2 * 16
    assert b3 == 4 * ((19 * 4 + 3 * 16 + 9 * 4) + (9 * 4 + 2 * 16 + 4 * 4))


def test_bound_takes_the_larger_side():
    assert flops.bound_s(165e12, 0.0) == pytest.approx(1.0)
    assert flops.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert flops.bound_s(989e12, 0.0, "bfloat16") == pytest.approx(1.0)


def test_train_counts_twice_the_forward_where_the_backward_goes():
    cfg = {"model": {"use_wavlm": False}}
    fwd = flops.clip_forward_flops(cfg, {})
    full = flops.clip_train_flops(cfg, {}, {})
    assert full > 2.5 * fwd and full < 3.0 * fwd
    wav = {"model": {"use_wavlm": True}}
    from perfbench.reference.model import WAVLM_BASE

    g = {**WAVLM_BASE, "layerdrop": 0.0}
    stage2 = flops.clip_train_flops(wav, g, {"wavlm_layers": 2, "video_stages": 1})
    w = flops.wavlm_flops(g)
    r = flops.resnet18_flops()
    extra = 2 * (2 * w["layer"] + 8 * r["layer4"] + flops.fusion_flops(149, 768))
    assert stage2 == pytest.approx(flops.clip_forward_flops(wav, g) + extra)
