"""Operations and bytes of the benchmark's models and kernels, and the peaks.

Pure arithmetic on shapes: a multiply-add is 2 operations; elementwise work
is left out of the model counts (it is a rounding error beside the
products).  A kernel's bytes are each input read once and each output
written once; its operations are those of the mathematics it computes, not
those of a route that implements it.

Peaks (NVIDIA H100 SXM data sheet, dense): HBM3 3.35 TB/s; 989 TFLOP/s in
bfloat16; float32 work at 495 / 3 = 165 TFLOP/s, three TF32 products per
float32 one on the tensor cores (3xTF32, the port's float32 kernels), with
the CUDA cores' 67 TFLOP/s stated beside it.  The card's power limit is
reported beside every share.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
F32 = 4


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the peak of their type."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])


# --------------------------------------------------------------- the models


def conv_out(n: int, k: int, s: int, pad: int = 0) -> int:
    return (n + 2 * pad - k) // s + 1


def wavlm_lengths(geometry: dict, samples: int = 48000) -> list:
    """Frame counts after each conv layer of the feature extractor."""
    out, n = [], samples
    for k, s in zip(geometry["conv_kernel"], geometry["conv_stride"]):
        n = conv_out(n, k, s)
        out.append(n)
    return out


def wavlm_layer_flops(t: int, e: int, h: int, ffn: int) -> float:
    """One encoder layer: q, k, v, out projections, scores and P.V, the gate
    (E/H -> 8 per head), the feed-forward."""
    return 8 * t * e * e + 4 * t * t * e + 2 * t * h * (e // h) * 8 + 4 * t * e * ffn


def wavlm_flops(geometry: dict, samples: int = 48000) -> dict:
    """Forward operations of one clip, by part."""
    lengths = wavlm_lengths(geometry, samples)
    dims = (1,) + tuple(geometry["conv_dim"])
    conv = [2 * n * k * dims[i] * dims[i + 1]
            for i, (n, k) in enumerate(zip(lengths, geometry["conv_kernel"]))]
    t, e = lengths[-1], geometry["hidden_size"]
    groups, k = geometry["num_conv_pos_embedding_groups"], geometry["num_conv_pos_embeddings"]
    return {
        "conv_l0": conv[0],
        "conv_l1_l6": sum(conv[1:]),
        "projection": 2 * t * dims[-1] * e,
        "pos_conv": 2 * t * e * (e // groups) * k,
        "layer": wavlm_layer_flops(t, e, geometry["num_attention_heads"],
                                   geometry["intermediate_size"]),
        "layers": geometry["num_hidden_layers"],
    }


def resnet18_flops(size: int = 112) -> dict:
    """Forward operations of one frame, by stage (conv1, layer1..layer4)."""
    n = conv_out(size, 7, 2, 3)
    out = {"conv1": 2 * n * n * 7 * 7 * 3 * 64}
    n = conv_out(n, 3, 2, 1)
    cin = 64
    for i, cout in enumerate((64, 128, 256, 512)):
        s = 1 if i == 0 else 2
        m = conv_out(n, 3, s, 1)
        f = 2 * m * m * 9 * cin * cout + 3 * (2 * m * m * 9 * cout * cout)
        if s != 1 or cin != cout:
            f += 2 * m * m * cin * cout
        out[f"layer{i + 1}"] = f
        n, cin = m, cout
    return out


def audio_resnet18_flops(n_mels: int = 64, frames: int = 301) -> float:
    """Forward operations of the mel encoder on one [1, n_mels, frames] input."""
    h, w = conv_out(n_mels, 7, 2, 3), conv_out(frames, 7, 2, 3)
    total = 2 * h * w * 49 * 64
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    total += 4 * 2 * h * w * 9 * 64 * 64
    cin = 64
    for cout in (128, 256, 512):
        h, w = conv_out(h, 1, 2), conv_out(w, 1, 2)
        total += 2 * h * w * cin * cout + 4 * 2 * h * w * 9 * cout * cout
        cin = cout
    return total + 2 * 16 * 512 * 128


def log_mel_flops(samples: int = 48000, n_fft: int = 400, hop: int = 160,
                  n_mels: int = 64) -> float:
    frames = 1 + samples // hop
    bins = n_fft // 2 + 1
    return 2 * frames * n_fft * 2 * bins + 2 * frames * bins * n_mels


def fusion_flops(t_audio: int, audio_dim: int, frames: int = 8, d: int = 128,
                 common: int = 256, classes: int = 8) -> float:
    """The cross-attention block, pooling and head of one clip."""
    proj = 2 * frames * 512 * d + 2 * t_audio * audio_dim * d + 2 * t_audio * d * d
    attn = 2 * (2 * frames * d * d + 2 * 2 * t_audio * d * d + 4 * frames * t_audio * d
                + 2 * frames * d * d)
    attn += 2 * (2 * t_audio * d * d + 2 * 2 * frames * d * d + 4 * frames * t_audio * d
                 + 2 * t_audio * d * d)
    return proj + attn + 2 * 2 * d * common + 2 * common * classes


def clip_forward_flops(config: dict, geometry: dict) -> float:
    """Forward operations of one clip of a configuration."""
    frames = 8
    video = frames * sum(resnet18_flops().values())
    if config["model"].get("use_wavlm"):
        w = wavlm_flops(geometry)
        audio = (w["conv_l0"] + w["conv_l1_l6"] + w["projection"] + w["pos_conv"]
                 + w["layer"] * w["layers"])
        t_audio, dim = wavlm_lengths(geometry)[-1], geometry["hidden_size"]
    else:
        audio = log_mel_flops() + audio_resnet18_flops()
        t_audio, dim = 16, 128
    return video + audio + fusion_flops(t_audio, dim)


def clip_train_flops(config: dict, geometry: dict, trainable: dict) -> float:
    """Operations of one clip in a train step: every layer's forward, plus
    twice the forward of each layer the backward goes through.  `trainable`
    names what the backward reaches: "wavlm_layers" (the top N encoder
    layers, N < all: the backward stops below them; all: the whole tower),
    "video_stages" (the last N of conv1, layer1..layer4) and "audio_all"
    (the mel tower).  WavLM's LayerDrop is counted at its expectation."""
    fwd = clip_forward_flops(config, geometry)
    back = 0.0
    r = resnet18_flops()
    stages = list(r.values())
    n_video = trainable.get("video_stages", len(stages))
    back += 8 * sum(stages[len(stages) - n_video:])
    if config["model"].get("use_wavlm"):
        w = wavlm_flops(geometry)
        keep = 1.0 - geometry.get("layerdrop", 0.0)
        n = trainable.get("wavlm_layers", w["layers"])
        back += w["layer"] * n * keep
        if n >= w["layers"]:
            back += w["conv_l0"] + w["conv_l1_l6"] + w["projection"] + w["pos_conv"]
        fwd -= w["layer"] * (w["layers"] - 1) * (1.0 - keep)
        t_audio, dim = wavlm_lengths(geometry)[-1], geometry["hidden_size"]
    else:
        if trainable.get("audio_all", True):
            back += audio_resnet18_flops()
        t_audio, dim = 16, 128
    back += fusion_flops(t_audio, dim)
    return fwd + 2.0 * back


# --------------------------------------------------------------- the kernels


def k1_cost(b: int, t: int, e: int, h: int) -> tuple:
    """K1, the WavLM attention sublayer forward (scores with the gated bias,
    softmax, P.V, out-projection, residual, LayerNorm) -> (operations, bytes).
    Inputs hidden, q, k, v, gate, bias, W_o, b_o, LayerNorm scale and bias;
    output the sublayer's rows; float32."""
    flops = 4 * b * t * t * e + 2 * b * t * e * e
    nbytes = F32 * (4 * b * t * e + b * h * t + h * t * t + e * e + 3 * e + b * t * e)
    return flops, nbytes


def k2_cost(b: int, t: int, e: int, h: int) -> tuple:
    """K2, the sublayer's backward (scores recomputed; dV, dP, dQ, dK; the
    out-projection's two products) -> (operations, bytes).  Inputs the
    cotangent and the forward's ten operands, outputs their ten gradients."""
    flops = 4 * b * t * e * e + 10 * b * t * t * e
    operands = 4 * b * t * e + b * h * t + h * t * t + e * e + 3 * e
    nbytes = F32 * (b * t * e + 2 * operands)
    return flops, nbytes


def k3_cost(b: int, geometry: dict, samples: int = 48000) -> tuple:
    """K3, conv layers L1..L6 of the feature extractor with their GELU, one
    chain -> (operations, bytes): each layer's input, weights and output once."""
    lengths = wavlm_lengths(geometry, samples)
    dims = geometry["conv_dim"]
    flops = nbytes = 0
    for i in range(1, len(lengths)):
        k = geometry["conv_kernel"][i]
        flops += 2 * b * lengths[i] * k * dims[i - 1] * dims[i]
        nbytes += F32 * (b * lengths[i - 1] * dims[i - 1] + k * dims[i - 1] * dims[i]
                         + b * lengths[i] * dims[i])
    return flops, nbytes
