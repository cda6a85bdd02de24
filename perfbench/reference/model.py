"""Plain PyTorch forward of the benchmark's configurations, eval and train.

The flagship (`wavlm-xattn`): WavLM-base (a 7-layer conv feature extractor
with GroupNorm on the first layer, feature projection, a grouped positional
conv, post-norm encoder layers with gated relative-position bias), ResNet18
over each frame, bidirectional cross-attention fusion, mean pooling and a
concat head.  The mel twin (`mel-xattn`): a log-mel front end and the
non-residual `AudioResNet18` in place of WavLM.  Module attributes are the
reference checkpoint's state-dict keys, so one state dict loads into this
model and into the program's alike.

Written from the published architectures (HF `WavLMModel`, torchvision
`resnet18`, the reference repository's fusion and audio modules) in float32
with no hand-written kernel, cache or batching; it imports nothing of the
measured program.  Train mode follows the configuration's regularisers: the
draws are made by `stochastic.py` from the same seeds, in the order the
configuration's forward consumes them.  BatchNorm in train mode takes batch
statistics in float32 as E[x^2] - E[x]^2 and moves the running statistics
by 0.1 towards the batch mean and the biased variance (Flax's rule, which
the configuration trains with).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference import stochastic as rs

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

WAVLM_BASE = dict(
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
    conv_dim=(512,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2), conv_kernel=(10, 3, 3, 3, 3, 2, 2),
    num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16, num_buckets=320,
    max_bucket_distance=800, layer_norm_eps=1e-5, hidden_dropout=0.1, attention_dropout=0.1,
    activation_dropout=0.1, mask_time_prob=0.05, mask_time_length=10, layerdrop=0.1,
)


# --------------------------------------------------------------------- WavLM


def relative_buckets(t: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5-style bidirectional relative-position buckets [T, T]."""
    relative = np.arange(t)[None, :] - np.arange(t)[:, None]
    nb = num_buckets // 2
    buckets = (relative > 0).astype(np.int64) * nb
    rel_abs = np.abs(relative)
    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        large = np.log(np.maximum(rel_abs, 1).astype(np.float64) / max_exact)
    large = large / math.log(max_distance / max_exact)
    large = np.minimum((max_exact + large * (nb - max_exact)).astype(np.int64), nb - 1)
    return buckets + np.where(rel_abs < max_exact, rel_abs, large)


class _Attention(nn.Module):
    def __init__(self, g, first: bool):
        super().__init__()
        e, h = g["hidden_size"], g["num_attention_heads"]
        self.q_proj, self.k_proj = nn.Linear(e, e), nn.Linear(e, e)
        self.v_proj, self.out_proj = nn.Linear(e, e), nn.Linear(e, e)
        self.gru_rel_pos_linear = nn.Linear(e // h, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
        if first:
            self.rel_attn_embed = nn.Embedding(g["num_buckets"], h)


class _FeedForward(nn.Module):
    def __init__(self, g):
        super().__init__()
        self.intermediate_dense = nn.Linear(g["hidden_size"], g["intermediate_size"])
        self.output_dense = nn.Linear(g["intermediate_size"], g["hidden_size"])


class _Layer(nn.Module):
    def __init__(self, g, first: bool):
        super().__init__()
        e = g["hidden_size"]
        self.attention = _Attention(g, first)
        self.layer_norm = nn.LayerNorm(e, eps=g["layer_norm_eps"])
        self.feed_forward = _FeedForward(g)
        self.final_layer_norm = nn.LayerNorm(e, eps=g["layer_norm_eps"])


class _ConvLayer(nn.Module):
    def __init__(self, cin, cout, k, s, group_norm):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, s, bias=False)
        if group_norm:
            self.layer_norm = nn.GroupNorm(cout, cout, eps=1e-5)


class WavLM(nn.Module):
    def __init__(self, g):
        super().__init__()
        self.g = g
        dims = (1,) + tuple(g["conv_dim"])
        self.feature_extractor = nn.Module()
        self.feature_extractor.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, i == 0)
            for i, (k, s) in enumerate(zip(g["conv_kernel"], g["conv_stride"])))
        self.feature_projection = nn.Module()
        self.feature_projection.layer_norm = nn.LayerNorm(dims[-1], eps=g["layer_norm_eps"])
        self.feature_projection.projection = nn.Linear(dims[-1], g["hidden_size"])
        self.masked_spec_embed = nn.Parameter(torch.zeros(g["hidden_size"]))
        self.encoder = nn.Module()
        k = g["num_conv_pos_embeddings"]
        self.encoder.pos_conv_embed = nn.Module()
        self.encoder.pos_conv_embed.conv = nn.Conv1d(
            g["hidden_size"], g["hidden_size"], k, padding=k // 2,
            groups=g["num_conv_pos_embedding_groups"])
        self.encoder.layer_norm = nn.LayerNorm(g["hidden_size"], eps=g["layer_norm_eps"])
        self.encoder.layers = nn.ModuleList(
            _Layer(g, i == 0) for i in range(g["num_hidden_layers"]))

    def conv_features(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, samples] -> [B, T, C]."""
        g, layers = self.g, self.feature_extractor.conv_layers
        x = F.conv1d(wav[:, None, :], layers[0].conv.weight, stride=g["conv_stride"][0])
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        x = (x - mean) * torch.rsqrt(var + 1e-5)
        x = x * layers[0].layer_norm.weight[:, None] + layers[0].layer_norm.bias[:, None]
        x = F.gelu(x)
        for layer, s in zip(layers[1:], g["conv_stride"][1:]):
            x = F.gelu(F.conv1d(x, layer.conv.weight, stride=s))
        return x.transpose(1, 2)

    def _layer(self, layer, x, bias, streams):
        """One post-norm encoder layer; `streams` None in eval, else the step's."""
        g = self.g
        b, t, e = x.shape
        h = g["num_attention_heads"]
        dh = e // h
        att = layer.attention
        q = att.q_proj(x) * dh**-0.5
        k, v = att.k_proj(x), att.v_proj(x)
        proj = att.gru_rel_pos_linear(x.view(b, t, h, dh).transpose(1, 2))
        gates = torch.sigmoid(proj.view(b, h, t, 2, 4).sum(-1))
        gate = gates[..., 0:1] * (gates[..., 1:2] * att.gru_rel_pos_const - 1.0) + 2.0

        def heads(y):
            return y.view(b, t, h, dh).transpose(1, 2)

        scores = heads(q) @ heads(k).transpose(-1, -2) + gate * bias[None]
        probs = torch.softmax(scores, dim=-1)
        gen = None
        if streams is not None:
            gen = streams.device_gen["dropout"]
            keep_attn, keep_hid = rs.sublayer_masks(
                streams.kernel_seed("dropout"), b, h, t, e, g["attention_dropout"],
                g["hidden_dropout"], x.device)
            probs = rs.apply_keep(probs, keep_attn, g["attention_dropout"])
        ctx = (probs @ heads(v)).transpose(1, 2).reshape(b, t, e)
        out = att.out_proj(ctx)
        if streams is not None:
            out = rs.apply_keep(out, keep_hid, g["hidden_dropout"])
        x = layer.layer_norm(x + out)
        ff = layer.feed_forward
        y = F.gelu(ff.intermediate_dense(x))
        y = rs.dropout(y, g["activation_dropout"], gen)
        y = rs.dropout(ff.output_dense(y), g["hidden_dropout"], gen)
        return layer.final_layer_norm(x + y)

    def forward(self, wav: torch.Tensor, streams=None) -> torch.Tensor:
        """[B, samples] -> [B, T, E]; `streams` turns train mode on."""
        g = self.g
        x = self.conv_features(wav)
        x = self.feature_projection.projection(self.feature_projection.layer_norm(x))
        gen = None
        if streams is not None:
            gen = streams.device_gen["dropout"]
            b, t, _ = x.shape
            starts = torch.rand((b, t), generator=streams.device_gen["wavlm_mask"],
                                device=x.device) < g["mask_time_prob"]
            w = g["mask_time_length"]
            mask = F.max_pool1d(F.pad(starts.float()[:, None], (w - 1, 0)), w, stride=1)
            x = torch.where(mask[:, 0, :, None] > 0, self.masked_spec_embed, x)
        pos = self.encoder.pos_conv_embed.conv(x.transpose(1, 2))
        if g["num_conv_pos_embeddings"] % 2 == 0:
            pos = pos[:, :, :-1]
        x = self.encoder.layer_norm(x + F.gelu(pos).transpose(1, 2))
        x = rs.dropout(x, g["hidden_dropout"], gen)
        t = x.shape[1]
        buckets = torch.from_numpy(relative_buckets(t, g["num_buckets"],
                                                    g["max_bucket_distance"])).to(x.device)
        bias = self.encoder.layers[0].attention.rel_attn_embed(buckets).permute(2, 0, 1)
        self.layers_run = []
        for i, layer in enumerate(self.encoder.layers):
            if streams is not None and i > 0 and g["layerdrop"] > 0.0 \
                    and streams.uniform("layerdrop") < g["layerdrop"]:
                continue
            x = self._layer(layer, x, bias, streams)
            self.layers_run.append(i)
        return x


class WavLMAudio(nn.Module):
    def __init__(self, g):
        super().__init__()
        self.wavlm = WavLM(g)
        self.sequence_dim = g["hidden_size"]

    def encode_sequence(self, audio, streams=None):
        return self.wavlm(audio[:, 0, :] if audio.ndim == 3 else audio, streams)


# ------------------------------------------------------------- BatchNorm, CNNs


class BatchNorm(nn.BatchNorm2d):
    """eps 1e-5; eval: running statistics; train: batch statistics (see module)."""

    def run(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if train:
            count = x.numel() // x.shape[1]
            mean = x.sum(dim=(0, 2, 3)) / count
            var = ((x * x).sum(dim=(0, 2, 3)) / count - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.lerp_(mean, 0.1)
                self.running_var.lerp_(var, 0.1)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def _conv(cin, cout, k, s):
    return nn.Conv2d(cin, cout, k, s, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, cout, 3, stride), BatchNorm(cout)
        self.conv2, self.bn2 = _conv(cout, cout, 3, 1), BatchNorm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            BatchNorm(cout))

    def run(self, x, train):
        out = torch.relu(self.bn1.run(self.conv1(x), train))
        out = self.bn2.run(self.conv2(out), train)
        if self.downsample is not None:
            x = self.downsample[1].run(self.downsample[0](x), train)
        return torch.relu(out + x)


class ResNet18(nn.Sequential):
    """torchvision resnet18 without its head, as an `nn.Sequential`
    (keys 0, 1, 4-7): [N, 3, H, W] -> [N, 512]."""

    def __init__(self):
        layers = [nn.Conv2d(3, 64, 7, 2, padding=3, bias=False), BatchNorm(64), nn.ReLU(),
                  nn.MaxPool2d(3, 2, padding=1)]
        cin = 64
        for stage, cout in enumerate((64, 128, 256, 512)):
            s = 1 if stage == 0 else 2
            layers.append(nn.Sequential(BasicBlock(cin, cout, s), BasicBlock(cout, cout, 1)))
            cin = cout
        super().__init__(*layers)

    def run(self, x, train):
        x = torch.relu(self[1].run(self[0](x), train))
        x = self[3](x)
        for stage in list(self)[4:]:
            for block in stage:
                x = block.run(x, train)
        return x.mean(dim=(2, 3))


class VideoTower(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = ResNet18()

    def encode_frames(self, video, train):
        b, t, c, h, w = video.shape
        return self.backbone.run(video.reshape(b * t, c, h, w), train).view(b, t, 512)


def _mel_block(cin, cout):
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False), BatchNorm(cout),
                         nn.ReLU(), nn.Conv2d(cout, cout, 3, padding=1, bias=False),
                         BatchNorm(cout))


def _run_seq(seq, x, train):
    for layer in seq:
        x = layer.run(x, train) if isinstance(layer, BatchNorm) else layer(x)
    return x


class AudioResNet18(nn.Module):
    """The reference repository's mel encoder, without residual adds:
    [B, 1, n_mels, T] -> [B, 16, 128]."""

    def __init__(self, embedding_dim=128):
        super().__init__()
        self.conv1, self.bn1 = nn.Conv2d(1, 64, 7, 2, padding=3, bias=False), BatchNorm(64)
        self.layer1 = nn.Sequential(_mel_block(64, 64), _mel_block(64, 64))
        cin = 64
        for idx, cout in ((2, 128), (3, 256), (4, 512)):
            down = nn.Sequential(nn.Conv2d(cin, cout, 1, 2, bias=False), BatchNorm(cout))
            setattr(self, f"layer{idx}", nn.Sequential(down, _mel_block(cout, cout),
                                                       _mel_block(cout, cout)))
            cin = cout
        self.fc = nn.Linear(512, embedding_dim)

    def run(self, x, train):
        h = torch.relu(self.bn1.run(self.conv1(x), train))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for stage in layer:
                h = _run_seq(stage, h, train)
        h = F.adaptive_avg_pool2d(h, (1, 16))[:, :, 0, :].transpose(1, 2)
        return self.fc(h)


class MelAudio(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = AudioResNet18()
        self.sequence_dim = 128

    def encode_sequence(self, mel, streams=None):
        if streams is not None:
            mel = rs.spec_augment(streams.device_gen["specaugment"], mel)
        return self.encoder.run(mel, streams is not None)


def log_mel(wav: torch.Tensor, sample_rate=16000, n_fft=400, hop=160, n_mels=64):
    """torchaudio MelSpectrogram (periodic Hann, centred reflect padding,
    power 2, HTK mel, no norm) + AmplitudeToDB, in float32 with the DFT and
    the mel bank as products (their tables made in float64):
    [B, samples] -> [B, n_mels, frames]."""
    n_bins = n_fft // 2 + 1
    n = torch.arange(n_fft, dtype=torch.float64)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / n_fft))
    angle = 2.0 * math.pi * n[:, None] * torch.arange(n_bins, dtype=torch.float64)[None] / n_fft
    basis = torch.cat([torch.cos(angle), -torch.sin(angle)], dim=1) * window[:, None]
    hz = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)  # noqa: E731
    mel_max = 2595.0 * math.log10(1.0 + (sample_rate / 2) / 700.0)
    f_pts = hz(torch.linspace(0.0, mel_max, n_mels + 2, dtype=torch.float64))
    freqs = torch.linspace(0.0, sample_rate / 2, n_bins, dtype=torch.float64)
    slopes = f_pts[None, :] - freqs[:, None]
    diff = f_pts[1:] - f_pts[:-1]
    fb = torch.clamp(torch.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]), min=0)
    x = F.pad(wav[:, None, :].float(), (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    spec = x.unfold(-1, n_fft, hop) @ basis.float().to(x.device)
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    mel = (power @ fb.float().to(x.device)).transpose(-1, -2)
    return 10.0 * torch.log10(mel.clamp_min(1e-10))


# -------------------------------------------------------------------- fusion


class MHA(nn.Module):
    def __init__(self, d, h):
        super().__init__()
        self.h = h
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def run(self, query, key, rate, gen):
        b, lq, d = query.shape
        lk, h = key.shape[1], self.h
        dh = d // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(query, wq, bq).view(b, lq, h, dh).transpose(1, 2) * dh**-0.5
        k = F.linear(key, wk, bk).view(b, lk, h, dh).transpose(1, 2)
        v = F.linear(key, wv, bv).view(b, lk, h, dh).transpose(1, 2)
        attn = rs.dropout(torch.softmax(q @ k.transpose(-1, -2), dim=-1), rate, gen)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, lq, d))


class Model(nn.Module):
    """Cross-attention fusion over the two towers: forward(video, audio) -> logits."""

    def __init__(self, config: dict):
        super().__init__()
        m = config["model"]
        d = m.get("xattn_d_model", 128)
        self.rates = (m.get("xattn_attn_dropout", 0.1), m.get("xattn_stochastic_depth", 0.1))
        self.use_wavlm = bool(m.get("use_wavlm", False))
        if self.use_wavlm:
            self.audio_model = WavLMAudio({**WAVLM_BASE, **config.get("wavlm", {})})
        else:
            self.audio_model = MelAudio()
        self.video_model = VideoTower()
        common = m.get("common_dim", 256)
        self.v_in_proj = nn.Linear(512, d)
        self.audio_seq_proj = nn.Linear(self.audio_model.sequence_dim, d)
        self.a_in_proj = nn.Linear(d, d)
        heads = m.get("xattn_heads", 4)
        self.v2a_attn, self.v_norm = MHA(d, heads), nn.LayerNorm(d, eps=1e-5)
        self.a2v_attn, self.a_norm = MHA(d, heads), nn.LayerNorm(d, eps=1e-5)
        self.xattn_mlp = nn.Sequential(nn.Linear(2 * d, common), nn.ReLU(), nn.Dropout(0.2),
                                       nn.Linear(common, m.get("num_classes", 8)))

    def audio_input(self, wav: torch.Tensor) -> torch.Tensor:
        """Waveform [B, 1, samples] -> what the audio tower reads."""
        return wav if self.use_wavlm else log_mel(wav[:, 0, :])[:, None]

    def forward(self, video, audio, streams=None):
        train = streams is not None
        gen = streams.device_gen["dropout"] if train else None
        path = streams.device_gen["droppath"] if train else None
        attn_rate, depth = self.rates
        v = self.v_in_proj(self.video_model.encode_frames(video, train))
        a = self.a_in_proj(self.audio_seq_proj(self.audio_model.encode_sequence(audio, streams)))
        v = self.v_norm(v + rs.drop_path(self.v2a_attn.run(v, a, attn_rate, gen), depth, path))
        a = self.a_norm(a + rs.drop_path(self.a2v_attn.run(a, v, attn_rate, gen), depth, path))
        both = torch.cat([v.mean(dim=1), a.mean(dim=1)], dim=1)
        hid = rs.dropout(torch.relu(self.xattn_mlp[0](both)), 0.2, gen)
        return self.xattn_mlp[3](hid)


def normalise_video(video_u8: torch.Tensor, aug=None, gen=None) -> torch.Tensor:
    """uint8 frames [B, T, 3, H, W] -> ImageNet-normalised float32; with `aug`
    [B, 2] (brightness factor, noise sigma) the training tail: x factor,
    + sigma * N(0, 1) from `gen`, clipped to [0, 1]."""
    v = video_u8.float() / 255.0
    if aug is not None:
        v = v * aug[:, 0].view(-1, 1, 1, 1, 1)
        if gen is not None:
            v = v + aug[:, 1].view(-1, 1, 1, 1, 1) * torch.randn(v.shape, generator=gen,
                                                                 device=v.device)
        v = v.clamp(0.0, 1.0)
    mean = torch.tensor(IMAGENET_MEAN, device=v.device).view(1, 1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=v.device).view(1, 1, 3, 1, 1)
    return (v - mean) / std
