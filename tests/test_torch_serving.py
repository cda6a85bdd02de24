"""The port's serving stack against the JAX package's, on the CPU.

  * streaming sessions: the same message sequence through both packages'
    sessions with one fake predictor, every observable equal (F1 included);
  * the frame and PCM codecs;
  * the dynamic batcher with spy runners: batch sizes, the blank-video route,
    the int16 wire, whole-batch failure marking, missing payloads;
  * both aiohttp apps in mock mode through `aiohttp.test_utils.TestClient`:
    every JSON reply equal to the JAX app's apart from time fields and
    random ids (mock probabilities are drawn from numpy's global generator,
    seeded alike before each request);
  * both apps on the CPU over one small reference-format checkpoint that
    `JaxModelRunner` and `TorchModelRunner` both load: probabilities within
    1e-5 of the JAX app's;
  * a non-mock app without its checkpoint, or without a card, raises at
    creation (the JAX app serves mock output);
  * the `python -m multimodalemotionrecognition_torch` hub.
"""

import asyncio
import base64
import io

import aiohttp
import cv2
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from scipy.io import wavfile

from multimodalemotionrecognition_tpu import config as jax_config
from multimodalemotionrecognition_tpu.serving import batcher as jax_batcher
from multimodalemotionrecognition_tpu.serving import server_direct as jax_direct
from multimodalemotionrecognition_tpu.serving import server_queued as jax_queued
from multimodalemotionrecognition_tpu.serving import streaming as jax_streaming
from multimodalemotionrecognition_torch import __main__ as hub
from multimodalemotionrecognition_torch import config
from multimodalemotionrecognition_torch.serving import batcher, server_direct, server_queued, streaming

from tests.test_torch_runner import ckpt  # noqa: F401  (the small reference-format checkpoint)

PROBS_ATOL = 1e-5
PACKAGES = {
    "jax": dict(config=jax_config, batcher=jax_batcher, streaming=jax_streaming,
                direct=jax_direct, queued=jax_queued),
    "torch": dict(config=config, batcher=batcher, streaming=streaming,
                  direct=server_direct, queued=server_queued),
}
# Values that differ between two runs of one app: clocks and random ids.
VOLATILE = {"uptime_sec", "queue_delay_ms", "processed_at", "submitted_at", "completed_at",
            "failed_at", "p50_ms", "p95_ms", "mean_ms", "task_id", "session_id"}


def _mask(obj):
    if isinstance(obj, dict):
        return {k: "<volatile>" if k in VOLATILE else _mask(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_mask(v) for v in obj)
    return obj


def _wav(seconds=1.0, sr=16000, seed=0):
    pcm = np.clip(np.random.RandomState(seed).randn(int(sr * seconds)) * 5000, -32768, 32767)
    buf = io.BytesIO()
    wavfile.write(buf, sr, pcm.astype(np.int16))
    return buf.getvalue()


# --------------------------------------------------------------------------- streaming


class _FakePredictor:
    """Records each window it is asked about; answers a fixed reply."""

    def __init__(self):
        self.calls = []

    def predict_stream(self, frames, waveform, waveform_sample_rate, use_face_crop=True):
        self.calls.append(([int(f.reshape(-1)[0]) for f in frames], waveform.copy(),
                           waveform_sample_rate, use_face_crop))
        return {"labels": ["a"], "probs": [100.0], "top1": {"label": "a", "prob": 100.0}}


def _frame(value):
    return np.full((4, 4, 3), value, np.uint8)


# Each step: ("frame", ts), ("audio", samples, sr) or ("audio_ramp", start, n, sr),
# ("ready", now), ("window", now), ("infer", now).
SESSIONS = {
    "cadence": [("frame", 0.0), ("frame", 0.1), ("ready", 1.0), ("audio", 48000, 16000),
                ("ready", 1.0), ("infer", 1.0), ("ready", 1.2), ("ready", 1.6), ("infer", 1.6)],
    "window_last_3s": [("audio_ramp", 0, 80000, 16000), ("frame", 10.0), ("window", 10.0)],
    "frames_in_window": [("frame", t) for t in (1.0, 2.0, 5.0, 6.5, 7.0)]
                        + [("audio", 48000, 16000), ("window", 7.0), ("window", 20.0), ("infer", 7.0)],
    "pruning": [("audio", 16000, 16000)] * 10 + [("frame", float(t)) for t in range(10)]
               + [("window", 9.0)],
    "chunk_wraparound": [("audio_ramp", s, 7001, 16000) for s in range(0, 144000, 7001)]
                        + [("window", 100.0)],
    "oversized_chunk": [("audio_ramp", 0, 160000, 16000), ("window", 0.0)],
    "out_of_order": [("frame", t) for t in (5.0, 0.5, 6.0, 7.0)] + [("window", 7.0)],
    "rate_change": [("audio", 48000, 16000), ("audio_ramp", 0, 8000, 8000), ("window", 1.0),
                    ("frame", 0.0), ("frame", 0.2), ("ready", 5.0)],
    # F1: pruning counts back from the NEWEST timestamp, so after one
    # far-future frame every later frame is evicted on arrival.
    "f1_far_future": [("audio", 48000, 16000), ("frame", 1.0), ("frame", 1000.0),
                      ("frame", 2.0), ("frame", 3.0), ("ready", 3.5), ("window", 3.5)],
}


def _run_session(module, steps):
    pred = _FakePredictor()
    s = module.StreamingEmotionSession(predictor=pred, waveform_sample_rate=16000,
                                       session_id="fixed")
    seen = []
    for step in steps:
        kind = step[0]
        if kind == "frame":
            s.add_frame(_frame(int(step[1] * 10) % 256), timestamp=step[1])
        elif kind == "audio":
            s.add_audio_chunk(np.zeros(step[1], np.float32), sample_rate=step[2])
        elif kind == "audio_ramp":
            start, n, sr = step[1:]
            s.add_audio_chunk(np.arange(start, start + n, dtype=np.float32), sample_rate=sr)
        elif kind == "ready":
            seen.append(("ready", s.ready_for_inference(now=step[1])))
        elif kind == "window":
            frames, wav = s.build_window(now=step[1])
            seen.append(("window", [int(f[0, 0, 0]) for f in frames], wav.tolist()))
        elif kind == "infer":
            seen.append(("infer", s.infer(now=step[1])))
        seen.append(("state", [t for t, _ in s.frames], s.audio_sample_count,
                     s.waveform_sample_rate, s.last_prediction_ts))
    calls = [(f, w.tolist(), sr, crop) for f, w, sr, crop in pred.calls]
    return seen, calls


@pytest.mark.parametrize("case", sorted(SESSIONS))
def test_streaming_session_equals_jax(case):
    got = _run_session(streaming, SESSIONS[case])
    assert got == _run_session(jax_streaming, SESSIONS[case])
    if case == "f1_far_future":
        assert got[0][-4] == ("ready", False)
        assert got[0][-1][1] == [1000.0]  # only the far-future frame is kept


def test_session_manager_equals_jax():
    for module in (streaming, jax_streaming):
        manager = module.StreamingSessionManager(_FakePredictor())
        session = manager.create_session(use_face_crop=False)
        assert manager.sessions == {session.session_id: session}
        assert session.use_face_crop is False and session.window_seconds == 3.0
        assert (session.step_seconds, session.max_buffer_seconds) == (0.5, 6.0)
        manager.close_session(session.session_id)
        manager.close_session("unknown")
        assert manager.sessions == {}


# --------------------------------------------------------------------------- codecs


def test_pcm16_codec_equals_jax():
    pcm = (np.sin(np.linspace(0, 10, 101)) * 30000).astype(np.int16)
    b64 = base64.b64encode(pcm.tobytes()).decode()
    got = streaming.decode_pcm16_b64(b64)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_streaming.decode_pcm16_b64(b64))
    np.testing.assert_array_equal(got, pcm.astype(np.float32) / 32768.0)


@pytest.mark.parametrize("prefix", ["", "data:image/jpeg;base64,"], ids=["bare", "data_url"])
def test_frame_codec_equals_jax(prefix):
    img = np.random.RandomState(0).randint(0, 255, (16, 24, 3), np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    b64 = prefix + base64.b64encode(buf.tobytes()).decode()
    got = streaming.decode_frame_b64(b64)
    assert got.shape == (16, 24, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_streaming.decode_frame_b64(b64))


@pytest.mark.parametrize("payload", ["not base64!", base64.b64encode(b"not an image").decode()],
                         ids=["bad_base64", "not_an_image"])
def test_frame_codec_rejects_what_jax_rejects(payload):
    for module in (streaming, jax_streaming):
        with pytest.raises(ValueError):
            module.decode_frame_b64(payload)


# --------------------------------------------------------------------------- batcher


class _SpyRunner:
    labels = list(config.EMOTION_LABELS_8)
    use_wavlm = False
    fusion_mode = "xattn"

    def __init__(self):
        self.calls = []

    def predict_probs(self, videos, audios):
        self.calls.append(("full", len(videos), videos.dtype.name, audios.dtype.name))
        probs = np.zeros((len(videos), 8))
        probs[:, 2], probs[:, 0] = 0.7, 0.3
        return probs


class _BlankSpyRunner(_SpyRunner):
    """A WavLM runner with the uint8 wire, the blank-video route and staging."""

    use_wavlm = True
    device_normalize = True

    def stage_audio(self, audios):
        self.calls.append(("stage_audio", len(audios), audios.dtype.name))
        return audios, len(audios)

    def predict_probs_blank_video(self, audios, n=None):
        self.calls.append(("blank", len(audios), audios.dtype.name, n))
        probs = np.full((len(audios), 8), 0.05)
        probs[:, 4] = 0.65
        probs[:, 3] = audios.reshape(len(audios), -1)[:, :100].std(axis=1) / 1e5
        return probs


class _FailingRunner(_SpyRunner):
    def predict_probs(self, videos, audios):
        raise RuntimeError("device lost")


def _batcher_scenario(name, runner, payloads, drop_payload=False, batch_size=8):
    pkg = PACKAGES[name]

    async def scenario():
        cfg = pkg["config"].ServeConfig(batch_size=batch_size, batch_timeout_ms=50)
        gateway = pkg["batcher"].InferenceGateway(cfg)
        b = pkg["batcher"].DynamicBatcher(gateway, runner, cfg)
        ids = await gateway.submit_many(payloads)
        if drop_payload:
            gateway.store.delete_payload(ids[0])
        task = asyncio.create_task(b.run())
        outcomes = []
        for task_id in ids:
            try:
                outcomes.append(("ok", await gateway.wait_for_result(task_id, timeout_sec=10)))
            except pkg["batcher"].GatewayError as e:
                outcomes.append(("error", e.status_code, e.detail))
        stored = [gateway.store.get_task(t) for t in ids]
        payload_left = [gateway.store.get_payload(t) is not None for t in ids]
        b.stop()
        task.cancel()
        n_batches = b.timer.summary().get("batch_size", {}).get("count", 0)
        return _mask(outcomes), _mask(stored), payload_left, n_batches

    return asyncio.run(scenario())


@pytest.mark.parametrize(
    "case", ["wav_batch", "blank_video_int16_wire", "mixed_sizes", "failure", "missing_payload"]
)
def test_batcher_equals_jax(case):
    wav3 = [(f"c{i}.wav", _wav(seed=i)) for i in range(3)]
    kinds = {
        "wav_batch": (_SpyRunner, wav3, {}),
        "blank_video_int16_wire": (_BlankSpyRunner, wav3 + [("d.wav", _wav(2.5, 48000, 9))], {}),
        "mixed_sizes": (_SpyRunner, [(f"c{i}.wav", _wav(seed=i)) for i in range(5)], dict(batch_size=2)),
        "failure": (_FailingRunner, wav3, {}),
        "missing_payload": (_SpyRunner, wav3, dict(drop_payload=True)),
    }
    runner_cls, payloads, kw = kinds[case]
    runs = {}
    for name in PACKAGES:
        runner = runner_cls()
        runs[name] = (_batcher_scenario(name, runner, payloads, **kw), runner.calls)
    assert runs["torch"] == runs["jax"]
    (outcomes, stored, payload_left, n_batches), calls = runs["torch"]
    assert not any(payload_left)  # payloads are deleted whatever the outcome
    if case == "wav_batch":
        assert calls == [("full", 3, "float32", "float32")] and n_batches == 1
        assert all(o[0] == "ok" and o[1]["top1"] == {"label": "happy", "prob": 0.7} for o in outcomes)
        assert set(outcomes[0][1]) == {"task_id", "worker_name", "labels", "probs", "top1",
                                       "queue_delay_ms", "processed_at"}
    elif case == "blank_video_int16_wire":
        assert calls == [("stage_audio", 4, "int16"), ("blank", 4, "int16", 4)]
    elif case == "mixed_sizes":
        assert [c[1] for c in calls] == [2, 2, 1] and n_batches == 3
    elif case == "failure":
        assert outcomes == [("error", 500, "device lost")] * 3
        assert all(s["status"] == "failed" for s in stored)
    else:
        assert outcomes[0] == ("error", 500, "Task payload missing or expired.")
        assert calls == [("full", 2, "float32", "float32")]


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_gateway_errors(name):
    pkg = PACKAGES[name]

    async def scenario():
        gateway = pkg["batcher"].InferenceGateway(pkg["config"].ServeConfig())
        codes = []
        for coro in (gateway.submit("x.mp4", b""), gateway.get_result("nope")):
            try:
                await coro
            except pkg["batcher"].GatewayError as e:
                codes.append((e.status_code, e.detail))
        task_id = await gateway.submit("x.wav", b"data")
        try:
            await gateway.wait_for_result(task_id, timeout_sec=0.01)
        except pkg["batcher"].GatewayError as e:
            codes.append((e.status_code, _mask(e.detail)))
        return codes

    assert asyncio.run(scenario()) == [
        (400, "Uploaded file is empty."), (404, "Task not found: nope"),
        (202, {"task_id": "<volatile>", "status": "queued"})]


# --------------------------------------------------------------------------- apps, mock mode


async def _serve(app, requests):
    """Run `requests(client)` against `app` on a test server; -> its replies."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        return await requests(client)
    finally:
        await client.close()


async def _call(client, method, path, seed=None, **kw):
    if seed is not None:
        np.random.seed(seed)
    r = await client.request(method, path, **kw)
    return r.status, _mask(await r.json())


def _form(field="file", files=(("clip.wav", None),)):
    form = aiohttp.FormData()
    for filename, data in files:
        form.add_field(field, _wav() if data is None else data, filename=filename)
    return form


async def _ws_session(client, seed):
    ok, buf = cv2.imencode(".jpg", np.full((8, 8, 3), 90, np.uint8))
    frame_b64 = base64.b64encode(buf.tobytes()).decode()
    pcm_b64 = base64.b64encode((np.arange(48000) % 200 - 100).astype(np.int16).tobytes()).decode()
    ws = await client.ws_connect("/ws/stream")
    seen = [await ws.receive_json()]
    await ws.send_json({"type": "start"})
    seen.append(await ws.receive_json())
    for ts in (0.0, 0.1):
        await ws.send_json({"type": "frame", "image_b64": frame_b64, "timestamp": ts})
    np.random.seed(seed)
    await ws.send_json({"type": "audio", "pcm_b64": pcm_b64, "sample_rate": 16000})
    seen.append(await ws.receive_json())
    await ws.send_str("{not json")
    seen.append(await ws.receive_json())
    await ws.send_json({"type": "bogus"})
    seen.append(await ws.receive_json())
    await ws.send_json({"type": "stop"})
    seen.append(await ws.receive_json())
    await ws.close()
    return _mask(seen)


def _queued_scenario(name, **create_kw):
    pkg = PACKAGES[name]

    async def requests(client):
        replies = [await _call(client, "GET", "/health"), await _call(client, "GET", "/queue/status")]
        np.random.seed(1)
        r = await client.post("/submit", data=_form())
        sub = await r.json()
        replies.append((r.status, _mask(sub)))
        for _ in range(500):
            r = await client.get(f"/result/{sub['task_id']}")
            res = await r.json()
            if res.get("status") == "completed":
                break
            await asyncio.sleep(0.01)
        replies.append((r.status, _mask(res)))
        replies.append(await _call(client, "POST", "/predict", seed=2, data=_form()))
        replies.append(await _call(client, "POST", "/predict_batch", seed=3, data=_form(
            "files", (("a.wav", None), ("b.wav", _wav(seed=4))))))
        replies.append(await _call(client, "GET", "/result/doesnotexist"))
        replies.append(await _call(client, "POST", "/predict", data=aiohttp.FormData({"x": "1"})))
        replies.append(await _call(client, "POST", "/submit", data=_form(files=(("e.wav", b""),))))
        replies.append(await _call(client, "POST", "/predict_batch", data=aiohttp.FormData({"x": "1"})))
        replies.append(await _call(client, "GET", "/metrics"))
        replies.append(await _ws_session(client, seed=5))
        return replies

    async def scenario():
        cfg = pkg["config"].ServeConfig(batch_size=4, batch_timeout_ms=10)
        return await _serve(pkg["queued"].create_app(config=cfg, **create_kw), requests)

    return asyncio.run(scenario())


def _direct_scenario(name, **create_kw):
    pkg = PACKAGES[name]

    async def requests(client):
        return [
            await _call(client, "GET", "/"),
            await _call(client, "GET", "/health"),
            await _call(client, "POST", "/predict", seed=7, data=_form(files=(("u.webm", None),))),
            await _call(client, "POST", "/predict", data=aiohttp.FormData({"x": "1"})),
            await _ws_session(client, seed=8),
        ]

    async def scenario():
        return await _serve(pkg["direct"].create_app(config=pkg["config"].ServeConfig(), **create_kw), requests)

    return asyncio.run(scenario())


def test_queued_app_mock_replies_equal_jax():
    got = _queued_scenario("torch", mock=True)
    assert got == _queued_scenario("jax", mock=True)
    health, _, sub, res, pred, batch, missing, no_file, empty, no_files, metrics, ws = got
    assert health[0] == 200 and health[1]["streaming_ready"] is True
    assert sub == (200, {"task_id": "<volatile>", "status": "queued"})
    assert res[1]["status"] == "completed" and abs(sum(res[1]["result"]["probs"]) - 1) < 1e-5
    assert pred[0] == 200 and pred[1]["worker_name"] == "worker-1"
    assert batch[1]["count"] == 2
    assert missing == (404, {"detail": "Task not found: doesnotexist"})
    assert no_file[0] == 422 and empty == (400, {"detail": "Uploaded file is empty."})
    assert no_files[0] == 422 and set(metrics[1]["stages"]) == {"preprocess", "infer", "batch_size"}
    assert [m["type"] for m in ws] == ["session_started", "ack", "prediction", "error", "error",
                                       "session_stopped"]


def test_queued_app_with_an_injected_runner_equals_jax():
    """The JAX app's JSON with a spy runner (its streaming predictor falls
    back to mock there; the port's shares the runner): the HTTP replies."""
    got = _queued_scenario("torch", runner=_SpyRunner(), mock=False)
    want = _queued_scenario("jax", runner=_SpyRunner(), mock=False)
    assert got[:-1] == want[:-1]
    assert got[4][1]["top1"] == {"label": "happy", "prob": 0.7}
    assert got[-1][2]["payload"]["top1"] == {"label": "happy", "prob": 70.0}


def test_direct_app_mock_replies_equal_jax():
    got = _direct_scenario("torch", mock=True)
    assert got == _direct_scenario("jax", mock=True)
    root, health, pred, no_file, ws = got
    assert root[1]["name"] == "Emotion Recognition API"
    assert health[1]["mock_mode"] is True and health[1]["device"] == "cpu"
    assert abs(sum(pred[1]["probs"]) - 100.0) < 1e-6
    assert no_file[0] == 422 and ws[2]["type"] == "prediction"


# --------------------------------------------------------------------------- apps on the CPU


def test_queued_app_on_the_cpu_matches_jax(ckpt):  # noqa: F811
    cfg = dict(checkpoint_path=ckpt, batch_buckets=(1,))

    def replies(name, **kw):
        pkg = PACKAGES[name]

        async def requests(client):
            out = [await _call(client, "GET", "/health")]
            r = await client.post("/predict", data=_form(files=(("clip.wav", _wav(2.0, 22050, 3)),)))
            out.append((r.status, await r.json()))
            return out

        async def scenario():
            app = pkg["queued"].create_app(config=pkg["config"].ServeConfig(**cfg), **kw)
            return await _serve(app, requests)

        return asyncio.run(scenario())

    got = replies("torch", device="cpu")
    want = replies("jax")
    assert got[0] == want[0]
    assert got[1][0] == want[1][0] == 200
    assert _mask(got[1][1]) | {"probs": None, "top1": None} == _mask(want[1][1]) | {"probs": None, "top1": None}
    np.testing.assert_allclose(got[1][1]["probs"], want[1][1]["probs"], atol=PROBS_ATOL, rtol=0)
    assert got[1][1]["top1"]["label"] == want[1][1]["top1"]["label"]


def test_direct_app_on_the_cpu_matches_jax(ckpt, tmp_path):  # noqa: F811
    """The direct app stores an upload as .webm; the JAX package reads its
    audio only through its libav loader, which is not built here, so its
    answer is held against the JAX app's predictor on the same bytes named
    .wav."""
    data = _wav(3.0, 16000, 6)

    async def requests(client):
        out = [await _call(client, "GET", "/health")]
        r = await client.post("/predict", data=_form(files=(("clip.wav", data),)))
        out.append((r.status, await r.json()))
        return out

    async def scenario(pkg, **kw):
        app = pkg["direct"].create_app(config=pkg["config"].ServeConfig(), checkpoint=ckpt, **kw)
        return app, await _serve(app, requests)

    _, got = asyncio.run(scenario(PACKAGES["torch"], device="cpu"))
    jax_app, want = asyncio.run(scenario(PACKAGES["jax"]))
    assert got[0] == want[0] and got[0][1]["device"] == "cpu" and got[0][1]["mock_mode"] is False
    path = tmp_path / "clip.wav"
    path.write_bytes(data)
    reference = jax_app["predictor"].predict(str(path))
    assert "error" in want[1][1]  # the JAX app could not read the upload
    assert got[1][0] == 200 and set(got[1][1]) == set(reference) == {"labels", "probs", "top1"}
    np.testing.assert_allclose(got[1][1]["probs"], reference["probs"], atol=100 * PROBS_ATOL, rtol=0)
    assert got[1][1]["top1"]["label"] == reference["top1"]["label"]


def test_apps_raise_without_their_checkpoint_or_card(ckpt, tmp_path):  # noqa: F811
    missing = str(tmp_path / "missing.pt")
    jax_app = jax_direct.create_app(config=jax_config.ServeConfig(), checkpoint=missing)
    assert jax_app["predictor"].mock_mode is True  # the JAX app serves mock output
    for create in (
        lambda **kw: server_direct.create_app(config=config.ServeConfig(), checkpoint=missing, **kw),
        lambda **kw: server_queued.create_app(config=config.ServeConfig(checkpoint_path=missing), **kw),
    ):
        with pytest.raises(FileNotFoundError):
            create(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server_direct.create_app(config=config.ServeConfig(), checkpoint=ckpt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server_queued.create_app(config=config.ServeConfig(checkpoint_path=ckpt))


# --------------------------------------------------------------------------- the hub


@pytest.mark.parametrize("command", ["build-native"])
def test_hub_refuses_what_is_not_ported(command, capsys):
    with pytest.raises(SystemExit) as e:
        hub.main([command, "--anything"])
    assert e.value.code == 2
    assert "ROADMAP queue 1" in capsys.readouterr().err


@pytest.mark.parametrize("command, module", [
    ("serve-direct", "multimodalemotionrecognition_torch.serving.server_direct"),
    ("serve-queued", "multimodalemotionrecognition_torch.serving.server_queued"),
    ("redis-worker", "multimodalemotionrecognition_torch.serving.redis_transport"),
    ("convert-pretrained", "multimodalemotionrecognition_torch.convert.pretrained"),
    ("export", "multimodalemotionrecognition_torch.runtime.export"),
])
def test_hub_dispatches_to_the_port(command, module, monkeypatch):
    import importlib

    seen = []
    monkeypatch.setattr(importlib.import_module(module), "main", seen.append)
    hub.main([command, "--port", "8002", "--mock"])
    assert seen == [["--port", "8002", "--mock"]]


def test_hub_convert_and_unknown_command(ckpt, capsys):  # noqa: F811
    hub.main(["convert", "--checkpoint", ckpt])
    out = capsys.readouterr().out
    assert out.startswith("keys: ") and "'fusion': 'xattn'" in out
    with pytest.raises(SystemExit) as e:
        hub.main(["bogus"])
    assert e.value.code == 2
    hub.main([])
    assert "serve-queued" in capsys.readouterr().out
