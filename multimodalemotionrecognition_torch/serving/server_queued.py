"""Queued inference API (reference `src/inference_server.py:216-308`).

Counterpart of the JAX package's `serving/server_queued.py`.  The same
endpoints and JSON (GET /health, GET /metrics, GET /queue/status, POST
/submit, GET /result/{task_id}, POST /predict, POST /predict_batch, WS
/ws/stream), served by aiohttp with the in-process dynamic batcher driving
one `TorchModelRunner` (compute dtype, `fused=ServeConfig.fused_xattn`,
`device_normalize` from the config), or, with `EMO_REDIS_URL` set, as a
gateway to remote `RedisWorker` hosts.

Unlike the JAX app nothing degrades quietly: a runner that cannot be built
or warmed up, or a streaming predictor that cannot be built, is an error at
creation.  Mock output (`_MockRunner`, a mock streaming predictor) is served
only when asked for (`--mock`, `EMO_MOCK=1`).  The streaming sessions share
the batcher's runner (the JAX app loads a second model for them).

Run: python -m multimodalemotionrecognition_torch serve-queued \\
       [--checkpoint outputs/best_xattn.pt] [--mock] [--port 8000]
"""

from __future__ import annotations

import argparse
import asyncio
from typing import Optional

import numpy as np
from aiohttp import web

from multimodalemotionrecognition_torch.config import ServeConfig, labels_for
from multimodalemotionrecognition_torch.serving.batcher import (
    DynamicBatcher,
    GatewayError,
    InferenceGateway,
)
from multimodalemotionrecognition_torch.serving.http import (
    cors_middleware,
    handle_ws_stream,
    json_response,
)
from multimodalemotionrecognition_torch.serving.predictor import EmotionPredictor
from multimodalemotionrecognition_torch.serving.streaming import StreamingSessionManager

__all__ = ["create_app", "main"]


class _MockRunner:
    """Dirichlet mock with the worker's labels/contract (EMO_MOCK analog)."""

    def __init__(self, num_classes: int = 8):
        self.labels = list(labels_for(num_classes))
        self.use_wavlm = False
        self.fusion_mode = "mock"

    def predict_probs(self, videos, audios):
        return np.random.dirichlet(np.ones(len(self.labels)), size=len(videos))


def create_app(
    config: Optional[ServeConfig] = None,
    runner=None,
    mock: bool = False,
    checkpoint: Optional[str] = None,
    redis_client=None,
    device: str = "cuda",
) -> web.Application:
    config = config or ServeConfig.from_env()
    mock = mock or config.mock
    checkpoint = checkpoint or config.checkpoint_path
    # EMO_REDIS_URL set -> this host is a pure gateway: tasks go over Redis to
    # remote RedisWorker hosts; no local batcher (reference topology
    # `src/inference_server.py` + N `inference_worker` processes).
    batcher = None
    if config.redis_url or redis_client is not None:
        from multimodalemotionrecognition_torch.serving.redis_transport import RedisGateway

        gateway = RedisGateway(config, client=redis_client)
    else:
        if runner is None:
            if mock:
                runner = _MockRunner()
            else:
                from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

                runner = TorchModelRunner(
                    checkpoint,
                    batch_buckets=config.batch_buckets,
                    compute_dtype=config.compute_dtype,
                    fused=config.fused_xattn,
                    device_normalize=config.device_normalize,
                    mesh=config.make_mesh(device),
                    device=device,
                )
                # Every bucket once at startup (kernel builds, cuDNN's
                # algorithm choice), so the first request does not pay it.
                runner.warmup()
        gateway = InferenceGateway(config)
        batcher = DynamicBatcher(gateway, runner, config)
    if mock:
        predictor = EmotionPredictor(mock_mode=True, config=config)
    elif runner is not None:
        predictor = EmotionPredictor(runner=runner, config=config)
    else:
        predictor = EmotionPredictor(checkpoint_path=checkpoint, config=config, device=device)
    streaming = StreamingSessionManager(predictor)

    app = web.Application(middlewares=[cors_middleware], client_max_size=256 * 2**20)
    app["gateway"] = gateway
    app["batcher"] = batcher
    app["streaming"] = streaming
    app["runner"] = runner

    if batcher is not None:

        async def start_batcher(app):
            app["batcher_task"] = asyncio.create_task(batcher.run())

        async def stop_batcher(app):
            batcher.stop()
            task = app.get("batcher_task")
            if task:
                task.cancel()

        app.on_startup.append(start_batcher)
        app.on_cleanup.append(stop_batcher)

    async def health(request):
        return json_response({"status": "ok", "streaming_ready": True, **gateway.queue_stats()})

    async def queue_status(request):
        return json_response(gateway.queue_stats())

    async def _read_upload(request, field="file"):
        data = await request.post()
        item = data.get(field)
        if item is None:
            raise GatewayError(422, [{"loc": ["body", field], "msg": "field required"}])
        return item.filename or "upload.mp4", item.file.read()

    async def submit(request):
        filename, payload = await _read_upload(request)
        task_id = await gateway.submit(filename, payload)
        return json_response({"task_id": task_id, "status": "queued"})

    async def result(request):
        task_id = request.match_info["task_id"]
        return json_response(await gateway.get_result(task_id))

    async def predict(request):
        filename, payload = await _read_upload(request)
        task_id = await gateway.submit(filename, payload)
        result_payload = await gateway.wait_for_result(task_id)
        result_payload["task_id"] = task_id
        return json_response(result_payload)

    async def predict_batch(request):
        data = await request.post()
        uploads = data.getall("files", [])
        if not uploads:
            raise GatewayError(422, [{"loc": ["body", "files"], "msg": "field required"}])
        items = [(u.filename or "upload.mp4", u.file.read()) for u in uploads]
        task_ids = await gateway.submit_many(items)
        results = await asyncio.gather(*(gateway.wait_for_result(t) for t in task_ids))
        for task_id, r in zip(task_ids, results):
            r["task_id"] = task_id
        return json_response({"count": len(results), "results": list(results)})

    async def ws_stream(request):
        return await handle_ws_stream(request, streaming)

    async def metrics(request):
        """Rolling per-stage latencies of the dynamic batcher (empty in
        gateway mode: the batcher lives on the worker hosts)."""
        stages = batcher.timer.summary() if batcher is not None else {}
        return json_response({"stages": stages, **gateway.queue_stats()})

    app.router.add_get("/health", health)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/queue/status", queue_status)
    app.router.add_post("/submit", submit)
    app.router.add_get("/result/{task_id}", result)
    app.router.add_post("/predict", predict)
    app.router.add_post("/predict_batch", predict_batch)
    app.router.add_get("/ws/stream", ws_stream)
    return app


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="serve-queued")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--mock", action="store_true")
    args = p.parse_args(argv)
    app = create_app(mock=args.mock, checkpoint=args.checkpoint)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
