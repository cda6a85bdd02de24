"""Direct in-process inference API (reference `backend/app/main.py:25-180`).

Counterpart of the JAX package's `serving/server_direct.py`.  Endpoints:
GET /, GET /health, POST /predict, WS /ws/stream, with the same JSON
(probabilities x100 percent, the rich health payload).  `/health`'s `device`
is the platform JAX would name on the same machine: "gpu" when the model
runs on a CUDA card, "cpu" on the CPU.

Unlike the JAX app, a predictor that cannot be built (no checkpoint, no
card) is an error at creation, not a switch to mock output; mock output is
served only when asked for (`--mock`, `EMO_MOCK=1`).

Run: python -m multimodalemotionrecognition_torch serve-direct \\
       [--checkpoint checkpoints/best.pt] [--mock] [--port 8000]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path
from typing import Optional

import torch
from aiohttp import web

from multimodalemotionrecognition_torch.config import ServeConfig
from multimodalemotionrecognition_torch.serving.batcher import GatewayError
from multimodalemotionrecognition_torch.serving.http import (
    cors_middleware,
    handle_ws_stream,
    json_response,
)
from multimodalemotionrecognition_torch.serving.predictor import EmotionPredictor
from multimodalemotionrecognition_torch.serving.streaming import StreamingSessionManager

__all__ = ["create_app", "device_platform", "main"]


def device_platform(runner) -> str:
    """"gpu" or "cpu": where the runner's model lives (without one, whether
    the machine has a card), as JAX's `devices()[0].platform` names it."""
    if runner is not None:
        on_card = runner.device.type == "cuda"
    else:
        on_card = torch.cuda.is_available()
    return "gpu" if on_card else "cpu"


def create_app(
    config: Optional[ServeConfig] = None,
    mock: bool = False,
    checkpoint: Optional[str] = None,
    num_classes: int = 8,
    device: str = "cuda",
) -> web.Application:
    config = config or ServeConfig.from_env()
    ckpt = checkpoint or config.checkpoint_path
    predictor = EmotionPredictor(
        mock_mode=mock or config.mock,
        checkpoint_path=ckpt,
        num_classes=num_classes,
        config=config,
        device=device,
    )
    if predictor.runner is not None:
        # The direct backend serves one clip per request: bucket 1 is the
        # hot shape (kernel builds and cuDNN's algorithm choice happen here).
        predictor.runner.warmup(buckets=(1,))
    streaming = StreamingSessionManager(predictor)
    platform = device_platform(predictor.runner)

    app = web.Application(middlewares=[cors_middleware], client_max_size=256 * 2**20)
    app["predictor"] = predictor
    app["streaming"] = streaming

    async def root(request):
        return json_response(
            {
                "name": "Emotion Recognition API",
                "version": "0.1.0",
                "endpoints": {
                    "GET /health": "Health check",
                    "POST /predict": "Predict emotion from video",
                    "WS /ws/stream": "Streaming emotion inference with sliding window",
                },
            }
        )

    async def health(request):
        return json_response(
            {
                "status": "ok",
                "mock_mode": predictor.mock_mode,
                "device": platform,
                "is_wsl": False,
                "checkpoint_path": str(ckpt),
                "checkpoint_exists": Path(ckpt).exists(),
                "num_emotions": len(predictor.emotion_labels),
                "emotion_labels": list(predictor.emotion_labels),
            }
        )

    async def predict(request):
        data = await request.post()
        item = data.get("file")
        if item is None:
            raise GatewayError(422, [{"loc": ["body", "file"], "msg": "field required"}])
        fd, temp_path = tempfile.mkstemp(suffix=".webm")
        os.close(fd)
        try:
            with open(temp_path, "wb") as f:
                f.write(item.file.read())
            try:
                return json_response(predictor.predict(temp_path))
            except RuntimeError as e:
                raise GatewayError(500, str(e))
            except Exception as e:
                raise GatewayError(500, f"Inference failed: {str(e)}")
        finally:
            os.remove(temp_path)

    async def ws_stream(request):
        return await handle_ws_stream(request, streaming)

    app.router.add_get("/", root)
    app.router.add_get("/health", health)
    app.router.add_post("/predict", predict)
    app.router.add_get("/ws/stream", ws_stream)
    return app


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="serve-direct")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--mock", action="store_true")
    args = p.parse_args(argv)
    app = create_app(mock=args.mock, checkpoint=args.checkpoint)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
