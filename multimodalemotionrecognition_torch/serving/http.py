"""Shared aiohttp plumbing of both server apps: FastAPI-compatible error
bodies, CORS, and the WebSocket streaming protocol handler
(`backend/app/main.py:72-123`, `src/inference_server.py:160-208`).
Counterpart of the JAX package's `serving/http.py`."""

from __future__ import annotations

import json
from typing import Any

from aiohttp import WSMsgType, web

from multimodalemotionrecognition_torch.serving.batcher import GatewayError
from multimodalemotionrecognition_torch.serving.streaming import (
    StreamingSessionManager,
    decode_frame_b64,
    decode_pcm16_b64,
)

__all__ = ["json_response", "error_response", "cors_middleware", "handle_ws_stream"]


def json_response(payload: Any, status: int = 200) -> web.Response:
    return web.json_response(payload, status=status)


def error_response(exc: GatewayError) -> web.Response:
    # FastAPI serializes HTTPException as {"detail": ...}.
    return web.json_response({"detail": exc.detail}, status=exc.status_code)


@web.middleware
async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        resp = web.Response()
    else:
        try:
            resp = await handler(request)
        except GatewayError as exc:
            resp = error_response(exc)
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "*"
    resp.headers["Access-Control-Allow-Headers"] = "*"
    return resp


async def handle_ws_stream(
    request: web.Request, streaming: StreamingSessionManager
) -> web.WebSocketResponse:
    """The reference's typed streaming protocol: start / frame / audio /
    flush / stop JSON messages."""
    ws = web.WebSocketResponse()
    await ws.prepare(request)
    session = streaming.create_session(use_face_crop=True)
    await ws.send_json({"type": "session_started", "session_id": session.session_id})
    try:
        async for msg in ws:
            if msg.type != WSMsgType.TEXT:
                if msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                    break
                continue
            try:
                payload = json.loads(msg.data)
            except json.JSONDecodeError:
                await ws.send_json({"type": "error", "detail": "Invalid JSON."})
                continue
            msg_type = str(payload.get("type", "")).lower()

            if msg_type == "start":
                await ws.send_json({"type": "ack", "session_id": session.session_id})
                continue
            if msg_type == "frame":
                frame = decode_frame_b64(str(payload["image_b64"]))
                session.add_frame(frame, timestamp=payload.get("timestamp"))
                if session.ready_for_inference():
                    result = session.infer()
                    await ws.send_json({"type": "prediction", "payload": result})
                continue
            if msg_type == "audio":
                audio = decode_pcm16_b64(str(payload["pcm_b64"]))
                session.add_audio_chunk(
                    audio,
                    sample_rate=int(payload.get("sample_rate", 16000)),
                    timestamp=payload.get("timestamp"),
                )
                if session.ready_for_inference():
                    result = session.infer()
                    await ws.send_json({"type": "prediction", "payload": result})
                continue
            if msg_type == "flush":
                if session.audio_sample_count > 0 and session.frames:
                    result = session.infer()
                    await ws.send_json({"type": "prediction", "payload": result})
                continue
            if msg_type == "stop":
                await ws.send_json(
                    {"type": "session_stopped", "session_id": session.session_id}
                )
                break
            await ws.send_json(
                {"type": "error", "detail": f"Unknown message type: {msg_type}"}
            )
    finally:
        streaming.close_session(session.session_id)
    return ws
