"""Redis transport for serving across hosts: both halves.

Counterpart of the JAX package's `serving/redis_transport.py`, with the same
key schema and JSON.  Within one host the in-process batcher
(`serving/batcher.py`) is the worker.  Across hosts the reference's pattern
still applies (`src/inference_server.py:53-151`,
`src/inference_worker.py:46-219`): a Redis list is the work queue and task
hashes are the result store.  N gateway hosts run `RedisGateway` (HSET task
+ SET payload + RPUSH id), M GPU hosts run `RedisWorker` (BLPOP/LPOP batches
into the local `TorchModelRunner`).  `server_queued.create_app` selects the
gateway when `EMO_REDIS_URL` is set.

Keys: `emo:task:{uuid}`, `emo:task:{uuid}:payload`, `emo:inference:queue`.
The `redis` package is imported only when no client is injected; an
injected client (a test's fake, a custom pool) works without it.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from multimodalemotionrecognition_torch.config import ServeConfig
from multimodalemotionrecognition_torch.serving.batcher import GatewayError, worker_result
from multimodalemotionrecognition_torch.serving.preprocess import EmotionPreprocessService

__all__ = ["redis_available", "RedisGateway", "RedisWorker"]


def redis_available() -> bool:
    try:
        import redis  # noqa: F401

        return True
    except ImportError:
        return False


class RedisGateway:
    """Producer half of the multi-host topology: submits tasks to Redis and
    awaits results (reference RedisInferenceGateway,
    `src/inference_server.py:53-151`).

    API-compatible with `batcher.InferenceGateway` so `server_queued`'s
    endpoint handlers work unchanged.  Redis calls are synchronous redis-py
    calls pushed through `run_in_executor` so the aiohttp event loop never
    blocks on the TCP round-trip (the reference uses redis.asyncio; the
    executor hop is the same non-blocking contract without a second client
    API surface).
    """

    def __init__(
        self,
        config: Optional[ServeConfig] = None,
        redis_url: Optional[str] = None,
        client=None,
    ):
        self.config = config or ServeConfig.from_env()
        self.redis_url = redis_url or self.config.redis_url or "redis://localhost:6379/0"
        if client is None:
            import redis

            client = redis.Redis.from_url(self.redis_url, decode_responses=False)
        self.redis = client
        self.started_at = time.time()

    # --- key schema (reference `src/inference_server.py:141-151`) ---

    def _task_key(self, task_id: str) -> str:
        return f"{self.config.task_prefix}{task_id}"

    def _payload_key(self, task_id: str) -> str:
        return f"{self.config.task_prefix}{task_id}:payload"

    @staticmethod
    def _decode(value) -> str:
        return value.decode("utf-8") if isinstance(value, bytes) else value

    async def _call(self, fn, *args, **kwargs):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: fn(*args, **kwargs))

    # --- producer (reference `src/inference_server.py:69-89`) ---

    def _submit_sync(self, filename: str, payload: bytes) -> str:
        task_id = str(uuid.uuid4())
        self.redis.hset(
            self._task_key(task_id),
            mapping={
                "status": "queued",
                "filename": filename or "upload.mp4",
                "submitted_at": str(time.time()),
            },
        )
        self.redis.expire(self._task_key(task_id), self.config.result_ttl_sec)
        self.redis.set(
            self._payload_key(task_id), payload, ex=self.config.payload_ttl_sec
        )
        self.redis.rpush(self.config.queue_name, task_id)
        return task_id

    async def submit(self, filename: str, payload: bytes) -> str:
        if not payload:
            raise GatewayError(400, "Uploaded file is empty.")
        return await self._call(self._submit_sync, filename, payload)

    async def submit_many(self, items: List[Tuple[str, bytes]]) -> List[str]:
        return [await self.submit(f, p) for f, p in items]

    # --- result retrieval (reference `src/inference_server.py:91-121`) ---

    def _get_task_sync(self, task_id: str) -> Optional[Dict[str, Any]]:
        raw = self.redis.hgetall(self._task_key(task_id))
        if not raw:
            return None
        task = {self._decode(k): self._decode(v) for k, v in raw.items()}
        if "result" in task:
            task["result"] = json.loads(task["result"])
        return task

    async def get_result(self, task_id: str) -> Dict[str, Any]:
        task = await self._call(self._get_task_sync, task_id)
        if not task:
            raise GatewayError(404, f"Task not found: {task_id}")
        return task

    async def wait_for_result(
        self, task_id: str, timeout_sec: Optional[float] = None
    ) -> Dict[str, Any]:
        timeout = (
            self.config.predict_timeout_sec if timeout_sec is None else float(timeout_sec)
        )
        deadline = time.monotonic() + timeout
        poll = max(self.config.poll_interval_ms, 1.0) / 1000.0
        while True:
            task = await self._call(self._get_task_sync, task_id)
            status = task.get("status") if task else None
            if status == "completed":
                return task["result"]
            if status == "failed":
                raise GatewayError(500, task.get("error", "Inference failed."))
            if time.monotonic() >= deadline:
                raise GatewayError(202, {"task_id": task_id, "status": status})
            await asyncio.sleep(poll)

    def queue_stats(self) -> Dict[str, Any]:
        """Byte-compatible /queue/status payload
        (`src/inference_server.py:123-134`)."""
        try:
            queue_size = int(self.redis.llen(self.config.queue_name))
        except Exception:
            queue_size = -1
        return {
            "redis_url": self.redis_url,
            "queue_key": self.config.queue_name,
            "queue_size": queue_size,
            "batch_size": self.config.batch_size,
            "batch_timeout_ms": int(self.config.batch_timeout_ms),
            "worker_count_hint": 1,
            "uptime_sec": round(time.time() - self.started_at, 2),
        }


class RedisWorker:
    """Blocking batch worker draining a Redis queue into a local runner
    (reference RedisBatchWorker semantics, `src/inference_worker.py:46-219`)."""

    def __init__(
        self,
        runner,
        config: Optional[ServeConfig] = None,
        redis_url: str = "redis://localhost:6379/0",
        preprocess=None,
        idle_timeout_sec: int = 1,
        client=None,
    ):
        self.config = config or ServeConfig.from_env()
        if client is None:
            import redis

            client = redis.Redis.from_url(redis_url, decode_responses=False)
        self.redis = client
        self.runner = runner
        self.preprocess = preprocess or EmotionPreprocessService()
        self.idle_timeout_sec = idle_timeout_sec
        self._running = True

    # --- key schema (reference `src/inference_worker.py:209-219`) ---

    def _task_key(self, task_id: str) -> str:
        return f"{self.config.task_prefix}{task_id}"

    def _payload_key(self, task_id: str) -> str:
        return f"{self.config.task_prefix}{task_id}:payload"

    @staticmethod
    def _decode(value) -> str:
        return value.decode("utf-8") if isinstance(value, bytes) else value

    # --- batch loop ---

    def run(self) -> None:
        print(
            f"[INFO] Redis inference worker started: name={self.config.worker_name}, "
            f"queue={self.config.queue_name}, batch_size={self.config.batch_size}"
        )
        while self._running:
            batch = self._pop_batch()
            if batch:
                self._process_batch(batch)

    def stop(self) -> None:
        self._running = False

    def _pop_batch(self) -> List[str]:
        first = self.redis.blpop(
            self.config.queue_name, timeout=max(1, self.idle_timeout_sec)
        )
        if first is None:
            return []
        task_ids = [self._decode(first[1])]
        deadline = time.monotonic() + self.config.batch_timeout_ms / 1000.0
        while len(task_ids) < self.config.batch_size:
            raw = self.redis.lpop(self.config.queue_name)
            if raw is None:
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.001)
                continue
            task_ids.append(self._decode(raw))
        return task_ids

    def _process_batch(self, task_ids: List[str]) -> None:
        infos = []
        for task_id in task_ids:
            task_hash = self.redis.hgetall(self._task_key(task_id))
            payload = self.redis.get(self._payload_key(task_id))
            if not task_hash or payload is None:
                self._mark_failed(task_id, "Task payload missing or expired.")
                continue
            info = {self._decode(k): self._decode(v) for k, v in task_hash.items()}
            infos.append(
                {
                    "task_id": task_id,
                    "filename": info.get("filename", "upload.mp4"),
                    "submitted_at": float(info.get("submitted_at", str(time.time()))),
                    "payload": payload,
                }
            )
        if not infos:
            return
        try:
            prepared = [self._preprocess_item(i) for i in infos]
            videos = np.stack([p["video"] for p in prepared])
            audios = np.stack([p["audio"] for p in prepared])
            probs = self.runner.predict_probs(videos, audios)
            labels = list(self.runner.labels)
            for row, item in zip(probs, prepared):
                result = worker_result(item["task_id"], self.config.worker_name, labels, row,
                                       item["submitted_at"])
                self._mark_completed(item["task_id"], result)
        except Exception as exc:
            for item in infos:
                self._mark_failed(item["task_id"], str(exc))

    def _preprocess_item(self, item: Dict[str, Any]) -> Dict[str, Any]:
        import tempfile
        from pathlib import Path

        suffix = Path(item["filename"]).suffix or ".mp4"
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tmp:
            tmp.write(item["payload"])
            media_path = Path(tmp.name)
        try:
            video, audio = self.preprocess.preprocess_video_audio(
                media_path,
                use_face_crop=True,
                use_wavlm=bool(getattr(self.runner, "use_wavlm", False)),
            )
            return {
                "task_id": item["task_id"],
                "submitted_at": item["submitted_at"],
                "video": video[0],
                "audio": audio[0],
            }
        finally:
            media_path.unlink(missing_ok=True)

    def _mark_completed(self, task_id: str, result: Dict[str, Any]) -> None:
        self.redis.hset(
            self._task_key(task_id),
            mapping={
                "status": "completed",
                "completed_at": str(time.time()),
                "result": json.dumps(result, ensure_ascii=True),
            },
        )
        self.redis.expire(self._task_key(task_id), self.config.result_ttl_sec)
        self.redis.delete(self._payload_key(task_id))

    def _mark_failed(self, task_id: str, error: str) -> None:
        self.redis.hset(
            self._task_key(task_id),
            mapping={
                "status": "failed",
                "failed_at": str(time.time()),
                "error": error,
            },
        )
        self.redis.expire(self._task_key(task_id), self.config.result_ttl_sec)
        self.redis.delete(self._payload_key(task_id))


def main(argv=None) -> None:  # pragma: no cover - needs a live Redis + checkpoint
    import argparse

    p = argparse.ArgumentParser(prog="redis-worker")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--redis-url", default="redis://localhost:6379/0")
    args = p.parse_args(argv)
    from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner

    cfg = ServeConfig.from_env()
    runner = TorchModelRunner(
        args.checkpoint,
        batch_buckets=cfg.batch_buckets,
        compute_dtype=cfg.compute_dtype,
        device_normalize=cfg.device_normalize,
        mesh=cfg.make_mesh(),
    )
    runner.warmup()
    RedisWorker(runner, redis_url=args.redis_url).run()


if __name__ == "__main__":
    main()
