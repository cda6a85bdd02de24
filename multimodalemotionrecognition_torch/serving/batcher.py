"""Dynamic batcher + task store (reference Redis queue + batch worker,
`src/inference_server.py:53-151`, `src/inference_worker.py:46-219`).

Counterpart of the JAX package's `serving/batcher.py`, stdlib and numpy only.
The external contract is the reference's: the task lifecycle hash
(status/filename/submitted_at -> completed_at/result | failed_at/error), TTLs
(result 3600 s, payload 600 s), batch assembly (the first task blocks, then
drain until batch_size=8 or batch_timeout=20 ms), thread-pool preprocessing,
the worker result JSON ({task_id, worker_name, labels, probs 0..1 rounded to
6, top1, queue_delay_ms, processed_at}) and whole-batch failure marking.  The
transport is an in-process asyncio queue feeding one `TorchModelRunner` with
fixed batch buckets; `serving/redis_transport.py` fronts several hosts.

Two stages overlap: while batch N runs its forward in an executor thread,
batch N+1 is preprocessed and its host->device copy is started on the event
loop's thread (`runner.stage` / `stage_audio`).  The runner issues both the
copy and the forward on one CUDA stream whatever the calling thread, so the
copy is ordered before the forward that reads it.
"""

from __future__ import annotations

import asyncio
import os
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from multimodalemotionrecognition_torch.config import ServeConfig
from multimodalemotionrecognition_torch.serving.preprocess import EmotionPreprocessService
from multimodalemotionrecognition_torch.utils.profiling import StageTimer

__all__ = ["TaskStore", "InferenceGateway", "DynamicBatcher", "GatewayError"]


class GatewayError(Exception):
    """HTTP-mappable error (mirrors fastapi.HTTPException usage)."""

    def __init__(self, status_code: int, detail: Any):
        super().__init__(str(detail))
        self.status_code = status_code
        self.detail = detail


class TaskStore:
    """In-memory task hash + payload store with Redis-equivalent TTL
    semantics (`emo:task:{id}` / `emo:task:{id}:payload`)."""

    def __init__(self, config: ServeConfig):
        self.config = config
        self._tasks: Dict[str, Tuple[float, Dict[str, Any]]] = {}  # (expiry, hash)
        self._payloads: Dict[str, Tuple[float, bytes]] = {}
        self._events: Dict[str, asyncio.Event] = {}

    def _sweep(self) -> None:
        now = time.time()
        for d in (self._tasks, self._payloads):
            for k in [k for k, (exp, _) in d.items() if exp < now]:
                d.pop(k, None)
        # Events follow their task's lifetime (else they leak per request).
        for k in [k for k in self._events if k not in self._tasks]:
            self._events.pop(k, None)

    def create_task(self, filename: str, payload: bytes) -> str:
        self._sweep()
        task_id = str(uuid.uuid4())
        now = time.time()
        self._tasks[task_id] = (
            now + self.config.result_ttl_sec,
            {"status": "queued", "filename": filename or "upload.mp4", "submitted_at": str(now)},
        )
        self._payloads[task_id] = (now + self.config.payload_ttl_sec, payload)
        self._events[task_id] = asyncio.Event()
        return task_id

    def get_task(self, task_id: str) -> Optional[Dict[str, Any]]:
        self._sweep()
        entry = self._tasks.get(task_id)
        return dict(entry[1]) if entry else None

    def get_payload(self, task_id: str) -> Optional[bytes]:
        self._sweep()
        entry = self._payloads.get(task_id)
        return entry[1] if entry else None

    def update_task(self, task_id: str, mapping: Dict[str, Any]) -> None:
        entry = self._tasks.get(task_id)
        base = entry[1] if entry else {}
        base.update(mapping)
        self._tasks[task_id] = (time.time() + self.config.result_ttl_sec, base)
        ev = self._events.get(task_id)
        if ev is not None and base.get("status") in {"completed", "failed"}:
            ev.set()

    def delete_payload(self, task_id: str) -> None:
        self._payloads.pop(task_id, None)

    def event_for(self, task_id: str) -> Optional[asyncio.Event]:
        return self._events.get(task_id)


class InferenceGateway:
    """Submit/await facade over the task store + batcher queue
    (reference RedisInferenceGateway, `src/inference_server.py:53-151`)."""

    def __init__(self, config: ServeConfig, store: Optional[TaskStore] = None):
        self.config = config
        self.store = store or TaskStore(config)
        self.queue: asyncio.Queue = asyncio.Queue()
        self.started_at = time.time()

    async def submit(self, filename: str, payload: bytes) -> str:
        if not payload:
            raise GatewayError(400, "Uploaded file is empty.")
        task_id = self.store.create_task(filename, payload)
        await self.queue.put(task_id)
        return task_id

    async def submit_many(self, items: List[Tuple[str, bytes]]) -> List[str]:
        return [await self.submit(f, p) for f, p in items]

    async def get_result(self, task_id: str) -> Dict[str, Any]:
        task = self.store.get_task(task_id)
        if not task:
            raise GatewayError(404, f"Task not found: {task_id}")
        return task

    async def wait_for_result(self, task_id: str, timeout_sec: Optional[float] = None) -> Dict[str, Any]:
        timeout = self.config.predict_timeout_sec if timeout_sec is None else float(timeout_sec)
        ev = self.store.event_for(task_id)
        if ev is not None:
            try:
                await asyncio.wait_for(ev.wait(), timeout=max(0.1, timeout))
            except asyncio.TimeoutError:
                task = self.store.get_task(task_id)
                status = task.get("status") if task else None
                raise GatewayError(202, {"task_id": task_id, "status": status})
        result = await self.get_result(task_id)
        status = result.get("status")
        if status == "completed":
            return result["result"]
        if status == "failed":
            raise GatewayError(500, result.get("error", "Inference failed."))
        raise GatewayError(202, {"task_id": task_id, "status": status})

    def queue_stats(self) -> Dict[str, Any]:
        """The reference's /queue/status payload (`src/inference_server.py:123-134`)."""
        return {
            "redis_url": os.environ.get("EMO_REDIS_URL", "redis://localhost:6379/0"),
            "queue_key": self.config.queue_name,
            "queue_size": self.queue.qsize(),
            "batch_size": self.config.batch_size,
            "batch_timeout_ms": int(self.config.batch_timeout_ms),
            "worker_count_hint": 1,
            "uptime_sec": round(time.time() - self.started_at, 2),
        }


def worker_result(task_id: str, worker_name: str, labels: List[str], row: np.ndarray,
                  submitted_at: float) -> Dict[str, Any]:
    """The reference worker's result JSON for one task (`src/inference_worker.py`)."""
    top_idx = int(np.argmax(row))
    return {
        "task_id": task_id,
        "worker_name": worker_name,
        "labels": labels,
        "probs": [round(float(x), 6) for x in row.tolist()],
        "top1": {"label": labels[top_idx], "prob": round(float(row[top_idx]), 6)},
        "queue_delay_ms": round((time.time() - submitted_at) * 1000.0, 2),
        "processed_at": time.time(),
    }


class DynamicBatcher:
    """Collects queued tasks into bucketed batches and runs the model
    (reference RedisBatchWorker, `src/inference_worker.py:46-219`)."""

    def __init__(
        self,
        gateway: InferenceGateway,
        runner,
        config: Optional[ServeConfig] = None,
        preprocess=None,
        preprocess_workers: int = 4,
    ):
        self.gateway = gateway
        self.runner = runner
        self.config = config or gateway.config
        self.preprocess = preprocess or EmotionPreprocessService()
        self.pool = ThreadPoolExecutor(max_workers=max(1, preprocess_workers))
        self._stop = asyncio.Event()
        self.timer = StageTimer()

    async def run(self) -> None:
        """Two-stage pipeline: host preprocessing (and the staged copy) of
        batch N+1 overlaps the forward of batch N (the reference worker is
        fully serial, `src/inference_worker.py:61-65`)."""
        prepped: asyncio.Queue = asyncio.Queue(maxsize=2)

        async def producer():
            while not self._stop.is_set():
                task_ids = await self._pop_batch()
                if not task_ids:
                    continue
                item = await self._prepare_batch(task_ids)
                if item is not None:
                    await prepped.put(item)
            await prepped.put(None)

        async def consumer():
            while True:
                item = await prepped.get()
                if item is None:
                    return
                await self._infer_batch(*item)

        prod = asyncio.create_task(producer())
        try:
            await consumer()
        finally:
            prod.cancel()

    def stop(self) -> None:
        self._stop.set()

    async def _pop_batch(self) -> List[str]:
        try:
            first = await asyncio.wait_for(self.gateway.queue.get(), timeout=1.0)
        except asyncio.TimeoutError:
            return []
        task_ids = [first]
        deadline = time.monotonic() + self.config.batch_timeout_ms / 1000.0
        while len(task_ids) < self.config.batch_size:
            try:
                task_ids.append(self.gateway.queue.get_nowait())
            except asyncio.QueueEmpty:
                if time.monotonic() >= deadline:
                    break
                await asyncio.sleep(0.001)
        return task_ids

    def _preprocess_item(self, item: Dict[str, Any]) -> Dict[str, Any]:
        video, audio, blank_video = self.preprocess.preprocess_payload(
            item["filename"],
            item["payload"],
            use_face_crop=True,
            use_wavlm=bool(getattr(self.runner, "use_wavlm", False)),
            raw_uint8=bool(getattr(self.runner, "device_normalize", False)),
        )
        return {
            "task_id": item["task_id"],
            "submitted_at": item["submitted_at"],
            "video": video[0],
            "audio": audio[0],
            "blank_video": blank_video,
        }

    async def _prepare_batch(self, task_ids: List[str]):
        """Stage 1: fetch payloads, preprocess in the thread pool, start the
        host->device copy.  -> (infos, prepared, videos, audios, n_staged) or None."""
        store = self.gateway.store
        infos = []
        for task_id in task_ids:
            task = store.get_task(task_id)
            payload = store.get_payload(task_id)
            if not task or payload is None:
                self._mark_failed(task_id, "Task payload missing or expired.")
                continue
            infos.append(
                {
                    "task_id": task_id,
                    "filename": task.get("filename", "upload.mp4"),
                    "submitted_at": float(task.get("submitted_at", str(time.time()))),
                    "payload": payload,
                }
            )
        if not infos:
            return None
        loop = asyncio.get_running_loop()
        try:
            with self.timer.stage("preprocess"):
                prepared = await asyncio.gather(
                    *(loop.run_in_executor(self.pool, self._preprocess_item, i) for i in infos)
                )
                # Wires (both keep the values exact): an all-blank video batch
                # (audio-only uploads) ships no video, the runner makes it on
                # the device; WavLM waveforms travel as int16 PCM (the uploads
                # are 16-bit PCM, /32768 on the device is lossless).
                if all(p["blank_video"] for p in prepared) and hasattr(
                    self.runner, "predict_probs_blank_video"
                ):
                    videos = None
                else:
                    videos = np.stack([p["video"] for p in prepared])
                audios = np.stack([p["audio"] for p in prepared])
                if (
                    getattr(self.runner, "use_wavlm", False)
                    and self.config.audio_int16_wire
                    and audios.dtype == np.float32
                ):
                    audios = np.clip(audios * 32768.0, -32768, 32767).astype(np.int16)
                # Start the host->device copy here, so it overlaps the
                # previous batch's forward.
                n_staged = None
                if videos is None and hasattr(self.runner, "stage_audio"):
                    audios, n_staged = self.runner.stage_audio(audios)
                elif videos is not None and hasattr(self.runner, "stage"):
                    videos, audios, n_staged = self.runner.stage(videos, audios)
        except Exception as exc:
            for item in infos:
                self._mark_failed(item["task_id"], str(exc))
            return None
        return infos, prepared, videos, audios, n_staged

    async def _infer_batch(self, infos, prepared, videos, audios, n_staged) -> None:
        """Stage 2: the forward in an executor thread, then per-task results."""
        loop = asyncio.get_running_loop()
        try:
            with self.timer.stage("infer"):
                if videos is None:
                    if n_staged is None:  # a runner without staging (e.g. mock)
                        call = lambda: self.runner.predict_probs_blank_video(audios)
                    else:
                        call = lambda: self.runner.predict_probs_blank_video(audios, n_staged)
                elif n_staged is None:
                    call = lambda: self.runner.predict_probs(videos, audios)
                else:
                    call = lambda: self.runner.predict_probs(videos, audios, n_staged)
                probs = await loop.run_in_executor(None, call)
            self.timer.record("batch_size", float(len(infos)))
            labels = list(self.runner.labels)
            for row, item in zip(probs, prepared):
                result = worker_result(item["task_id"], self.config.worker_name, labels, row,
                                       item["submitted_at"])
                self._mark_completed(item["task_id"], result)
        except Exception as exc:
            # Whole-batch failure marking: reference behaviour
            # (`src/inference_worker.py:148-150`).
            for item in infos:
                self._mark_failed(item["task_id"], str(exc))

    def _mark_completed(self, task_id: str, result: Dict[str, Any]) -> None:
        self.gateway.store.update_task(
            task_id, {"status": "completed", "completed_at": str(time.time()), "result": result}
        )
        self.gateway.store.delete_payload(task_id)

    def _mark_failed(self, task_id: str, error: str) -> None:
        self.gateway.store.update_task(
            task_id, {"status": "failed", "failed_at": str(time.time()), "error": error}
        )
        self.gateway.store.delete_payload(task_id)
