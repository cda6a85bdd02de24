"""The port's Redis transport against the JAX package's, on the in-memory
`FakeRedis` of `tests/test_redis_transport.py`: both packages write the same
keys and the same JSON (apart from clocks and ids) to one fake, and each
package's gateway reads what the other's worker wrote."""

import asyncio
import json
import time

import numpy as np
import pytest

from multimodalemotionrecognition_tpu.config import ServeConfig as JaxServeConfig
from multimodalemotionrecognition_tpu.serving import redis_transport as jax_redis
from multimodalemotionrecognition_tpu.serving.batcher import GatewayError as JaxGatewayError
from multimodalemotionrecognition_torch.config import ServeConfig
from multimodalemotionrecognition_torch.serving import redis_transport
from multimodalemotionrecognition_torch.serving.batcher import GatewayError

from tests.test_redis_transport import FakeRedis, _StubRunner, fake_redis_module  # noqa: F401
from tests.test_torch_serving import _mask, _wav

TRANSPORTS = {"jax": (jax_redis, JaxServeConfig), "torch": (redis_transport, ServeConfig)}
ERRORS = {"jax": JaxGatewayError, "torch": GatewayError}


def _decoded(fake, key):
    out = {k.decode(): v.decode() for k, v in fake.hgetall(key).items()}
    if "result" in out:
        out["result"] = json.loads(out["result"])
    return out


def _keys(fake):
    """Every hash and string key the fake holds, and each list's length."""
    return sorted(fake.hashes), sorted(fake.strings), {k: len(v) for k, v in fake.lists.items()}


@pytest.mark.parametrize("gateway_pkg, worker_pkg", [("jax", "torch"), ("torch", "jax"), ("torch", "torch")])
def test_gateway_to_worker_round_trip_across_packages(gateway_pkg, worker_pkg):
    cfg = ServeConfig(batch_size=4, batch_timeout_ms=5, poll_interval_ms=1)
    shared = FakeRedis()
    gw_mod, gw_cfg = TRANSPORTS[gateway_pkg]
    wk_mod, wk_cfg = TRANSPORTS[worker_pkg]
    gateway = gw_mod.RedisGateway(gw_cfg(batch_size=4, batch_timeout_ms=5, poll_interval_ms=1),
                                  client=shared)
    worker = wk_mod.RedisWorker(_StubRunner(), config=wk_cfg(batch_size=4, batch_timeout_ms=5),
                                client=shared)

    async def scenario():
        ids = await gateway.submit_many([(f"g{i}.wav", _wav(seed=i)) for i in range(3)])
        queued = _mask(await gateway.get_result(ids[0]))
        assert gateway.queue_stats()["queue_size"] == 3
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, lambda: worker._process_batch(worker._pop_batch()))
        results = await asyncio.gather(*(gateway.wait_for_result(t, timeout_sec=2.0) for t in ids))
        return ids, queued, results

    ids, queued, results = asyncio.run(scenario())
    assert queued == {"status": "queued", "filename": "g0.wav", "submitted_at": "<volatile>"}
    for task_id, result in zip(ids, results):
        assert result["task_id"] == task_id and result["top1"] == {"label": "angry", "prob": 1.0}
        assert set(result) == {"task_id", "worker_name", "labels", "probs", "top1",
                               "queue_delay_ms", "processed_at"}
        assert shared.get(f"{cfg.task_prefix}{task_id}:payload") is None
        assert shared.ttls[f"{cfg.task_prefix}{task_id}"] == cfg.result_ttl_sec
    assert shared.lists[cfg.queue_name] == []


def _worker_run(name, with_payload):
    """One worker batch on a fresh fake: 2 tasks, the second one's payload
    missing when `with_payload` is False.  -> the stored hashes and keys."""
    mod, cfg_cls = TRANSPORTS[name]
    cfg = cfg_cls(batch_size=4, batch_timeout_ms=5)
    fake = FakeRedis()
    worker = mod.RedisWorker(_StubRunner(), config=cfg, client=fake)
    for i, task_id in enumerate(("t0", "t1")):
        fake.hset(f"{cfg.task_prefix}{task_id}",
                  mapping={"status": "queued", "filename": f"c{i}.wav", "submitted_at": str(time.time())})
        if with_payload or i == 0:
            fake.set(f"{cfg.task_prefix}{task_id}:payload", _wav(seed=i))
        fake.rpush(cfg.queue_name, task_id)
    batch = worker._pop_batch()
    worker._process_batch(batch)
    return batch, [_mask(_decoded(fake, f"{cfg.task_prefix}{t}")) for t in ("t0", "t1")], _keys(fake), fake.ttls


@pytest.mark.parametrize("with_payload", [True, False], ids=["both_payloads", "one_payload_expired"])
def test_worker_batch_contract_equals_jax(fake_redis_module, with_payload):  # noqa: F811
    got = _worker_run("torch", with_payload)
    assert got == _worker_run("jax", with_payload)
    batch, (first, second), _, _ = got
    assert batch == ["t0", "t1"]
    assert first["status"] == "completed" and first["result"]["top1"]["label"] == "angry"
    if with_payload:
        assert second["status"] == "completed"
    else:
        assert second["status"] == "failed" and second["error"] == "Task payload missing or expired."


def test_gateway_error_paths_equal_jax():
    def codes(name):
        mod, cfg_cls = TRANSPORTS[name]
        cfg = cfg_cls(poll_interval_ms=1)
        gateway = mod.RedisGateway(cfg, client=FakeRedis())
        error_type = ERRORS[name]

        async def scenario():
            out = []
            task_id = await gateway.submit("x.wav", b"data")
            calls = (gateway.submit("x.wav", b""), gateway.get_result("nope"),
                     gateway.wait_for_result(task_id, timeout_sec=0.02))
            for coro in calls:
                try:
                    await coro
                except error_type as e:
                    out.append((e.status_code, _mask(e.detail)))
            gateway.redis.hset(f"{cfg.task_prefix}{task_id}", mapping={"status": "failed", "error": "boom"})
            try:
                await gateway.wait_for_result(task_id, timeout_sec=1.0)
            except error_type as e:
                out.append((e.status_code, e.detail))
            return out

        return asyncio.run(scenario()), _mask(gateway.queue_stats())

    assert codes("torch") == codes("jax")
    assert [c for c, _ in codes("torch")[0]] == [400, 404, 202, 500]


def test_queued_app_selects_the_redis_gateway(fake_redis_module):  # noqa: F811
    from multimodalemotionrecognition_torch.serving.server_queued import create_app

    cfg = ServeConfig(mock=True)
    shared = FakeRedis()
    app = create_app(config=cfg, redis_client=shared)
    assert isinstance(app["gateway"], redis_transport.RedisGateway)
    assert app["batcher"] is None
    task_id = asyncio.run(app["gateway"].submit("a.wav", b"payload"))
    assert shared.llen(cfg.queue_name) == 1
    assert shared.get(f"{cfg.task_prefix}{task_id}:payload") == b"payload"
    # Without an injected client the redis package is imported (the fake here).
    assert isinstance(redis_transport.RedisWorker(_StubRunner(), config=cfg).redis, FakeRedis)
    assert redis_transport.redis_available()


def test_worker_probabilities_are_rounded_like_jax(fake_redis_module):  # noqa: F811
    class Runner(_StubRunner):
        def predict_probs(self, videos, audios):
            return np.tile(np.linspace(0.01, 0.2345678912, 8), (len(videos), 1))

    for name in TRANSPORTS:
        mod, cfg_cls = TRANSPORTS[name]
        cfg = cfg_cls()
        fake = FakeRedis()
        worker = mod.RedisWorker(Runner(), config=cfg, client=fake)
        fake.hset(f"{cfg.task_prefix}r", mapping={"status": "queued", "filename": "r.wav",
                                                  "submitted_at": str(time.time())})
        fake.set(f"{cfg.task_prefix}r:payload", _wav())
        worker._process_batch(["r"])
        probs = _decoded(fake, f"{cfg.task_prefix}r")["result"]["probs"]
        assert probs == [round(float(x), 6) for x in np.linspace(0.01, 0.2345678912, 8)]
