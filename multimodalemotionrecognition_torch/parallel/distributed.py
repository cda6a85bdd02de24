"""Process groups for data parallelism over `torch.distributed`.

Counterpart of the JAX package's `parallel/distributed.py`
(`maybe_initialize_distributed`, `is_multi_host`).  JAX runs one process per
host and lets XLA insert the collectives of a sharded step; PyTorch runs one
process per rank, one rank per card, and this module gives them what the
step needs:

  * `maybe_initialize_distributed` starts the default process group from
    torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
    `MASTER_ADDR`, `MASTER_PORT`); without it, it is a no-op that returns
    False, as JAX's is without `JAX_COORDINATOR_ADDRESS`.
  * `rank`, `world_size`, `local_device`, and `local_row`, the devices of
    this rank's mesh row under tensor parallelism (a rank owns a row: its
    model axis runs inside the process, `parallel/tensor.py`).
  * `launch` spawns `world_size` ranks on `torch.multiprocessing` (tests,
    `chip_smoke.py`, `train --mesh_data N` started alone), each on the
    device, or the mesh row of devices, it is given, and returns what each
    rank's function returned.
  * `all_reduce_sum` and `all_gather_rows`, differentiable collectives
    (`torch.autograd.Function`s over `torch.distributed`), which train-mode
    BatchNorm and the CLIP alignment loss use to see the global batch.
  * `batch_shard`, the context a data-parallel step runs in: which rows of
    the global batch this rank holds, and the group to reduce over.

Backends: NCCL across distinct cards, Gloo only where the caller names it
(the CPU, or two ranks on one card: NCCL refuses that, Gloo stages its CUDA
collectives through the host).  With rows, NCCL needs each rank's cards to
be its own; a collective of a row's tensors runs per device
(`train/trainer.py::reduce_gradients`), so the ranks' rows must list their
devices in the same pattern.  Nothing switches backend quietly, a rank
asked for a card that is not there raises, and a failed collective raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "ALONE",
    "BatchShard",
    "all_gather_rows",
    "all_reduce_sum",
    "batch_shard",
    "current_shard",
    "is_multi_host",
    "launch",
    "local_device",
    "local_row",
    "maybe_initialize_distributed",
    "rank",
    "world_size",
]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_BACKENDS = ("nccl", "gloo")


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if _initialized() else 0


def world_size() -> int:
    """Ranks in the default group (1 without one)."""
    return dist.get_world_size() if _initialized() else 1


def is_multi_host() -> bool:
    """Whether this process is one of several ranks."""
    return world_size() > 1


def local_device(device_type: str = "cuda") -> torch.device:
    """The device this rank runs on: `cuda:LOCAL_RANK` (0 without torchrun's
    environment), or the CPU.  A rank whose card is not there raises."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"local_device: device type {device_type!r} is neither 'cuda' nor 'cpu'")
    index = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= count:
        raise RuntimeError(f"rank with LOCAL_RANK={index} finds {count} CUDA card(s)")
    return torch.device("cuda", index)


def local_row(tp: int, device_type: str = "cuda") -> Tuple[torch.device, ...]:
    """The `tp` devices of this rank's mesh row: cards LOCAL_RANK * tp ..
    LOCAL_RANK * tp + tp - 1 (LOCAL_RANK 0 without torchrun's environment),
    or the CPU `tp` times.  A rank whose cards are not all there raises (to
    share one card, pass the row itself, e.g. `["cuda:0"] * 2`)."""
    if device_type == "cpu":
        return (torch.device("cpu"),) * tp
    if device_type != "cuda":
        raise ValueError(f"local_row: device type {device_type!r} is neither 'cuda' nor 'cpu'")
    first = int(os.environ.get("LOCAL_RANK", "0")) * tp
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if first + tp > count:
        raise RuntimeError(f"a mesh row of {tp} cards from cuda:{first} finds {count} CUDA card(s)")
    return tuple(torch.device("cuda", first + i) for i in range(tp))


def _row(device) -> Tuple[torch.device, ...]:
    """A rank's device or mesh row as a tuple of devices."""
    if isinstance(device, (list, tuple)):
        return tuple(torch.device(d) for d in device)
    return (torch.device(device),)


def _check_backend(backend: str, devices: Sequence[Any]) -> None:
    """`devices`: one device, or one mesh row of devices, per rank."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}; got {backend!r}")
    if backend == "nccl":
        rows = [_row(d) for d in devices]
        if any(d.type != "cuda" for row in rows for d in row):
            raise ValueError("the NCCL backend takes CUDA devices only (name 'gloo' for the CPU)")
        cards = [{d.index or 0 for d in row} for row in rows]
        if sum(map(len, cards)) != len(set().union(*cards)):
            raise ValueError(
                f"NCCL refuses two ranks on one card ({[str(d) for row in rows for d in row]}); "
                "name the 'gloo' backend for that")


def maybe_initialize_distributed(
    backend: Optional[str] = None, device_type: str = "cuda", timeout_s: float = 600.0
) -> bool:
    """Start the default process group from torchrun's environment.  ->
    whether this process is one of several ranks.  Without that environment
    (or with WORLD_SIZE 1) nothing happens and the answer is False.
    `backend` None is NCCL for `device_type` "cuda" and Gloo for "cpu"; on
    NCCL the rank's card becomes the current one."""
    if _initialized():
        return dist.get_world_size() > 1
    if any(key not in os.environ for key in _TORCHRUN_ENV) or int(os.environ["WORLD_SIZE"]) <= 1:
        return False
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    device = local_device(device_type)
    _check_backend(backend, [device])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group's ranks; dx = the sum of dy (each
    rank's loss depends on every rank's x through y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, op=dist.ReduceOp.SUM, group=ctx.group)
        return dx, None


class _AllGatherRows(torch.autograd.Function):
    """y = every rank's x, concatenated along dim 0 in rank order (equal
    row counts); dx = this rank's rows of the sum of dy.  The collectives
    run in float32 whatever x's dtype (Gloo has no bfloat16 on every build)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows, ctx.rank = x.shape[0], dist.get_rank(group)
        xf = x.detach().float().contiguous()
        parts = [torch.empty_like(xf) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, xf, group=group)
        return torch.cat(parts).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        df = dy.float().contiguous().clone()
        dist.all_reduce(df, op=dist.ReduceOp.SUM, group=ctx.group)
        return df[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows].to(dy.dtype), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of `group` (default group)."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable concatenation of every rank's `x` along dim 0."""
    return _AllGatherRows.apply(x, group)


# ---------------------------------------------------------------------------
# the rows a data-parallel step holds
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's share of a global batch: the `rank`-th of `world` equal
    row blocks, and the group whose ranks hold the others (None: the default
    group).  `BatchShard(0, 1)` is a process alone: its `sum` and `gather`
    return their input, so a layer keeps one formula for both cases."""

    rank: int
    world: int
    group: Any = None

    def rows(self, n: int) -> slice:
        """This rank's rows of a global tensor whose local part has `n` rows."""
        return slice(self.rank * n, (self.rank + 1) * n)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """`all_reduce_sum` over the shard's ranks."""
        return x if self.world == 1 else all_reduce_sum(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """`all_gather_rows` over the shard's ranks."""
        return x if self.world == 1 else all_gather_rows(x, self.group)


ALONE = BatchShard(0, 1)
_SHARD: contextvars.ContextVar = contextvars.ContextVar("batch_shard", default=ALONE)


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]):
    """Run a block as `shard`'s part of a data-parallel step (None: alone)."""
    token = _SHARD.set(shard or ALONE)
    try:
        yield shard
    finally:
        _SHARD.reset(token)


def current_shard() -> BatchShard:
    """The `BatchShard` of the step being run, `ALONE` outside one."""
    return _SHARD.get()


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank_, world, backend, device, port, args, results, timeout_s):
    """One spawned rank: its group, then fn(rank, world, device, *args)
    (`device` a tuple of devices for a mesh row, the first one current)."""
    try:
        device = tuple(map(torch.device, device)) if isinstance(device, tuple) else torch.device(device)
        first = device[0] if isinstance(device, tuple) else device
        if first.type == "cuda":
            torch.cuda.set_device(first)
        # A collective that waits past this raises (at most half an hour).
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank_, world_size=world,
            timeout=datetime.timedelta(seconds=min(timeout_s, 1800.0)),
        )
        try:
            out = fn(rank_, world, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank_, True, out))
    except BaseException:  # noqa: BLE001 - every failure goes back to the parent
        results.put((rank_, False, traceback.format_exc()))
        raise SystemExit(1)


def _spawnable(device):
    """A device or a row as strings (what a spawned process unpickles)."""
    return tuple(map(str, device)) if isinstance(device, tuple) else str(device)


def launch(
    fn: Callable,
    world_size: int,
    backend: str,
    devices: Sequence[Any],
    args: tuple = (),
    timeout_s: float = 900.0,
) -> List[Any]:
    """Spawn `world_size` ranks, rank r on `devices[r]` in a group of
    `backend` on a free local port, each calling fn(r, world_size, device,
    *args).  `devices[r]` is a device, or a sequence of devices (the rank's
    mesh row under tensor parallelism), which fn gets as a tuple.  -> fn's
    results by rank (picklable values: move tensors to the CPU).  `fn` must
    be importable by name (a module's top-level function).  If a rank
    fails, every rank is stopped and its traceback raised; past `timeout_s`
    the same with TimeoutError."""
    devices = [_row(d) if isinstance(d, (list, tuple)) else torch.device(d) for d in devices]
    if len(devices) != world_size or world_size < 1:
        raise ValueError(f"launch: {len(devices)} devices for {world_size} ranks")
    _check_backend(backend, devices)
    flat = [d for entry in devices for d in _row(entry)]
    if any(d.type == "cuda" for d in flat):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        wanted = max(d.index or 0 for d in flat if d.type == "cuda")
        if wanted >= count:
            raise RuntimeError(
                f"launch: {[str(d) for d in flat]} asked for, {count} CUDA card(s) here")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, _spawnable(devices[r]),
                                             port, args, results, timeout_s), daemon=True)
        for r in range(world_size)
    ]
    for p in procs:
        p.start()
    out: dict = {}
    failed: dict = {}
    deadline = time.monotonic() + timeout_s
    grace = None  # once a rank has failed: how long the others' tracebacks may take
    try:
        while len(out) + len(failed) < world_size:
            try:
                r, ok, value = results.get(timeout=1.0)
                (out if ok else failed)[r] = value
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: ranks still running after {timeout_s} s")
            if grace is None and (failed or any(p.exitcode not in (None, 0) for p in procs)):
                # The other ranks fail in their collectives next: a few seconds
                # for their tracebacks, so the first cause is among them.
                grace = time.monotonic() + 5.0
            if grace is not None and (time.monotonic() > grace
                                      or all(p.exitcode is not None for p in procs)):
                break
        while len(out) + len(failed) < world_size:  # what the exited ranks left queued
            try:
                r, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                break
            (out if ok else failed)[r] = value
        if len(out) < world_size:
            raise RuntimeError("\n".join(
                [f"rank {r} of {world_size} failed:\n{failed[r]}" for r in sorted(failed)]
                + [f"rank {r} of {world_size} exited with {p.exitcode} and no result"
                   for r, p in enumerate(procs) if r not in out and r not in failed]))
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world_size)]
