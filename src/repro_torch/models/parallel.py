"""Process groups of a (1, tp) mesh: the collectives the sharded layers run.

The reference's layers state a layout (``topo.shard``) and let the XLA
partitioner insert the collectives; the port's run them itself, through a
``Group`` of the mesh's ``tp`` ranks.  Each collective takes the rank's
tensor and returns a new one (``DistGroup`` may reduce its input in place):

* ``all_reduce(t, op)``: the elementwise sum (or max) over the ranks;
* ``all_gather(t, dim)``: the ranks' tensors concatenated along ``dim`` in
  rank order;
* ``reduce_scatter(t, dim)``: the sum over the ranks, cut along ``dim``
  into ``size`` equal runs, of which rank r keeps run r;
* ``broadcast(t, src)``: rank ``src``'s tensor on every rank.

Two implementations, and the caller always chooses one:

* ``DistGroup`` over ``torch.distributed``: NCCL with one process a card,
  gloo on the CPU.  ``spawn`` starts the processes, with a rendezvous on a
  port the OS picks, a time limit, and every process joined or killed.
* ``LocalGroup``: the ranks are threads of one process, meeting at a
  barrier; each reads the others' tensors from shared slots and sums them
  in rank order, so every rank holds the same bits.  It serves the CPU
  tests and a host with fewer cards than ranks (``run_local``), as the
  reference's own sharded test fakes its devices on the host.

Each group counts, per collective, its calls and the bytes of the tensors
its rank handed in (``counts``).
"""
from __future__ import annotations

import datetime
import multiprocessing
import pickle
import threading
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import build

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "broadcast")


class Group:
    """The ``size`` ranks of a (1, tp) mesh, seen from rank ``rank``."""

    rank: int
    size: int

    def __init__(self) -> None:
        self.counts = {c: {"calls": 0, "bytes": 0} for c in COLLECTIVES}

    def _count(self, what: str, t: torch.Tensor) -> None:
        self.counts[what]["calls"] += 1
        self.counts[what]["bytes"] += t.numel() * t.element_size()

    def reset_counts(self) -> None:
        for c in self.counts.values():
            c["calls"] = c["bytes"] = 0

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        raise NotImplementedError

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        raise NotImplementedError

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        raise NotImplementedError


def _check_op(op: str) -> None:
    if op not in ("sum", "max"):
        raise ValueError(f"unknown reduction {op!r}: sum or max")


# ---------------------------------------------------------------------------
# ranks as threads of one process
# ---------------------------------------------------------------------------
class _Hub:
    """What the threads of one ``LocalGroup`` share: two rows of a slot a
    rank, used in turns, and a barrier (its ``timeout`` turns a lost rank
    into an error)."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.slots: list[list[Any]] = [[None] * size, [None] * size]
        self.barrier = threading.Barrier(size, timeout=timeout)


class LocalGroup(Group):
    def __init__(self, hub: _Hub, rank: int, device: torch.device):
        super().__init__()
        self.hub, self.rank, self.size = hub, rank, hub.size
        self.device = torch.device(device)
        self._turn = 0

    @staticmethod
    def make(size: int, devices: Sequence = ("cpu",),
             timeout: float = 600.0) -> list["LocalGroup"]:
        """``size`` ranks, rank r on ``devices[r % len(devices)]``."""
        hub = _Hub(size, timeout)
        return [LocalGroup(hub, r, devices[r % len(devices)])
                for r in range(size)]

    def _exchange(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's tensor, in rank order, after one barrier.  The
        collectives write the two rows of slots in turns: a rank writes a
        row again only after the next barrier, which every rank reaches
        after reading it.  On one card the threads share its stream, so a
        rank's writes are ordered before the reads; a tensor on another
        card is copied under the copy's own stream synchronisation."""
        row = self.hub.slots[self._turn]
        self._turn ^= 1
        row[self.rank] = t
        self.hub.barrier.wait()
        return list(row)

    def _here(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def _fold(self, parts: list[torch.Tensor], op: str) -> torch.Tensor:
        out = self._here(parts[0])
        for x in parts[1:]:
            x = self._here(x)
            out = out + x if op == "sum" else torch.maximum(out, x)
        return out

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        _check_op(op)
        self._count("all_reduce", t)
        return self._fold(self._exchange(t), op)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        self._count("all_gather", t)
        return torch.cat([self._here(x) for x in self._exchange(t)], dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        self._count("reduce_scatter", t)
        n = t.shape[dim] // self.size
        return self._fold([x.narrow(dim, self.rank * n, n)
                           for x in self._exchange(t)], "sum")

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        self._count("broadcast", t)
        got = self._exchange(t)[src]
        return t if self.rank == src else got.to(self.device, copy=True)


def run_local(fn: Callable[[LocalGroup], Any], size: int,
              devices: Sequence = ("cpu",), timeout: float = 600.0) -> list:
    """``fn(group)`` on ``size`` threads, one a rank of a ``LocalGroup``
    (each sets its card as the thread's current device); the results in
    rank order.  The kernels are built first when a rank is on a card, so
    the threads never build them at once.  A rank that raises breaks the
    barrier, so the others stop too, and its error is raised here."""
    groups = LocalGroup.make(size, devices, timeout)
    if any(g.device.type == "cuda" for g in groups):
        build.build_all()
    results: list[Any] = [None] * size
    errors: list[BaseException | None] = [None] * size

    def body(g: LocalGroup) -> None:
        try:
            if g.device.type == "cuda":
                torch.cuda.set_device(g.device)
            results[g.rank] = fn(g)
        except BaseException as e:        # re-raised below, in this thread
            errors[g.rank] = e
            g.hub.barrier.abort()

    threads = [threading.Thread(target=body, args=(g,), name=f"rank{g.rank}")
               for g in groups]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    failed = [e for e in errors if e is not None]
    cause = [e for e in failed
             if not isinstance(e, threading.BrokenBarrierError)]
    if failed:
        raise (cause or failed)[0]
    return results


# ---------------------------------------------------------------------------
# ranks as processes: torch.distributed
# ---------------------------------------------------------------------------
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class DistGroup(Group):
    """The default process group of ``torch.distributed`` (NCCL on the
    cards, gloo on the CPU); ``device`` is the rank's."""

    def __init__(self, device: torch.device) -> None:
        super().__init__()
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.device = torch.device(device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        _check_op(op)
        self._count("all_reduce", t)
        t = t.contiguous()
        dist.all_reduce(t, _OPS[op])
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        self._count("all_gather", t)
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        self._count("reduce_scatter", t)
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // self.size, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, dist.ReduceOp.SUM)
        return out.movedim(0, dim).contiguous()

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        self._count("broadcast", t)
        t = t.contiguous()
        dist.broadcast(t, src)
        return t


def _rank_main(fn, rank: int, size: int, backend: str, port: int,
               timeout: float, queue, args: tuple) -> None:
    """A spawned rank: join the group at the parent's store, run
    ``fn(group, *args)``, put ``(rank, result, error)`` on ``queue``."""
    try:
        device = torch.device("cuda", rank) if backend == "nccl" \
            else torch.device("cpu")
        if backend == "nccl":
            torch.cuda.set_device(device)
        store = dist.TCPStore("127.0.0.1", port, is_master=False,
                              timeout=datetime.timedelta(seconds=timeout))
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=size,
                                timeout=datetime.timedelta(seconds=timeout),
                                **kw)
        try:
            # plain pickle: the queue's pickler would pass a tensor as a
            # shared-memory handle, which dies with this process
            queue.put((rank, pickle.dumps(fn(DistGroup(device), *args)),
                       None))
        finally:
            dist.destroy_process_group()
    except BaseException:                 # reported to the parent
        queue.put((rank, None, traceback.format_exc()))


def spawn(fn: Callable, size: int, backend: str = "gloo",
          timeout: float = 600.0, args: tuple = ()) -> list:
    """``fn(DistGroup(device), *args)`` in ``size`` new processes, one a rank
    (with ``nccl`` rank r on card r, the kernels built here first, so the
    processes never build them at once); the results in rank order.
    ``fn`` and ``args`` must pickle (a module-level function), and so must
    the results, on the host.  The
    rendezvous store listens on 127.0.0.1 at a port the OS picks.  Raises
    the first rank's error, or ``TimeoutError`` after ``timeout`` seconds;
    every process is joined, or killed, before this returns."""
    if backend == "nccl":
        build.build_all()
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, size, backend, store.port, timeout,
                               queue, args), daemon=True)
             for r in range(size)]
    results: list[Any] = [None] * size
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for done in range(size):
            while queue.empty():
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{size - done} of {size} ranks gave "
                                       f"no result within {timeout} s")
                if not any(p.is_alive() for p in procs) and queue.empty():
                    raise RuntimeError(f"every rank exited and {size - done}"
                                       f" gave no result")
                time.sleep(0.02)
            rank, result, error = queue.get()
            if error is not None:
                raise RuntimeError(f"rank {rank} failed:\n{error}")
            results[rank] = pickle.loads(result)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        del store
    return results
