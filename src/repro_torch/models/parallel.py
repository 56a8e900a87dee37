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
  reference's own sharded test fakes its devices on the host.  It serves
  no backward on a card: autograd runs a card's backward on one thread
  of its own, where the ranks' collectives would wait for each other
  until the barrier's timeout; ranks that share a card train as gloo
  processes (``spawn(..., devices=)``).

Each group counts, per collective, its calls and the bytes of the tensors
its rank handed in (``counts``), those of a backward pass too.

Training differentiates through four collectives (``torch.autograd``
functions over a group's), each with its conjugate as its backward, as
Megatron-LM pairs them:

* ``gather(x, group, dim)``: ``all_gather`` forward, ``reduce_scatter``
  backward (a sequence-sharded residual entering a sublayer; k and v over
  their head_dim);
* ``scatter(x, group, dim)``: ``reduce_scatter`` forward, ``all_gather``
  backward (a row-parallel product's partials onto the rank's run);
* ``reduce(x, group)``: ``all_reduce`` forward, the gradient passed
  through (a row-parallel product's partials summed, whole on every rank);
* ``replicate(x, group)``: the identity forward, ``all_reduce`` backward (a
  replicated activation entering cut weights: each rank's gradient of it
  is a share of the whole).

With ``group`` None each is the identity.
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
    cards, gloo on the CPU or between processes that share a card);
    ``device`` is the rank's.  Every collective writes a new tensor, never
    the caller's (autograd may have saved it for the backward).  gloo
    takes host tensors, so a card's tensor goes through the host there."""

    def __init__(self, device: torch.device) -> None:
        super().__init__()
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.device = torch.device(device)
        self._host = dist.get_backend() == "gloo"

    def _in(self, t: torch.Tensor, inplace: bool = False) -> torch.Tensor:
        """``t`` contiguous where the backend reads it; a copy where the
        collective writes its input (``inplace``)."""
        x = t.cpu() if self._host else t
        if inplace and x is t:
            return x.clone(memory_format=torch.contiguous_format)
        return x.contiguous()

    def _out(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device) if self._host else t

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        _check_op(op)
        self._count("all_reduce", t)
        x = self._in(t, inplace=True)
        dist.all_reduce(x, _OPS[op])
        return self._out(x, t)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        self._count("all_gather", t)
        x = self._in(t.movedim(dim, 0))
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return self._out(out.movedim(0, dim).contiguous(), t)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        self._count("reduce_scatter", t)
        x = self._in(t.movedim(dim, 0))
        out = x.new_empty((x.shape[0] // self.size, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, dist.ReduceOp.SUM)
        return self._out(out.movedim(0, dim).contiguous(), t)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        self._count("broadcast", t)
        x = self._in(t, inplace=True)
        dist.broadcast(x, src)
        return self._out(x, t)


# ---------------------------------------------------------------------------
# collectives that autograd goes through
# ---------------------------------------------------------------------------
class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; the gradient
    reduce-scattered back."""
    return x if group is None else _Gather.apply(x, group, dim)


def scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` summed, the rank's run of ``dim`` kept; the
    gradient gathered back."""
    return x if group is None else _Scatter.apply(x, group, dim)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` summed; the gradient passed to each as it is."""
    return x if group is None else _Reduce.apply(x, group)


def replicate(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; the ranks' gradients of it summed."""
    return x if group is None else _Replicate.apply(x, group)


def _rank_main(fn, rank: int, size: int, backend: str, port: int,
               timeout: float, queue, args: tuple, devices: tuple) -> None:
    """A spawned rank: join the group at the parent's store, run
    ``fn(group, *args)``, put ``(rank, result, error)`` on ``queue``."""
    try:
        device = torch.device(devices[rank % len(devices)])
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", 0)
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
            got = (rank, pickle.dumps(fn(DistGroup(device), *args)), None)
        except BaseException:             # reported to the parent at once:
            got = (rank, None, traceback.format_exc())  # the others may
        queue.put(got)                    # wait in a collective for it
        dist.destroy_process_group()
    except BaseException:                 # reported to the parent
        queue.put((rank, None, traceback.format_exc()))


def spawn(fn: Callable, size: int, backend: str = "gloo",
          timeout: float = 600.0, args: tuple = (),
          devices: Sequence | None = None) -> list:
    """``fn(DistGroup(device), *args)`` in ``size`` new processes, one a rank
    (with ``nccl`` rank r on card r; with ``gloo`` rank r on
    ``devices[r % len(devices)]``, the CPU by default, so several ranks
    may share a card), the kernels built here first when a rank is on a
    card, so the processes never build them at once; the results in rank
    order.  ``fn`` and ``args`` must pickle (a module-level function; a
    card's tensor in ``args`` reaches the ranks as a CUDA IPC handle, so
    it must outlive them), and the results must pickle on the host.  The
    rendezvous store listens on 127.0.0.1 at a port the OS picks.  Raises
    the first rank's error, or ``TimeoutError`` after ``timeout`` seconds;
    every process is joined, or killed, before this returns."""
    if backend == "nccl":
        devices = [f"cuda:{r}" for r in range(size)]
    devices = tuple(str(d) for d in (devices or ("cpu",)))
    if any(torch.device(d).type == "cuda" for d in devices):
        build.build_all()
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, size, backend, store.port, timeout,
                               queue, args, devices), daemon=True)
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
