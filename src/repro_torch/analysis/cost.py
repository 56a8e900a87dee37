"""Cost of what the port dispatches: the counterpart of the reference's
``repro.analysis.hlo``.

The reference parses a step's compiled HLO and walks its instructions.  The
port runs eagerly and has no HLO, so ``CostCounter`` is a
``TorchDispatchMode`` that sees every aten op a step dispatches, forward
and backward through autograd, on the CPU, on ``meta`` tensors (a dry run
that moves no data) or on the card alike, and charges each by the
reference's rules:

  * matrix products: 2·m·n·k, from ``torch.utils.flop_counter``'s formulas;
    those with bfloat16 or float16 operands also count as ``tensor_flops``
    (the card's tensor cores; float32 products run off them, TF32 being
    off);
  * elementwise ops: one flop an output element; transcendentals four, and
    counted; reductions: input elements minus output elements;
  * views are free, as the reference's ``bitcast``;
  * ``hbm_bytes``: operands and results of each op (what eager execution
    moves); ``hbm_bytes_min``: only the ops of ``MATERIALIZE``, the aten
    counterparts of the reference's ``_MATERIALIZE_OPS``;
  * slicing and writes in place as the reference's ``_traffic``: a write
    into a slice (a cache update) moves twice the update, a gather or an
    embedding twice its result, a scatter twice its update.

A kernel call (``repro_torch.kernels.build.counted``) is charged its work
function's flops, bytes (to both byte estimates) and exps, and the ops of a
plain twin that runs inside it on the CPU are not counted, so a step counts
the same on every device.  The counter also records kernel calls by name
and the peak of live bytes over the step (every storage an op allocates,
tracked until it is freed, the tensors handed to ``track`` and each
kernel call's workspace while it runs): the counterpart of the
reference's ``memory_analysis()``.  Eager code has no loop to resolve:
``unresolved_loops`` stays 0.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# aten op (base name, in place or not) -> the reference's HLO op whose
# operands and results move through HBM even under TPU fusion
MATERIALIZE = {
    **dict.fromkeys(("mm", "addmm", "bmm", "baddbmm", "matmul", "mv", "dot",
                     "_scaled_mm"), "dot"),
    **dict.fromkeys(("convolution", "_convolution", "convolution_backward"),
                    "convolution"),
    **dict.fromkeys(("index", "gather", "embedding", "index_select",
                     "take"), "gather"),
    **dict.fromkeys(("index_put", "_index_put_impl", "scatter",
                     "scatter_add", "scatter_reduce", "index_add",
                     "index_copy", "embedding_dense_backward"), "scatter"),
    **dict.fromkeys(("copy", "slice_scatter", "select_scatter"),
                    "dynamic-update-slice"),
    **dict.fromkeys(("sort", "topk", "argsort"), "sort"),
    "clone": "copy",
    **dict.fromkeys(("cat", "stack"), "concatenate"),
    "constant_pad_nd": "pad",
    **dict.fromkeys(("sum", "mean", "amax", "amin", "max", "min", "prod",
                     "argmax", "argmin", "any", "all", "var", "var_mean",
                     "std", "norm", "linalg_vector_norm", "logsumexp",
                     "_softmax", "_log_softmax", "_softmax_backward_data",
                     "_log_softmax_backward_data"), "reduce"),
}

# one flop an output element (the reference's _EW_OPS)
_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "eq", "ne",
    "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "neg", "abs", "floor", "ceil", "round", "trunc", "clamp",
    "clamp_min", "clamp_max", "sign", "reciprocal", "square", "remainder",
    "fmod", "masked_fill", "threshold_backward", "cumsum"))
# four flops and one transcendental an output element (the reference's
# _TRANS_OPS)
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "log", "log2", "log1p", "expm1", "rsqrt", "sqrt", "tanh",
    "sigmoid", "pow", "sin", "cos", "erf"))
# composites the reference sees as several ops: (flops, transcendentals)
# an output element
_COMPOSITE = {
    "silu": (5, 1), "silu_backward": (8, 1), "gelu": (12, 1),
    "gelu_backward": (16, 1), "softplus": (10, 2), "softplus_backward": (5, 1),
    "sigmoid_backward": (2, 0), "tanh_backward": (2, 0),
    "_softmax": (8, 1), "_log_softmax": (7, 1),
    "_softmax_backward_data": (4, 0), "_log_softmax_backward_data": (8, 1),
    "addcmul": (2, 0), "addcdiv": (2, 0), "lerp": (2, 0),
}
_REDUCTIONS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "any", "all", "var", "var_mean", "std", "norm", "linalg_vector_norm",
    "logsumexp", "nansum"))
_GATHERS = frozenset(("index", "gather", "embedding", "index_select",
                      "take"))
# scatter-like op -> the argument holding its update (a scatter of a
# number: its index); those that add count a flop an update element
_SCATTERS = {"index_put": 2, "_index_put_impl": 2, "scatter": 3,
             "scatter_add": 3, "scatter_reduce": 3, "index_add": 3,
             "index_copy": 3, "embedding_dense_backward": 0,
             "slice_scatter": 1, "select_scatter": 1}
_ACCUMULATE = frozenset(("scatter_add", "scatter_reduce", "index_add",
                         "embedding_dense_backward"))
_WRITES = frozenset(("fill", "zero", "zeros", "ones", "full", "zeros_like",
                     "ones_like", "full_like", "new_zeros", "new_ones",
                     "new_full", "scalar_tensor"))
# ops that move no data (the reference's parameter, bitcast, iota...) or
# only allocate
_FREE = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "lift_fresh", "lift_fresh_copy", "arange",
    "_local_scalar_dense", "set_", "resize_", "is_same_size", "detach"))
_HALF = (torch.bfloat16, torch.float16)


@dataclass
class Cost:
    """Per-step counts, the reference's ``Cost`` and one more field:
    ``tensor_flops``, the part of ``flops`` the card runs on its tensor
    cores (bfloat16/float16 products and the bf16 flash kernels); the rest
    runs at the float32 rate."""
    flops: float = 0.0
    hbm_bytes: float = 0.0        # every op's operands + results
    hbm_bytes_min: float = 0.0    # only MATERIALIZE's ops and the kernels
    coll_bytes: dict = field(default_factory=dict)
    transcendentals: float = 0.0
    unresolved_loops: int = 0
    tensor_flops: float = 0.0

    def add(self, other: "Cost", times: float = 1.0) -> None:
        self.flops += other.flops * times
        self.hbm_bytes += other.hbm_bytes * times
        self.hbm_bytes_min += other.hbm_bytes_min * times
        self.transcendentals += other.transcendentals * times
        self.unresolved_loops += other.unresolved_loops
        self.tensor_flops += other.tensor_flops * times
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * times

    @property
    def collective_total(self) -> float:
        return sum(self.coll_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@functools.lru_cache(maxsize=None)
def _op_info(func) -> tuple[str, bool, tuple[bool, ...]]:
    """(base name, is a view, which returns alias an input) of an aten
    op."""
    name = func._overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    aliased = tuple(r.alias_info is not None for r in func._schema.returns)
    view = any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)
    return name, view, aliased


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched inside its ``with`` block: ``cost``
    (``Cost``), ``calls`` (kernel name -> calls), ``matmul_flops`` (the
    products alone, as ``torch.utils.flop_counter.FlopCounterMode`` counts
    them), ``live_bytes`` and ``peak_bytes`` (the storages alive; the
    tensors given to ``track`` count from then on)."""

    def __init__(self) -> None:
        super().__init__()
        self.cost = Cost()
        self.calls: dict[str, int] = {}
        self.matmul_flops = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: dict[int, tuple[weakref.ref, int]] = {}
        self._quiet = 0
        self._lock = threading.RLock()

    # -- memory ---------------------------------------------------------
    def track(self, *trees) -> int:
        """Count the storages of the tensors in ``trees`` (nested dicts,
        lists, tuples) as live from now on (a step's parameters, optimizer
        state, inputs and caches); returns the bytes added."""
        added = sum(self._register(t) for tree in trees
                    for t in _tensors(tree))
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return added

    def _register(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._storages:
                return 0
            n = st.nbytes()
            self._storages[key] = (
                weakref.ref(st, functools.partial(self._freed, key)), n)
            self.live_bytes += n
        return n

    def _freed(self, key: int, _ref) -> None:
        with self._lock:
            _, n = self._storages.pop(key)
            self.live_bytes -= n

    # -- kernels --------------------------------------------------------
    @contextlib.contextmanager
    def kernel_call(self, name: str, work):
        """One kernel call (``build.counted``): the ops inside are not
        counted; ``work()`` (a ``build.Work``) is charged, and its
        workspace counts on top of what is live."""
        self._quiet += 1
        try:
            yield
            w = work()
        finally:
            self._quiet -= 1
        c = self.cost
        c.flops += w.flops
        c.tensor_flops += w.tensor_flops
        c.transcendentals += w.exps
        c.hbm_bytes += w.bytes
        c.hbm_bytes_min += w.bytes
        self.calls[name] = self.calls.get(name, 0) + 1
        self.peak_bytes = max(self.peak_bytes, self.live_bytes + w.scratch)

    # -- ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        name, view, aliased = _op_info(func)
        if view:
            return out
        outs = _tensors(out)
        if name not in _FREE:
            self._charge(func, name, args, kwargs, _tensors((args, kwargs)),
                         outs, out)
        if any(aliased):                  # in place, or into out=
            vals = out if len(aliased) > 1 else (out,)
            fresh = _tensors([v for v, a in zip(vals, aliased) if not a])
        else:
            fresh = outs
        for t in fresh:
            self._register(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out

    def _charge(self, func, name, args, kwargs, ins, outs, out) -> None:
        c = self.cost
        out_elems = max((t.numel() for t in outs), default=0)
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += flops
            self.matmul_flops += flops
            if ins and ins[0].dtype in _HALF:
                c.tensor_flops += flops
        elif name in _ELEMENTWISE:
            c.flops += out_elems
        elif name in _TRANSCENDENTAL:
            c.flops += 4 * out_elems
            c.transcendentals += out_elems
        elif name in _COMPOSITE:
            f, tr = _COMPOSITE[name]
            c.flops += f * out_elems
            c.transcendentals += tr * out_elems
        elif name in _REDUCTIONS:
            if len(ins) > 1:                  # max/min of two tensors
                c.flops += out_elems
            elif ins:
                c.flops += max(ins[0].numel() - out_elems, 0)
        if name in _GATHERS:
            traffic = 2 * sum(map(_nbytes, outs))
        elif name in _SCATTERS:
            upd = args[_SCATTERS[name]] if len(args) > _SCATTERS[name] \
                else None
            if isinstance(upd, torch.Tensor):
                n, n_bytes = upd.numel(), _nbytes(upd)
            else:                             # a scatter of a number
                n = args[2].numel() if len(args) > 2 and isinstance(
                    args[2], torch.Tensor) else out_elems
                n_bytes = n * outs[0].element_size()
            traffic = 2 * n_bytes
            accumulate = args[3] if len(args) > 3 else kwargs.get(
                "accumulate", False)
            if name in _ACCUMULATE or (
                    name in ("index_put", "_index_put_impl") and accumulate):
                c.flops += n
        elif name in _WRITES:
            traffic = sum(map(_nbytes, outs))
        elif name == "copy":
            traffic = _nbytes(args[0]) + _nbytes(args[1])
        else:
            traffic = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        c.hbm_bytes += traffic
        if name in MATERIALIZE:
            c.hbm_bytes_min += traffic
