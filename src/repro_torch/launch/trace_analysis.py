"""The dry run's analysis of one rank's executed ops: FLOPs, HBM bytes and
collective bytes -- the port's counterpart of the reference's
``launch/hlo_analysis.py``.

The reference compiles a cell and parses XLA's HLO text, multiplying each
while body by its trip count.  The port has no compiled program: it runs
the step eagerly, under ``FakeTensorMode`` where no byte is allocated, and
:class:`Recorder` (a ``TorchDispatchMode``) records every op that one rank
executes, in order, with every iteration of every loop.  So no HLO is
parsed and nothing is multiplied.

Methodology (:func:`analyze`, the reference's fields):

* ``flops``: matrix products only, as the reference counts only ``dot``
  (the MFU convention): ``mm``, ``addmm``, ``bmm`` and ``baddbmm`` (but
  for a contraction of size 1, an outer product, which XLA's simplifier
  turns into a multiply and the reference then does not count), and
  K5's and K6's custom ops by their FLOP formulas (registered with
  ``torch.utils.flop_counter``), never the ops inside their CPU
  implementations.  Per device: under DTensor the recorder lets DTensor
  dispatch each op (the mode steps aside for a DTensor's op) and records
  the local ops it runs on this rank's shards, never the global op; the
  global shapes DTensor propagates on the side are skipped.
* ``hbm_bytes``: operand bytes plus result bytes of every executed op but
  the plumbing the reference skips too: views, ``detach``, ``alias``,
  ``t``, ``_unsafe_view``, factory ops with no tensor input, and the
  collectives.  Eager PyTorch does not fuse, so this is an upper bound
  beside the reference's count at XLA's fusion boundaries.
* ``collective_bytes`` / ``collective_count``: by the reference's names,
  from the ``_c10d_functional`` ops DTensor calls: result bytes a device,
  each op once (``wait_tensor`` is not a second one).
* ``trip_counts``: kept for the artifact's key; the caller lists the loops
  as run (the layer stacks, the micro-batches), with nothing multiplied.

The recorder also counts the bytes of live storages (its outputs, and the
tensors given to :meth:`Recorder.hold`) and keeps their peak: the dry
run's memory estimate.  A collective's ``wait_tensor`` returns its input
in an eager run, where under ``FakeTensorMode`` it makes a new storage:
the recorder counts the waited tensor as its input's storage, once.

On meta tensors (an un-meshed dry run traced without a fake mode) the
recorder also keeps the output layouts of each op that makes new tensors
from its operands, keyed by the op, its operands' shapes, strides and
types and its other arguments, and makes a repeated op's outputs from
them: PyTorch's meta kernels of the elementwise ops run in Python, and a
train step repeats each layer's ops for every layer and micro-batch.  The
recorded ops are the same either way.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# K5's and K6's custom ops and their FLOP formulas
import repro_torch.kernels.flash_attention.ops  # noqa: F401
import repro_torch.kernels.rwkv6.ops  # noqa: F401

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: the functional collectives' names -> the reference's
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d_functional")

_AT = torch.ops.aten
#: the matrix products counted (the reference's ``dot``)
PRODUCTS = frozenset(p for p in (_AT.mm, _AT.addmm, _AT.bmm, _AT.baddbmm))
#: the custom ops counted by their FLOP formulas
CUSTOM = frozenset((torch.ops.repro_torch.flash_fwd,
                    torch.ops.repro_torch.flash_bwd,
                    torch.ops.repro_torch.wkv6_fwd,
                    torch.ops.repro_torch.wkv6_bwd))
#: plumbing that moves no bytes (beside the views, which the op's schema
#: marks)
_SKIP_BYTES = frozenset(("detach", "alias", "t", "_unsafe_view", "lift_fresh",
                         "_local_scalar_dense"))


@dataclasses.dataclass
class Op:
    """One executed op of the rank: its name (``aten.mm.default``), the
    shapes of its tensor operands, the device type of its first tensor
    (a CPU tensor's op in a trace of the card's step is the host's),
    FLOPs, HBM bytes and, for a collective, its reference name and result
    bytes."""
    name: str
    shapes: tuple
    device: str = ""
    flops: float = 0.0
    bytes: float = 0.0
    collective: str | None = None
    collective_bytes: float = 0.0


@dataclasses.dataclass
class Trace:
    """What a :class:`Recorder` saw: ``ops`` in order and the live bytes'
    peak (``peak_bytes``)."""
    ops: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0

    def calls(self, name: str) -> int:
        """How many times the op ``name`` (an op or packet name, as
        ``repro_torch.flash_fwd``) ran."""
        return sum(1 for op in self.ops
                   if op.name == name or op.name.rsplit(".", 1)[0] == name)


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_count: dict = dataclasses.field(default_factory=dict)
    trip_counts: list = dataclasses.field(default_factory=list)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_count": dict(self.collective_count),
            "total_collective_bytes": self.total_collective_bytes,
            "trip_counts": self.trip_counts,
        }


def _contracted(func, args) -> int:
    """The contracted size of a matrix product: its first matrix's last
    dim (``addmm``/``baddbmm`` take the added tensor first)."""
    a = args[1] if func._overloadpacket in (_AT.addmm, _AT.baddbmm) \
        else args[0]
    return a.shape[-1]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs) -> list:
    """The tensors among ``xs`` and in its lists and tuples (an op's
    arguments nest no deeper)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


_DTENSOR = []


def _dtensor():
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return _DTENSOR[0]


def _local(t):
    """A DTensor's local shard, or the tensor itself."""
    return getattr(t, "_local_tensor", t)


# DTensor works out each op's global output shape by running the op on
# global-shaped fake tensors of the active fake mode: those ops are no
# rank's work, and the recorder skips them
_PROPAGATING = threading.local()
#: a functional collective's wait, which returns its input
_WAIT = "_c10d_functional.wait_tensor"
#: the method of DTensor's ``ShardingPropagator`` that runs those ops
_PROPAGATE = "_propagate_tensor_meta_non_cached"


@contextlib.contextmanager
def _marked_propagation():
    """Mark DTensor's global-shape propagation for the duration, so that
    the recorder skips the ops it runs -> True, or False where this torch
    build has no such method (then :class:`Recorder` refuses a DTensor's
    op: its counts would mix global shapes with the rank's)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    inner = ShardingPropagator.__dict__.get(_PROPAGATE)
    if inner is None:
        yield False
        return

    def marked(self, *args, **kwargs):
        _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1

    setattr(ShardingPropagator, _PROPAGATE, marked)
    try:
        yield True
    finally:
        setattr(ShardingPropagator, _PROPAGATE, inner)


@functools.lru_cache(maxsize=None)
def _fresh(func) -> bool:
    """Whether the aten op ``func`` returns only new tensors and aliases or
    writes none of its operands: its outputs' layouts then follow from its
    operands' and its other arguments."""
    sch = func._schema
    return (func.namespace == "aten" and not func.is_view
            and bool(sch.returns)
            and all(a.alias_info is None for a in sch.arguments)
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in sch.returns))


def _meta_key(func, args, kwargs):
    """The key of a meta op's output layouts: the op, its tensor operands'
    shapes, strides and types and its other arguments -> None unless it
    has a tensor operand, every one a meta tensor, and hashable
    arguments."""
    key, meta = [func], False
    for a in (*args, *(x for kv in sorted(kwargs.items()) for x in kv)):
        if isinstance(a, torch.Tensor):
            if a.device.type != "meta":
                return None
            key.append((tuple(a.shape), a.stride(), a.dtype))
            meta = True
        elif isinstance(a, (list, tuple)):
            if any(isinstance(x, torch.Tensor) for x in a):
                return None
            key.append(tuple(a))
        else:
            key.append(a)
    if not meta:
        return None
    key = tuple(key)
    try:
        hash(key)
    except TypeError:
        return None
    return key


class Recorder(TorchDispatchMode):
    """Records every op one rank executes into :attr:`trace` (see the
    module's docstring), and counts live storages for the peak.  Use as a
    context manager around the step; :meth:`hold` first counts the tensors
    the step starts from (parameters, optimizer state, inputs)."""

    def __init__(self):
        super().__init__()
        self.trace = Trace()
        # storage -> (its bytes, the weak reference whose callback frees
        # it); a weak reference's id -> its storage
        self._live: dict[int, tuple] = {}
        self._keys: dict[int, int] = {}
        self._now = 0
        self._stack = contextlib.ExitStack()
        # a meta op's key (:func:`_meta_key`) -> its outputs' layouts
        self._layouts: dict = {}
        self._marked = False         # DTensor's propagation marked
        # a waited tensor's storage -> the collective's output storage it
        # stands for, kept alive (so counted) while it lives
        self._waited: dict[int, object] = {}

    # -- live storages --------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        ref = weakref.ref(st, self._free)
        self._live[key] = (n, ref)
        self._keys[id(ref)] = key
        self._now += n
        if self._now > self.trace.peak_bytes:
            self.trace.peak_bytes = self._now

    def _free(self, ref) -> None:
        key = self._keys.pop(id(ref), None)
        if key is not None:
            self._now -= self._live.pop(key)[0]
            self._waited.pop(key, None)

    def _alias(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """``dst`` is ``src`` (a collective's wait): ``dst``'s storage, and
        any view of it, counts no bytes, and ``src``'s stays counted while
        ``dst``'s lives."""
        st = _local(src).untyped_storage()
        waited = _local(dst).untyped_storage()
        key = waited._cdata
        if key == st._cdata or key in self._live:
            return
        ref = weakref.ref(waited, self._free)
        self._live[key] = (0, ref)
        self._keys[id(ref)] = key
        self._waited[key] = st

    def hold(self, tensors) -> None:
        """Count the storages of ``tensors`` (any tree; a DTensor by its
        local shard) as live."""
        for t in tree_leaves(tensors):
            if isinstance(t, torch.Tensor):
                self._track(t)

    @property
    def live_bytes(self) -> int:
        return self._now

    # -- the mode --------------------------------------------------------
    def __enter__(self):
        self._marked = self._stack.enter_context(_marked_propagation())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor()) for t in types):
            if not self._marked:
                raise RuntimeError(
                    f"{func}: this torch build's DTensor has no "
                    f"ShardingPropagator.{_PROPAGATE}, so the recorder "
                    f"cannot tell its global-shape propagation from the "
                    f"rank's own ops; a meshed trace is refused")
            return NotImplemented        # DTensor runs the local ops
        out = self._run(func, args, kwargs)
        if func.namespace != "prim" and not getattr(_PROPAGATING, "depth",
                                                    0):
            self._record(func, args, kwargs, out)
        return out

    def _run(self, func, args, kwargs):
        """``func`` on its operands, or for a meta op seen before with the
        same key, new meta tensors of its outputs' layouts."""
        key = _meta_key(func, args, kwargs) if _fresh(func) else None
        if key is None:
            return func(*args, **kwargs)
        layouts = self._layouts.get(key)
        if layouts is None:
            out = func(*args, **kwargs)
            self._layouts[key] = [
                (tuple(t.shape), t.stride(), t.dtype)
                for t in (out if isinstance(out, tuple) else (out,))]
            return out
        outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                         device="meta")
                     for shape, stride, dtype in layouts)
        return outs[0] if len(func._schema.returns) == 1 else outs

    def _record(self, func, args, kwargs, out) -> None:
        name, counted, collective, moves = _kind(func)
        ins = _tensors((*args, *kwargs.values()) if kwargs else args)
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
        first = ins or outs
        op = Op(name, tuple(tuple(t.shape) for t in ins),
                first[0].device.type if first else "")
        if counted and (func._overloadpacket in CUSTOM
                        or _contracted(func, args) > 1):
            op.flops = float(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        if collective:
            op.collective = collective
            op.collective_bytes = float(sum(_nbytes(o) for o in outs))
        elif moves and ins:
            op.bytes = float(sum(_nbytes(t) for t in ins)
                             + sum(_nbytes(o) for o in outs))
        self.trace.ops.append(op)
        if str(func._overloadpacket) == _WAIT and ins and outs:
            self._alias(ins[0], outs[0])
            return
        for o in outs:
            self._track(o)


@functools.lru_cache(maxsize=None)
def _kind(func):
    """What the recorder counts of ``func``: -> (its name, whether its
    FLOPs count (a product or a custom op), its collective's reference name
    or None, whether its operands and results count as bytes moved)."""
    packet = func._overloadpacket
    base = packet.__name__
    collective = (_COLLECTIVE_OPS.get(base)
                  if func.namespace in _COLLECTIVE_NAMESPACES else None)
    moves = not (func.namespace in _COLLECTIVE_NAMESPACES or func.is_view
                 or base in _SKIP_BYTES)
    return (str(func), packet in CUSTOM or packet in PRODUCTS, collective,
            moves)


def analyze(trace: Trace, trip_counts=()) -> Totals:
    """-> the trace's totals (the reference's ``analyze`` fields);
    ``trip_counts``: the loops as run, ``(loop, count)``."""
    totals = Totals(collective_bytes=collections.defaultdict(float),
                    collective_count=collections.defaultdict(float),
                    trip_counts=list(trip_counts))
    for op in trace.ops:
        totals.flops += op.flops
        totals.hbm_bytes += op.bytes
        if op.collective:
            totals.collective_bytes[op.collective] += op.collective_bytes
            totals.collective_count[op.collective] += 1
    totals.collective_bytes = dict(totals.collective_bytes)
    totals.collective_count = dict(totals.collective_count)
    return totals


def top_ops(trace: Trace, n: int = 20):
    """The n ops (by name and operand shapes) that move the most bytes in
    all, the reference's ``top_instructions`` -> rows ``(bytes, calls,
    flops, name, shapes)``."""
    rows: dict = {}
    for op in trace.ops:
        key = (op.name, op.shapes)
        r = rows.setdefault(key, [0.0, 0, 0.0])
        r[0] += op.bytes
        r[1] += 1
        r[2] += op.flops
    out = [(b, c, f, name, shapes)
           for (name, shapes), (b, c, f) in rows.items()]
    out.sort(key=lambda r: -r[0])
    return out[:n]
