"""Logical-axis sharding rules (MaxText-style) with divisibility fallback,
on PyTorch's ``DeviceMesh`` and DTensor: the reference's
``distributed/sharding.py``.

Parameters and activations are annotated with *logical* axis names
(``"embed"``, ``"heads"``, ``"batch"``...).  A rule table maps logical names
to mesh axes; the resolver drops any mesh axis that (a) is absent from the
active mesh or (b) does not divide the dimension, or (c) was already taken
by an earlier dimension of the same tensor -- so the same model code runs
on the single-pod ``(data=16, model=16)`` mesh, the multi-pod ``(pod=2,
data=16, model=16)`` mesh, and the one-rank ``(1, 1)`` smoke mesh.

A resolved :class:`PartitionSpec` (the reference's, entry for entry) turns
into DTensor placements through one seam, :func:`placements`: ``Shard(d)``
on each mesh dimension that shards tensor dimension ``d``, ``Replicate()``
elsewhere.  An entry of several mesh axes, ``("pod", "data")``, splits its
dimension major first, as the reference does; its axes must come in the
mesh's order.

Default placement strategy (the paper-faithful baseline):
  * batch          -> ("pod", "data")   pure DP across pods, DP within pod
  * embed (params) -> "data"            ZeRO-3/FSDP within a pod
  * vocab/heads/kv_heads/mlp/experts -> "model"  tensor/expert parallelism
  * decode-cache seq -> "data"          flash-decode style cache partition

Outside :func:`use_mesh_rules` every annotation (:func:`constrain`,
:func:`weight_gather`) is the identity.  Inside it, a plain tensor that
meets a DTensor is taken as replicated (DTensor's implicit replication):
the positions, masks and rope tables a model makes for itself are the same
on every rank.  A kernel never sees a DTensor: its boundary
(:func:`run_local`) hands it each rank's local shards.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)

from repro_torch.nn import param as pm

# logical axis -> mesh axis (str), tuple of mesh axes, or None
DEFAULT_RULES: dict = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    # decode caches shard over seq on whatever axis batch left free --
    # attention against a seq-sharded cache is flash-decode (partial softmax
    # + small all-reduce).
    "cache_seq": ("data", "model"),
    "embed_act": None,
    "heads_act": "model",
    "mlp_act": "model",
    "vocab_act": "model",
    # parameters
    "embed": "data",              # FSDP
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "moe_cap": ("data", "model"),   # MoE dispatch-grid capacity dim
    "media": None,
    "layers": None,
    "q_lora": None,
    "kv_lora": None,
    "ssm": None,
    "conv": None,
}


class PartitionSpec(tuple):
    """One entry a tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of mesh axis names (major first) -- the reference's
    ``jax.sharding.PartitionSpec``, as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of an abstract mesh (any
    object whose ``shape`` is that dict, as the reference's meshes')."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def placements(spec: Sequence, mesh: DeviceMesh) -> tuple:
    """A spec -> DTensor placements on ``mesh``: ``Shard(d)`` on each mesh
    dimension that an entry ``d`` names, ``Replicate()`` elsewhere.  A
    tuple entry shards its dimension over several mesh dimensions, major
    first, which DTensor does in mesh order; an entry whose axes are not in
    mesh order is refused rather than reordered."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {tuple(spec)} names mesh axes {missing} "
                             f"absent from the mesh {tuple(names)}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec entry {axes} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions in {tuple(spec)}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the reference's ``NamedSharding``)."""
    mesh: object
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict

    def mesh_axes_for(self, logical: Optional[str], dim: int, mesh,
                      used=()):
        """Resolve one logical axis to mesh axes, honoring divisibility and
        skipping mesh axes already consumed by an earlier dim of the same
        tensor (a mesh axis can shard at most one dim)."""
        if logical is None:
            return None
        target = self.rules.get(logical)
        if target is None:
            return None
        sizes = axis_sizes(mesh)
        axes = (target,) if isinstance(target, str) else tuple(target)
        chosen = []
        prod = 1
        for ax in axes:
            if ax not in sizes or ax in used:
                continue
            n = sizes[ax]
            if dim % (prod * n) == 0:
                chosen.append(ax)
                prod *= n
        if not chosen:
            return None
        return chosen[0] if len(chosen) == 1 else tuple(chosen)

    def pspec(self, axes: tuple, shape: tuple, mesh) -> PartitionSpec:
        used: list = []
        out = []
        for a, d in zip(axes, shape):
            r = self.mesh_axes_for(a, d, mesh, used=tuple(used))
            if r is not None:
                used.extend((r,) if isinstance(r, str) else r)
            out.append(r)
        return PartitionSpec(*out)

    def param_sharding(self, template, mesh):
        """Template -> :class:`NamedSharding` tree."""
        return pm.tree_map_specs(
            lambda p: NamedSharding(mesh, self.pspec(p.axes, p.shape, mesh)),
            template)

    def param_pspecs(self, template):
        """Template -> PartitionSpec tree (requires active mesh context)."""
        ctx = _CTX.get()
        if ctx is None:
            raise RuntimeError("param_pspecs needs use_mesh_rules()")
        mesh = ctx[0]
        return pm.tree_map_specs(lambda p: self.pspec(p.axes, p.shape, mesh),
                                 template)


# -- activation constraints --------------------------------------------------

_CTX: contextvars.ContextVar = contextvars.ContextVar("mesh_rules",
                                                     default=None)


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Optional[ShardingRules] = None):
    """Activate a mesh + rule table; layer code then honors
    :func:`constrain`.  On a ``DeviceMesh`` plain tensors that meet
    DTensors are taken as replicated for the duration."""
    token = _CTX.set((mesh, rules or ShardingRules(DEFAULT_RULES)))
    try:
        if isinstance(mesh, DeviceMesh):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.reset(token)


def bind_rules(fn: Callable) -> Callable:
    """``fn`` under the mesh rules active now, wherever and whenever it is
    called (the identity outside :func:`use_mesh_rules`).  Autograd runs a
    remat body's recomputation on its own thread, which does not see the
    caller's context."""
    ctx = _CTX.get()
    if ctx is None:
        return fn

    def bound(*args, **kwargs):
        token = _CTX.set(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.reset(token)
    return bound


def active_rules() -> Optional[ShardingRules]:
    ctx = _CTX.get()
    return None if ctx is None else ctx[1]


def active_mesh():
    ctx = _CTX.get()
    return None if ctx is None else ctx[0]


def as_dtensor(x, mesh: DeviceMesh) -> DTensor:
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain tensor
    as replicated (the same on every rank)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def redistribute(x, mesh: DeviceMesh, target: Sequence) -> DTensor:
    """``x`` (DTensor or plain, see :func:`as_dtensor`) moved to the
    placements ``target``; a DTensor already there is returned as it is."""
    x = as_dtensor(x, mesh)
    if tuple(x.placements) == tuple(target):
        return x
    if not x.is_contiguous():
        # a redistribution's local result is contiguous, but DTensor keeps
        # the input's strides as the output's: a later view would read the
        # local memory in the wrong order
        x = x.contiguous()
    return x.redistribute(mesh, tuple(target))


def constrain(x, logical_axes: tuple, override: Optional[dict] = None):
    """Redistribute ``x`` to the placements its logical axes resolve to
    under the active rules (the reference's ``with_sharding_constraint``);
    the identity outside :func:`use_mesh_rules` or on an abstract mesh.
    `override` remaps logical axes for this call only."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    if override:
        rules = ShardingRules({**rules.rules, **override})
    spec = rules.pspec(logical_axes, x.shape, mesh)
    if not isinstance(mesh, DeviceMesh):
        return x
    return redistribute(x, mesh, placements(spec, mesh))


def weight_gather(w, logical_axes: tuple):
    """Weight-gather FSDP: force the FSDP ("embed"-over-data) shards of a
    weight to all-gather BEFORE use, keeping TP axes intact.  Without this,
    the partitioner tends to keep weights sharded and all-reduce the (much
    larger) activation partial sums.

    Gated by the `_weight_gather` entry of the active rules (profiles:
    baseline=False, optimized=True); no-op outside a mesh context.
    """
    ctx = _CTX.get()
    if ctx is None or not ctx[1].rules.get("_weight_gather", True):
        return w
    return constrain(w, logical_axes, override={"embed": None, "vocab": None}
                     if "vocab" in logical_axes else {"embed": None})


def make_rules(**overrides) -> ShardingRules:
    r = dict(DEFAULT_RULES)
    r.update(overrides)
    return ShardingRules(r)


# -- the kernel boundary -----------------------------------------------------

def is_distributed(*xs) -> bool:
    """Is any of ``xs`` a DTensor (so a kernel, which reads ``data_ptr()``,
    must take its local shards)?  A DTensor outside mesh rules on a
    ``DeviceMesh`` raises: the rules place its shards."""
    if not any(isinstance(x, DTensor) for x in xs):
        return False
    ctx = _CTX.get()
    if ctx is None or not isinstance(ctx[0], DeviceMesh):
        raise RuntimeError("a DTensor reached a kernel's boundary outside "
                           "use_mesh_rules on a DeviceMesh")
    return True


def shard_block(mesh: DeviceMesh, pl: Sequence, dim: int) -> tuple[int, int]:
    """(this rank's block, the number of blocks) of tensor dimension
    ``dim`` under placements ``pl``: the mesh dimensions that shard it,
    major first."""
    idx, n = 0, 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            size = mesh.size(i)
            idx, n = idx * size + mesh.get_local_rank(i), n * size
    return idx, n


def run_local(fn: Callable, inputs: Sequence, out_specs: Sequence):
    """Run ``fn`` on local shards: the boundary of a kernel under a mesh.

    ``inputs``: ``(tensor or None, logical axes)`` pairs; each tensor is
    redistributed to the placements its axes resolve to under the active
    rules and handed to ``fn`` as its local shard, after them the tuple
    of the inputs' placements.  ``out_specs``: one ``(logical axes, global
    shape)`` an output of ``fn``, whose local result is wrapped back as a
    DTensor of the placements those axes resolve to (evenly: the rules
    shard only what divides), or of the placements given in their stead
    (a tuple of DTensor placements, one a mesh dimension; ``Partial()``
    where the local results are partial sums).  Differentiable both ways:
    an input's gradient keeps its placements, except on a mesh dimension
    where the input is replicated and another input or an output is
    sharded or partial; there the local gradients are partial sums
    (``Partial()``), summed over that dimension's ranks."""
    mesh, rules = _CTX.get()
    pls = [None if t is None
           else placements(rules.pspec(axes, t.shape, mesh), mesh)
           for t, axes in inputs]
    out_pls = [_out_placements(spec, shape, mesh, rules)
               for spec, shape in out_specs]
    sharded = [any(pl is not None and isinstance(pl[i], (Shard, Partial))
                   for pl in pls + out_pls)
               for i in range(mesh.ndim)]
    local = []
    for (t, _axes), pl in zip(inputs, pls):
        if t is None:
            local.append(None)
            continue
        grad_pl = tuple(Partial() if isinstance(p, Replicate) and sharded[i]
                        else p for i, p in enumerate(pl))
        local.append(redistribute(t, mesh, pl).to_local(
            grad_placements=grad_pl))
    outs = fn(*local, tuple(pls))
    single = torch.is_tensor(outs)
    outs = (outs,) if single else tuple(outs)
    wrapped = [DTensor.from_local(o, mesh, pl, run_check=False)
               for o, pl in zip(outs, out_pls)]
    return wrapped[0] if single else tuple(wrapped)


def _out_placements(spec, shape, mesh, rules) -> tuple:
    """An output spec of :func:`run_local` -> its placements: logical axes
    resolved under ``rules``, or placements given as they are."""
    if len(spec) == mesh.ndim and all(isinstance(p, Placement)
                                      for p in spec):
        return tuple(spec)
    return placements(rules.pspec(spec, shape, mesh), mesh)


def mesh_placements(logical_axes: tuple, shape: Sequence[int]) -> tuple:
    """The placements ``logical_axes`` of a tensor of ``shape`` resolve to
    under the active rules on a ``DeviceMesh``."""
    mesh, rules = _CTX.get()
    return placements(rules.pspec(logical_axes, tuple(shape), mesh), mesh)


# -- reshapes of sharded tensors ---------------------------------------------

def _view_groups(src: Sequence[int], dst: Sequence[int]) -> list:
    """The dims of ``src`` and ``dst`` that a reshape maps onto each other:
    ``[(src dims, dst dims)]``, each pair of equal size."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        a, b = [i], [j]
        pa = src[i] if i < len(src) else 1
        pb = dst[j] if j < len(dst) else 1
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                a.append(i)
                pa *= src[i]
                i += 1
            else:
                b.append(j)
                pb *= dst[j]
                j += 1
        groups.append(([d for d in a if d < len(src)],
                       [d for d in b if d < len(dst)]))
    return groups


def viewable(x: DTensor, shape: Sequence[int]) -> DTensor:
    """``x`` with every shard that DTensor could not carry through a
    reshape to ``shape`` gathered: a dim may stay sharded where it leads
    its group of merged dims and its shards split the group's leading
    target dim evenly (12 heads of 128 flattened to 1536 may not be split
    16 ways and then unflattened)."""
    mesh, src = x.device_mesh, tuple(x.shape)
    pl = list(x.placements)
    lead = {}
    for a, b in _view_groups(src, tuple(shape)):
        big = [d for d in a if src[d] > 1]
        for d in a:
            lead[d] = (big and d == big[0], shape[b[0]] if b else 1)
    counts = {}
    for i, p in enumerate(pl):
        if not isinstance(p, Shard):
            continue
        d = p.dim % len(src)
        ok, first = lead.get(d, (False, 1))
        n = counts.get(d, 1) * mesh.size(i)
        if ok and first % n == 0:
            counts[d] = n
        else:
            pl[i] = Replicate()
    return redistribute(x, mesh, pl)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return viewable(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            g = viewable(g, ctx.shape)
        return g.reshape(ctx.shape), None


def reshape(x, shape: Sequence[int]):
    """``x.reshape(shape)``; a DTensor whose shards the reshape cannot
    carry is gathered where it must be first (:func:`viewable`), in the
    forward and, for its gradient, in the backward."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    shape = tuple(int(s) for s in shape)
    if -1 in shape:
        known = 1
        for s_ in shape:
            known *= s_ if s_ != -1 else 1
        shape = tuple(x.numel() // known if s_ == -1 else s_ for s_ in shape)
    return _Reshape.apply(x, shape)


def from_shard(shape: Sequence[int], pl: Sequence, mesh: DeviceMesh,
               make: Callable) -> DTensor:
    """A DTensor of global ``shape`` and placements ``pl`` on ``mesh``
    whose local shard is ``make(local shape)``: this rank's block alone is
    made, never the whole tensor (the rules shard only what divides)."""
    shape = tuple(int(d) for d in shape)
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    stride, n = [], 1                   # row-major, made of no tensor
    for d in reversed(shape):
        stride.insert(0, n)
        n *= max(d, 1)
    return DTensor.from_local(
        make(local), mesh, tuple(pl), run_check=False,
        shape=torch.Size(shape), stride=tuple(stride))


def zeros(shape: Sequence[int], dtype, logical_axes: tuple, device):
    """Zeros of ``shape``: under :func:`use_mesh_rules` on a ``DeviceMesh``
    a DTensor of the placements ``logical_axes`` resolve to, made from this
    rank's shard alone (:func:`from_shard`: a cache the ranks split is
    never held whole); elsewhere a plain tensor."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(ctx[0], DeviceMesh):
        return torch.zeros(shape, dtype=dtype, device=device)
    mesh, rules = ctx
    pl = placements(rules.pspec(logical_axes, tuple(shape), mesh), mesh)
    return from_shard(shape, pl, mesh, lambda local: torch.zeros(
        local, dtype=dtype, device=device))
