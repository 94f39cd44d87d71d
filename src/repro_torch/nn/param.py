"""Parameter templates: shapes + logical axes, materialised on demand.

Every layer declares a *template*: a nested dict whose leaves are
:class:`ParamSpec` (shape, logical axis names, initializer), as in the
reference.  Here a template is

  * materialised into tensors (:func:`init_params`), a nested dict of the
    reference's layout, stacked layers included;
  * built into a module tree (:class:`Params`), whose leaves are the
    parameters and whose nodes answer ``params["name"]`` like the
    reference's dicts, so the layer functions read the same.

Each :class:`Params` node keeps its leaves' logical axes; :func:`distribute`
reads them to place the leaves on a ``DeviceMesh`` under the sharding rules
(:mod:`repro_torch.distributed.sharding`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                     # logical axis name (or None) per dim
    init: str = "normal"            # normal | zeros | ones | embed
    scale: Optional[float] = None   # override fan-in scaling

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def spec(shape, axes, init="normal", scale=None) -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), tuple(axes), init, scale)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], template):
    if is_spec(template):
        return fn(template)
    return {k: tree_map_specs(fn, v) for k, v in template.items()}


def stack_template(template, n: int, axis_name: str = "layers"):
    """Prefix every param with a stacking dim (the reference's scan-over-
    layers storage; :class:`Params` splits it into per-layer modules)."""
    return tree_map_specs(
        lambda p: ParamSpec((n, *p.shape), (axis_name, *p.axes), p.init, p.scale),
        template,
    )


def _leaves(template):
    if is_spec(template):
        return [template]
    return [p for v in template.values() for p in _leaves(v)]


def count_params(template) -> int:
    return sum(p.size for p in _leaves(template))


def _init_one(p: ParamSpec, gen: torch.Generator, dtype):
    dev = gen.device
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=dev)
    if p.init in ("embed", "normal"):
        if p.init == "embed":
            s = p.scale if p.scale is not None else 1.0
        else:
            # fan-in-scaled normal; fan-in approximated by the second-to-last
            # dim (the reference's rule)
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            s = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(p.shape, generator=gen, dtype=torch.float32, device=dev)
        return (x.mul_(s)).to(dtype)
    raise ValueError(f"unknown init {p.init!r}")


def init_params(template, generator: torch.Generator, dtype=torch.float32):
    """Materialise a template into tensors on ``generator``'s device, leaf by
    leaf in the template's order, with the reference's rules (fan-in normal,
    zeros, ones, embed).  ``jax.random``'s stream cannot be reproduced, so
    the values differ from the reference's for the same seed; to compare the
    two packages, carry the reference's arrays across with
    :func:`repro_torch.models.common.load_reference_params`."""
    return tree_map_specs(lambda p: _init_one(p, generator, dtype), template)


class Params(nn.Module):
    """A template (without the stacking dim) as a module tree.

    ``params["wq"]`` returns the parameter, ``params["attn"]`` the sub-tree,
    ``"wg" in params`` tests for a leaf, as the reference's dicts do.
    :meth:`cast` returns a leaf in the compute type.

    Serving (no gradient): the cast is made once and kept, since the
    reference's cast of the f32 weights at every use gives the same bits
    every time; :meth:`drop_casts` forgets the copies after the parameters
    were overwritten.  Training (grad enabled and the leaf requires grad,
    after ``Model.requires_grad_(True)``): :meth:`cast` returns ``t.to(
    dtype)`` inside the autograd graph at every use and keeps nothing, so
    the gradient reaches the f32 leaf and no copy outlives an optimizer
    step.  With ``grad_dtype`` set (``Model.requires_grad_`` sets it to the
    config's compute type), every floating leaf read under grad is first
    cast to it, as the reference's ``loss_fn`` casts the whole parameter
    tree to the compute type before the forward."""

    def __init__(self, template, dtype=torch.float32, device=None):
        super().__init__()
        self._names = []
        self._casts = {}
        self._axes = {}
        self.grad_dtype = None
        for name, sub in template.items():
            self._names.append(name)
            if is_spec(sub):
                self._axes[name] = sub.axes
                self.register_parameter(name, nn.Parameter(
                    torch.empty(sub.shape, dtype=dtype, device=device),
                    requires_grad=False))
            else:
                self.add_module(name, Params(sub, dtype, device))

    def __getitem__(self, name):
        t = getattr(self, name)
        if (self.grad_dtype is not None and isinstance(t, nn.Parameter)
                and t.requires_grad and torch.is_grad_enabled()
                and t.is_floating_point()):
            if _is_dtensor(t):
                return _ShardedCast.apply(t, self.grad_dtype)
            return t.to(self.grad_dtype)
        return t

    def __contains__(self, name):
        return name in self._names

    def keys(self):
        return list(self._names)

    def cast(self, name, dtype):
        t = getattr(self, name)
        if t.requires_grad and torch.is_grad_enabled():
            return self[name].to(dtype)      # in the graph, kept nowhere
        if t.dtype == dtype:
            return t
        key = (name, dtype)
        if key not in self._casts:
            self._casts[key] = t.detach().to(dtype)
        return self._casts[key]

    def drop_casts(self):
        """Forget the cast copies (after the parameters were overwritten)."""
        for m in self.modules():
            if isinstance(m, Params):
                m._casts.clear()


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class _ShardedCast(torch.autograd.Function):
    """A DTensor parameter read in ``dtype`` under grad, whose gradient
    takes the parameter's own placements as the backward reaches it (in
    the parameter's type, then reduce-scattered where the products left
    partial sums), as the reference's gradient is sharded as its
    parameter.  DTensor alone would keep the products' partial sums, a
    full-size tensor a rank, until the optimizer."""

    @staticmethod
    def forward(ctx, p, dtype):
        ctx.dtype, ctx.mesh, ctx.placements = (p.dtype, p.device_mesh,
                                               tuple(p.placements))
        return p.to(dtype) if p.dtype != dtype else p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.dtype)
        if _is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None


def distribute(params: nn.Module, mesh, rules) -> nn.Module:
    """Place every leaf of the module tree ``params`` (a model, or any
    tree of :class:`Params`) on ``mesh``: each becomes a DTensor parameter
    whose placements its logical axes resolve to under ``rules``
    (:func:`repro_torch.distributed.sharding.placements`), the reference's
    ``jax.tree.map(jax.device_put, params, rules.param_sharding(...))``.
    Every rank holds the whole tensor and keeps its own shard, so nothing
    is sent.  In place; returns ``params``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import placements

    for node in params.modules():
        if not isinstance(node, Params):
            continue
        for name, axes in node._axes.items():
            t = getattr(node, name)
            pl = placements(rules.pspec(axes, t.shape, mesh), mesh)
            d = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
            setattr(node, name, nn.Parameter(d, requires_grad=t.requires_grad))
        node._casts.clear()
    return params


def abstract_params(params: nn.Module, *, mesh=None, rules=None,
                    device="cuda") -> nn.Module:
    """The reference's ``abstract_params``: every leaf of the module tree
    ``params`` becomes a parameter that holds no data, for a dry run
    (:mod:`repro_torch.launch.dryrun`).  Must run under a
    ``FakeTensorMode``, where each leaf is a fake tensor of ``device`` in
    its own type, unless ``device`` is ``"meta"``.  On a ``DeviceMesh``
    each is a DTensor
    built from this rank's shard alone, of the placements its logical axes
    resolve to under ``rules``
    (:func:`repro_torch.distributed.sharding.placements`); the whole tensor
    is never made, so a count of live storages sees one rank's bytes.  A
    leaf keeps its ``requires_grad``.  In place; returns ``params``."""
    from torch._guards import detect_fake_mode

    if detect_fake_mode() is None and torch.device(device).type != "meta":
        raise RuntimeError("abstract_params runs under a FakeTensorMode "
                           "or on meta (elsewhere it would allocate every "
                           "leaf)")
    for node in params.modules():
        if not isinstance(node, Params):
            continue
        for name, axes in node._axes.items():
            t = getattr(node, name)
            if mesh is None:
                leaf = torch.empty(t.shape, dtype=t.dtype, device=device)
            else:
                leaf = _abstract_shard(t.shape, t.dtype, axes, mesh, rules,
                                       device)
            setattr(node, name, nn.Parameter(leaf,
                                             requires_grad=t.requires_grad))
        node._casts.clear()
    return params


def _abstract_shard(shape, dtype, axes, mesh, rules, device):
    """A DTensor of global ``shape`` on ``mesh`` made from this rank's
    shard (fake) alone."""
    from repro_torch.distributed.sharding import from_shard, placements

    pl = placements(rules.pspec(axes, shape, mesh), mesh)
    return from_shard(shape, pl, mesh, lambda local: torch.empty(
        local, dtype=dtype, device=device))
