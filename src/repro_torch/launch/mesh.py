"""The agent mesh of the multi-device allocation epoch: the port of the
reference's ``make_agent_mesh`` (``repro.launch.mesh``).

The reference shards the server (Mesos agent) axis over a 1-D ``"agents"``
mesh under ``shard_map`` and reduces partials with ``lax.pmin``/``psum``/
``pmax``.  It is single-controller: one Python process drives every
device.  The port keeps that shape: one process drives an
:class:`AgentMesh` of ``K`` shards, each shard's block lives on its own
device, and :meth:`AgentMesh.gmin`/:meth:`~AgentMesh.gsum`/
:meth:`~AgentMesh.gany` reduce one partial a shard on the lead device (shard
0's) and hand the result back to every shard's device.  No process group
is involved, so the allocator needs no rank protocol, and ``K`` shards may
also sit on one card (:func:`shard_devices`), which a process group could
not do (NCCL refuses two ranks on one GPU).

Shards on one device form one *group*: their blocks are stacked along a
leading shard axis and the epoch runs them as one batch.  A partial is
therefore passed as one tensor a group, with that group's shards along its
first axis, and is reduced in shard order.

Every reduction is exact: f32 and int32 minima do not depend on order (the
epoch's sentinels are ``3.0e38`` and ``2**31 - 1``), the counts are int32
sums, and the epoch's one f32 sum adds a single owner's column to zeros
(its scores are all >= +0.0, so adding +0.0 changes no bit).

The model substrate's meshes are here too: the production meshes
(:func:`make_production_mesh`, ``(16, 16)`` or ``(2, 16, 16)``), the
one-rank smoke mesh (:func:`make_smoke_mesh`) and the device-free abstract
mesh (:func:`make_abstract_mesh`) the sharding rules resolve against.  The
first two are ``DeviceMesh``es over the running process group
(``torch.distributed``, which the caller starts with its own address, world
size and rank); a mesh that cannot be built raises.
"""
from __future__ import annotations

from typing import Sequence

import torch

#: logical CPU devices a mesh may take: the counterpart of the reference's
#: ``--xla_force_host_platform_device_count`` (tests raise it to run the
#: mesh on the CPU; with the default of 1 a CPU epoch stays on one device)
HOST_DEVICES = 1


def device_count(device) -> int:
    """Devices a mesh may take on ``device``'s type: the CUDA cards, or
    :data:`HOST_DEVICES` logical CPU devices."""
    kind = torch.device(device).type
    if kind == "cuda":
        return torch.cuda.device_count()
    if kind == "cpu":
        return HOST_DEVICES
    raise ValueError(f"unsupported device {device}")


class AgentMesh:
    """``K`` ordered shards of the agent axis.  ``devices[k]`` holds shard
    ``k``'s block and ``lead`` is shard 0's device.  ``groups`` lists the
    runs of consecutive shards that share a device as ``(device, start,
    stop)``."""

    def __init__(self, devices: Sequence[torch.device],
                 groups: Sequence[tuple[torch.device, int, int]]):
        self.devices = [torch.device(d) for d in devices]
        self.groups = [(torch.device(d), a, b) for d, a, b in groups]
        if not self.devices or self.groups[-1][2] != len(self.devices):
            raise ValueError("a mesh's groups must cover its shards")
        self.lead = self.devices[0]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def one_device(self) -> bool:
        """Do all shards sit on one device (one CUDA graph may hold them)?"""
        return len({str(d) for d, _, _ in self.groups}) == 1

    def key(self):
        """The layout, for a cache key: shards and their groups."""
        return tuple((str(d), a, b) for d, a, b in self.groups)

    def _reduce(self, parts, local, combine):
        acc = None
        for (_dev, _a, _b), part in zip(self.groups, parts):
            p = local(part).to(self.lead)
            acc = p if acc is None else combine(acc, p)
        return [acc.to(dev) for dev, _a, _b in self.groups]

    def gmin(self, parts):
        """Elementwise minimum over the shards (``lax.pmin``)."""
        return self._reduce(parts, lambda p: p.amin(0), torch.minimum)

    def gsum(self, parts):
        """Sum over the shards (``lax.psum``), in shard order."""
        return self._reduce(parts, lambda p: p.sum(0, dtype=p.dtype),
                            torch.add)

    def gany(self, parts):
        """Logical or over the shards (``lax.pmax`` of the flags)."""
        return self._reduce(parts, lambda p: p.any(0), torch.logical_or)


def make_agent_mesh(n: int, device="cuda") -> AgentMesh:
    """A mesh over the first ``n`` devices of ``device``'s type, one shard
    each: the CUDA cards, or ``n`` logical CPU devices (at most
    :data:`HOST_DEVICES`).  More shards than devices raises, as the
    reference does; nothing falls back to shards on one device."""
    kind = torch.device(device).type
    have = device_count(kind)
    if n < 1 or n > have:
        raise ValueError(f"agent mesh wants {n} devices, have {have}")
    devs = ([torch.device("cuda", i) for i in range(n)] if kind == "cuda"
            else [torch.device("cpu")] * n)
    return AgentMesh(devs, [(d, k, k + 1) for k, d in enumerate(devs)])


def shard_devices(n: int, device) -> AgentMesh:
    """``n`` shards on the one device ``device``, stacked as one group: the
    mesh's algorithm and reductions at fleet size on a single card."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return AgentMesh([dev] * n, [(dev, 0, n)])


def as_mesh(devices, device) -> AgentMesh:
    """``devices`` as a mesh: an :class:`AgentMesh` as it is, a count as
    :func:`make_agent_mesh` of that many ``device`` devices."""
    if isinstance(devices, AgentMesh):
        return devices
    return make_agent_mesh(int(devices), device)


# -- the model substrate's meshes --------------------------------------------

class AbstractMesh:
    """A device-free mesh: its axis names and sizes, all the sharding rules
    read (the reference's ``AbstractMesh``).  ``shape`` is ``{axis:
    size}``."""

    def __init__(self, shape: tuple, axes: tuple):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} vs axes {axes}")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, (int(s) for s in shape)))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def make_abstract_mesh(shape: tuple, axes: tuple) -> AbstractMesh:
    """Device-free mesh of ``shape`` over ``axes``."""
    return AbstractMesh(tuple(shape), tuple(axes))


def make_mesh(shape: tuple, axes: tuple, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the running process
    group (the reference's ``jax.make_mesh``), ranks in row-major order.
    Raises unless a process group is running and its world size is the
    mesh's size, and a CUDA mesh without a card unless the group is the
    ``"fake"`` backend's (:mod:`repro_torch.launch.dryrun`)."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a running process group "
                           "(torch.distributed.init_process_group)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} over {tuple(axes)} needs "
                         f"{n} ranks, the process group has "
                         f"{dist.get_world_size()}")
    kind = torch.device(device).type
    if (kind == "cuda" and not torch.cuda.is_available()
            and dist.get_backend() != "fake"):
        # a fake group (the dry run's) drives no device: its CUDA mesh
        # only names the card's type
        raise RuntimeError("a CUDA mesh needs a CUDA card")
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_smoke_mesh(device="cuda"):
    """One-rank mesh with the production axis names."""
    return make_mesh((1, 1), ("data", "model"), device)
