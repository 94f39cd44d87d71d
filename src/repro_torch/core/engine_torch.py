"""Device-resident allocation epochs on PyTorch: the port of
:mod:`repro.core.engine_jax` (single device).

One allocation epoch is the select -> grant -> refresh loop over the
(frameworks x agents) score matrix, with scores and feasibility kept
consistent by the incremental formulas of the numpy ``BatchedEpoch`` (via
:mod:`repro_torch.core.criteria` with ``xp=torch``).  ``kernel=`` picks who
runs the loop:

  * ``"persistent"`` (default) — the whole epoch segment is ONE launch of
    the persistent CUDA kernel (:mod:`repro_torch.kernels.epoch_persistent`);
    on the CPU its plain version runs, which is the plain loop below;
  * ``"tiles"`` — the plain loop with its selects on the masked argmins
    K1/K2 (:mod:`repro_torch.kernels.psdsf_score`, one CUDA launch each,
    into output scratch made once per segment); on the CPU their plain
    versions.  Exact ties across 128-wide tiles resolve in tile order (the
    reference's ``use_pallas=True`` caveat);
  * ``None`` — the plain loop of tensor operations, the counterpart of the
    reference's default loop of array operations.

All three give the reference's grant sequences bit for bit: f32 scores,
the global two-pass tie-low rule (``atol=1e-9 + rtol=1e-6 * |min|``), and
the same order of operations.  Two sums depend on order — the rPS-DSF
residual ``C[j] - X[:, j] @ D`` and the TSF monopoly sum — and are exact on
quantized demands (multiples of 1/4 against integer capacities, as in the
paper's workloads).

RRR permutations are pre-drawn from the allocator's numpy ``Generator``
exactly as the reference draws them (``_draw_perms``), so fused-vs-numpy
stream parity is per epoch and fused-vs-fused is exact; see the reference
module docstring.  :func:`run_epoch_async` returns an :class:`EpochHandle`
whose ``result()`` is the commit point: with the persistent kernel on the
card the launch is asynchronous and the only host sync is the readback of
the count and the grant sequence.

The plain and tiles loops (and the sharded selects) are the reference's
device-resident ``while_loop`` too.  :class:`EpochLoop` is its ``cond`` and
``body``: one grant a step, every write predicated on the loop being alive,
every index a 1-element tensor, so a step never syncs the host and a step
past the end changes nothing.  On the card :func:`run_loop` replays
:data:`CHUNK` steps captured as one CUDA graph (:class:`LoopGraph`) and
reads one alive flag a chunk; each graph is captured once per
:func:`graph_key` (shape bucket and static configuration), the counterpart
of the reference's jit cache, and :data:`CAPTURE_COUNT` is the counterpart
of its ``TRACE_COUNT``.  On the CPU the same step runs eagerly.

The multi-device epoch (:func:`epoch_loop_mesh`, the reference's
``shard_map`` over the agent axis) runs on an
:class:`~repro_torch.launch.mesh.AgentMesh`: each shard keeps its column
block of the epoch state and a per-row minima cache, and one process drives
all shards through :class:`MeshLoop`, reducing partials with the mesh's
``gmin``/``gsum``/``gany``.  Buffer donation has no counterpart: a graph's
buffers are its own, and a segment is copied in and out.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core import criteria
from repro_torch.kernels import KernelError
from repro_torch.kernels.epoch_persistent.ops import persistent_epoch
from repro_torch.kernels.psdsf_score import ops as _tiles
from repro_torch.kernels.psdsf_score.ops import next_pow2
from repro_torch.launch import mesh as _mesh

_BIG = 3.0e38
_IBIG = 2**31 - 1

#: incremented once per device dispatch (every segment and replay).
DISPATCH_COUNT = 0
#: incremented once per captured :class:`LoopGraph` (the reference's
#: ``TRACE_COUNT``): flat across epochs of one shape bucket.
CAPTURE_COUNT = 0
#: steps in one captured chunk of the epoch loop, between two reads of its
#: alive flag on the card (at most CHUNK - 1 dead steps a segment)
CHUNK = 64
#: captured graphs kept (epoch loops and fill step loops), the least
#: recently used dropped first
GRAPH_CACHE_SIZE = 64
_GRAPHS: OrderedDict = OrderedDict()
_GRAPHS_LOCK = threading.Lock()

#: chaos hook (:mod:`repro_torch.core.faults`): when set, called with no
#: args before EVERY fused dispatch — including chained and grow-and-replay
#: segments — so a test can simulate a device failure by raising.
fault_hook = None

COVERED_CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")
COVERED_POLICIES = ("pooled", "rrr")
KERNELS = ("persistent", "tiles", None)


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; "cuda" without a card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def supports(criterion, policy: str, mode: str, tie: str) -> bool:
    """Can the fused device epoch serve this configuration?"""
    try:
        name = criteria.get_criterion(criterion).name
    except ValueError:
        return False
    return (name in COVERED_CRITERIA and policy in COVERED_POLICIES
            and mode == "characterized" and tie == "low")


def _argmin_tie_low(s, mask, rtol=1e-6, atol=1e-9):
    """First index among near-minimal masked entries (numpy tie="low"); the
    reference's rule and tolerance, in f32."""
    masked = torch.where(mask, s.float(), _BIG)
    m = masked.min()
    tol = atol + rtol * m.abs()
    idx = torch.arange(masked.shape[0], dtype=torch.int32, device=s.device)
    return torch.where(masked <= m + tol, idx, _IBIG).min()


def _argmin_tie_low_sharded(s, mask, shards, rtol=1e-6, atol=1e-9):
    """Sharded :func:`_argmin_tie_low`: per-shard masked minima, the global
    threshold from their minimum, then the least per-shard first index.
    f32 min is exact, so the winner is the unsharded one."""
    Ls = s.shape[0] // shards
    masked = torch.where(mask, s.float(), _BIG).reshape(shards, Ls)
    m = masked.amin(1).min()
    tol = atol + rtol * m.abs()
    idx = torch.arange(Ls, dtype=torch.int32, device=s.device)
    local = torch.where(masked <= m + tol, idx, _IBIG).amin(1)
    valid = local < _IBIG
    offs = torch.arange(shards, dtype=torch.int32, device=s.device) * Ls
    return torch.where(valid, offs + torch.where(valid, local, 0),
                       _IBIG).min()


def _argmin2d_tie_low_sharded(mat, mask, shards, rtol=1e-6, atol=1e-9):
    """Sharded (N, J) masked argmin over ``shards`` column blocks; per-shard
    winners reduce by the global flat key ``n * J + j``."""
    N, J = mat.shape
    Js = J // shards
    m3 = (torch.where(mask, mat.float(), _BIG)
          .reshape(N, shards, Js).permute(1, 0, 2).reshape(shards, N * Js))
    m = m3.amin(1).min()
    tol = atol + rtol * m.abs()
    idx = torch.arange(N * Js, dtype=torch.int32, device=mat.device)
    local = torch.where(m3 <= m + tol, idx, _IBIG).amin(1)
    valid = local < _IBIG
    lf = torch.where(valid, local, 0)
    n, jl = lf // Js, lf % Js
    offs = torch.arange(shards, dtype=torch.int32, device=mat.device) * Js
    key = torch.where(valid, n * J + offs + jl, _IBIG).min()
    return key // J, key % J


def _flat_tie_low(mat, mask):
    flat = _argmin_tie_low(mat.reshape(-1), mask.reshape(-1))
    return flat // mat.shape[1], flat % mat.shape[1]


def _tiles_1d(vec, ok, out):
    return _tiles.masked_argmin1d(vec, ok, out=out)[1]


def _tiles_2d(mat, ok, out):
    _, n, j = _tiles.masked_argmin2d(mat, ok, out=out)
    return n, j


def _dominant_cols(D, cap, big):
    """(k, N) dominant shares against each of ``k`` residuals ``cap`` (k,
    R): ``criteria.virtual_dominant``'s arithmetic with sentinel ``big``,
    a column a residual."""
    safe = torch.where(cap > 1e-12, cap, 1e-30)[:, None, :]
    frac = D[None] / safe
    frac = torch.where((cap <= 1e-12)[:, None, :] & (D > 0.0)[None], big,
                       frac)
    return frac.amax(2)


def _index(v, size):
    """A select's result as a 1-element int64 index, clamped into
    ``[0, size)``: a select over nothing feasible returns 0 (the tie-low
    rule), -1 (K1/K2) or the int32 sentinel, and a dead step must still
    index in range."""
    return v.reshape(1).long().clamp(0, size - 1)


def _put(t, dim, i, new, alive):
    """``t``'s slice ``i`` (a 1-element index) along ``dim`` becomes
    ``new`` where ``alive``, and stays as it was elsewhere."""
    t.index_copy_(dim, i, torch.where(alive, new, t.index_select(dim, i)))


def _selects(select, shards):
    """The two select functions of a loop, as the module holds them now
    (``chip_smoke.plain_selects`` patches ``_tiles_1d``/``_tiles_2d``)."""
    if shards > 1:
        return _argmin_tie_low_sharded, _argmin2d_tie_low_sharded
    if select == "tiles":
        return _tiles_1d, _tiles_2d
    return _argmin_tie_low, _flat_tie_low


#: the tensors of one segment the loop reads and writes: its state, updated
#: in place, then its constants
LOOP_TENSORS = ("X", "tot", "FREE", "cap", "dom", "s", "feas", "used", "D",
                "TD", "C", "phi", "wanted", "allowed", "perms", "aux")


class EpochLoop:
    """The epoch loop over one segment's tensors (a dict keyed by
    :data:`LOOP_TENSORS`): the reference's ``cond`` and ``body``
    (``engine_jax.epoch_loop``) as :meth:`step`, one grant applied only
    where the loop is alive, with no host sync.

    The state tensors are updated in place.  The loop owns the rest of the
    reference's loop state as (1,)-shaped device tensors — ``count``, the
    RRR cursor ``pidx``/``pos``, the grant sequence ``nsjs`` (2, max_steps)
    — and holds ``j_real``, ``limit`` and ``eps`` on the device too, so
    that a captured chunk of steps serves every segment of its shape
    bucket.  ``select`` is ``"plain"`` (the tie-low rule) or ``"tiles"``
    (K1/K2, into output holders the loop keeps); ``shards > 1`` takes the
    sharded tie-low selects instead of either."""

    def __init__(self, tensors: dict, *, kind: str, policy: str,
                 lookahead: bool, use_limit: bool, max_steps: int,
                 select: str = "plain", shards: int = 1,
                 dom_big=criteria._BIG):
        self.t = tensors
        X = tensors["X"]
        dev = X.device
        self.N, self.J = X.shape
        self.kind, self.policy = kind, policy
        self.la = 1.0 if lookahead else 0.0
        self.use_limit, self.max_steps = use_limit, max_steps
        self.dom_big = dom_big
        self.ss = kind in ("psdsf", "rpsdsf")
        i32 = torch.int32
        one = lambda dtype: torch.zeros(1, dtype=dtype, device=dev)  # noqa
        self.count, self.pidx, self.pos = one(i32), one(i32), one(i32)
        self.j_real, self.limit = one(i32), one(i32)
        self.eps = one(torch.float32)
        self.nsjs = torch.full((2, max_steps), -1, dtype=i32, device=dev)
        self.flag = one(torch.bool)
        self.arangeJ = torch.arange(self.J, dtype=i32, device=dev)
        a1, a2 = _selects(select, shards)
        if shards > 1:
            self.argmin1d = lambda v, ok: a1(v, ok, shards)
            self.argmin2d = lambda m, ok: a2(m, ok, shards)
        elif select == "tiles":
            # one output holder per select for the loop's life: each grant
            # consumes (n, j) on the stream before the next select
            # overwrites them
            out1, out2 = _tiles.ArgminOut(dev, 1), _tiles.ArgminOut(dev, 2)
            self.argmin1d = lambda v, ok: a1(v, ok, out1)
            self.argmin2d = lambda m, ok: a2(m, ok, out2)
        else:
            self.argmin1d, self.argmin2d = a1, a2

    def reset(self, pidx0, pos0, j_real, limit, eps):
        """Start a segment: no grants yet, the RRR cursor at (pidx0,
        pos0)."""
        self.count.zero_()
        self.nsjs.fill_(-1)
        for t, v in ((self.pidx, pidx0), (self.pos, pos0),
                     (self.j_real, j_real), (self.limit, limit),
                     (self.eps, eps)):
            t.fill_(v)

    def alive_now(self):
        """(1,) bool: the reference's ``cond``, on the device."""
        return self.t["feas"].any() & (self.count < self.max_steps)

    def step(self):
        """One pass of the reference's ``body`` where ``cond`` holds; where
        it does not, every tensor is left as it was."""
        t = self.t
        X, tot, FREE, s, feas, used = (t["X"], t["tot"], t["FREE"], t["s"],
                                       t["feas"], t["used"])
        N, J = self.N, self.J
        f32, i32 = torch.float32, torch.int32
        la = self.la
        alive = self.alive_now()
        # -- select ---------------------------------------------------------
        if self.policy == "pooled":
            if self.ss:
                n, j = self.argmin2d(s, feas)
                n1, j1 = _index(n, N), _index(j, J)
            else:
                n1 = _index(self.argmin1d(s, feas.any(1)), N)
                row = feas.index_select(0, n1)[0]
                j1 = _index(torch.where(row, self.arangeJ, _IBIG).min(), J)
        else:
            # rrr: the first feasible server at-or-after `pos` in the
            # round's permutation; wrap to a fresh permutation when the
            # rest of the round has nothing feasible.
            perms, K = t["perms"], t["perms"].shape[0]
            perm = perms.index_select(0, self.pidx.clamp(max=K - 1))[0]
            rank = torch.zeros(J, dtype=i32, device=X.device).scatter_(
                0, perm, self.arangeJ)
            server_ok = feas.any(0)
            ahead = server_ok & (rank >= self.pos)
            wrap = ~ahead.any()
            perm2 = perms.index_select(0, (self.pidx + 1).clamp(max=K - 1))[0]
            rank2 = torch.zeros(J, dtype=i32, device=X.device).scatter_(
                0, perm2, self.arangeJ)
            eff_rank = torch.where(wrap, rank2, rank)
            eff_ok = torch.where(wrap, server_ok, ahead)
            j1 = torch.argmin(torch.where(eff_ok, eff_rank, _IBIG)).reshape(1)
            col = s.index_select(1, j1)[:, 0] if self.ss else s
            n1 = _index(self.argmin1d(col, feas.index_select(1, j1)[:, 0]), N)
            krank = eff_rank.index_select(0, j1)
            last = krank == self.j_real - 1
            pidx = self.pidx + wrap.to(i32) + last.to(i32)
            pos = torch.where(last, 0, krank + 1).to(i32)
        # -- grant: adds of 0 where the loop is dead ------------------------
        af, ai = alive.to(f32), alive.to(i32)
        X.view(-1).index_add_(0, n1 * J + j1, af)
        tot.index_add_(0, n1, af)
        # -TD[n] where alive, -0.0 where dead (demands are >= 0)
        FREE.index_add_(0, j1, t["TD"].index_select(0, n1) * -af)
        used.index_add_(0, j1, ai)
        # feasibility: column j saw FREE change; row n may have hit `wanted`
        wants = tot < t["wanted"]
        colf = (wants & t["allowed"].index_select(1, j1)[:, 0]
                & (t["TD"] <= FREE.index_select(0, j1) + self.eps).all(1))
        if self.use_limit:
            colf = colf & (used.index_select(0, j1) < self.limit)
        _put(feas, 1, j1, colf[:, None], alive)
        feas.index_copy_(0, n1, feas.index_select(0, n1)
                         & (wants.index_select(0, n1) | ~alive))
        # -- refresh: row n, and for rPS-DSF first residual column j -------
        phi_n = t["phi"].index_select(0, n1)
        xt_n = tot.index_select(0, n1) + la
        if self.kind == "drf":
            _put(s, 0, n1, xt_n * t["aux"].index_select(0, n1) / phi_n, alive)
        elif self.kind == "tsf":
            _put(s, 0, n1, xt_n / t["aux"].index_select(0, n1), alive)
        else:
            dom = t["dom"]
            if self.kind == "rpsdsf":
                D = t["D"]
                cap_j = (t["C"].index_select(0, j1)
                         - X.index_select(1, j1).T @ D)          # (1, R)
                _put(t["cap"], 0, j1, cap_j, alive)
                _put(dom, 1, j1, _dominant_cols(D, cap_j, self.dom_big).T,
                     alive)
                _put(s, 1, j1, ((tot + la) / t["phi"])[:, None]
                     * dom.index_select(1, j1), alive)
            _put(s, 0, n1, (xt_n / phi_n)[:, None] * dom.index_select(0, n1),
                 alive)
        _put(self.nsjs, 1, self.count.clamp(max=self.max_steps - 1).long(),
             torch.cat([n1, j1]).to(i32)[:, None], alive)
        self.count.add_(ai)
        if self.policy == "rrr":
            self.pidx.copy_(torch.where(alive, pidx, self.pidx))
            self.pos.copy_(torch.where(alive, pos, self.pos))

    def run(self, steps: int):
        """``steps`` steps, then the alive flag for the next one."""
        for _ in range(steps):
            self.step()
        self.flag.copy_(self.alive_now())

    def result(self):
        """-> ``(ns, js, count, X, tot, FREE, used, pidx, pos)``."""
        t = self.t
        return (self.nsjs[0], self.nsjs[1], self.count.reshape(()), t["X"],
                t["tot"], t["FREE"], t["used"], self.pidx.reshape(()),
                self.pos.reshape(()))


def drive(loop: EpochLoop, chunk: int):
    """Run ``loop`` eagerly to its end in chunks of ``chunk`` steps, reading
    its alive flag after each chunk -> :meth:`EpochLoop.result`.  Steps
    past the end change nothing, so the chunk only sets how often the
    flag is read."""
    loop.flag.copy_(loop.alive_now())
    while bool(loop.flag):
        loop.run(chunk)
    return loop.result()


def _k12_launches():
    return _tiles.masked_argmin1d.launches, _tiles.masked_argmin2d.launches


def _add_k12_launches(k1, k2):
    _tiles.masked_argmin1d.launches += k1
    _tiles.masked_argmin2d.launches += k2


class CapturedGraph:
    """Work captured once as a CUDA graph on buffers its owner keeps, and
    what keeps two callers off those buffers: :meth:`use` holds a lock on
    the host and, at its end, records an event that the next use waits
    for on the device (the last copy out of the buffers is behind it).

    ``warm()`` runs first on a side stream (it builds and loads the
    kernels and initializes cuBLAS, on buffers whose steps are all dead),
    then ``body()`` is captured."""

    def __init__(self, device, warm, body):
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                warm()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                body()
        self.lock = threading.Lock()
        self._done = None

    @contextlib.contextmanager
    def use(self):
        with self.lock:
            if self._done is not None:
                torch.cuda.current_stream(self._done.device).wait_event(
                    self._done)
            yield self
            self._done = torch.cuda.Event()
            self._done.record()


class LoopGraph(CapturedGraph):
    """:data:`CHUNK` steps of an :class:`EpochLoop` on static buffers,
    captured as one CUDA graph, and the alive flag after them.

    :func:`run_loop` keeps one per :func:`graph_key` and copies each
    segment's tensors into its buffers.  A capture's K1/K2 calls launch
    nothing, so the capture takes back what they counted, and every
    :meth:`replay` adds the graph's launches (one a step, dead steps
    included)."""

    def __init__(self, tensors: dict, loop_kw: dict):
        global CAPTURE_COUNT
        self.static = {k: torch.zeros_like(v) for k, v in tensors.items()}
        self.loop = EpochLoop(self.static, **loop_kw)
        self.loop.reset(0, 0, 0, 0, 0.0)
        super().__init__(self.static["X"].device, lambda: self.loop.run(2),
                         self._captured)
        CAPTURE_COUNT += 1

    def _captured(self):
        """The captured chunk.  Its K1/K2 calls launch nothing (the warm-up
        before it does launch), so their counts are taken back here and
        added at every replay instead."""
        before = _k12_launches()
        try:
            self.loop.run(CHUNK)
        finally:
            counted = _k12_launches()
            _add_k12_launches(*(b - c for b, c in zip(before, counted)))
            self.launches = tuple(c - b for b, c in zip(before, counted))

    def load(self, tensors: dict, pidx0, pos0, j_real, limit, eps):
        """Copy a segment's tensors into the buffers and start it."""
        for k, v in tensors.items():
            self.static[k].copy_(v)
        self.loop.reset(pidx0, pos0, j_real, limit, eps)

    def replay(self):
        """One chunk of steps; no host sync."""
        self.graph.replay()
        _add_k12_launches(*self.launches)

    def alive(self) -> bool:
        """The alive flag after the last chunk: one host sync."""
        return bool(self.loop.flag.item())

    def unload(self, tensors: dict):
        """Copy the state back into a segment's tensors -> fresh copies of
        what the loop owns, ``(ns, js, count, pidx, pos)``."""
        for k in LOOP_TENSORS[:8]:
            tensors[k].copy_(self.static[k])
        lp = self.loop
        return (lp.nsjs[0].clone(), lp.nsjs[1].clone(),
                lp.count.reshape(()).clone(), lp.pidx.reshape(()).clone(),
                lp.pos.reshape(()).clone())


def graph_key(tensors: dict, *, kind, policy, lookahead, use_limit,
              max_steps, select="plain", shards=1, dom_big=criteria._BIG):
    """What a captured chunk bakes in, the counterpart of the reference's
    jit key: the device, the padded shapes (N, J, R and the height of the
    permutation stack), the tensors' types, the static configuration, the
    two select functions themselves and the chunk's length."""
    X, perms = tensors["X"], tensors["perms"]
    return (str(X.device), *X.shape, tensors["D"].shape[1], perms.shape[0],
            tuple(str(v.dtype) for v in tensors.values()), max_steps, kind,
            policy, bool(lookahead), bool(use_limit), select, shards,
            float(dom_big), _selects(select, shards), CHUNK)


def cached_graph(key, make, what: str):
    """The cached graph of ``key``, captured by ``make()`` on a miss (the
    least recently used dropped past :data:`GRAPH_CACHE_SIZE`).  A capture
    that fails raises :class:`KernelError` and caches nothing."""
    with _GRAPHS_LOCK:
        g = _GRAPHS.pop(key, None)
        if g is None:
            try:
                g = make()
            except RuntimeError as exc:
                if isinstance(exc, KernelError):
                    raise
                raise KernelError(f"{what}: capturing a chunk of steps "
                                  f"failed: {exc}") from exc
        _GRAPHS[key] = g
        while len(_GRAPHS) > GRAPH_CACHE_SIZE:
            _GRAPHS.popitem(last=False)
    return g


def _graph(tensors: dict, loop_kw: dict) -> LoopGraph:
    return cached_graph(graph_key(tensors, **loop_kw),
                        lambda: LoopGraph(tensors, loop_kw), "epoch loop")


def _loop_tensors(X, tot, FREE, cap, dom, s, feas, used, D, TD, C, phi,
                  wanted, allowed, perms, aux):
    return dict(zip(LOOP_TENSORS, (
        X, tot, FREE, cap, dom, s, feas, used, D, TD, C, phi, wanted,
        allowed, perms.to(device=X.device, dtype=torch.int64), aux)))


def run_loop_eager(*args, kind: str, policy: str, lookahead: bool,
                   use_limit: bool, max_steps: int, select: str = "plain",
                   shards: int = 1, dom_big=criteria._BIG):
    """:func:`run_loop`'s loop with its step run eagerly on the tensors'
    device and the alive flag read after every step: what :func:`run_loop`
    does on the CPU, and on the card the yardstick its graphs are held to
    (it syncs the host once a grant)."""
    loop = EpochLoop(_loop_tensors(*args[:16]), kind=kind, policy=policy,
                     lookahead=lookahead, use_limit=use_limit,
                     max_steps=max_steps, select=select, shards=shards,
                     dom_big=dom_big)
    loop.reset(*args[16:])
    return drive(loop, 1)


def run_loop(X, tot, FREE, cap, dom, s, feas, used, D, TD, C, phi, wanted,
             allowed, perms, aux, pidx0, pos0, j_real, limit, eps, *,
             kind: str, policy: str, lookahead: bool, use_limit: bool,
             max_steps: int, select: str = "plain", shards: int = 1,
             dom_big=criteria._BIG):
    """The epoch loop from an initialized state, updating ``X, tot, FREE,
    cap, dom, s, feas, used`` in place.  -> ``(ns, js, count, X, tot,
    FREE, used, pidx, pos)``.  With the default selects it is the
    persistent kernel's plain version (``dom_big=3.0e38`` there).

    On the CPU the :class:`EpochLoop` runs eagerly on these tensors
    (:func:`run_loop_eager`; a flag read costs nothing there).  On the card
    the segment runs on the cached :class:`LoopGraph` of its
    :func:`graph_key`: one replay and one flag read a :data:`CHUNK` of
    steps.  A capture or replay that fails raises :class:`KernelError`;
    nothing falls back to the eager loop."""
    loop_kw = dict(kind=kind, policy=policy, lookahead=lookahead,
                   use_limit=use_limit, max_steps=max_steps, select=select,
                   shards=shards, dom_big=dom_big)
    if X.device.type != "cuda":
        return run_loop_eager(X, tot, FREE, cap, dom, s, feas, used, D, TD, C,
                              phi, wanted, allowed, perms, aux, pidx0, pos0,
                              j_real, limit, eps, **loop_kw)
    tensors = _loop_tensors(X, tot, FREE, cap, dom, s, feas, used, D, TD, C,
                            phi, wanted, allowed, perms, aux)
    g = _graph(tensors, loop_kw)
    with g.use():
        g.load(tensors, pidx0, pos0, j_real, limit, eps)
        try:
            g.replay()
            while g.alive():
                g.replay()
        except torch.AcceleratorError as exc:    # a fault on the card
            raise KernelError(f"epoch loop faulted on the device: "
                              f"{exc}") from exc
        ns, js, count, pidx, pos = g.unload(tensors)
    return ns, js, count, X, tot, FREE, used, pidx, pos


def epoch_state(X, D, TD, C, FREE, phi, wanted, allowed, perms, used,
                pidx0, pos0, j_real, limit, eps, *, kind: str,
                lookahead: bool, use_limit: bool):
    """The f32 epoch state and constants of one segment: the argument tuple
    of :func:`run_loop` and of the persistent kernel, ``(X, tot, FREE, cap,
    dom, s, feas, used, D, TD, C, phi, wanted, allowed, perms, aux, pidx0,
    pos0, j_real, limit, eps)``.  The state tensors are fresh copies."""
    N = X.shape[0]
    f32 = torch.float32
    X = X.to(f32, copy=True)
    FREE = FREE.to(f32, copy=True)
    used = used.to(torch.int32, copy=True)
    D, TD, C = D.to(f32), TD.to(f32), C.to(f32)
    phi, wanted = phi.to(f32), wanted.to(f32)
    allowed = allowed.bool()
    la = 1.0 if lookahead else 0.0
    tot = X.sum(1)
    dummy = torch.zeros((1, 1), dtype=f32, device=X.device)

    # -- X-independent score pieces (computed once per dispatch) ------------
    cap0 = dom0 = dummy
    if kind == "drf":
        aux = criteria.drf_dominant(D, C, xp=torch)              # (N,)
        s0 = (tot + la) * aux / phi
    elif kind == "tsf":
        monopoly = criteria.tsf_monopoly(D, C, allowed=allowed, xp=torch)
        aux = phi * monopoly.clamp_min(1e-30)                    # (N,)
        s0 = (tot + la) / aux
    elif kind in ("psdsf", "rpsdsf"):
        aux = torch.zeros(N, dtype=f32, device=X.device)
        if kind == "rpsdsf":
            cap0 = criteria.residual_capacities(X, D, C, xp=torch)  # (J, R)
            dom0 = criteria.virtual_dominant(D, cap0, xp=torch)     # (N, J)
        else:
            dom0 = criteria.virtual_dominant(D, C, xp=torch)
        s0 = ((tot + la) / phi)[:, None] * dom0
    else:
        raise ValueError(f"unsupported criterion kind {kind!r}")

    feas0 = criteria.feasible_mask(TD, FREE, allowed, tot < wanted, eps=eps,
                                   xp=torch)
    if use_limit:
        feas0 = feas0 & (used < limit)[None, :]
    return (X, tot, FREE, cap0, dom0, s0, feas0, used, D, TD, C, phi, wanted,
            allowed, perms, aux, pidx0, pos0, j_real, limit, eps)


def epoch_loop(X, D, TD, C, FREE, phi, wanted, allowed, perms, used,
               pidx0, pos0, j_real, limit, eps, *, kind: str, policy: str,
               lookahead: bool, use_limit: bool, kernel="persistent",
               max_steps: int, shards: int = 1):
    """Run one allocation epoch segment on ``X``'s device.  Returns ``(ns,
    js, count, X, tot, FREE, used, pidx, pos)``; the inputs are not
    modified.

    All array arguments may be padded; padded frameworks must carry
    ``wanted == 0`` / ``allowed == False`` and padded servers ``FREE == 0``
    so they are infeasible by construction.  ``j_real`` is the number of
    REAL servers (RRR round length); ``perms`` is a (K, J) stack of server
    permutations consumed by RRR from row ``pidx0`` / position ``pos0``
    (rows beyond the stack repeat the last; :class:`_EpochRun` detects that
    and replays with a bigger stack)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown epoch kernel {kernel!r}")
    N, J = X.shape
    if shards > 1 and (N % shards or J % shards):
        shards = 1
    args = epoch_state(X, D, TD, C, FREE, phi, wanted, allowed, perms, used,
                       pidx0, pos0, j_real, limit, eps, kind=kind,
                       lookahead=lookahead, use_limit=use_limit)
    kw = dict(kind=kind, policy=policy, lookahead=lookahead,
              use_limit=use_limit, max_steps=max_steps)
    if kernel == "persistent":
        return persistent_epoch(*args, **kw)
    return run_loop(*args, **kw, select="tiles" if kernel == "tiles"
                    else "plain", shards=shards)


# -- the multi-device epoch (the reference's epoch_loop_mesh) -----------------

def _cols(t, jl):
    """(k, N) column ``jl[i]`` of each shard's (N, Js) block of ``t``."""
    k, N, _ = t.shape
    return t.gather(2, jl.view(k, 1, 1).expand(k, N, 1))[..., 0]


def _set_cols(t, jl, v):
    """Each shard's column ``jl[i]`` of ``t`` becomes ``v[i]``."""
    k, N, _ = t.shape
    t.scatter_(2, jl.view(k, 1, 1).expand(k, N, 1), v[..., None])


def _row_scan(s, feas):
    """Exact per-row masked block minima and the first column attaining
    each, (k, N) each."""
    masked = torch.where(feas, s, _BIG)
    return masked.amin(2), masked.argmin(2).to(torch.int32)


#: what every mesh group holds whole: the replicated state and constants
MESH_SHARED = ("tot", "D", "TD", "phi", "wanted", "perms", "aux")


def mesh_groups(tensors: dict, mesh, *, kind: str, policy: str) -> list:
    """Split one segment's global tensors (a dict keyed by
    :data:`LOOP_TENSORS`, after the global f32 score init of
    :func:`epoch_state`) by column onto the mesh: one dict a group, its
    shards' blocks stacked along a leading axis on the group's device, with
    the replicated tensors (:data:`MESH_SHARED`) copied whole.  ``X``,
    ``FREE``, ``feas``, ``used``, ``allowed`` and ``C`` are split, and
    ``s`` and ``dom`` for PS-DSF/rPS-DSF and ``cap`` for rPS-DSF; otherwise
    the group holds a replicated ``s`` and (1, 1, 1) dummies.  Adds each
    block's feasibility
    counts by row (``fcnt``) and column (``ccnt``) and, for pooled
    PS-DSF/rPS-DSF, its per-row masked minima ``rmin`` and their columns
    ``rarg``."""
    X = tensors["X"]
    N, J = X.shape
    K = mesh.size
    Js = J // K
    ss = kind in ("psdsf", "rpsdsf")
    split = {
        "X": X.reshape(N, K, Js).transpose(0, 1),
        "FREE": tensors["FREE"].reshape(K, Js, -1),
        "feas": tensors["feas"].reshape(N, K, Js).transpose(0, 1),
        "used": tensors["used"].reshape(K, Js),
        "allowed": tensors["allowed"].reshape(N, K, Js).transpose(0, 1),
        "C": tensors["C"].reshape(K, Js, -1),
    }
    if ss:
        for name in ("dom", "s"):
            split[name] = tensors[name].reshape(N, K, Js).transpose(0, 1)
    if kind == "rpsdsf":
        split["cap"] = tensors["cap"].reshape(K, Js, -1)
    groups = []
    for dev, a, b in mesh.groups:
        g = {name: blk[a:b].to(dev).clone(
            memory_format=torch.contiguous_format)
            for name, blk in split.items()}
        for name in MESH_SHARED + (() if ss else ("s",)):
            g[name] = tensors[name].to(dev).clone()
        g["perms"] = g["perms"].long()
        for name in ("cap", "dom"):
            g.setdefault(name, torch.zeros((1, 1, 1), dtype=torch.float32,
                                           device=dev))
        g["fcnt"] = g["feas"].sum(2, dtype=torch.int32)
        g["ccnt"] = g["feas"].sum(1, dtype=torch.int32)
        if policy == "pooled" and ss:
            g["rmin"], g["rarg"] = _row_scan(g["s"], g["feas"])
        else:
            g["rmin"] = torch.zeros((b - a, N), dtype=torch.float32,
                                    device=dev)
            g["rarg"] = torch.zeros((b - a, N), dtype=torch.int32,
                                    device=dev)
        groups.append(g)
    return groups


class MeshLoop:
    """The mesh epoch's loop over the mesh's groups (dicts from
    :func:`mesh_groups`): the reference's ``shard_body`` ``cond`` and
    ``body`` (``engine_jax.epoch_loop_mesh``) for all K shards, as
    :meth:`step`, with the rules of :class:`EpochLoop`: every write
    predicated on the loop being alive, every index a 1-element tensor, no
    host sync.  The group tensors are updated in place.

    Each group holds its own copy of the replicated loop state (``count``,
    ``pidx``, ``pos``, ``alive``, the grant sequence ``nsjs``), as each
    device does in the reference; a step computes it identically on every
    group from the same reduced partials.  A grant touches one column of
    one shard (its owner) and one row of every shard.

    Per-row minima cache (pooled PS-DSF/rPS-DSF): the global select is one
    ``gmin`` over the shards' (N,) row minima and one over the first
    qualifying column of the winning row.  Epoch updates only raise masked
    scores, so a grant at (n, j) leaves every cached row exact except row
    n, which every shard re-scans, and, on the owner, rows whose cached
    minimum sat in column j and strictly rose.  The reference re-scans the
    owner's block only then (``lax.cond``); here the block is re-scanned
    every step and the scan's rows taken by ``torch.where`` where that
    holds: the same values, with no branch on the host."""

    def __init__(self, groups: list, mesh, *, kind: str, policy: str,
                 lookahead: bool, use_limit: bool, max_steps: int):
        self.g, self.mesh = groups, mesh
        _k, self.N, self.Js = groups[0]["X"].shape
        self.K = mesh.size
        self.J = self.K * self.Js
        self.R = groups[0]["D"].shape[1]
        self.kind, self.policy = kind, policy
        self.la = 1.0 if lookahead else 0.0
        self.use_limit, self.max_steps = use_limit, max_steps
        self.ss = kind in ("psdsf", "rpsdsf")
        i32 = torch.int32
        self.st = []
        for (dev, a, b), g in zip(mesh.groups, groups):
            one = lambda dtype: torch.zeros(1, dtype=dtype, device=dev)  # noqa
            ar = lambda n: torch.arange(n, dtype=i32, device=dev)  # noqa
            self.st.append(dict(
                count=one(i32), pidx=one(i32), pos=one(i32),
                alive=one(torch.bool), j_real=one(i32), limit=one(i32),
                eps=one(torch.float32),
                nsjs=torch.full((2, max_steps), -1, dtype=i32, device=dev),
                ax=ar(b - a) + a, offs=(ar(b - a) + a) * self.Js,
                sidx=torch.arange(b - a, device=dev),
                arangeN=ar(self.N), arangeJs=ar(self.Js), arangeJ=ar(self.J),
                a=a, b=b))
        self.flag = torch.zeros(1, dtype=torch.bool, device=mesh.lead)

    def reset(self, pidx0, pos0, j_real, limit, eps, alive=True):
        """Start a segment: no grants yet, the RRR cursor at (pidx0,
        pos0)."""
        for s in self.st:
            s["count"].zero_()
            s["nsjs"].fill_(-1)
            for name, v in (("pidx", pidx0), ("pos", pos0),
                            ("j_real", j_real), ("limit", limit),
                            ("eps", eps), ("alive", alive)):
                s[name].fill_(v)

    def alive_now(self):
        """(1,) bool on the lead device: the reference's ``cond``."""
        s = self.st[0]
        return s["alive"] & (s["count"] < self.max_steps)

    # -- select: the reference's shard_body._select ------------------------

    def _select_pooled_2d(self):
        grmin = self.mesh.gmin([g["rmin"] for g in self.g])
        sel, parts = [], []
        for g, s, gm in zip(self.g, self.st, grmin):
            m = gm.min().reshape(1)
            thr = m + (1e-9 + 1e-6 * m.abs())    # _argmin_tie_low's
            n1 = _index(torch.where(gm <= thr, s["arangeN"], _IBIG).min(),
                        self.N)
            row = torch.where(g["feas"].index_select(1, n1),
                              g["s"].index_select(1, n1), _BIG)[:, 0]
            parts.append(torch.where(row <= thr, s["offs"][:, None]
                                     + s["arangeJs"], _IBIG).amin(1))
            sel.append((n1, m < _BIG))
        return [(n1, j, found, s["pidx"], s["pos"]) for (n1, found), j, s
                in zip(sel, self.mesh.gmin(parts), self.st)]

    def _select_pooled_1d(self):
        cnt = self.mesh.gsum([g["fcnt"] for g in self.g])
        sel, parts = [], []
        for g, s, c in zip(self.g, self.st, cnt):
            row_ok = c > 0
            n1 = _index(_argmin_tie_low(g["s"], row_ok), self.N)
            row = g["feas"].index_select(1, n1)[:, 0]
            parts.append(torch.where(row, s["offs"][:, None]
                                     + s["arangeJs"], _IBIG).amin(1))
            sel.append((n1, row_ok.any().reshape(1)))
        return [(n1, j, found, s["pidx"], s["pos"]) for (n1, found), j, s
                in zip(sel, self.mesh.gmin(parts), self.st)]

    def _ranks(self, g, s, row):
        """This group's shards' (k, Js) ranks in permutation ``row`` of
        the stack (a 1-element index, clamped to the stack)."""
        perms = g["perms"]
        perm = perms.index_select(0, row.clamp(max=perms.shape[0] - 1))[0]
        rank = torch.zeros(self.J, dtype=torch.int32,
                           device=perm.device).scatter_(0, perm,
                                                        s["arangeJ"])
        return rank.view(self.K, self.Js)[s["a"]:s["b"]]

    def _select_rrr(self):
        mesh, J, Js = self.mesh, self.J, self.Js
        # the round's next feasible server from the running column counts
        pre, parts = [], []
        for g, s in zip(self.g, self.st):
            rank = self._ranks(g, s, s["pidx"])
            server_ok = g["ccnt"] > 0
            ahead = server_ok & (rank >= s["pos"])
            pre.append((server_ok, rank, ahead))
            parts.append(ahead.any(1))
        anys, wraps, parts = mesh.gany(parts), [], []
        for g, s, (server_ok, rank, ahead), any_ahead in zip(
                self.g, self.st, pre, anys):
            wrap = ~any_ahead.reshape(1)
            rank2 = self._ranks(g, s, s["pidx"] + 1)
            eff_rank = torch.where(wrap, rank2, rank)
            eff_ok = torch.where(wrap, server_ok, ahead)
            # one fused (rank, server) key: ranks are a permutation
            parts.append(torch.where(eff_ok, eff_rank * J + s["offs"][:, None]
                                     + s["arangeJs"], _IBIG).amin(1))
            wraps.append(wrap)
        keys = [k.reshape(1) for k in mesh.gmin(parts)]
        # the best framework on the owner's column, broadcast by a sum
        # that exactly one owner contributes to
        parts = []
        for g, s, key in zip(self.g, self.st, keys):
            j = key % J
            ow = (j // Js) == s["ax"]
            jl = (j - s["offs"]).clamp(0, Js - 1).long()
            fcol = torch.where(ow[:, None], _cols(g["feas"], jl),
                               False).float()
            if self.ss:
                colv = torch.where(ow[:, None], _cols(g["s"], jl), 0.0)
                parts.append(torch.stack([colv, fcol], 1))
            else:
                parts.append(fcol)
        out = []
        for g, s, key, wrap, pay in zip(self.g, self.st, keys, wraps,
                                        mesh.gsum(parts)):
            if self.ss:
                col, fcol = pay[0], pay[1] > 0.5
            else:
                col, fcol = g["s"], pay > 0.5
            n1 = _index(_argmin_tie_low(col, fcol), self.N)
            mrank = key // J
            last = mrank == s["j_real"] - 1
            pidx = s["pidx"] + wrap.to(torch.int32) + last.to(torch.int32)
            pos = torch.where(last, 0, mrank + 1).to(torch.int32)
            out.append((n1, key % J, key < _IBIG, pidx, pos))
        return out

    # -- the step: the reference's shard_body.body -------------------------

    def step(self):
        """One pass of the reference's ``body`` on every shard where
        ``cond`` holds; where it does not, every tensor is left as it
        was."""
        live = [s["alive"] & (s["count"] < self.max_steps) for s in self.st]
        if self.policy == "pooled":
            sel = (self._select_pooled_2d() if self.ss
                   else self._select_pooled_1d())
        else:
            sel = self._select_rrr()
        for g, s, lv, (n1, j, found, pidx, pos) in zip(self.g, self.st,
                                                       live, sel):
            self._grant(g, s, n1, j.reshape(1).to(torch.int32),
                        found.reshape(1) & lv, pidx, pos, lv)

    def _grant(self, g, s, n1, j, found, pidx, pos, live):
        N, Js, R = self.N, self.Js, self.R
        f32, i32 = torch.float32, torch.int32
        la = self.la
        X, tot, FREE, feas, used = g["X"], g["tot"], g["FREE"], g["feas"], \
            g["used"]
        fcnt, ccnt, sc = g["fcnt"], g["ccnt"], g["s"]
        # owner-predicated block updates: adding 0 elsewhere keeps the
        # other shards' blocks bit for bit (the state is >= +0.0)
        ow = ((j // Js) == s["ax"]) & found                      # (k,)
        jl = (j - s["offs"]).clamp(0, Js - 1).long()             # (k,)
        owf = ow.to(f32)
        sj = s["sidx"] * Js + jl                                 # (k,)
        X.view(-1).index_add_(0, s["sidx"] * (N * Js) + n1 * Js + jl, owf)
        tot.index_add_(0, n1, found.to(f32))
        FREE.view(-1, R).index_add_(0, sj, -g["TD"].index_select(0, n1)
                                    * owf[:, None])
        used.view(-1).index_add_(0, sj, ow.to(i32))
        # feasibility: the owner's column j, then row n if n is satisfied
        wants = tot < g["wanted"]
        FREEj = FREE.view(-1, R).index_select(0, sj)             # (k, R)
        colf = (wants & _cols(g["allowed"], jl)
                & (g["TD"] <= (FREEj + s["eps"])[:, None, :]).all(2))
        if self.use_limit:
            colf = colf & (used.view(-1).index_select(0, sj)
                           < s["limit"])[:, None]
        old_col = _cols(feas, jl)
        new_col = torch.where(ow[:, None], colf, old_col)
        _set_cols(feas, jl, new_col)
        dcol = old_col.to(i32) - new_col.to(i32)                 # removals
        fcnt.sub_(dcol)
        ccnt.view(-1).index_add_(0, sj, -dcol.sum(1, dtype=i32))
        dead = found & ~wants.index_select(0, n1)
        old_row = feas.index_select(1, n1)[:, 0]                 # (k, Js)
        drow = torch.where(dead, old_row.to(i32), 0)
        feas.index_copy_(1, n1, (old_row & ~dead)[:, None])
        fcnt.index_add_(1, n1, -drow.sum(1, keepdim=True, dtype=i32))
        ccnt.sub_(drow)
        # score refresh: the owner's column slice and the granted row
        phi = g["phi"]
        phi_n = phi.index_select(0, n1)
        xt_n = tot.index_select(0, n1) + la
        stale = None
        if self.policy == "pooled" and self.ss:
            rmin, rarg = g["rmin"], g["rarg"]
        if self.kind == "drf":
            _put(sc, 0, n1, xt_n * g["aux"].index_select(0, n1) / phi_n,
                 found)
        elif self.kind == "tsf":
            _put(sc, 0, n1, xt_n / g["aux"].index_select(0, n1), found)
        else:
            dom = g["dom"]
            if self.kind == "rpsdsf":
                D, cap = g["D"], g["cap"]
                used_d = torch.cat([X[i].index_select(1, jl[i:i + 1]).T @ D
                                    for i in range(X.shape[0])])  # (k, R)
                capj = g["C"].view(-1, R).index_select(0, sj) - used_d
                capj = torch.where(ow[:, None], capj,
                                   cap.view(-1, R).index_select(0, sj))
                cap.view(-1, R).index_copy_(0, sj, capj)
                domc = torch.where(ow[:, None],
                                   _dominant_cols(D, capj, criteria._BIG),
                                   _cols(dom, jl))
                _set_cols(dom, jl, domc)
                col = torch.where(ow[:, None], ((tot + la) / phi)[None]
                                  * domc, _cols(sc, jl))
                _set_cols(sc, jl, col)
            if self.policy == "pooled":
                # the cache's stale rows, against the cached values
                newc = torch.where(_cols(feas, jl), _cols(sc, jl), _BIG)
                stale = ((rarg == jl[:, None].to(i32)) & (rmin < _BIG)
                         & (s["arangeN"] != n1) & (newc > rmin))
            _put(sc, 1, n1, (xt_n / phi_n) * dom.index_select(1, n1), found)
        if stale is not None:
            # every shard re-scans the granted row; the owner's stale rows
            # take the block's fresh scan
            rowm = torch.where(feas.index_select(1, n1),
                               sc.index_select(1, n1), _BIG)[:, 0]
            _put(rmin, 1, n1, rowm.amin(1, keepdim=True), found)
            _put(rarg, 1, n1, rowm.argmin(1, keepdim=True).to(i32), found)
            redo = (ow & stale.any(1))[:, None]
            smin, sarg = _row_scan(sc, feas)
            rmin.copy_(torch.where(redo, smin, rmin))
            rarg.copy_(torch.where(redo, sarg, rarg))
        _put(s["nsjs"], 1, s["count"].clamp(max=self.max_steps - 1).long(),
             torch.cat([n1.to(i32), j])[:, None], found)
        s["count"].add_(found.to(i32))
        if self.policy == "rrr":
            s["pidx"].copy_(torch.where(found, pidx, s["pidx"]))
            s["pos"].copy_(torch.where(found, pos, s["pos"]))
        s["alive"].copy_(torch.where(live, found, s["alive"]))

    def run(self, steps: int):
        """``steps`` steps, then the alive flag for the next one."""
        for _ in range(steps):
            self.step()
        self.flag.copy_(self.alive_now())

    def result(self):
        """-> ``(ns, js, count, X, tot, FREE, used, pidx, pos)`` on the
        lead device, the blocks joined along the agent axis."""
        lead, s = self.mesh.lead, self.st[0]

        def joined(name):
            return torch.cat([g[name].to(lead) for g in self.g])

        X = joined("X").transpose(0, 1).reshape(self.N, self.J)
        return (s["nsjs"][0], s["nsjs"][1], s["count"].reshape(()), X,
                self.g[0]["tot"], joined("FREE").reshape(self.J, self.R),
                joined("used").reshape(self.J), s["pidx"].reshape(()),
                s["pos"].reshape(()))


class MeshGraph(CapturedGraph):
    """:data:`CHUNK` steps of a :class:`MeshLoop` whose shards all sit on
    one card, on static buffers, captured as one CUDA graph (the
    counterpart of the reference's jitted mesh loop; the captures count in
    :data:`CAPTURE_COUNT`)."""

    def __init__(self, groups: list, mesh, loop_kw: dict):
        global CAPTURE_COUNT
        self.static = [{k: torch.zeros_like(v) for k, v in g.items()}
                       for g in groups]
        self.loop = MeshLoop(self.static, mesh, **loop_kw)
        # the warm-up's steps are all dead
        self.loop.reset(0, 0, 0, 0, 0.0, alive=False)
        super().__init__(mesh.lead, lambda: self.loop.run(2),
                         lambda: self.loop.run(CHUNK))
        CAPTURE_COUNT += 1

    def load(self, groups: list, pidx0, pos0, j_real, limit, eps):
        """Copy a segment's group tensors into the buffers and start it."""
        for st, g in zip(self.static, groups):
            for k, v in g.items():
                st[k].copy_(v)
        self.loop.reset(pidx0, pos0, j_real, limit, eps)

    def replay(self):
        """One chunk of steps; no host sync."""
        self.graph.replay()

    def alive(self) -> bool:
        """The alive flag after the last chunk: one host sync."""
        return bool(self.loop.flag.item())

    def unload(self):
        """-> fresh copies of :meth:`MeshLoop.result`."""
        return tuple(t.clone() for t in self.loop.result())


def mesh_graph_key(groups: list, mesh, *, kind, policy, lookahead,
                   use_limit, max_steps):
    """What a captured chunk of the mesh loop bakes in: :func:`graph_key`'s
    parts, with the mesh's shards and groups in place of the selects."""
    g = groups[0]
    _k, N, Js = g["X"].shape
    return ("mesh", str(mesh.lead), N, mesh.size * Js, g["D"].shape[1],
            g["perms"].shape[0],
            tuple((k, str(v.dtype), tuple(v.shape)) for k, v in g.items()),
            max_steps, kind, policy, bool(lookahead), bool(use_limit),
            mesh.key(), CHUNK)


def epoch_loop_mesh(X, D, TD, C, FREE, phi, wanted, allowed, perms, used,
                    pidx0, pos0, j_real, limit, eps, *, kind: str,
                    policy: str, lookahead: bool, use_limit: bool,
                    max_steps: int, devices=1):
    """Multi-device epoch segment: the agent (server) axis split over
    ``devices``, an :class:`~repro_torch.launch.mesh.AgentMesh` or a count
    of devices for :func:`~repro_torch.launch.mesh.make_agent_mesh` on
    ``X``'s device type.  Same contract as :func:`epoch_loop` (padded
    inputs, the same grant sequences), minus ``kernel``/``shards``: each
    shard keeps its (N, J/K) block.  Returns ``(ns, js, count, X, tot,
    FREE, used, pidx, pos)`` on the mesh's lead device; the inputs are not
    modified.

    The f32 score init runs on the global arrays on the lead device, in
    the reference's order (a sum over the agent axis computed a shard at a
    time would reorder it); then the state is split by column.  Each step
    crosses the shards with (N,)-sized and scalar partials only (see
    :class:`MeshLoop`).  When all shards sit on one card the loop runs as
    captured :data:`CHUNK`-step graphs (:class:`MeshGraph`, cached per
    :func:`mesh_graph_key`), one alive-flag read a chunk; across cards it
    runs eagerly in chunks of :data:`CHUNK` steps, one flag read a chunk,
    and on the CPU eagerly with a read a step."""
    mesh = _mesh.as_mesh(devices, X.device)
    N, J = X.shape
    if J % mesh.size:
        raise ValueError(f"padded J={J} not divisible by mesh size "
                         f"{mesh.size}")
    lead = mesh.lead
    to = lambda a: a.to(lead) if torch.is_tensor(a) else a  # noqa: E731
    args = epoch_state(*(to(a) for a in (X, D, TD, C, FREE, phi, wanted,
                                         allowed, perms, used)),
                       pidx0, pos0, j_real, limit, eps, kind=kind,
                       lookahead=lookahead, use_limit=use_limit)
    groups = mesh_groups(_loop_tensors(*args[:16]), mesh, kind=kind,
                         policy=policy)
    loop_kw = dict(kind=kind, policy=policy, lookahead=lookahead,
                   use_limit=use_limit, max_steps=max_steps)
    if lead.type == "cuda" and mesh.one_device:
        g = cached_graph(mesh_graph_key(groups, mesh, **loop_kw),
                         lambda: MeshGraph(groups, mesh, loop_kw),
                         "mesh epoch")
        with g.use():
            g.load(groups, *args[16:])
            try:
                g.replay()
                while g.alive():
                    g.replay()
            except torch.AcceleratorError as exc:    # a fault on the card
                raise KernelError(f"mesh epoch faulted on the device: "
                                  f"{exc}") from exc
            return g.unload()
    loop = MeshLoop(groups, mesh, **loop_kw)
    loop.reset(*args[16:])
    return drive(loop, CHUNK if lead.type == "cuda" else 1)


def _bucket(n: int, lo: int = 8) -> int:
    """Next power of two >= max(n, lo) — the shape bucket (the same
    rounding rule the kernel wrappers use for tiles)."""
    return next_pow2(n, lo)


def _pad(a, n, axis, value):
    pad = n - a.shape[axis]
    if pad <= 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, constant_values=value)


def grant_bound(TD, FREE, tot, wanted, per_agent_limit=None) -> int:
    """Upper bound on grants this epoch (sizes the device-side sequence).

    Every grant consumes at least ``min_n max_r TD[n, r]`` units of SOME
    resource on its server, so server j can absorb at most
    ``sum_r FREE[j, r] / that`` grants; the total is additionally capped by
    the outstanding wanted deficit and by J * per_agent_limit.  The
    wanted/limit caps apply even when a degenerate zero-demand framework
    voids the capacity argument."""
    wants = tot < wanted
    if not wants.any():
        return 0
    deficit = float(np.sum(wanted[wants] - tot[wants]))
    bound = int(min(deficit, 2**30))
    dmin = float(np.max(TD[wants], axis=1).min())
    if dmin > 0:
        bound = min(bound,
                    int(np.ceil(np.sum(np.maximum(FREE, 0.0)) / dmin)))
    if per_agent_limit is not None:
        bound = min(bound, FREE.shape[0] * int(per_agent_limit))
    return max(bound, 1)


def rrr_perm_budget(bound: int, J: int, max_steps_cap: int = 16384) -> int:
    """Initial RRR permutation-stack height for one dispatch segment.

    One permutation per round of ~J grants plus wrap slack, pow2-bucketed.
    A pure function of the epoch profile — the epoch-cache layer calls this
    to pre-draw (and fingerprint) the exact prefix the dispatch would draw,
    keeping the rng stream position identical with and without a cache in
    front."""
    seg = min(bound, max_steps_cap)
    return _bucket(4 + 4 * ((seg + J - 1) // J))


class _EpochRun:
    """Continuation state of an in-flight fused epoch (one dispatch issued,
    readback deferred).  ``_finish`` drives RRR grow-and-replay rounds and
    chained overflow segments.  Dispatches never modify their inputs, so a
    replay restarts from the kept segment-start tensors."""

    def __init__(self, *, kind, policy, lookahead, use_limit, kernel, shards,
                 J, limit, eps, draw, consts, perms, bound, max_steps_cap,
                 devices=1):
        self.kind, self.policy = kind, policy
        self.lookahead, self.use_limit = lookahead, use_limit
        self.kernel, self.shards = kernel, shards
        self.devices = devices      # >1: mesh dispatch (epoch_loop_mesh)
        self.J, self.limit, self.eps = J, limit, eps
        self.draw = draw            # rng-stream permutation drawer (RRR)
        self.consts = consts        # (dD, dTD, dC, dphi, dwanted, dallowed)
        self.perms = perms
        self.pidx = self.pos = 0
        self.remaining = bound
        self.max_steps_cap = max_steps_cap
        self._last_inputs = None
        self.pending = None

    def dispatch(self, X_cur, FREE_cur, used_cur):
        global DISPATCH_COUNT
        DISPATCH_COUNT += 1
        if fault_hook is not None:
            fault_hook()
        self.max_steps = _bucket(min(self.remaining, self.max_steps_cap),
                                 lo=16)
        if self.policy == "rrr":
            self._last_inputs = (X_cur, FREE_cur, used_cur)
        dD, dTD, dC, dphi, dwanted, dallowed = self.consts
        args = (X_cur, dD, dTD, dC, FREE_cur, dphi, dwanted, dallowed,
                torch.as_tensor(self.perms, device=X_cur.device), used_cur,
                self.pidx, self.pos, self.J, self.limit, self.eps)
        kw = dict(kind=self.kind, policy=self.policy,
                  lookahead=self.lookahead, use_limit=self.use_limit,
                  max_steps=self.max_steps)
        if self.devices > 1:
            self.pending = epoch_loop_mesh(*args, **kw, devices=self.devices)
            return
        self.pending = epoch_loop(*args, **kw, kernel=self.kernel,
                                  shards=self.shards)

    def _finish(self) -> list[tuple[int, int]]:
        out: list[tuple[int, int]] = []
        while True:
            ns, js, count, Xd, _totd, FREEd, usedd, pidx_d, pos_d = \
                self.pending
            if self.policy == "rrr":
                # a cursor that ran past the stack read clamped rows: grow
                # the stack (stream-append) and replay the segment
                while int(pidx_d) >= self.perms.shape[0]:
                    self.perms = np.concatenate(
                        [self.perms, self.draw(self.perms.shape[0])])
                    self.dispatch(*self._last_inputs)
                    ns, js, count, Xd, _totd, FREEd, usedd, pidx_d, pos_d = \
                        self.pending
            k = int(count)
            out.extend(zip(ns[:k].tolist(), js[:k].tolist()))
            if k < self.max_steps or self.remaining - k <= 0:
                return out
            # overflow: chain another dispatch from the final DEVICE state
            # (incl. the RRR cursor, so the chain equals one long epoch)
            self.remaining -= k
            self.pidx, self.pos = int(pidx_d), int(pos_d)
            self.dispatch(Xd, FREEd, usedd)


class EpochHandle:
    """Handle to an in-flight fused epoch (see :func:`run_epoch_async`).

    ``result()`` is the commit point: it blocks until the device loop(s)
    finish, drives any chained/replayed dispatches, and returns the flat
    grant sequence.  Idempotent — repeated calls return the same list."""

    __slots__ = ("_seq", "_run", "perms")

    def __init__(self, seq=None, run=None):
        self._seq = seq
        self._run = run
        # final permutation stack (set at result(); None for empty epochs).
        # The epoch-cache layer reads it to record how many grow-and-replay
        # rows an RRR epoch drew PAST the pre-drawn prefix.
        self.perms = None

    @property
    def in_flight(self) -> bool:
        """True until ``result()`` has been driven to completion."""
        return self._seq is None

    def result(self) -> list[tuple[int, int]]:
        if self._seq is None:
            try:
                self._seq = self._run._finish()
            except torch.AcceleratorError as exc:   # a fault on the card
                raise KernelError(f"fused epoch faulted on the device: "
                                  f"{exc}") from exc
            self.perms = self._run.perms
            self._run = None
        return self._seq


def run_epoch_async(criterion, policy: str, *, X, D, C, FREE, phi, allowed,
                    wanted, true_demands,
                    per_agent_limit: Optional[int] = None,
                    lookahead: bool = False,
                    rng: Optional[np.random.Generator] = None,
                    eps: float = 1e-9, kernel="persistent",
                    shards: int = 1, devices: int = 1,
                    max_steps_cap: int = 16384,
                    preperms: Optional[np.ndarray] = None,
                    _perm_rows: Optional[int] = None,
                    device="cuda") -> EpochHandle:
    """Dispatch one allocation epoch on ``device`` WITHOUT blocking on the
    grant-sequence readback.

    The host prep is the reference's: pad to power-of-two shape buckets and
    pre-draw the RRR permutations from the shared numpy rng (all rng use
    happens here, at dispatch).  ``handle.result()`` blocks, drives chained
    dispatches (epochs whose :func:`grant_bound` exceeds ``max_steps_cap``)
    and RRR grow-and-replay rounds, and returns the grant sequence.
    ``kernel`` is ``"persistent"`` (default), ``"tiles"`` or ``None`` (see
    the module docstring); ``shards > 1`` partitions the plain loop's
    selects (rounded down to a power of two dividing the padded shapes; the
    persistent kernel owns the whole epoch and ignores it).  ``devices > 1``
    dispatches :func:`epoch_loop_mesh` instead, the agent axis split over
    that many devices of ``device``'s type (clamped to
    :func:`repro_torch.launch.mesh.device_count`, floored to a power of two
    and to the padded J; ``kernel``/``shards`` do not apply there: the
    mesh keeps plain partials, as the reference's does).  ``preperms``
    supplies the RRR permutation prefix already drawn from the stream (the
    epoch-cache layer); ``_perm_rows`` is a test hook that forces the
    grow-and-replay path."""
    crit = criteria.get_criterion(criterion)
    kind = crit.name
    if kind not in COVERED_CRITERIA or policy not in COVERED_POLICIES:
        raise ValueError(f"fused epoch does not cover {kind}/{policy}")
    if kernel not in KERNELS:
        raise ValueError(f"unknown epoch kernel {kernel!r}")
    dev = resolve_device(device)
    devices = max(1, min(int(devices), _mesh.device_count(dev)))
    devices = 1 << (devices.bit_length() - 1)    # floor to a power of two
    if devices > 1:
        shards = 1          # each mesh device IS one resident shard
        kernel = None       # the mesh keeps plain partials (the reference's)
    if kernel == "persistent":
        shards = 1          # one resident instance owns the whole epoch

    X = np.asarray(X, np.float64)
    D = np.asarray(D, np.float64)
    TD = np.asarray(true_demands, np.float64)
    C = np.asarray(C, np.float64)
    FREE = np.array(FREE, np.float64)
    phi = np.asarray(phi, np.float64)
    wanted = np.asarray(wanted, np.float64)
    allowed = np.asarray(allowed, bool)
    N, J = X.shape
    tot = X.sum(axis=1)

    bound = grant_bound(TD, FREE, tot, wanted, per_agent_limit)
    if bound == 0:
        return EpochHandle(seq=[])
    Np, Jp = _bucket(N), _bucket(J)
    limit = int(per_agent_limit if per_agent_limit is not None else 0)
    use_limit = per_agent_limit is not None
    shards = max(1, int(shards))
    shards = 1 << (shards.bit_length() - 1)      # floor to a power of two
    shards = min(shards, Np, Jp)                 # pow2s: divides both
    devices = min(devices, Jp)                   # pow2s: divides Jp

    Xp = _pad(_pad(X, Np, 0, 0.0), Jp, 1, 0.0)
    Dp = _pad(D, Np, 0, 0.0)
    TDp = _pad(TD, Np, 0, 0.0)
    Cp = _pad(C, Jp, 0, 0.0)
    FREEp = _pad(FREE, Jp, 0, 0.0)
    phip = _pad(phi, Np, 0, 1.0)
    wantedp = _pad(wanted, Np, 0, 0.0)       # padded frameworks want nothing
    allowedp = _pad(_pad(allowed, Np, 0, False), Jp, 1, False)
    usedp = np.zeros(Jp, np.int32)

    def _draw_perms(k: int) -> np.ndarray:
        """k permutation rows from the shared rng stream, padded to Jp."""
        rows = np.empty((k, Jp), np.int32)
        for i in range(k):
            rows[i, :J] = rng.permutation(J)
            rows[i, J:] = np.arange(J, Jp)
        return rows

    if policy == "rrr":
        if rng is None:
            raise ValueError("fused RRR epoch needs the allocator rng")
        # optimistic budget, grown by stream-append if the cursor runs past
        # it (see the reference's run_epoch_async for the reasoning)
        if preperms is not None:
            pp = np.asarray(preperms, np.int32)
            perms = np.empty((pp.shape[0], Jp), np.int32)
            perms[:, :J] = pp[:, :J]
            perms[:, J:] = np.arange(J, Jp)
        else:
            perms = _draw_perms(_perm_rows if _perm_rows is not None
                                else rrr_perm_budget(bound, J,
                                                     max_steps_cap))
    else:
        perms = np.arange(Jp, dtype=np.int32)[None, :]

    f32 = torch.float32
    # constant inputs upload once; the mutable state stays on the device
    # across chained segments (only the grant sequence is read back).
    # (torch.tensor copies: the frozen views are read-only numpy arrays)
    consts = tuple(torch.tensor(a, dtype=f32, device=dev)
                   for a in (Dp, TDp, Cp, phip, wantedp))
    consts += (torch.tensor(allowedp, device=dev),)
    run = _EpochRun(
        kind=kind, policy=policy, lookahead=lookahead, use_limit=use_limit,
        kernel=kernel, shards=shards, J=J, limit=limit, eps=eps,
        draw=_draw_perms, consts=consts, perms=perms, bound=bound,
        max_steps_cap=max_steps_cap, devices=devices)
    run.dispatch(torch.tensor(Xp, dtype=f32, device=dev),
                 torch.tensor(FREEp, dtype=f32, device=dev),
                 torch.tensor(usedp, device=dev))
    return EpochHandle(run=run)


def run_epoch(criterion, policy: str, **kw) -> list[tuple[int, int]]:
    """Run one allocation epoch; returns the grant sequence.

    Synchronous wrapper: ``run_epoch_async(...).result()``, so async and
    sync sequences are identical by construction."""
    return run_epoch_async(criterion, policy, **kw).result()
