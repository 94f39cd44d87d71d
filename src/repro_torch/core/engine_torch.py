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
the count and the grant sequence.  The plain and tiles loops are driven
from the host and finish inside the dispatch.

Not ported yet: the multi-device mesh epoch (``devices > 1`` raises after
clamping to the device count).  Buffer donation and the trace counter have
no counterpart: PyTorch has no jit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import criteria
from repro_torch.kernels import KernelError
from repro_torch.kernels.epoch_persistent.ops import persistent_epoch
from repro_torch.kernels.psdsf_score import ops as _tiles
from repro_torch.kernels.psdsf_score.ops import next_pow2

_BIG = 3.0e38
_IBIG = 2**31 - 1

#: incremented once per device dispatch (every segment and replay).
DISPATCH_COUNT = 0

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


def _dominant_col(D, cap_j, big):
    """(N,) dominant shares against one server's residual ``cap_j`` (R,):
    ``criteria.virtual_dominant``'s arithmetic with sentinel ``big``."""
    safe = torch.where(cap_j > 1e-12, cap_j, 1e-30)[None, :]
    frac = D / safe
    frac = torch.where((cap_j[None, :] <= 1e-12) & (D > 0.0), big, frac)
    return frac.amax(1)


def run_loop(X, tot, FREE, cap, dom, s, feas, used, D, TD, C, phi, wanted,
             allowed, perms, aux, pidx0, pos0, j_real, limit, eps, *,
             kind: str, policy: str, lookahead: bool, use_limit: bool,
             max_steps: int, argmin1d=_argmin_tie_low,
             argmin2d=_flat_tie_low, dom_big=criteria._BIG):
    """The plain epoch loop from an initialized state, updating ``X, tot,
    FREE, cap, dom, s, feas, used`` in place.  -> ``(ns, js, count, X, tot,
    FREE, used, pidx, pos)``.  With the default selects it is the
    persistent kernel's plain version (``dom_big=3.0e38`` there)."""
    N, J = X.shape
    dev = X.device
    i32 = torch.int32
    la = 1.0 if lookahead else 0.0
    server_specific = kind in ("psdsf", "rpsdsf")
    arangeJ = torch.arange(J, dtype=i32, device=dev)
    perms = perms.to(device=dev, dtype=torch.int64)
    K = perms.shape[0]
    pidx = torch.as_tensor(pidx0, dtype=i32, device=dev)
    pos = torch.as_tensor(pos0, dtype=i32, device=dev)
    ns = torch.full((max_steps,), -1, dtype=i32, device=dev)
    js = torch.full((max_steps,), -1, dtype=i32, device=dev)
    count = 0
    while count < max_steps and bool(feas.any()):
        # -- select -----------------------------------------------------
        if policy == "pooled":
            if server_specific:
                n, j = argmin2d(s, feas)
            else:
                n = argmin1d(s, feas.any(1))
                j = torch.where(feas[n], arangeJ, _IBIG).min()
        else:
            # rrr: the first feasible server at-or-after `pos` in the
            # round's permutation; wrap to a fresh permutation when the
            # rest of the round has nothing feasible.
            perm = perms[torch.clamp(pidx, max=K - 1)]
            rank = torch.zeros(J, dtype=i32, device=dev).scatter_(
                0, perm, arangeJ)
            server_ok = feas.any(0)
            ahead = server_ok & (rank >= pos)
            wrap = ~ahead.any()
            perm2 = perms[torch.clamp(pidx + 1, max=K - 1)]
            rank2 = torch.zeros(J, dtype=i32, device=dev).scatter_(
                0, perm2, arangeJ)
            eff_rank = torch.where(wrap, rank2, rank)
            eff_ok = torch.where(wrap, server_ok, ahead)
            j = torch.argmin(torch.where(eff_ok, eff_rank, _IBIG))
            col = s[:, j] if server_specific else s
            n = argmin1d(col, feas[:, j])
            krank = eff_rank[j]
            last = krank == j_real - 1
            pidx = pidx + wrap.to(i32) + last.to(i32)
            pos = torch.where(last, 0, krank + 1).to(i32)
        # -- grant --------------------------------------------------------
        X[n, j] += 1.0
        tot[n] += 1.0
        FREE[j] += -TD[n]
        used[j] += 1
        # feasibility: column j saw FREE change; row n may have hit `wanted`
        wants = tot < wanted
        colf = wants & allowed[:, j] & (TD <= FREE[j][None, :] + eps).all(1)
        if use_limit:
            colf = colf & (used[j] < limit)
        feas[:, j] = colf
        feas[n] = feas[n] & wants[n]
        # -- refresh: row n, and for rPS-DSF first residual column j -------
        xt_n = tot[n] + la
        if kind == "drf":
            s[n] = xt_n * aux[n] / phi[n]
        elif kind == "tsf":
            s[n] = xt_n / aux[n]
        else:
            if kind == "rpsdsf":
                cap_j = C[j] - X[:, j] @ D
                cap[j] = cap_j
                dom[:, j] = _dominant_col(D, cap_j, dom_big)
                s[:, j] = (tot + la) / phi * dom[:, j]
            s[n] = xt_n / phi[n] * dom[n]
        ns[count] = n
        js[count] = j
        count += 1
    return (ns, js, torch.tensor(count, dtype=i32, device=dev), X, tot, FREE,
            used, pidx, pos)


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
    if shards > 1:
        return run_loop(
            *args, **kw,
            argmin1d=lambda v, ok: _argmin_tie_low_sharded(v, ok, shards),
            argmin2d=lambda m, ok: _argmin2d_tie_low_sharded(m, ok, shards))
    if kernel == "tiles":
        # one output holder per select for the whole segment: each grant
        # consumes (n, j) on the same stream before the next select
        # overwrites them
        out1 = _tiles.ArgminOut(X.device, 1)
        out2 = _tiles.ArgminOut(X.device, 2)
        return run_loop(*args, **kw,
                        argmin1d=lambda v, ok: _tiles_1d(v, ok, out1),
                        argmin2d=lambda m, ok: _tiles_2d(m, ok, out2))
    return run_loop(*args, **kw)


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
                 J, limit, eps, draw, consts, perms, bound, max_steps_cap):
        self.kind, self.policy = kind, policy
        self.lookahead, self.use_limit = lookahead, use_limit
        self.kernel, self.shards = kernel, shards
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
        self.pending = epoch_loop(
            X_cur, dD, dTD, dC, FREE_cur, dphi, dwanted, dallowed,
            torch.as_tensor(self.perms, device=X_cur.device), used_cur,
            self.pidx, self.pos, self.J, self.limit, self.eps,
            kind=self.kind, policy=self.policy, lookahead=self.lookahead,
            use_limit=self.use_limit, kernel=self.kernel,
            max_steps=self.max_steps, shards=self.shards)

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
    persistent kernel owns the whole epoch and ignores it).  ``devices`` is
    clamped to the device count; more than one raises (the mesh epoch is
    not ported).  ``preperms`` supplies the RRR permutation prefix already
    drawn from the stream (the epoch-cache layer); ``_perm_rows`` is a test
    hook that forces the grow-and-replay path."""
    crit = criteria.get_criterion(criterion)
    kind = crit.name
    if kind not in COVERED_CRITERIA or policy not in COVERED_POLICIES:
        raise ValueError(f"fused epoch does not cover {kind}/{policy}")
    if kernel not in KERNELS:
        raise ValueError(f"unknown epoch kernel {kernel!r}")
    dev = resolve_device(device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    devices = max(1, min(int(devices), n_dev))
    devices = 1 << (devices.bit_length() - 1)    # floor to a power of two
    if devices > 1:
        raise NotImplementedError("the multi-device epoch (the reference's "
                                  "epoch_loop_mesh) is not ported yet")
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
        max_steps_cap=max_steps_cap)
    run.dispatch(torch.tensor(Xp, dtype=f32, device=dev),
                 torch.tensor(FREEp, dtype=f32, device=dev),
                 torch.tensor(usedp, device=dev))
    return EpochHandle(run=run)


def run_epoch(criterion, policy: str, **kw) -> list[tuple[int, int]]:
    """Run one allocation epoch; returns the grant sequence.

    Synchronous wrapper: ``run_epoch_async(...).result()``, so async and
    sync sequences are identical by construction."""
    return run_epoch_async(criterion, policy, **kw).result()
