"""Incremental struct-of-arrays cluster state for the online allocator.

The pre-refactor allocator rebuilt dense ``X/D/C/FREE`` matrices from Python
dicts-of-lists on *every grant* — O(N*J) Python work per grant, quadratic per
epoch.  ``ClusterState`` keeps those arrays resident and updates them
incrementally on register/deregister/grant/release/agent-churn, in the spirit
of Mesos's own sorter (incremental per-client shares):

  X    (N, J)  executors of framework-slot n on agent-slot j
  Xr   (N, J)  the REVOCABLE subset of X (grants made past the framework's
               phi-weighted fair share; Xr <= X elementwise) — the
               preemption pass's victim ledger
  D    (N, R)  scoring demands (declared, or inferred in oblivious mode)
  C    (J, R)  agent capacities
  FREE (J, R)  agent free resources
  phi  (N,)    framework weights
  allowed (N, J) placement constraints
  wanted  (N,) executor targets (feasibility gate)

Frameworks and agents get *stable slots*: arrays grow geometrically and
slots are recycled on removal, so live rows/columns never move.  Engines
that want name-sorted matrices (the allocator's historical tie-break order)
use :meth:`sorted_view`; the gather order is cached and only recomputed on
membership changes.

Double-buffered epochs: :meth:`epoch_view` returns a *frozen* (read-only)
name-sorted snapshot — the upload view an asynchronous allocation epoch
works from while the live arrays keep serving the DES.  ``mutation_count``
ticks on EVERY state change (membership and O(R) updates alike), so
``OnlineAllocator.commit_epoch`` can prove the snapshot is still current
before applying an in-flight grant sequence.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class StateView(NamedTuple):
    """Name-sorted dense view of the active cluster (gathered copies)."""

    fids: tuple          # sorted framework ids
    agents: tuple        # sorted agent names
    X: np.ndarray        # (N, J)
    D: np.ndarray        # (N, R)
    C: np.ndarray        # (J, R)
    FREE: np.ndarray     # (J, R)
    phi: np.ndarray      # (N,)
    allowed: np.ndarray  # (N, J) bool
    wanted: np.ndarray   # (N,)
    Xr: np.ndarray = None  # (N, J) revocable subset of X (see module doc)


class ClusterState:
    """Struct-of-arrays cluster state with stable fid/agent slots."""

    def __init__(self, n_resources: int, fw_capacity: int = 8,
                 agent_capacity: int = 8):
        self.R = n_resources
        self._nf = fw_capacity
        self._na = agent_capacity
        self.X = np.zeros((fw_capacity, agent_capacity))
        self.Xr = np.zeros((fw_capacity, agent_capacity))
        self.D = np.zeros((fw_capacity, n_resources))
        self.C = np.zeros((agent_capacity, n_resources))
        self.FREE = np.zeros((agent_capacity, n_resources))
        self.phi = np.ones(fw_capacity)
        self.allowed = np.ones((fw_capacity, agent_capacity), bool)
        self.wanted = np.zeros(fw_capacity)
        self.fw_active = np.zeros(fw_capacity, bool)
        self.agent_active = np.zeros(agent_capacity, bool)
        # insertion-ordered name -> slot maps (python dicts preserve order,
        # matching the pre-refactor dict-of-arrays semantics)
        self.fid2slot: dict[str, int] = {}
        self.agent2slot: dict[str, int] = {}
        self._free_fw_slots: list[int] = []
        self._free_agent_slots: list[int] = []
        self._fw_allowed_names: dict[int, Optional[frozenset]] = {}
        self._version = 0          # bumped on membership change
        self._view_cache = None    # (version, f_slots, a_slots, fids, agents)
        self._epoch_view_cache = None   # (mutation_count, frozen StateView)
        #: ticks on every mutation (membership AND grant/release/set_*) —
        #: the in-flight-epoch staleness guard (see module docstring).
        self.mutation_count = 0

    # -- capacity growth -----------------------------------------------------

    def _grow_frameworks(self):
        new = self._nf * 2
        self.X = np.vstack([self.X, np.zeros((self._nf, self._na))])
        self.Xr = np.vstack([self.Xr, np.zeros((self._nf, self._na))])
        self.D = np.vstack([self.D, np.zeros((self._nf, self.R))])
        self.phi = np.concatenate([self.phi, np.ones(self._nf)])
        self.wanted = np.concatenate([self.wanted, np.zeros(self._nf)])
        self.allowed = np.vstack([self.allowed, np.ones((self._nf, self._na), bool)])
        self.fw_active = np.concatenate([self.fw_active, np.zeros(self._nf, bool)])
        self._nf = new

    def _grow_agents(self):
        new = self._na * 2
        self.X = np.hstack([self.X, np.zeros((self._nf, self._na))])
        self.Xr = np.hstack([self.Xr, np.zeros((self._nf, self._na))])
        self.C = np.vstack([self.C, np.zeros((self._na, self.R))])
        self.FREE = np.vstack([self.FREE, np.zeros((self._na, self.R))])
        self.allowed = np.hstack([self.allowed, np.ones((self._nf, self._na), bool)])
        self.agent_active = np.concatenate([self.agent_active, np.zeros(self._na, bool)])
        self._na = new

    # -- membership ----------------------------------------------------------

    @property
    def n_frameworks(self) -> int:
        return len(self.fid2slot)

    @property
    def n_agents(self) -> int:
        return len(self.agent2slot)

    def add_agent(self, name: str, capacity) -> int:
        if name in self.agent2slot:
            raise ValueError(f"agent {name!r} already registered")
        cap = np.asarray(capacity, np.float64)
        if self._free_agent_slots:
            j = self._free_agent_slots.pop()
        else:
            if len(self.agent2slot) == self._na:
                self._grow_agents()
            j = len(self.agent2slot)
            while self.agent_active[j]:  # pragma: no cover (defensive)
                j += 1
        self.agent2slot[name] = j
        self.agent_active[j] = True
        self.C[j] = cap
        self.FREE[j] = cap
        self.X[:, j] = 0.0
        self.Xr[:, j] = 0.0
        # placement constraints are name-based: refresh the new column
        for slot, names in self._fw_allowed_names.items():
            self.allowed[slot, j] = names is None or name in names
        self._version += 1
        self.mutation_count += 1
        return j

    def remove_agent(self, name: str) -> int:
        j = self.agent2slot.pop(name)
        self.agent_active[j] = False
        self.C[j] = 0.0
        self.FREE[j] = 0.0
        self.X[:, j] = 0.0
        self.Xr[:, j] = 0.0
        self.allowed[:, j] = True
        self._free_agent_slots.append(j)
        self._version += 1
        self.mutation_count += 1
        return j

    def add_framework(self, fid: str, demand=None, phi: float = 1.0,
                      allowed_agents=None, wanted: float = 0.0) -> int:
        if fid in self.fid2slot:
            raise ValueError(f"framework {fid!r} already registered")
        if self._free_fw_slots:
            n = self._free_fw_slots.pop()
        else:
            if len(self.fid2slot) == self._nf:
                self._grow_frameworks()
            n = len(self.fid2slot)
            while self.fw_active[n]:  # pragma: no cover (defensive)
                n += 1
        self.fid2slot[fid] = n
        self.fw_active[n] = True
        self.D[n] = 0.0 if demand is None else np.asarray(demand, np.float64)
        self.phi[n] = float(phi)
        self.wanted[n] = float(wanted)
        self.X[n, :] = 0.0
        self.Xr[n, :] = 0.0
        names = None if allowed_agents is None else frozenset(allowed_agents)
        self._fw_allowed_names[n] = names
        if names is None:
            self.allowed[n, :] = True
        else:
            self.allowed[n, :] = False
            for a, j in self.agent2slot.items():
                self.allowed[n, j] = a in names
        self._version += 1
        self.mutation_count += 1
        return n

    def remove_framework(self, fid: str) -> int:
        n = self.fid2slot.pop(fid)
        self.fw_active[n] = False
        self.D[n] = 0.0
        self.phi[n] = 1.0
        self.wanted[n] = 0.0
        self.X[n, :] = 0.0
        self.Xr[n, :] = 0.0
        self.allowed[n, :] = True
        self._fw_allowed_names.pop(n, None)
        self._free_fw_slots.append(n)
        self._version += 1
        self.mutation_count += 1
        return n

    # -- incremental updates (O(R) each) --------------------------------------

    def grant(self, fid: str, agent: str, bundle, n_units: int = 1,
              revocable_units: int = 0) -> None:
        n, j = self.fid2slot[fid], self.agent2slot[agent]
        self.X[n, j] += n_units
        self.Xr[n, j] += revocable_units
        self.FREE[j] -= bundle
        self.mutation_count += 1

    def release(self, fid: str, agent: str, bundle, n_units: int = 1,
                revocable_units: int = 0) -> None:
        n, j = self.fid2slot[fid], self.agent2slot[agent]
        self.X[n, j] -= n_units
        self.Xr[n, j] -= revocable_units
        self.FREE[j] += bundle
        self.mutation_count += 1

    def revoke(self, fid: str, agent: str, bundle, n_units: int = 1) -> None:
        """Revoke ``n_units`` REVOCABLE executors of fid on agent: the freed
        bundle re-enters FREE incrementally (O(R)), both the total and the
        revocable allocation columns shrink, and ``mutation_count`` ticks —
        a revocation invalidates an in-flight epoch exactly like any other
        mutation (the online allocator refuses it outright while an epoch
        is in flight; see ``OnlineAllocator.revoke_executor``)."""
        n, j = self.fid2slot[fid], self.agent2slot[agent]
        if self.Xr[n, j] < n_units:
            raise ValueError(
                f"{fid!r} holds only {self.Xr[n, j]:.0f} revocable "
                f"executors on {agent!r}, cannot revoke {n_units}")
        self.X[n, j] -= n_units
        self.Xr[n, j] -= n_units
        self.FREE[j] += bundle
        self.mutation_count += 1

    # the set_* updates skip the mutation tick when the value is unchanged:
    # the simulator re-asserts wanted/demand every cycle, and a no-op tick
    # would needlessly invalidate the memoized epoch_view (and trip the
    # in-flight staleness guard) for a state that did not change.

    def set_demand(self, fid: str, demand) -> None:
        n = self.fid2slot[fid]
        d = 0.0 if demand is None else demand
        if np.all(self.D[n] == d):
            return
        self.D[n] = d
        self.mutation_count += 1

    def set_weight(self, fid: str, phi: float) -> None:
        n = self.fid2slot[fid]
        if self.phi[n] == float(phi):
            return
        self.phi[n] = float(phi)
        self.mutation_count += 1

    def set_wanted(self, fid: str, wanted: float) -> None:
        n = self.fid2slot[fid]
        if self.wanted[n] == float(wanted):
            return
        self.wanted[n] = float(wanted)
        self.mutation_count += 1

    # -- durability (repro.core.journal) --------------------------------------

    def to_payload(self) -> dict:
        """Bit-exact serialization for checkpoints (journal.py snapshots).

        Raw array copies, NOT a re-derivable summary: restoring must not
        re-run any float accumulation (grant/release order changes the
        rounding), so every ledger array ships verbatim, along with the
        slot maps, free-slot recycling stacks and version counters that
        make future slot assignment deterministic."""
        return {
            "R": self.R, "nf": self._nf, "na": self._na,
            "X": self.X.copy(), "Xr": self.Xr.copy(), "D": self.D.copy(),
            "C": self.C.copy(), "FREE": self.FREE.copy(),
            "phi": self.phi.copy(), "allowed": self.allowed.copy(),
            "wanted": self.wanted.copy(), "fw_active": self.fw_active.copy(),
            "agent_active": self.agent_active.copy(),
            "fid2slot": dict(self.fid2slot),
            "agent2slot": dict(self.agent2slot),
            "free_fw_slots": list(self._free_fw_slots),
            "free_agent_slots": list(self._free_agent_slots),
            "fw_allowed_names": {
                n: (None if v is None else sorted(v))
                for n, v in self._fw_allowed_names.items()},
            "version": self._version,
            "mutation_count": self.mutation_count,
        }

    @classmethod
    def from_payload(cls, p: dict) -> "ClusterState":
        """Rebuild a :meth:`to_payload` checkpoint (array-identical)."""
        st = cls(p["R"], fw_capacity=p["nf"], agent_capacity=p["na"])
        for name in ("X", "Xr", "D", "C", "FREE", "phi", "allowed",
                     "wanted", "fw_active", "agent_active"):
            setattr(st, name, np.array(p[name]))
        st.fid2slot = dict(p["fid2slot"])
        st.agent2slot = dict(p["agent2slot"])
        st._free_fw_slots = list(p["free_fw_slots"])
        st._free_agent_slots = list(p["free_agent_slots"])
        st._fw_allowed_names = {
            n: (None if v is None else frozenset(v))
            for n, v in p["fw_allowed_names"].items()}
        st._version = int(p["version"])
        st.mutation_count = int(p["mutation_count"])
        return st

    # -- views ----------------------------------------------------------------

    def _orders(self):
        cache = self._view_cache
        if cache is None or cache[0] != self._version:
            fids = tuple(sorted(self.fid2slot))
            agents = tuple(sorted(self.agent2slot))
            f_slots = np.fromiter((self.fid2slot[f] for f in fids), np.intp,
                                  len(fids))
            a_slots = np.fromiter((self.agent2slot[a] for a in agents), np.intp,
                                  len(agents))
            cache = (self._version, f_slots, a_slots, fids, agents)
            self._view_cache = cache
        return cache[1], cache[2], cache[3], cache[4]

    def sorted_view(self) -> StateView:
        """Dense name-sorted matrices of the active cluster.

        Gathered copies (fancy indexing, no Python loops); the sort order is
        cached between membership changes."""
        f_slots, a_slots, fids, agents = self._orders()
        return StateView(
            fids=fids,
            agents=agents,
            X=self.X[np.ix_(f_slots, a_slots)],
            D=self.D[f_slots],
            C=self.C[a_slots],
            FREE=self.FREE[a_slots],
            phi=self.phi[f_slots],
            allowed=self.allowed[np.ix_(f_slots, a_slots)],
            wanted=self.wanted[f_slots],
            Xr=self.Xr[np.ix_(f_slots, a_slots)],
        )

    def epoch_view(self) -> StateView:
        """Frozen :meth:`sorted_view` — the double-buffer an in-flight
        allocation epoch reads from.  The arrays are the same gathered
        copies sorted_view hands out, additionally marked read-only so a
        concurrent writer trips immediately instead of corrupting an epoch
        that already uploaded them.

        Memoized on ``mutation_count``: back-to-back epochs with no
        intervening mutation get the SAME frozen snapshot back instead of
        re-gathering (and re-uploading) an identical one — safe precisely
        because the arrays are immutable."""
        cache = self._epoch_view_cache
        if cache is not None and cache[0] == self.mutation_count:
            return cache[1]
        view = self.sorted_view()
        for arr in (view.X, view.D, view.C, view.FREE, view.phi,
                    view.allowed, view.wanted, view.Xr):
            arr.setflags(write=False)
        self._epoch_view_cache = (self.mutation_count, view)
        return view
