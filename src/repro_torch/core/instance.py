"""Problem instances for multi-resource fair allocation.

An *instance* is: N frameworks with per-task demand vectors ``D[n, r]``,
J servers with capacity vectors ``C[j, r]``, and framework weights ``phi[n]``
(all-ones = equal priority, the only case the paper studies).

The paper's illustrative example (its Eqs. (1)-(2)) is provided as
:func:`paper_example`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Instance:
    """A fair-allocation problem instance.

    Attributes:
      demands:    (N, R) per-task demand of framework n for resource r.
      capacities: (J, R) capacity of server j for resource r.
      weights:    (N,)  framework priorities phi_n (default all ones).
      allowed:    (N, J) placement constraints — framework n may only run on
                  servers with allowed[n, j] (the setting of the paper's TSF
                  reference, Wang+ SC'16; default: unconstrained).
    """

    demands: np.ndarray
    capacities: np.ndarray
    weights: np.ndarray
    allowed: np.ndarray = None

    def __post_init__(self):
        d = np.asarray(self.demands, dtype=np.float64)
        c = np.asarray(self.capacities, dtype=np.float64)
        w = np.asarray(self.weights, dtype=np.float64)
        a = (np.ones((d.shape[0], c.shape[0]), bool) if self.allowed is None
             else np.asarray(self.allowed, bool))
        if d.ndim != 2 or c.ndim != 2 or d.shape[1] != c.shape[1]:
            raise ValueError(f"shape mismatch: demands {d.shape} capacities {c.shape}")
        if w.shape != (d.shape[0],):
            raise ValueError(f"weights shape {w.shape} != ({d.shape[0]},)")
        if a.shape != (d.shape[0], c.shape[0]):
            raise ValueError(f"allowed shape {a.shape}")
        if (d <= 0).all(axis=1).any():
            raise ValueError("each framework must demand at least one resource")
        object.__setattr__(self, "demands", d)
        object.__setattr__(self, "capacities", c)
        object.__setattr__(self, "weights", w)
        object.__setattr__(self, "allowed", a)

    @property
    def n_frameworks(self) -> int:
        return self.demands.shape[0]

    @property
    def n_servers(self) -> int:
        return self.capacities.shape[0]

    @property
    def n_resources(self) -> int:
        return self.demands.shape[1]

    def residual(self, x: np.ndarray) -> np.ndarray:
        """Residual capacities (J, R) under integer allocation x (N, J)."""
        used = np.einsum("nj,nr->jr", np.asarray(x, dtype=np.float64), self.demands)
        return self.capacities - used

    def feasible(self, x: np.ndarray, eps: float = 1e-9) -> np.ndarray:
        """(N, J) bool: can one more task of framework n fit on server j?"""
        res = self.residual(x)  # (J, R)
        fits = (self.demands[:, None, :] <= res[None, :, :] + eps).all(axis=-1)
        return fits & self.allowed


def make_instance(
    demands: Sequence[Sequence[float]],
    capacities: Sequence[Sequence[float]],
    weights: Sequence[float] | None = None,
    allowed: Sequence[Sequence[bool]] | None = None,
) -> Instance:
    d = np.asarray(demands, dtype=np.float64)
    c = np.asarray(capacities, dtype=np.float64)
    w = np.ones(d.shape[0]) if weights is None else np.asarray(weights, np.float64)
    return Instance(d, c, w, allowed)


def paper_example() -> Instance:
    """The illustrative example of Section 2: Eqs. (1) and (2).

    Two frameworks, two servers, two resources:
      d1 = (5, 1), d2 = (1, 5);  c1 = (100, 30), c2 = (30, 100).
    """
    return make_instance(
        demands=[[5.0, 1.0], [1.0, 5.0]],
        capacities=[[100.0, 30.0], [30.0, 100.0]],
    )


def spark_cluster_heterogeneous() -> Instance:
    """The paper's Section 3.3 experiment cluster (heterogeneous).

    Frameworks: Pi executors need (2 CPU, 2 GB); WordCount (1 CPU, 3.5 GB).
    Servers (Mesos agents): two each of
      type-1: (4 CPU, 14 GB), type-2: (8 CPU, 8 GB), type-3: (6 CPU, 11 GB).
    """
    return make_instance(
        demands=[[2.0, 2.0], [1.0, 3.5]],
        capacities=[[4.0, 14.0]] * 2 + [[8.0, 8.0]] * 2 + [[6.0, 11.0]] * 2,
    )


def spark_cluster_homogeneous() -> Instance:
    """Section 3.6: six type-3 servers (6 CPU, 11 GB)."""
    return make_instance(
        demands=[[2.0, 2.0], [1.0, 3.5]],
        capacities=[[6.0, 11.0]] * 6,
    )


def spark_cluster_fig9() -> Instance:
    """Section 3.7: one server of each type, registered one-by-one."""
    return make_instance(
        demands=[[2.0, 2.0], [1.0, 3.5]],
        capacities=[[4.0, 14.0], [8.0, 8.0], [6.0, 11.0]],
    )
