"""Single source of truth for fair-allocation criterion scores.

DRF(H), TSF, PS-DSF, rPS-DSF and the best-fit server metrics are implemented
here ONCE, as array code parameterized by namespace (``xp=numpy`` or
``xp=jax.numpy``), and wrapped in pluggable :class:`Criterion` strategy
objects.  Every engine dispatches into this module:

  * the exact numpy reference filler (:mod:`repro_torch.core.filling`),
  * the online Mesos-style allocator (:mod:`repro_torch.core.online`) and
    its batched epoch engine (:mod:`repro_torch.core.engine`),
  * the PyTorch fleet filler (:mod:`repro_torch.core.filling_torch`).

All criteria are expressed as *scores to be minimized* by progressive
filling: the framework (or framework x server pair) with the smallest score
receives the next task.

Notation (matching the paper):
  X   (N, J)  current integer allocation x_{n,j};  x_n = sum_j X[n, j]
  D   (N, R)  per-task demands d_{n,r}
  C   (J, R)  server capacities c_{j,r}
  phi (N,)    framework weights (priorities)

Criteria:
  * DRF / DRFH  [Ghodsi+ NSDI'11; Wang+ TPDS'15]:
      s_n = x_n * max_r d_{n,r} / (phi_n * sum_j c_{j,r})
    (global dominant share over pooled cluster capacity — server-oblivious).
  * TSF  [Wang+ SC'16]:
      s_n = x_n / (phi_n * M_n),  M_n = sum_j min_r c_{j,r} / d_{n,r}
    (task share relative to the framework's fluid monopoly allocation).
  * PS-DSF  [Khamse-Ashari+ ICC'17] — per-server virtual dominant share:
      K_{n,j} = x_n * max_r d_{n,r} / (phi_n * c_{j,r})
  * rPS-DSF (this paper's novel criterion) — PS-DSF against *residual*
    capacities under the current allocation:
      K~_{n,j} = x_n * max_r d_{n,r} / (phi_n * (c_{j,r} - sum_n' x_{n',j} d_{n',r}))

``lookahead=True`` scores the hypothetical allocation after granting one more
task (x_n + 1); this is how a progressive filler breaks the all-zeros start and
is one of the calibration knobs for reproducing the paper's exact tables.

The building blocks (:func:`drf_dominant`, :func:`tsf_monopoly`,
:func:`virtual_dominant`) are exposed separately so incremental engines can
cache the X-independent part per epoch and recompute only the touched
row/column per grant — same formulas, same rounding, no duplication.
"""
from __future__ import annotations

import numpy as _np

_BIG = 1e18


# Reductions over one axis use ``xp.amax``/``xp.amin``: ``torch.max(a, axis)``
# returns a (values, indices) pair, ``amax`` the values on every namespace.
def _is_torch(xp) -> bool:
    return getattr(xp, "__name__", "") == "torch"


def _maximum(a, floor, xp):
    """Elementwise max against a scalar floor (``torch.maximum`` takes
    tensors only; ``clamp_min`` is its scalar form, same f32 result)."""
    return xp.clamp_min(a, floor) if _is_torch(xp) else xp.maximum(a, floor)


def _totals(X, xp):
    return xp.sum(X, axis=1)  # (N,)


# ---------------------------------------------------------------------------
# X-independent building blocks (cacheable per epoch)
# ---------------------------------------------------------------------------

def drf_dominant(D, C, *, xp=_np):
    """(N,) global dominant demand fraction max_r d_{n,r} / sum_j c_{j,r}."""
    ctot = xp.sum(C, axis=0)  # (R,)
    return xp.amax(D / _maximum(ctot[None, :], 1e-30, xp), 1)


def tsf_monopoly(D, C, *, allowed=None, xp=_np):
    """(N,) fluid monopoly allocation M_n = sum_{j allowed} min_r c_{j,r}/d_{n,r}.

    With placement constraints (allowed (N, J)), the monopoly allocation only
    counts each framework's ALLOWED servers — this normalization is the core
    of TSF's sharing-incentive guarantee under constraints (Wang+ SC'16)."""
    ratio = C[None, :, :] / _maximum(D[:, None, :], 1e-30, xp)  # (N, J, R)
    per_server = xp.amin(ratio, 2)                            # (N, J)
    if allowed is not None:
        per_server = xp.where(allowed, per_server, 0.0)
    return xp.sum(per_server, axis=1)  # (N,)


def virtual_dominant(D, cap, *, xp=_np):
    """(N, J') per-server dominant demand fraction max_r d_{n,r} / cap_{j,r}.

    Non-positive capacities make a server unusable for any framework
    demanding a resource there: the entry becomes ~inf (feasibility masks
    catch this anyway).  Works on any column slice of the capacity matrix, so
    incremental engines can refresh a single touched server."""
    safe = xp.where(cap > 1e-12, cap, 1e-30)[None, :, :]  # (1, J', R)
    frac = D[:, None, :] / safe  # (N, J', R)
    frac = xp.where((cap[None, :, :] <= 1e-12) & (D[:, None, :] > 0), _BIG, frac)
    return xp.amax(frac, 2)  # (N, J')


def residual_capacities(X, D, C, *, xp=_np):
    """(J, R) residual capacities c_{j,r} - sum_n x_{n,j} d_{n,r}."""
    used = xp.einsum("nj,nr->jr", X * 1.0, D)
    return C - used


def feasible_mask(TD, FREE, allowed, wants, *, eps=1e-9, xp=_np):
    """(N, J) one-more-task feasibility from true demands.

    wants (N,) bool; allowed (N, J) bool; fits = every resource of the
    demand bundle fits in the server's free vector (eps absorbs rounding).
    Shared by the numpy batched epoch and the device-resident JAX epoch so
    both layers apply the identical formula."""
    fits = xp.all(TD[:, None, :] <= FREE[None, :, :] + eps, axis=-1)
    return wants[:, None] & allowed & fits


# ---------------------------------------------------------------------------
# Criterion score functions
# ---------------------------------------------------------------------------

def drf_scores(X, D, C, phi, *, lookahead: bool = True, xp=_np):
    """(N,) global dominant shares (to minimize)."""
    x = _totals(X, xp) + (1.0 if lookahead else 0.0)
    return x * drf_dominant(D, C, xp=xp) / phi


def tsf_scores(X, D, C, phi, *, lookahead: bool = True, xp=_np, allowed=None):
    """(N,) task shares relative to fluid monopoly allocation (to minimize)."""
    x = _totals(X, xp) + (1.0 if lookahead else 0.0)
    monopoly = tsf_monopoly(D, C, allowed=allowed, xp=xp)
    return x / (phi * _maximum(monopoly, 1e-30, xp))


def psdsf_scores(X, D, C, phi, *, residual: bool = False, lookahead: bool = True, xp=_np):
    """(N, J) per-server virtual dominant shares K_{n,j} (to minimize).

    residual=True gives rPS-DSF (the paper's Eq. for K~): capacities are the
    *current residual* c_{j,r} - sum_n x_{n,j} d_{n,r}.
    """
    x = _totals(X, xp) + (1.0 if lookahead else 0.0)  # (N,)
    cap = residual_capacities(X, D, C, xp=xp) if residual else C
    return (x / phi)[:, None] * virtual_dominant(D, cap, xp=xp)


def usage_dominant_share(usage, C, phi, *, xp=_np):
    """(N,) dominant share of *aggregate usage* over pooled capacity.

    The oblivious-mode (coarse-grained) DRF/TSF surrogate: the allocator is
    not told per-task demands, so it scores frameworks on what they hold."""
    ctot = _maximum(xp.sum(C, axis=0), 1e-30, xp)
    return xp.amax(usage / ctot, 1) / phi


def fair_share_level(phi, *, xp=_np):
    """Scalar phi-weighted fair level 1 / sum_m phi_m.

    Weighted DRF equalizes the weighted dominant shares s_n =
    (max_r u_{n,r} / sum_j c_{j,r}) / phi_n; when the dominant resource is
    fully and fairly divided, every framework sits at s_n = 1 / sum_m phi_m
    (equivalently, framework n is entitled to the phi_n / sum_m phi_m slice
    of its dominant resource).  This is the reference level the revocable /
    firm grant classification and the preemption pass compare against
    (:mod:`repro.core.preemption`): a framework is OVER share when its
    weighted dominant share exceeds ``threshold * fair_share_level(phi)``
    and UNDER when it sits below ``fair_share_level(phi)``."""
    return 1.0 / _maximum(xp.sum(phi), 1e-30, xp)


# ---------------------------------------------------------------------------
# Best-fit server metrics (used by BF-DRF: framework chosen by DRF, then the
# server "whose residual capacity most closely matches the demand vector").
# All metrics are scores to MINIMIZE over feasible servers.
# ---------------------------------------------------------------------------

def bestfit_scores(res, d, *, metric: str = "cosine", xp=_np):
    """(J,) best-fit score of placing one task with demand d on residual res.

    res: (J, R) residual capacities;  d: (R,) demand vector.

    metrics:
      cosine : 1 - cos(res_j, d)            — directional match (alignment).
      align  : -<res_j/|res_j|_1, d/|d|_1>  — L1-normalized alignment.
      tasks  : -min_r res_{j,r}/d_r         — prefer the server that can host
                                              the MOST further tasks of n
                                              (worst-fit by count; greedy-pack).
      tight  : +min_r res_{j,r}/d_r         — classical best-fit (tightest).
      slack  : max_r (res_{j,r} - d_r)/max(res_{j,r},eps): leftover dominance.
    """
    res = xp.asarray(res, dtype=xp.float64) if xp is _np else res
    eps = 1e-30
    if metric == "cosine":
        num = xp.sum(res * d[None, :], axis=1)
        den = xp.sqrt(xp.sum(res * res, axis=1) * xp.sum(d * d)) + eps
        return 1.0 - num / den
    if metric == "align":
        rn = res / (xp.sum(xp.abs(res), axis=1, keepdims=True) + eps)
        dn = d / (xp.sum(xp.abs(d)) + eps)
        return -xp.sum(rn * dn[None, :], axis=1)
    if metric == "tasks":
        return -xp.amin(res / _maximum(d[None, :], eps, xp), 1)
    if metric == "tight":
        return xp.amin(res / _maximum(d[None, :], eps, xp), 1)
    if metric == "slack":
        return xp.amax((res - d[None, :]) / _maximum(res, eps, xp), 1)
    raise ValueError(f"unknown best-fit metric {metric!r}")


# ---------------------------------------------------------------------------
# Pluggable Criterion strategy objects
# ---------------------------------------------------------------------------

class Criterion:
    """A fairness criterion: scores to minimize, written against ``xp``.

    ``scores`` returns (N,) for global criteria and (N, J) for
    server-specific ones; ``matrix_scores`` always returns (N, J)."""

    name: str = "?"
    server_specific: bool = False

    def scores(self, X, D, C, phi, *, lookahead=True, xp=_np, allowed=None):
        raise NotImplementedError

    def matrix_scores(self, X, D, C, phi, *, lookahead=True, xp=_np, allowed=None):
        s = self.scores(X, D, C, phi, lookahead=lookahead, xp=xp, allowed=allowed)
        if self.server_specific:
            return s
        return xp.broadcast_to(s[:, None], (D.shape[0], C.shape[0]))

    def __repr__(self):
        return f"<Criterion {self.name}>"


class DRF(Criterion):
    name = "drf"

    def scores(self, X, D, C, phi, *, lookahead=True, xp=_np, allowed=None):
        return drf_scores(X, D, C, phi, lookahead=lookahead, xp=xp)


class TSF(Criterion):
    name = "tsf"

    def scores(self, X, D, C, phi, *, lookahead=True, xp=_np, allowed=None):
        return tsf_scores(X, D, C, phi, lookahead=lookahead, xp=xp, allowed=allowed)


class PSDSF(Criterion):
    server_specific = True

    def __init__(self, residual: bool = False):
        self.residual = residual
        self.name = "rpsdsf" if residual else "psdsf"

    def scores(self, X, D, C, phi, *, lookahead=True, xp=_np, allowed=None):
        return psdsf_scores(X, D, C, phi, residual=self.residual,
                            lookahead=lookahead, xp=xp)


CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")
_REGISTRY: dict[str, Criterion] = {
    "drf": DRF(), "tsf": TSF(), "psdsf": PSDSF(False), "rpsdsf": PSDSF(True),
}


def get_criterion(criterion) -> Criterion:
    """Resolve a name or pass through a Criterion instance."""
    if isinstance(criterion, Criterion):
        return criterion
    try:
        return _REGISTRY[criterion]
    except KeyError:
        raise ValueError(f"unknown criterion {criterion!r}") from None


def criterion_scores(name, X, D, C, phi, *, lookahead=True, xp=_np, allowed=None):
    """Uniform entry point.  Returns (N,) for global criteria, (N, J) for
    server-specific ones."""
    return get_criterion(name).scores(
        X, D, C, phi, lookahead=lookahead, xp=xp, allowed=allowed
    )


def is_server_specific(name) -> bool:
    return get_criterion(name).server_specific
