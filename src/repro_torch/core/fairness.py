"""Compatibility shim — the criterion formulas live in
:mod:`repro_torch.core.criteria` (the single shared scoring module used by the
numpy reference filler, the online allocator, and the JAX fleet engine).

Import from here only for backwards compatibility; new code should use
``repro_torch.core.criteria`` directly (including the pluggable ``Criterion``
strategy objects and ``get_criterion``).
"""
from __future__ import annotations

from repro_torch.core.criteria import (  # noqa: F401
    CRITERIA,
    Criterion,
    bestfit_scores,
    criterion_scores,
    drf_dominant,
    drf_scores,
    get_criterion,
    is_server_specific,
    psdsf_scores,
    residual_capacities,
    tsf_monopoly,
    tsf_scores,
    usage_dominant_share,
    virtual_dominant,
)

__all__ = [
    "CRITERIA",
    "Criterion",
    "bestfit_scores",
    "criterion_scores",
    "drf_dominant",
    "drf_scores",
    "get_criterion",
    "is_server_specific",
    "psdsf_scores",
    "residual_capacities",
    "tsf_monopoly",
    "tsf_scores",
    "usage_dominant_share",
    "virtual_dominant",
]
