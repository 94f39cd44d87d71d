"""Plain PyTorch version of the persistent epoch kernel (K3).

The engine's plain loop is this kernel's specification, as the reference
pins its persistent kernel equal to the default loop: this function runs
that loop from the kernel's inputs, updating the same eight state arrays in
place.  The one difference is the kernel's own sentinel, 3.0e38, for an
exhausted residual in the rPS-DSF column refresh (the loop uses
``criteria._BIG``); such entries are infeasible either way, so grant
sequences agree and the state arrays match the kernel's.
"""
from __future__ import annotations

BIG = 3.0e38


def persistent_epoch_ref(X, tot, FREE, cap, dom, s, feas, used, D, TD, C,
                         phi, wanted, allowed, perms, aux, pidx0, pos0,
                         j_real, limit, eps, *, kind: str, policy: str,
                         lookahead: bool, use_limit: bool, max_steps: int):
    from repro_torch.core import engine_torch

    return engine_torch.run_loop(
        X, tot, FREE, cap, dom, s, feas.bool(), used, D, TD, C, phi, wanted,
        allowed.bool(), perms, aux, pidx0, pos0, j_real, limit, eps,
        kind=kind, policy=policy, lookahead=lookahead, use_limit=use_limit,
        max_steps=max_steps, dom_big=BIG)
