"""Plain PyTorch version of the persistent epoch kernel (K3), and an
emulation of the kernel's own algorithm for the tests.

The engine's plain loop is this kernel's specification, as the reference
pins its persistent kernel equal to the default loop: :func:`persistent_epoch_ref`
runs that loop from the kernel's inputs, updating the same eight state
arrays in place.  The one difference is the kernel's own sentinel, 3.0e38,
for an exhausted residual in the rPS-DSF column refresh (the loop uses
``criteria._BIG``); such entries are infeasible either way, so grant
sequences agree and the state arrays match the kernel's.

:func:`persistent_epoch_emulated` is ``csrc/epoch.cu``'s algorithm step
for step, which the wrapper never runs: feasibility counts kept in the
grant instead of mask scans, and on the pooled PS-DSF / rPS-DSF path the
grid's one-barrier pick (parts over any split of the cells, the row and
column of the grant in flight left to the granting block, each part's
first index within its own tolerance, and a near-tie round where two
near-tied parts disagree).
"""
from __future__ import annotations

import torch

BIG = 3.0e38
_IBIG = 2**31 - 1


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


def _threshold(m):
    """The kernel's ``m + (1e-9f + 1e-6f * fabsf(m))``, in f32."""
    f32 = torch.float32
    return m + (torch.tensor(1e-9, dtype=f32) +
                torch.tensor(1e-6, dtype=f32) * m.abs())


def grid_blocks(N: int, J: int, grid: int):
    """(N * J,) the block of the kernel's grid shape that streams each
    cell: blocks 1..grid-1 own contiguous slices of the float4 groups
    (block 0 applies grants)."""
    group = torch.arange(N * J) // 4
    per = -(-(N * J // 4) // (grid - 1))
    return 1 + group // per


def grid_pick(masked, held, blocks, grid: int):
    """The grid shape's pick over the flat masked scores: each part (block
    0: the ``held`` cells, the row and column of the grant in flight; block
    b: its slice, held cells aside) publishes its least score, the first
    index whose score is within ITS tolerance of that least one, and that
    score.  The pick is the least first index among the parts whose least
    score is within the tolerance of the least of all; where such a part's
    published score is not (two near-tied parts), a near-tie round takes
    every part's first index within that tolerance.  -> (flat index,
    whether the near-tie round ran)."""
    parts = torch.where(held, 0, blocks)
    flat = torch.arange(masked.shape[0])
    least = torch.full((grid,), BIG).scatter_reduce_(0, parts, masked,
                                                     "amin")
    hit = masked <= _threshold(least)[parts]
    first = torch.full((grid,), _IBIG).scatter_reduce_(
        0, parts, torch.where(hit, flat, _IBIG), "amin")
    score = torch.where(first < _IBIG, masked[first.clamp(max=len(flat) - 1)],
                        BIG)
    m = least.min()
    thr = _threshold(m)
    cand = (least <= thr) & (first < _IBIG)
    near_tie = bool((cand & ~(score <= thr)).any())
    if near_tie:
        return int(torch.where(masked <= thr, flat, _IBIG).min()), True
    return int(torch.where(cand, first, _IBIG).min()), False


def persistent_epoch_emulated(X, tot, FREE, cap, dom, s, feas, used, D, TD,
                              C, phi, wanted, allowed, perms, aux, pidx0,
                              pos0, j_real, limit, eps, *, kind: str,
                              policy: str, lookahead: bool, use_limit: bool,
                              max_steps: int, grid: int = 2, on_grant=None):
    """``csrc/epoch.cu`` in plain PyTorch on the CPU (tests only), with the
    kernel's arguments and results.  ``grid`` splits the cells as the grid
    shape does (:func:`grid_blocks`); ``on_grant(feas, rowcnt, colcnt,
    total)`` is called after every grant with the kept counts."""
    from repro_torch.core.engine_torch import _argmin_tie_low, _dominant_cols

    N, J = X.shape
    i32 = torch.int32
    feas = feas.view(torch.bool) if feas.dtype == torch.uint8 else feas
    allowed = allowed.bool()
    la = 1.0 if lookahead else 0.0
    ss = kind in ("psdsf", "rpsdsf")
    K = perms.shape[0]
    ns = torch.full((max_steps,), -1, dtype=i32)
    js = torch.full((max_steps,), -1, dtype=i32)
    # the counts, from the mask once a launch
    rowcnt = feas.sum(1, dtype=i32)
    colcnt = feas.sum(0, dtype=i32)
    total = int(rowcnt.sum())

    def grant(n, j, k):
        """The grant as the kernel keeps it: the column rewrite folds row
        n's clear in, and the counts move by new - old."""
        nonlocal total
        X[n, j] += 1.0
        tot[n] += 1.0
        FREE[j] += -TD[n]
        used[j] += 1
        ns[k], js[k] = n, j
        wants = tot < wanted
        colf = wants & allowed[:, j] & (TD <= FREE[j][None, :] + eps).all(1)
        if use_limit:
            colf = colf & (used[j] < limit)
        done = not bool(wants[n])
        old = feas[:, j].clone()
        feas[:, j] = colf
        rowcnt.add_(colf.to(i32) - old.to(i32))
        removed = int(rowcnt[n]) if done else 0
        colsum = int(colf.sum())
        if done:
            rowcnt[n] = 0
            cleared = feas[n].clone()
            cleared[j] = False
            colcnt.sub_(cleared.to(i32))
            feas[n] = False
        total += colsum - int(colcnt[j]) - removed
        colcnt[j] = colsum
        xt_n = tot[n] + la
        if kind == "drf":
            s[n] = xt_n * aux[n] / phi[n]
        elif kind == "tsf":
            s[n] = xt_n / aux[n]
        else:
            if kind == "rpsdsf":
                cap_j = C[j] - X[:, j] @ D
                cap[j] = cap_j
                dom[:, j] = _dominant_cols(D, cap_j[None, :], BIG)[0]
                s[:, j] = (tot + la) / phi * dom[:, j]
            s[n] = xt_n / phi[n] * dom[n]
        if on_grant is not None:
            on_grant(feas, rowcnt, colcnt, total)

    count = 0
    pidx, pos = int(pidx0), int(pos0)
    if ss and policy == "pooled":
        blocks = grid_blocks(N, J, grid)
        flat = torch.arange(N * J)
        rows, cols = flat // J, flat % J
        n = j = -1                      # picked, not yet applied
        while True:
            if n >= 0:
                grant(n, j, count - 1)
            masked = torch.where(feas, s, BIG).reshape(-1)
            pick, _ = grid_pick(masked, (rows == n) | (cols == j), blocks,
                                grid)
            if count == max_steps or total == 0:
                break
            n, j = divmod(pick, J)
            count += 1
    else:
        while count < max_steps and total > 0:
            ok = colcnt > 0
            if policy == "rrr":
                def first_ok(p, start):
                    perm = perms[min(p, K - 1)].long()
                    at = torch.nonzero(ok[perm[start:]])
                    return None if len(at) == 0 else start + int(at[0])

                krank = first_ok(pidx, pos)
                wrap = krank is None
                p = pidx + 1 if wrap else pidx
                if wrap:
                    krank = first_ok(p, 0)
                j = int(perms[min(p, K - 1), krank])
                col = s[:, j] if ss else s
                n = int(_argmin_tie_low(col, feas[:, j]))
                last = krank == j_real - 1
                pidx, pos = pidx + int(wrap) + int(last), (
                    0 if last else krank + 1)
            else:
                n = int(_argmin_tie_low(s, rowcnt > 0))
                j = int(torch.nonzero(feas[n])[0])
            grant(n, j, count)
            count += 1
    return (ns, js, torch.tensor(count, dtype=i32), X, tot, FREE, used,
            torch.tensor(pidx, dtype=i32), torch.tensor(pos, dtype=i32))
