"""Plain PyTorch versions of the psdsf_score kernels (K1, K2, K4).

They define the functions the Triton kernels in :mod:`.kernel` compute, tie
order included, and they are what :mod:`.ops` runs for tensors on the CPU.
``masked_argmin2d_ref`` keeps the tile order of the TPU kernel it replaces
(``repro/kernels/psdsf_score/kernel.py::masked_argmin2d_tiles``): the first
minimum inside each (bn, bj) tile in row-major order, then the first tile in
row-major tile order.  That is lexicographic (n, j) order only within one
tile, so an exact tie that straddles a tile boundary resolves to the tile
that comes first."""
from __future__ import annotations

import torch

BIG = 3.4e38  # masked-entry sentinel (~f32 max), as in the TPU kernels


def next_pow2(n: int, lo: int = 8) -> int:
    """Next power of two >= max(n, lo) — the shape and tile rounding rule."""
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


def _block(n: int, b: int) -> int:
    """Effective tile size: pow2-clamped to the padded extent, >= 8."""
    return min(b, next_pow2(n))


def masked_argmin1d_ref(s, ok):
    """-> (min_value, i) over ok entries, first index on ties; (BIG, -1)
    if none.  Tiles of a vector come in index order, so the tile rule of
    the TPU kernel is the plain first minimum."""
    masked = torch.where(ok.bool(), s.float(), BIG)
    i = torch.argmin(masked)
    val = masked[i]
    return val, torch.where(val >= BIG, -1, i).to(torch.int32)


def masked_argmin2d_ref(s, feas, *, bn: int = 128, bj: int = 128):
    """-> (min_value, n, j) over feasible pairs in tile order; (BIG, -1, -1)
    if none."""
    N, J = s.shape
    bn, bj = _block(N, bn), _block(J, bj)
    tn, tj = -(-N // bn), -(-J // bj)
    masked = torch.full((tn * bn, tj * bj), BIG, dtype=torch.float32,
                        device=s.device)
    masked[:N, :J] = torch.where(feas.bool(), s.float(), BIG)
    # (tn, bn, tj, bj) -> one row per tile, tiles row-major, cells row-major
    tiles = masked.reshape(tn, bn, tj, bj).permute(0, 2, 1, 3).reshape(
        tn * tj, bn * bj)
    cell = torch.argmin(tiles, dim=1)                 # first min per tile
    mins = tiles.gather(1, cell[:, None])[:, 0]
    t = torch.argmin(mins)                            # first tile with it
    val = mins[t]
    n = (t // tj) * bn + cell[t] // bj
    j = (t % tj) * bj + cell[t] % bj
    bad = val >= BIG
    return (val, torch.where(bad, -1, n).to(torch.int32),
            torch.where(bad, -1, j).to(torch.int32))


def psdsf_argmin_ref(x, phi, d, res, *, bn: int = 128, bj: int = 128):
    """The fused PS-DSF / rPS-DSF pick: x, phi (N,), d (N, R), res (J, R)
    -> (min_value, n, j) of ``K[n, j] = (x_n / phi_n) * max_r d[n, r] /
    res[j, r]`` over the pairs with ``d[n] <= res[j]`` in every resource;
    (BIG, -1, -1) if none.

    The reference kernel's order of operations, in f32: per resource the
    quotient (BIG where ``res <= 0``, 0 where also ``d == 0``), a running
    maximum from 0, then ``(x / phi) * dom``.  Infeasible cells are masked
    by ``where``, never by arithmetic: an exhausted row (``d`` near 3e38)
    over a small residual gives ``inf`` and ``0 * inf`` gives NaN, and
    neither may reach the minimum.  The pick is :func:`masked_argmin2d_ref`,
    so ties resolve in the reference kernel's tile order.  Cells beyond
    (N, J) take no part (the reference pads them infeasible for every
    framework with a nonzero demand)."""
    x, phi, d, res = (t.float() for t in (x, phi, d, res))
    N, J = d.shape[0], res.shape[0]
    dom = torch.zeros((N, J), dtype=torch.float32, device=d.device)
    feas = torch.ones((N, J), dtype=torch.bool, device=d.device)
    for r in range(d.shape[1]):
        d_r = d[:, r, None]                               # (N, 1)
        res_r = res[None, :, r]                           # (1, J)
        ok = res_r > 0.0
        frac = torch.where(ok, d_r / torch.where(ok, res_r, 1.0), BIG)
        frac = torch.where((d_r == 0.0) & ~ok, 0.0, frac)
        dom = torch.maximum(dom, frac)
        feas &= d_r <= res_r
    score = (x / phi)[:, None] * dom
    return masked_argmin2d_ref(torch.where(feas, score, BIG), feas, bn=bn,
                               bj=bj)
