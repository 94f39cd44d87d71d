"""Plain PyTorch versions of the psdsf_score kernels (K1, K2, K4).

They define the functions the kernels of ``csrc/argmin.cu`` compute, tie
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
IBIG = 2**31 - 1  # the kernels' cell keys and indices are below it
#: the per-grant backend's unsatisfiable demand: a framework that reached
#: its wanted count gets this demand row (``core/engine.py``'s ``_KBIG``)
EXHAUSTED = 3.0e38


def next_pow2(n: int, lo: int = 8) -> int:
    """Next power of two >= max(n, lo) — the shape and tile rounding rule."""
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


def _block(n: int, b: int) -> int:
    """Effective tile size: pow2-clamped to the padded extent, >= 8."""
    return min(b, next_pow2(n))


def masked_argmin1d_ref(s, ok):
    """-> (min_value, i) over ok entries, first index on ties; (BIG, -1)
    if none.  Tiles of a vector come in index order, so the tile rule of
    the TPU kernel is the plain first minimum.  Where the TPU kernel pads
    the vector to whole tiles, the padding reads as BIG, so a minimum above
    BIG (every ok entry inf) comes back as BIG."""
    masked = torch.where(ok.bool(), s.float(), BIG)
    i = torch.argmin(masked)
    val = masked.reshape(-1).index_select(0, i.reshape(1))[0]
    N = s.shape[0]
    if N % _block(N, 128):
        val = torch.clamp(val, max=BIG)
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
    t = torch.argmin(mins).reshape(1)                 # first tile with it
    val, c = mins.index_select(0, t)[0], cell.index_select(0, t)[0]
    t = t[0]
    n = (t // tj) * bn + c // bj
    j = (t % tj) * bj + c % bj
    bad = val >= BIG
    return (val, torch.where(bad, -1, n).to(torch.int32),
            torch.where(bad, -1, j).to(torch.int32))


def apply_update(x, d, res, update) -> None:
    """Apply a pending mirror update (``PickOut.defer``'s words) to the
    per-grant backend's mirrors in place, as the engine's eager writes did:
    ``x[n] += units`` as one f32 add, ``d[n] = EXHAUSTED`` where row n is
    now exhausted, ``res[j] = row``.  ``update`` is ``(n, units, j, row,
    exhausted)`` or None."""
    if update is None:
        return
    n, units, j, row, exhausted = update
    x[n] += float(units)
    if exhausted:
        d[n] = EXHAUSTED
    res[j] = torch.as_tensor(row, dtype=torch.float32)


def _psdsf_scores(x, phi, d, res):
    """-> ((N, J) f32 scores, (N, J) feasibility) of the fused pick, in the
    reference kernel's order of operations."""
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
    return (x / phi)[:, None] * dom, feas


def psdsf_argmin_ref(x, phi, d, res, *, bn: int = 128, bj: int = 128,
                     out=None):
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
    framework with a nonzero demand).

    With ``out`` (an ``ops.PickOut``) it does what the kernel's launch does
    with its holder: it first applies the holder's pending mirror update to
    x, d and res (the mirrors, in place; :func:`apply_update`), then writes
    the result into the holder and returns its views."""
    if out is not None:
        apply_update(x, d, res, out.take())
    score, feas = _psdsf_scores(x, phi, d, res)
    r = masked_argmin2d_ref(torch.where(feas, score, BIG), feas, bn=bn,
                            bj=bj)
    return r if out is None else out.write(r)


# -- an emulation of csrc/argmin.cu's reduction ------------------------------

def ordered_bits(v):
    """f32 tensor -> int64 tensor of ``ordered_bits(v + 0.0f)`` as the
    kernel forms it, less 2^31: a key whose order is the order of the
    values, -0.0 and +0.0 equal.  Shifted by 2^31 so that packing it with a
    cell key into a signed int64 keeps the order."""
    u = (v.float() + 0.0).view(torch.int32).long() & 0xFFFFFFFF
    o = torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return o - 0x80000000


def _from_ordered(o: int) -> float:
    o += 0x80000000
    bits = o & 0x7FFFFFFF if o & 0x80000000 else ~o & 0xFFFFFFFF
    return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32).item()


def _packed_min(s, ok, keys, parts):
    """The kernel's packed minimum: the masked value (BIG where ok is False)
    and the key packed as ``ordered_bits << 32 | key``, a feasible NaN
    packing below every value (ordered bits 0), as ``torch.argmin`` orders
    a NaN first; the minimum within each part (``parts``: a block number
    per cell), then over the parts' minima.  -> (value, key) of the winner,
    the value NaN where a feasible NaN won."""
    s, ok = s.reshape(-1).float(), ok.reshape(-1).bool()
    masked = torch.where(ok, s, BIG)
    o = torch.where(ok & torch.isnan(s), -0x80000000, ordered_bits(masked))
    packed = (o << 32) | keys.reshape(-1)
    parts = torch.as_tensor(parts).reshape(-1).long()
    partial = torch.full((int(parts.max()) + 1,),
                         torch.iinfo(torch.int64).max).scatter_reduce_(
        0, parts, packed, "amin")
    w = int(partial.min())
    return _from_ordered(w >> 32), w & 0xFFFFFFFF


def tile_keys(N: int, J: int, bn: int, bj: int):
    """(N, J) int64: each cell's place in the reference's tile order,
    ``((n // bn) * tj + j // bj) * bn * bj + (n % bn) * bj + j % bj``."""
    tj = -(-J // bj)
    n = torch.arange(N)[:, None]
    j = torch.arange(J)[None, :]
    return ((n // bn) * tj + j // bj) * (bn * bj) + (n % bn) * bj + j % bj


def kernel_parts2d(N: int, J: int, grid: int, threads: int = 256,
                   vec: bool = True):
    """(N, J) block numbers of K2's split of the cells: W-cell chunks (W = 4
    on the vector path, 1 on the scalar one) of the flattened (N, J / W)
    grid, chunk c read by thread c % (grid * threads)."""
    chunk = torch.arange(N * J).reshape(N, J) // (4 if vec else 1)
    return (chunk % (grid * threads)) // threads


def _feasible_win(v: float, big: float) -> bool:
    """A feasible cell won: its value is below BIG, or a NaN."""
    return not v >= big


def _decoded(v, big, padded):
    if padded:
        v = min(v, big)
    return torch.tensor(v, dtype=torch.float32)


def masked_argmin2d_emulated(s, feas, parts, *, bn: int = 128,
                             bj: int = 128):
    """K2 as ``csrc/argmin.cu`` computes it, in plain PyTorch: the packed
    (value, tile key) minimum over ``parts`` (an (N, J) block number per
    cell), decoded.  The value is the source element at the winner, or the
    minimum itself, clamped to BIG where the shape is padded, when nothing
    is feasible.  Equals :func:`masked_argmin2d_ref` for every partition,
    a feasible NaN included (the first in tile order wins)."""
    N, J = s.shape
    bn, bj = _block(N, bn), _block(J, bj)
    v, key = _packed_min(s, feas, tile_keys(N, J, bn, bj), parts)
    big = torch.tensor(BIG).item()
    if _feasible_win(v, big):
        tj = -(-J // bj)
        t, cell = key // (bn * bj), key % (bn * bj)
        n, j = (t // tj) * bn + cell // bj, (t % tj) * bj + cell % bj
        i32 = torch.int32
        return (s[n, j].float(), torch.tensor(n, dtype=i32),
                torch.tensor(j, dtype=i32))
    none = torch.tensor(-1, dtype=torch.int32)
    return _decoded(v, big, N % bn or J % bj), none, none.clone()


def masked_argmin1d_emulated(s, ok, parts):
    """K1 as ``csrc/argmin.cu`` computes it: the packed (value, index)
    minimum over ``parts`` (a block or thread number per entry), decoded as
    :func:`masked_argmin2d_emulated` decodes."""
    N = s.shape[0]
    v, i = _packed_min(s, ok, torch.arange(N), parts)
    big = torch.tensor(BIG).item()
    if _feasible_win(v, big):
        return s[i].float(), torch.tensor(i, dtype=torch.int32)
    return _decoded(v, big, N % _block(N, 128)), torch.tensor(
        -1, dtype=torch.int32)


def argmin_cases(rng, shape):
    """-> [(label, scores, mask)] as numpy f32 / bool arrays of ``shape``:
    the inputs K1's and K2's contract names.  Quarter-quantized scores
    (exact ties everywhere, across tiles too), about half masked; an exact
    tie planted at the first and the last cell; -0.0 against +0.0 as the
    minimum; a feasible cell at exactly BIG, alone among masked cells and
    everywhere; inf scores, beside finite ones and everywhere; everything
    masked; and NaN scores (the first feasible NaN wins, as
    ``torch.argmin`` has it): beside finite ones, only where masked, and
    everywhere."""
    import numpy as np

    big = np.float32(BIG)
    size = int(np.prod(shape))
    s = (np.round(rng.standard_normal(shape) * 4) / 4).astype(np.float32)
    ok = rng.random(shape) < 0.5
    ends = s.copy().reshape(-1)
    ends[0] = ends[-1] = ends.min() - 1.0
    zeros = (np.abs(s) + 1.0).reshape(-1)
    zeros[rng.random(size) < 0.3] = -0.0
    zeros[rng.random(size) < 0.3] = 0.0
    one = np.zeros(size, bool)
    one[rng.integers(size)] = True
    inf = s.copy().reshape(-1)
    inf[rng.random(size) < 0.3] = np.inf
    every = np.ones(shape, bool)
    nan = s.copy().reshape(-1)
    nan[rng.random(size) < 0.2] = np.nan
    masked_nan = np.where(ok, s, np.float32(np.nan))
    return [
        ("quantized", s, ok),
        ("tie at the first and last cell", ends.reshape(shape), every),
        ("-0.0 against +0.0", zeros.reshape(shape), ok),
        ("feasible at BIG", np.full(shape, big), one.reshape(shape)),
        ("all feasible at BIG", np.full(shape, big), every),
        ("inf beside finite", inf.reshape(shape), ok),
        ("all inf", np.full(shape, np.inf, np.float32), every),
        ("all masked", s, np.zeros(shape, bool)),
        ("NaN beside finite", nan.reshape(shape), ok),
        ("NaN only where masked", masked_nan, ok),
        ("all NaN", np.full(shape, np.nan, np.float32), every),
    ]


def pick_parts(N: int, J: int, grid_cap: int = 528, threads: int = 256):
    """(N, J) block numbers of K4's split of the cells: column chunks of
    ``threads`` columns times row groups, enough groups for about
    ``grid_cap`` blocks (four a SM), block = group * chunks + chunk."""
    chunks = -(-J // threads)
    groups = min(max(grid_cap // chunks, 1), N)
    rows = -(-N // groups)
    n = torch.arange(N)[:, None]
    j = torch.arange(J)[None, :]
    return (n // rows) * chunks + j // threads


def psdsf_argmin_emulated(x, phi, d, res, parts, *, update=None,
                          bn: int = 128, bj: int = 128):
    """K4 as ``csrc/argmin.cu``'s launch computes it, in plain PyTorch: the
    inputs as the launch sees them (``update``, the pending mirror update,
    applied to copies: no block reads the mirrors at its row and column),
    each cell's score and feasibility, the packed (value, tile key) minimum
    over ``parts`` (an (N, J) block number per cell), decoded, the winner's
    value recomputed from the updated inputs; then the last block's
    write-back of ``update`` to the mirrors (in place).  Equals
    :func:`psdsf_argmin_ref` for every partition."""
    xu, du, ru = x.clone(), d.clone(), res.clone()
    apply_update(xu, du, ru, update)
    score, feas = _psdsf_scores(xu, phi, du, ru)
    N, J = score.shape
    bn, bj = _block(N, bn), _block(J, bj)
    v, key = _packed_min(score, feas, tile_keys(N, J, bn, bj), parts)
    big = torch.tensor(BIG).item()
    i32 = torch.int32
    if _feasible_win(v, big):
        tj = -(-J // bj)
        t, cell = key // (bn * bj), key % (bn * bj)
        n, j = (t // tj) * bn + cell // bj, (t % tj) * bj + cell % bj
        out = (score[n, j], torch.tensor(n, dtype=i32),
               torch.tensor(j, dtype=i32))
    else:
        none = torch.tensor(-1, dtype=i32)
        out = (_decoded(v, big, N % bn or J % bj), none, none.clone())
    apply_update(x, d, res, update)
    return out
