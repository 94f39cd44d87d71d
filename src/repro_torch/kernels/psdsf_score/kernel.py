"""Triton kernels for the allocation epoch's selects and the per-grant pick.

Replaces the three TPU kernels of ``repro/kernels/psdsf_score/kernel.py``:

* K1 ``masked_argmin1d_tiles`` (``:90-115``): masked argmin over a score
  vector, the RRR server visit and the DRF/TSF row select.  One program
  walks the vector in BLOCK-wide chunks; each lane keeps the first index of
  its own running minimum, and one cross-lane pass picks the first index of
  the global minimum.  Tiles of a vector come in index order, so this is
  exactly the TPU kernel's per-tile-then-across-tiles result.
* K2 ``masked_argmin2d_tiles`` (``:136-165``): masked argmin over the
  (N, J) score matrix, the pooled PS-DSF / rPS-DSF select.  Pass 1 has one
  program per (bn, bj) tile, at the TPU kernel's tile boundaries, writing
  (tile min, first row-major index of it); pass 2 is one program that picks
  the first tile, in row-major tile order, holding the global minimum.  The
  tie order is thereby the TPU kernel's, whatever the block shape.
* K4 ``psdsf_argmin_tiles`` (``:168-199``, body ``_score_tile_kernel``
  ``:43-69``): the fused PS-DSF / rPS-DSF score, feasibility and argmin of
  the per-grant backend, ``K[n, j] = (x_n / phi_n) * max_r d[n, r] /
  res[j, r]`` over the pairs with ``d[n] <= res[j]``.  Pass 1 has one
  program per (bn, bj) tile that loads its rows of x, phi, d and its
  columns of res, unrolls the R <= 8 resources, forms the scores in
  registers and writes only (tile min, first index); pass 2 is K2's.  No
  (N, J) matrix reaches memory.  Both divisions are ``tl.math.div_rn`` (IEEE
  round to nearest, as PyTorch divides): Triton's ``/`` on f32 may lower
  to an approximate division, and the grant sequence must equal the plain
  version's bit for bit.  Infeasible cells are masked by ``where``, so the
  ``inf`` and NaN that exhausted rows (d = 3e38) produce never reach the
  minimum.

Every pick is two-pass (minimum, then the least index holding it), not
``tl.argmin``, so ties never depend on how Triton orders a reduction.
Masked entries read as ``BIG``; "nothing feasible" comes back as index -1.

Bound on the H100.  K1 and K2 are bound by bytes: each launch reads the
scores (f32) and the mask (one byte) once and writes a few words, so the
least time is those bytes over 3.35 TB/s; at 512 x 4096 that is 10.5 MB,
about 3.1 us.  Pass 1 reads every byte once with coalesced 2-D tiles.  K4
reads only (N + J) * (R + 1) words (about 40 KB at 512 x 4096, R = 2) and
does about 5R + 3 f32 operations a cell, so it is bound by operations:
about 0.3 us at 67 TFLOP/s.  At these sizes the cost of the launches
themselves dominates (PERF.md).

The bodies are plain functions until :func:`compiled` imports Triton and
wraps them, so this module imports on machines without Triton.  The
sentinels reach them as ``constexpr`` arguments (a kernel may read no plain
Python global); the wrappers in :mod:`.ops` pass ``BIG`` and ``IBIG``.
"""
from __future__ import annotations

IBIG = 2**31 - 1
tl = None   # triton.language, bound by compiled()


def _argmin1d_body(s_ptr, ok_ptr, val_ptr, idx_ptr, n, s_stride, ok_stride,
                   BLOCK: tl.constexpr, BIG: tl.constexpr,
                   IBIG: tl.constexpr):
    lane = tl.arange(0, BLOCK)
    best_v = tl.full([BLOCK], BIG, tl.float32)
    best_i = tl.zeros([BLOCK], tl.int32)
    for start in range(0, n, BLOCK):
        offs = start + lane
        inb = offs < n
        s = tl.load(s_ptr + offs * s_stride, mask=inb, other=BIG)
        ok = tl.load(ok_ptr + offs * ok_stride, mask=inb, other=0)
        masked = tl.where(ok != 0, s, BIG)
        take = masked < best_v        # strict: a lane keeps its first min
        best_i = tl.where(take, offs, best_i)
        best_v = tl.where(take, masked, best_v)
    m = tl.min(best_v, axis=0)
    i = tl.min(tl.where(best_v == m, best_i, IBIG), axis=0)
    tl.store(val_ptr, m)
    tl.store(idx_ptr, tl.where(m >= BIG, -1, i))


def _argmin2d_tiles_body(s_ptr, f_ptr, pmin_ptr, parg_ptr, n_rows, n_cols,
                         s_stride, f_stride, BN: tl.constexpr,
                         BJ: tl.constexpr, BIG: tl.constexpr,
                         IBIG: tl.constexpr):
    ti = tl.program_id(0)
    tj = tl.program_id(1)
    rows = ti * BN + tl.arange(0, BN)[:, None]
    cols = tj * BJ + tl.arange(0, BJ)[None, :]
    inb = (rows < n_rows) & (cols < n_cols)
    s = tl.load(s_ptr + rows * s_stride + cols, mask=inb, other=BIG)
    f = tl.load(f_ptr + rows * f_stride + cols, mask=inb, other=0)
    masked = tl.where(f != 0, s, BIG)
    m = tl.min(tl.min(masked, axis=1), axis=0)
    # within a tile, row-major cell order is the order of n * J + j
    key = tl.where((masked == m) & inb, rows * n_cols + cols, IBIG)
    first = tl.min(tl.min(key, axis=1), axis=0)
    t = ti * tl.num_programs(1) + tj
    tl.store(pmin_ptr + t, m)
    tl.store(parg_ptr + t, first)


def _argmin_partials_body(pmin_ptr, parg_ptr, val_ptr, out_ptr, n_tiles,
                          n_cols, BLOCK: tl.constexpr, BIG: tl.constexpr,
                          IBIG: tl.constexpr):
    lane = tl.arange(0, BLOCK)
    best_v = tl.full([BLOCK], BIG, tl.float32)
    best_t = tl.zeros([BLOCK], tl.int32)
    for start in range(0, n_tiles, BLOCK):
        offs = start + lane
        v = tl.load(pmin_ptr + offs, mask=offs < n_tiles, other=BIG)
        take = v < best_v
        best_t = tl.where(take, offs, best_t)
        best_v = tl.where(take, v, best_v)
    m = tl.min(best_v, axis=0)
    t = tl.min(tl.where(best_v == m, best_t, IBIG), axis=0)
    enc = tl.load(parg_ptr + t)
    bad = m >= BIG
    tl.store(val_ptr, m)
    tl.store(out_ptr, tl.where(bad, -1, enc // n_cols))
    tl.store(out_ptr + 1, tl.where(bad, -1, enc % n_cols))


def _psdsf_score_tiles_body(x_ptr, phi_ptr, d_ptr, res_ptr, pmin_ptr,
                            parg_ptr, n_rows, n_cols, d_stride, res_stride,
                            R: tl.constexpr, BN: tl.constexpr,
                            BJ: tl.constexpr, BIG: tl.constexpr,
                            IBIG: tl.constexpr):
    ti = tl.program_id(0)
    tj = tl.program_id(1)
    rn = ti * BN + tl.arange(0, BN)
    cj = tj * BJ + tl.arange(0, BJ)
    rin = rn < n_rows
    cin = cj < n_cols
    x = tl.load(x_ptr + rn, mask=rin, other=1.0)
    phi = tl.load(phi_ptr + rn, mask=rin, other=1.0)
    inb = rin[:, None] & cin[None, :]
    dom = tl.zeros([BN, BJ], tl.float32)
    feas = inb
    for r in tl.static_range(R):
        d_r = tl.broadcast_to(
            tl.load(d_ptr + rn * d_stride + r, mask=rin, other=0.0)[:, None],
            (BN, BJ))
        res_r = tl.broadcast_to(
            tl.load(res_ptr + cj * res_stride + r, mask=cin,
                    other=1.0)[None, :], (BN, BJ))
        ok = res_r > 0.0
        q = tl.math.div_rn(d_r, tl.where(ok, res_r, 1.0))
        frac = tl.where(ok, q, BIG)
        frac = tl.where((d_r == 0.0) & ~ok, 0.0, frac)
        dom = tl.maximum(dom, frac)
        feas = feas & (d_r <= res_r)
    score = tl.math.div_rn(x, phi)[:, None] * dom
    masked = tl.where(feas, score, BIG)
    m = tl.min(tl.min(masked, axis=1), axis=0)
    # within a tile, row-major cell order is the order of n * J + j
    key = tl.where((masked == m) & inb, rn[:, None] * n_cols + cj[None, :],
                   IBIG)
    first = tl.min(tl.min(key, axis=1), axis=0)
    t = ti * tl.num_programs(1) + tj
    tl.store(pmin_ptr + t, m)
    tl.store(parg_ptr + t, first)


_COMPILED = None


def compiled():
    """-> (argmin1d, argmin2d_tiles, argmin_partials, psdsf_score_tiles) as
    Triton kernels; imports Triton on first use."""
    global _COMPILED, tl
    if _COMPILED is None:
        import triton
        import triton.language as tl

        _COMPILED = (triton.jit(_argmin1d_body),
                     triton.jit(_argmin2d_tiles_body),
                     triton.jit(_argmin_partials_body),
                     triton.jit(_psdsf_score_tiles_body))
    return _COMPILED
