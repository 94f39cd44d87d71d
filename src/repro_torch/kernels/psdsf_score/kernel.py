"""Triton kernels for the masked argmins of the allocation epoch's selects.

Replaces two TPU kernels of ``repro/kernels/psdsf_score/kernel.py``:

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

Both picks are two-pass (minimum, then the least index holding it), not
``tl.argmin``, so ties never depend on how Triton orders a reduction.
Masked entries read as ``BIG``; "nothing feasible" comes back as index -1.

Bound on the H100: bytes.  Each launch reads the scores (f32) and the mask
(one byte) once and writes a few words, so the least time is those bytes
over 3.35 TB/s; at 512 x 4096 that is 10.5 MB, about 3.1 us.  Pass 1 reads
every byte once with coalesced 2-D tiles; at these sizes the cost of the
launches themselves dominates (PERF.md).

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


_COMPILED = None


def compiled():
    """-> (argmin1d, argmin2d_tiles, argmin_partials) as Triton kernels;
    imports Triton on first use."""
    global _COMPILED, tl
    if _COMPILED is None:
        import triton
        import triton.language as tl

        _COMPILED = (triton.jit(_argmin1d_body),
                     triton.jit(_argmin2d_tiles_body),
                     triton.jit(_argmin_partials_body))
    return _COMPILED
