"""Triton kernel of the per-grant pick (K4).

Replaces the TPU kernel ``psdsf_argmin_tiles`` of
``repro/kernels/psdsf_score/kernel.py`` (``:168-199``, body
``_score_tile_kernel`` ``:43-69``): the fused PS-DSF / rPS-DSF score,
feasibility and argmin of the per-grant backend, ``K[n, j] = (x_n / phi_n)
* max_r d[n, r] / res[j, r]`` over the pairs with ``d[n] <= res[j]``.  Pass
1 has one program per (bn, bj) tile, at the TPU kernel's tile boundaries,
that loads its rows of x, phi, d and its columns of res, unrolls the R <= 8
resources, forms the scores in registers and writes only (tile min, first
row-major index of it); pass 2 is one program that picks the first tile,
in row-major tile order, holding the global minimum, so the tie order is
the TPU kernel's whatever the block shape.  No (N, J) matrix reaches
memory.  Both divisions are ``tl.math.div_rn`` (IEEE round to nearest, as
PyTorch divides): Triton's ``/`` on f32 may lower to an approximate
division, and the grant sequence must equal the plain version's bit for
bit.  Infeasible cells are masked by ``where``, so the ``inf`` and NaN that
exhausted rows (d = 3e38) produce never reach the minimum.

Every pick is two-pass (minimum, then the least index holding it), not
``tl.argmin``, so ties never depend on how Triton orders a reduction.
Masked entries read as ``BIG``; "nothing feasible" comes back as index -1.
The epoch's selects K1 and K2 are CUDA C++ (``csrc/argmin.cu``).

Bound on the H100: operations.  K4 reads only (N + J) * (R + 1) words
(about 40 KB at 512 x 4096, R = 2) and does about 5R + 3 f32 operations a
cell: about 0.3 us at 67 TFLOP/s.  At these sizes the cost of the launches
themselves dominates (PERF.md).

The bodies are plain functions until :func:`compiled` imports Triton and
wraps them, so this module imports on machines without Triton.  The
sentinels reach them as ``constexpr`` arguments (a kernel may read no plain
Python global); the wrapper in :mod:`.ops` passes ``BIG`` and ``IBIG``.
"""
from __future__ import annotations

IBIG = 2**31 - 1
tl = None   # triton.language, bound by compiled()


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
    """-> (argmin_partials, psdsf_score_tiles) as Triton kernels; imports
    Triton on first use."""
    global _COMPILED, tl
    if _COMPILED is None:
        import triton
        import triton.language as tl

        _COMPILED = (triton.jit(_argmin_partials_body),
                     triton.jit(_psdsf_score_tiles_body))
    return _COMPILED
