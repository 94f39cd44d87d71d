"""Wrappers of the psdsf_score kernels (K1, K2, K4).

For tensors on the CPU each wrapper runs the kernel's plain version
(:mod:`.ref`); for CUDA tensors it launches the Triton kernel
(:mod:`.kernel`) or raises :class:`~repro_torch.kernels.KernelError`.
Each wrapper counts its own launches in its ``launches`` attribute
(compare runs of the plain versions do not count).

  * :func:`masked_argmin1d` — masked argmin over a score vector (an RRR
    server visit, or DRF/TSF scores against row feasibility);
  * :func:`masked_argmin2d` — masked argmin over a maintained (N, J) score
    matrix (pooled selection in the incremental device epoch);
  * :func:`psdsf_argmin` — fused PS-DSF / rPS-DSF score, feasibility and
    argmin from raw (x, phi, d, res), the per-grant ``BatchedEpoch``
    backend.

Results stay on the device as 0-d tensors, so a select costs no host sync.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import KernelError
from repro_torch.kernels.psdsf_score import kernel
from repro_torch.kernels.psdsf_score.ref import (  # noqa: F401 (re-exported)
    BIG,
    _block,
    masked_argmin1d_ref,
    masked_argmin2d_ref,
    next_pow2,
    psdsf_argmin_ref,
)


def _check(name, s, mask, ndim):
    if s.device.type != "cuda" or mask.device != s.device:
        raise KernelError(f"{name}: scores and mask must share one CUDA "
                         f"device (got {s.device}, {mask.device})")
    if s.dtype != torch.float32 or s.dim() != ndim or mask.shape != s.shape:
        raise KernelError(f"{name}: needs f32 scores of rank {ndim} and a "
                         f"mask of the same shape (got {s.dtype} "
                         f"{tuple(s.shape)}, {tuple(mask.shape)})")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise KernelError(f"{name}: the mask must be bool or uint8, got "
                         f"{mask.dtype}")
    return mask.view(torch.uint8)


def masked_argmin1d(s, ok):
    """Masked argmin over a score vector.  s (N,), ok (N,) -> (val, i) as
    0-d tensors; i == -1 when no entry has ok True.  Any stride."""
    if s.device.type == "cpu":
        return masked_argmin1d_ref(s, ok)
    ok = _check("masked_argmin1d", s, ok, 1)
    val = torch.empty(1, dtype=torch.float32, device=s.device)
    idx = torch.empty(1, dtype=torch.int32, device=s.device)
    try:
        k1 = kernel.compiled()[0]
        k1[(1,)](s, ok, val, idx, s.shape[0], s.stride(0), ok.stride(0),
                 BLOCK=1024, BIG=BIG, IBIG=kernel.IBIG, num_warps=4)
    except Exception as exc:    # Triton build or launch
        raise KernelError(f"masked_argmin1d: {exc!r}") from exc
    masked_argmin1d.launches += 1
    return val[0], idx[0]


def masked_argmin2d(s, feas, *, bn: int = 128, bj: int = 128):
    """Masked argmin over a score matrix.  s (N, J), feas (N, J) ->
    (val, n, j) as 0-d tensors; n == j == -1 when no pair is feasible.
    Exact ties resolve in (bn, bj) tile order (see :mod:`.ref`)."""
    if s.device.type == "cpu":
        return masked_argmin2d_ref(s, feas, bn=bn, bj=bj)
    feas = _check("masked_argmin2d", s, feas, 2)
    if s.stride(1) != 1 or feas.stride(1) != 1:
        raise KernelError("masked_argmin2d: rows must be contiguous")
    N, J = s.shape
    bn, bj = _block(N, bn), _block(J, bj)
    tn, tj = -(-N // bn), -(-J // bj)
    pmin = torch.empty(tn * tj, dtype=torch.float32, device=s.device)
    parg = torch.empty(tn * tj, dtype=torch.int32, device=s.device)
    val = torch.empty(1, dtype=torch.float32, device=s.device)
    nj = torch.empty(2, dtype=torch.int32, device=s.device)
    try:
        _, k_tiles, k_reduce, _ = kernel.compiled()
        k_tiles[(tn, tj)](s, feas, pmin, parg, N, J, s.stride(0),
                          feas.stride(0), BN=bn, BJ=bj, BIG=BIG,
                          IBIG=kernel.IBIG, num_warps=8)
        k_reduce[(1,)](pmin, parg, val, nj, tn * tj, J, BLOCK=1024, BIG=BIG,
                       IBIG=kernel.IBIG, num_warps=4)
    except Exception as exc:    # Triton build or launch
        raise KernelError(f"masked_argmin2d: {exc!r}") from exc
    masked_argmin2d.launches += 1
    return val[0], nj[0], nj[1]


def psdsf_argmin(x, phi, d, res, *, bn: int = 128, bj: int = 128):
    """Fused feasibility-masked PS-DSF argmin over (frameworks x servers).
    x (N,), phi (N,), d (N, R), res (J, R) with R <= 8 -> (val, n, j) as
    0-d tensors; n == j == -1 when no pair is feasible.  Residual
    capacities as ``res`` give rPS-DSF, full capacities PS-DSF.  Exact ties
    resolve in (bn, bj) tile order (see :func:`.ref.psdsf_argmin_ref`)."""
    if d.device.type == "cpu":
        return psdsf_argmin_ref(x, phi, d, res, bn=bn, bj=bj)
    dev = d.device
    if dev.type != "cuda" or any(t.device != dev for t in (x, phi, res)):
        raise KernelError(f"psdsf_argmin: inputs must share one CUDA device "
                          f"(got {x.device}, {phi.device}, {dev}, "
                          f"{res.device})")
    if any(t.dtype != torch.float32 for t in (x, phi, d, res)):
        raise KernelError("psdsf_argmin: needs f32 inputs")
    N, R = d.shape if d.dim() == 2 else (-1, -1)
    J = res.shape[0] if res.dim() == 2 else -1
    if (x.shape != (N,) or phi.shape != (N,) or res.shape != (J, R)
            or not 1 <= R <= 8 or N < 1 or J < 1):
        raise KernelError(f"psdsf_argmin: needs x, phi (N,), d (N, R), res "
                          f"(J, R) with 1 <= R <= 8 (got {tuple(x.shape)}, "
                          f"{tuple(phi.shape)}, {tuple(d.shape)}, "
                          f"{tuple(res.shape)})")
    if (x.stride(0) != 1 or phi.stride(0) != 1 or d.stride(1) != 1
            or res.stride(1) != 1):
        raise KernelError("psdsf_argmin: vectors and rows must be contiguous")
    if N * J >= kernel.IBIG:
        raise KernelError(f"psdsf_argmin: {N} x {J} cells overflow the "
                          "int32 cell index")
    bn, bj = _block(N, bn), _block(J, bj)
    tn, tj = -(-N // bn), -(-J // bj)
    pmin = torch.empty(tn * tj, dtype=torch.float32, device=dev)
    parg = torch.empty(tn * tj, dtype=torch.int32, device=dev)
    val = torch.empty(1, dtype=torch.float32, device=dev)
    nj = torch.empty(2, dtype=torch.int32, device=dev)
    try:
        _, _, k_reduce, k_score = kernel.compiled()
        k_score[(tn, tj)](x, phi, d, res, pmin, parg, N, J, d.stride(0),
                          res.stride(0), R=R, BN=bn, BJ=bj, BIG=BIG,
                          IBIG=kernel.IBIG, num_warps=8)
        k_reduce[(1,)](pmin, parg, val, nj, tn * tj, J, BLOCK=1024, BIG=BIG,
                       IBIG=kernel.IBIG, num_warps=4)
    except Exception as exc:    # Triton build or launch
        raise KernelError(f"psdsf_argmin: {exc!r}") from exc
    psdsf_argmin.launches += 1
    return val[0], nj[0], nj[1]


masked_argmin1d.launches = 0
masked_argmin2d.launches = 0
psdsf_argmin.launches = 0
