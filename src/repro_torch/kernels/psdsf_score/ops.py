"""Wrappers of the masked-argmin kernels (K1, K2).

For tensors on the CPU each wrapper runs the kernel's plain version
(:mod:`.ref`); for CUDA tensors it launches the Triton kernel
(:mod:`.kernel`) or raises :class:`~repro_torch.kernels.KernelError`.
Each wrapper counts its own launches in its ``launches`` attribute
(compare runs of the plain versions do not count).

  * :func:`masked_argmin1d` — masked argmin over a score vector (an RRR
    server visit, or DRF/TSF scores against row feasibility);
  * :func:`masked_argmin2d` — masked argmin over a maintained (N, J) score
    matrix (pooled selection in the incremental device epoch).

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
        k1, _, _ = kernel.compiled()
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
        _, k_tiles, k_reduce = kernel.compiled()
        k_tiles[(tn, tj)](s, feas, pmin, parg, N, J, s.stride(0),
                          feas.stride(0), BN=bn, BJ=bj, BIG=BIG,
                          IBIG=kernel.IBIG, num_warps=8)
        k_reduce[(1,)](pmin, parg, val, nj, tn * tj, J, BLOCK=1024, BIG=BIG,
                       IBIG=kernel.IBIG, num_warps=4)
    except Exception as exc:    # Triton build or launch
        raise KernelError(f"masked_argmin2d: {exc!r}") from exc
    masked_argmin2d.launches += 1
    return val[0], nj[0], nj[1]


masked_argmin1d.launches = 0
masked_argmin2d.launches = 0
