"""Wrappers of the psdsf_score kernels (K1, K2, K4).

For tensors on the CPU each wrapper runs the kernel's plain version
(:mod:`.ref`); for CUDA tensors it launches the kernel or raises
:class:`~repro_torch.kernels.KernelError`.  Each wrapper counts its own
launches in its ``launches`` attribute (compare runs of the plain versions
do not count).

  * :func:`masked_argmin1d` — masked argmin over a score vector (an RRR
    server visit, or DRF/TSF scores against row feasibility); one launch of
    ``csrc/argmin.cu``;
  * :func:`masked_argmin2d` — masked argmin over a maintained (N, J) score
    matrix (pooled selection in the incremental device epoch); one launch of
    ``csrc/argmin.cu``;
  * :func:`psdsf_argmin` — fused PS-DSF / rPS-DSF score, feasibility and
    argmin from raw (x, phi, d, res), the per-grant ``BatchedEpoch``
    backend; one launch of ``csrc/argmin.cu``.

Results stay on the device as 0-d tensors, so a select costs no host sync.
K1 and K2 write into an :class:`ArgminOut` the caller keeps (``out=``): a
call with it allocates nothing, makes no tensor and can be captured in a
CUDA graph.  The holder also carries K2's 16-byte workspace, which every
launch leaves ready for the next.  Without ``out`` each call makes a fresh
holder (a convenience for one-off calls and tests; the tiles loop passes
one).  K4 writes into a :class:`PickOut`, which also carries a pinned host
pair that the launch writes (n, j) into, and the previous grant's pending
mirror update, which the launch applies: a pick is one launch and one
stream sync (:meth:`PickOut.result`).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch import _build
from repro_torch.kernels import KernelError
from repro_torch.kernels.psdsf_score.ref import (  # noqa: F401 (re-exported)
    BIG,
    IBIG,
    _block,
    masked_argmin1d_ref,
    masked_argmin2d_ref,
    next_pow2,
    psdsf_argmin_ref,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "argmin.cu"
_F32 = torch.float32
_MASKS = (torch.bool, torch.uint8)

_LIB = None


def library() -> ctypes.CDLL:
    """The built K1/K2 library (nvcc runs on the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        i32 = ctypes.c_int
        for fn in (lib.argmin2d_launch, lib.argmin1d_launch):
            fn.argtypes = [ctypes.c_void_p]     # an ArgminOut's word array
            fn.restype = i32
        lib.psdsf_pick_launch.argtypes = [ctypes.c_void_p]   # PickOut's
        lib.psdsf_pick_launch.restype = i32
        lib.psdsf_pick_wait.argtypes = [ctypes.c_void_p]
        lib.psdsf_pick_wait.restype = i32
        lib.argmin_host_device_ptr.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.argmin_host_device_ptr.restype = i32
        lib.argmin_noop_launch.argtypes = [i32, ctypes.c_void_p]
        lib.argmin_noop_launch.restype = i32
        lib.argmin_error.argtypes = [i32]
        lib.argmin_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


class ArgminOut:
    """Outputs of one select, made once and handed to every call as
    ``out=``: ``views``, the 0-d tensors a call returns ((val, i) for K1,
    (val, n, j) for K2; f32 and int32); for K2 the ``workspace`` its blocks
    meet in (an int64 slot, all ones, then the ticket word, 0; every launch
    leaves it so); and the array of 64-bit words in which a CUDA call passes
    its arguments (``Argmin1dArgs`` / ``Argmin2dArgs`` of
    ``csrc/argmin.cu``).  A call overwrites the views; a caller that keeps a
    result past the next call on the same holder copies it (``ns[count] =
    n`` does).  Calls on one holder must not overlap (on two streams, or a
    graph replay beside a direct call): they share outputs and workspace.
    Calls on different holders never share anything."""

    __slots__ = ("views", "workspace", "device_index", "_ptrs", "_args",
                 "_addr")

    def __init__(self, device, ndim: int):
        if ndim not in (1, 2):
            raise ValueError(f"ArgminOut: ndim must be 1 or 2, got {ndim}")
        device = torch.device(device)
        self.views = (torch.empty((), dtype=_F32, device=device),) + tuple(
            torch.empty((), dtype=torch.int32, device=device)
            for _ in range(ndim))
        # [-1, 0]: the slot all ones, the ticket (and its pad word) zero
        self.workspace = (torch.arange(-1, 1, dtype=torch.int64,
                                       device=device) if ndim == 2 else None)
        self.device_index = self.views[0].get_device()
        self._ptrs = tuple(v.data_ptr() for v in self.views) + (
            () if ndim == 1 else (self.workspace.data_ptr(),))
        self._args = (ctypes.c_longlong * (10 if ndim == 1 else 16))()
        self._addr = ctypes.addressof(self._args)

    def write(self, result):
        """Copy a plain version's result into the holder -> its views."""
        for view, r in zip(self.views, result):
            view.copy_(r)
        return self.views


class PickOut:
    """What K4's caller keeps across picks, made once an epoch and handed to
    every call as ``out=``: ``views``, the 0-d (val, n, j) a call returns
    (f32, int32, int32); the ``workspace`` its blocks meet in (as
    :class:`ArgminOut`'s); ``host``, an int32 pair in pinned memory that
    the launch also writes (n, j) into; ``pending``, the previous grant's
    mirror update (:meth:`defer`), which the next call applies; and the
    array of 64-bit words in which a CUDA call passes its arguments
    (``PickArgs`` of ``csrc/argmin.cu``).  Calls on one holder must not
    overlap."""

    __slots__ = ("views", "workspace", "host", "device_index", "R",
                 "pending", "_host_np", "_ptrs", "_args", "_addr", "_units",
                 "_row", "_bound")
    _PENDING = 20               # the word of pend_n in PickArgs

    def __init__(self, device, R: int):
        if not 1 <= R <= 8:
            raise ValueError(f"PickOut: R must be 1 to 8, got {R}")
        device = torch.device(device)
        self.R = R
        self.views = (torch.empty((), dtype=_F32, device=device),
                      torch.empty((), dtype=torch.int32, device=device),
                      torch.empty((), dtype=torch.int32, device=device))
        self.workspace = torch.arange(-1, 1, dtype=torch.int64, device=device)
        cuda = device.type == "cuda"
        self.host = torch.full((2,), -1, dtype=torch.int32, pin_memory=cuda)
        self._host_np = self.host.numpy()
        self.device_index = self.views[0].get_device()
        self.pending = None
        self._args = (ctypes.c_longlong * 28)()
        self._addr = ctypes.addressof(self._args)
        self._units = ctypes.c_double.from_buffer(self._args, 23 * 8)
        self._row = (ctypes.c_float * 8).from_buffer(self._args, 24 * 8)
        self._args[self._PENDING:self._PENDING + 2] = (-1, -1)
        self._ptrs = ()
        # (x, phi, d, res, bn, bj, N, J) of the last CUDA call, whose
        # argument words stand: a call on the same four tensors (the
        # engine's mirrors, never resized) skips the checks
        self._bound = None
        if cuda:
            lib = _LIB or library()
            host_dev = ctypes.c_void_p()
            rc = lib.argmin_host_device_ptr(self.host.data_ptr(),
                                            ctypes.byref(host_dev))
            if rc:
                raise KernelError("PickOut: pinned pair not mapped: "
                                  + lib.argmin_error(rc).decode())
            self._ptrs = tuple(v.data_ptr() for v in self.views) + (
                self.workspace.data_ptr(), host_dev.value)

    def defer(self, n: int, units, j: int, row, exhausted: bool) -> None:
        """Record a grant's mirror update for the next call to apply: x[n]
        += units, res[j] = row (R values, rounded to f32), and d[n] =
        ``ref.EXHAUSTED`` where ``exhausted``.  One update between two
        calls."""
        if self.pending is not None:
            raise KernelError("PickOut: an update is already pending; a "
                              "pick must come between two grants")
        row = np.asarray(row, np.float32)
        if row.shape != (self.R,):
            raise KernelError(f"PickOut: the res row must have {self.R} "
                              f"values (got {row.shape})")
        self.pending = (int(n), float(units), int(j), row, bool(exhausted))
        a = self._args
        a[self._PENDING:self._PENDING + 3] = (n, j, int(bool(exhausted)))
        self._units.value = float(units)
        self._row[:self.R] = row.tolist()

    def take(self):
        """-> the pending update (or None), cleared."""
        p, self.pending = self.pending, None
        self._args[self._PENDING:self._PENDING + 2] = (-1, -1)
        return p

    def write(self, result):
        """Copy a plain version's (val, n, j) into the holder -> its views."""
        for view, r in zip(self.views, result):
            view.copy_(r)
        self.host.copy_(torch.stack(result[1:]).to(torch.int32))
        return self.views

    def result(self) -> tuple[int, int]:
        """-> (n, j) of the last call: on the card, after one sync of the
        stream it launched on, read from the pinned pair."""
        if self._ptrs:
            lib = _LIB or library()
            rc = lib.psdsf_pick_wait(self._args[9])
            if rc:
                raise KernelError("psdsf_argmin failed: "
                                  + lib.argmin_error(rc).decode())
        h = self._host_np
        return int(h[0]), int(h[1])


@functools.lru_cache(maxsize=64)
def _blocks2d(N: int, J: int, bn: int, bj: int):
    """-> K2's tile words (log2 bn, log2 bj, tj, pad): the reference's tile
    (:func:`.ref._block`), the tiles a row of tiles, and whether the tiles
    overhang (N, J).  Raises where the padded cell count overflows the
    kernel's 31-bit cell key."""
    bn, bj = _block(N, bn), _block(J, bj)
    if bn & (bn - 1) or bj & (bj - 1):
        raise KernelError(f"masked_argmin2d: tiles must be powers of two "
                          f"(got {bn} x {bj})")
    tn, tj = -(-N // bn), -(-J // bj)
    cells = tn * bn * tj * bj
    if cells >= IBIG:
        raise KernelError(f"masked_argmin2d: {N} x {J} padded to {cells} "
                          "cells overflows the int32 cell key")
    return (bn.bit_length() - 1, bj.bit_length() - 1, tj,
            int(tn * bn != N or tj * bj != J))


@functools.lru_cache(maxsize=64)
def _pad1d(n: int) -> int:
    """-> K1's ``pad``: whether the reference pads n to whole tiles.
    Raises where n overflows the kernel's 31-bit index."""
    if n >= IBIG:
        raise KernelError(f"masked_argmin1d: {n} entries overflow the int32 "
                          "index")
    return int(n % _block(n, 128) != 0)


def _refuse(name, s, mask, ndim):
    if mask.get_device() != s.get_device():
        return KernelError(f"{name}: scores and mask must share one CUDA "
                           f"device (got {s.device}, {mask.device})")
    return KernelError(f"{name}: needs f32 scores of rank {ndim} and a bool "
                       f"or uint8 mask of the same shape (got {s.dtype} "
                       f"{tuple(s.shape)}, {mask.dtype} "
                       f"{tuple(mask.shape)})")


def _out(name, out, s, ndim):
    if out is None:
        return ArgminOut(s.device, ndim)
    if len(out.views) != ndim + 1 or out.device_index != s.get_device():
        raise KernelError(f"{name}: out must be an ArgminOut(device, {ndim}) "
                          f"on {s.device}")
    return out


def _plain(name, fn, s, *args, out, ndim, **kw):
    if s.device.type != "cpu":
        raise KernelError(f"{name}: unsupported device {s.device}")
    r = fn(s, *args, **kw)
    return r if out is None else _out(name, out, s, ndim).write(r)


def masked_argmin1d(s, ok, *, out: ArgminOut | None = None):
    """Masked argmin over a score vector.  s (N,), ok (N,) -> (val, i) as
    0-d tensors (``out.views`` when ``out`` is given); i == -1 when no entry
    has ok True.  Any stride."""
    if not s.is_cuda:
        return _plain("masked_argmin1d", masked_argmin1d_ref, s, ok, out=out,
                      ndim=1)
    index = s.get_device()
    if (ok.get_device() != index or s.dtype != _F32 or s.dim() != 1
            or ok.shape != s.shape or ok.dtype not in _MASKS):
        raise _refuse("masked_argmin1d", s, ok, 1)
    out = _out("masked_argmin1d", out, s, 1)
    lib = _LIB or library()
    n = s.shape[0]
    # the private call: torch.cuda.current_stream() builds a Stream object,
    # microseconds of host time on a call paced by the host
    out._args[:] = (s.data_ptr(), ok.data_ptr(), *out._ptrs,
                    torch._C._cuda_getCurrentRawStream(index), n,
                    s.stride(0), ok.stride(0), _pad1d(n), index)
    rc = lib.argmin1d_launch(out._addr)
    if rc:
        raise KernelError("masked_argmin1d launch failed: "
                          + lib.argmin_error(rc).decode())
    masked_argmin1d.launches += 1
    return out.views


def masked_argmin2d(s, feas, *, bn: int = 128, bj: int = 128,
                    out: ArgminOut | None = None):
    """Masked argmin over a score matrix.  s (N, J), feas (N, J) ->
    (val, n, j) as 0-d tensors (``out.views`` when ``out`` is given);
    n == j == -1 when no pair is feasible.  Exact ties resolve in (bn, bj)
    tile order (see :mod:`.ref`).  On CUDA, rows must be contiguous."""
    if not s.is_cuda:
        return _plain("masked_argmin2d", masked_argmin2d_ref, s, feas,
                      out=out, ndim=2, bn=bn, bj=bj)
    index = s.get_device()
    if (feas.get_device() != index or s.dtype != _F32 or s.dim() != 2
            or feas.shape != s.shape or feas.dtype not in _MASKS):
        raise _refuse("masked_argmin2d", s, feas, 2)
    ss, s1 = s.stride()
    fs, f1 = feas.stride()
    if s1 != 1 or f1 != 1:
        raise KernelError("masked_argmin2d: rows must be contiguous")
    N, J = s.shape
    geometry = _blocks2d(N, J, bn, bj)
    out = _out("masked_argmin2d", out, s, 2)
    lib = _LIB or library()
    out._args[:] = (s.data_ptr(), feas.data_ptr(), *out._ptrs,
                    torch._C._cuda_getCurrentRawStream(index), N, J, ss, fs,
                    *geometry, index)
    rc = lib.argmin2d_launch(out._addr)
    if rc:
        raise KernelError("masked_argmin2d launch failed: "
                          + lib.argmin_error(rc).decode())
    masked_argmin2d.launches += 1
    return out.views


def noop_launch(index: int) -> None:
    """Launch an empty kernel on device ``index``'s current stream through
    the same library (the launch floor; timing only, not counted)."""
    lib = _LIB or library()
    rc = lib.argmin_noop_launch(index,
                                torch._C._cuda_getCurrentRawStream(index))
    if rc:
        raise KernelError("argmin noop launch failed: "
                          + lib.argmin_error(rc).decode())


def _bind_pick(x, phi, d, res, bn, bj, out):
    """Check K4's CUDA inputs and write their argument words into ``out``
    (a fresh holder where None) -> the holder."""
    dev = d.device
    if dev.type != "cuda" or any(t.device != dev for t in (x, phi, res)):
        raise KernelError(f"psdsf_argmin: inputs must share one CUDA device "
                          f"(got {x.device}, {phi.device}, {dev}, "
                          f"{res.device})")
    if any(t.dtype != _F32 for t in (x, phi, d, res)):
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
    geometry = _blocks2d(N, J, bn, bj)
    index = d.get_device()
    if out is None:
        out = PickOut(dev, R)
    elif (not isinstance(out, PickOut) or out.device_index != index
            or out.R != R):
        raise KernelError(f"psdsf_argmin: out must be a PickOut({dev}, {R})")
    out._args[:20] = (x.data_ptr(), phi.data_ptr(), d.data_ptr(),
                      res.data_ptr(), *out._ptrs, 0, N, J, R, d.stride(0),
                      res.stride(0), *geometry, index)
    out._bound = (x, phi, d, res, bn, bj, N, J)
    return out


def psdsf_argmin(x, phi, d, res, *, bn: int = 128, bj: int = 128,
                 out: PickOut | None = None):
    """Fused feasibility-masked PS-DSF argmin over (frameworks x servers).
    x (N,), phi (N,), d (N, R), res (J, R) with R <= 8 -> (val, n, j) as
    0-d tensors (``out.views`` when ``out`` is given); n == j == -1 when no
    pair is feasible.  Residual capacities as ``res`` give rPS-DSF, full
    capacities PS-DSF.  Exact ties resolve in (bn, bj) tile order (see
    :func:`.ref.psdsf_argmin_ref`).  With ``out``, the holder's pending
    mirror update is applied to x, d and res first (in place), and (n, j)
    also reaches the holder's host pair; a CUDA call then allocates
    nothing."""
    if d.device.type == "cpu":
        return psdsf_argmin_ref(x, phi, d, res, bn=bn, bj=bj, out=out)
    b = getattr(out, "_bound", None)
    if (b is None or b[0] is not x or b[1] is not phi or b[2] is not d
            or b[3] is not res or b[4] != bn or b[5] != bj):
        out = _bind_pick(x, phi, d, res, bn, bj, out)
        b = out._bound
    p = out.pending
    if p is not None and not (0 <= p[0] < b[6] and 0 <= p[2] < b[7]):
        raise KernelError(f"psdsf_argmin: the pending update's row {p[0]} "
                          f"or column {p[2]} is outside {b[6:]}")
    lib = _LIB or library()
    out._args[9] = torch._C._cuda_getCurrentRawStream(out.device_index)
    rc = lib.psdsf_pick_launch(out._addr)
    if rc:
        raise KernelError("psdsf_argmin launch failed: "
                          + lib.argmin_error(rc).decode())
    out.take()          # the launch carried it
    psdsf_argmin.launches += 1
    return out.views


masked_argmin1d.launches = 0
masked_argmin2d.launches = 0
psdsf_argmin.launches = 0
