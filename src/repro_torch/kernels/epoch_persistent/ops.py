"""Wrapper of the persistent allocation-epoch kernel (K3).

For tensors on the CPU :func:`persistent_epoch` runs the kernel's plain
version (:mod:`.ref`); for CUDA tensors it launches ``csrc/epoch.cu`` (built
by nvcc on first use, see :mod:`repro_torch._build`) cooperatively on
PyTorch's current stream, or raises :class:`~repro_torch.kernels.KernelError`
(a refused cooperative launch included: there is no other kernel to fall
back on).  Both update the eight state arrays in place and return the
:func:`repro_torch.core.engine_torch.epoch_loop` tuple
``(ns, js, count, X, tot, FREE, used, pidx, pos)``.  ``launches`` counts
kernel launches, ``grid`` holds the last launch's blocks: every co-resident
block of the card for pooled PS-DSF / rPS-DSF, one for the other pairs.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch import _build
from repro_torch.kernels import KernelError
from repro_torch.kernels.epoch_persistent.ref import persistent_epoch_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "epoch.cu"
KINDS = {"drf": 0, "tsf": 1, "psdsf": 2, "rpsdsf": 3}
MAX_R = 8
SYNC_WORDS = 9    # a block's words of scratch: two 4-word slots and one

_LIB = None
_GRID: dict[tuple[int, int], int] = {}   # (device, R) -> co-resident blocks
#: words of the per-phase profile (``persistent_epoch(..., profile=)``)
PROFILE_WORDS = 10


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc runs on the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.epoch_persistent_launch.argtypes = (
            [ptr] * 23 + [i32] * 8 + [ctypes.c_float] + [i32] * 7 + [ptr])
        lib.epoch_persistent_launch.restype = i32
        lib.epoch_grid_size.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.epoch_grid_size.restype = i32
        lib.epoch_barrier_floor.argtypes = [i32] * 3 + [ptr]
        lib.epoch_barrier_floor.restype = i32
        lib.epoch_persistent_error.argtypes = [i32]
        lib.epoch_persistent_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(rc: int, what: str):
    if rc != 0:
        raise KernelError(f"{what} failed: "
                          + library().epoch_persistent_error(rc).decode())


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def grid_size(device, R: int) -> int:
    """The blocks of the pooled PS-DSF launch for R resources on
    ``device``: the most that are co-resident (occupancy x SMs), asked of
    the card once."""
    key = (_index(device), int(R))
    if key not in _GRID:
        out = ctypes.c_int(0)
        _check(library().epoch_grid_size(key[0], key[1], ctypes.byref(out)),
               "persistent_epoch: the occupancy query")
        if out.value < 2:
            raise KernelError(f"persistent_epoch: only {out.value} block(s) "
                              "co-resident; the grid shape needs two")
        _GRID[key] = out.value
    return _GRID[key]


def barrier_floor(steps: int, device, R: int) -> None:
    """Launch the barrier floor: ``steps`` grid barriers, one a grant as
    K3's grid path pays, on K3's own grid (:func:`grid_size`) and block
    size, nothing else (a timing yardstick; not counted in
    ``persistent_epoch.launches``)."""
    grid = grid_size(device, R)
    stream = torch.cuda.current_stream(device).cuda_stream
    _check(library().epoch_barrier_floor(steps, grid, _index(device), stream),
           "persistent_epoch: the barrier floor launch")


def _need(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise KernelError(f"persistent_epoch: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise KernelError(f"persistent_epoch: {name} must be contiguous on "
                         f"{device}")


def persistent_epoch(X, tot, FREE, cap, dom, s, feas, used, D, TD, C, phi,
                     wanted, allowed, perms, aux, pidx0, pos0, j_real, limit,
                     eps, *, kind: str, policy: str, lookahead: bool,
                     use_limit: bool, max_steps: int,
                     profile: torch.Tensor | None = None):
    """Run one whole allocation epoch segment as one kernel launch.

    The arguments are the engine's padded f32 epoch state and constants, as
    for the TPU kernel (``aux`` is the DRF unit share or TSF denominator,
    zeros for the PS-DSF family; ``cap``/``dom`` may be dummies where the
    criterion does not read them).  On CUDA ``feas``/``allowed`` are byte
    masks (bool or uint8) and ``perms`` int32.  Pooled PS-DSF / rPS-DSF
    runs on :func:`grid_size` blocks, the other pairs on one.
    ``profile``, an int64 tensor of :data:`PROFILE_WORDS` on the device,
    runs the grid path's profiled build (pooled PS-DSF / rPS-DSF only),
    which writes that launch's per-phase profile (``epoch.cu``'s
    ``epoch_persistent_launch`` says what each word holds)."""
    if X.device.type == "cpu":
        return persistent_epoch_ref(
            X, tot, FREE, cap, dom, s, feas, used, D, TD, C, phi, wanted,
            allowed, perms, aux, pidx0, pos0, j_real, limit, eps, kind=kind,
            policy=policy, lookahead=lookahead, use_limit=use_limit,
            max_steps=max_steps)
    dev = X.device
    if dev.type != "cuda":
        raise KernelError(f"persistent_epoch: unsupported device {dev}")
    N, J = X.shape
    R = D.shape[1]
    if R > MAX_R or J % 4 or N * J >= 2**31:
        raise KernelError(f"persistent_epoch: needs R <= {MAX_R}, J % 4 == 0 "
                          f"and N*J < 2^31 (got N={N}, J={J}, R={R})")
    ss = kind in ("psdsf", "rpsdsf")
    f32 = torch.float32
    if feas.dtype == torch.bool:
        feas = feas.view(torch.uint8)
    if allowed.dtype == torch.bool:
        allowed = allowed.view(torch.uint8)
    for name, t, dtype, shape in (
            ("X", X, f32, (N, J)), ("tot", tot, f32, (N,)),
            ("FREE", FREE, f32, (J, R)), ("s", s, f32, (N, J) if ss else (N,)),
            ("feas", feas, torch.uint8, (N, J)),
            ("used", used, torch.int32, (J,)), ("D", D, f32, (N, R)),
            ("TD", TD, f32, (N, R)), ("C", C, f32, (J, R)),
            ("phi", phi, f32, (N,)), ("wanted", wanted, f32, (N,)),
            ("allowed", allowed, torch.uint8, (N, J)),
            ("perms", perms, torch.int32, (perms.shape[0], J)),
            ("aux", aux, f32, (N,))):
        _need(name, t, dtype, shape, dev)
    if ss:
        _need("dom", dom, f32, (N, J), dev)
    if kind == "rpsdsf":
        _need("cap", cap, f32, (J, R), dev)
    lib = library()
    blocks = grid_size(dev, R) if ss and policy == "pooled" else 1
    # rows and slices are read four cells at a time
    if (ss and (s.data_ptr() % 16 or dom.data_ptr() % 16)
            or feas.data_ptr() % 4):
        raise KernelError("persistent_epoch: s and dom must start on a "
                          "16-byte boundary, feas on a 4-byte one")
    if profile is not None:
        if blocks == 1:
            raise KernelError("persistent_epoch: profile= is for the grid "
                              "path (pooled PS-DSF / rPS-DSF) only")
        _need("profile", profile, torch.int64, (PROFILE_WORDS,), dev)
    ns = torch.empty(max_steps, dtype=torch.int32, device=dev)
    js = torch.empty(max_steps, dtype=torch.int32, device=dev)
    cnt = torch.empty(3, dtype=torch.int32, device=dev)
    # the grid shape's slots (9 words a block, 16-byte aligned at the
    # start), rowcnt (N), colcnt (J); the kernel fills all
    words = -(-SYNC_WORDS * blocks // 4) * 4
    scratch = torch.empty(words + N + J, dtype=torch.int32, device=dev)
    sync, rowcnt, colcnt = scratch.split([words, N, J])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.epoch_persistent_launch(
        D.data_ptr(), TD.data_ptr(), C.data_ptr(), phi.data_ptr(),
        wanted.data_ptr(), allowed.data_ptr(), perms.data_ptr(),
        aux.data_ptr(), X.data_ptr(), tot.data_ptr(), FREE.data_ptr(),
        cap.data_ptr(), dom.data_ptr(), s.data_ptr(), feas.data_ptr(),
        used.data_ptr(), ns.data_ptr(), js.data_ptr(), cnt.data_ptr(),
        rowcnt.data_ptr(), colcnt.data_ptr(), sync.data_ptr(),
        None if profile is None else profile.data_ptr(), N, J, R,
        perms.shape[0], int(pidx0), int(pos0), int(j_real), int(limit),
        float(eps), KINDS[kind], int(policy == "rrr"), int(lookahead),
        int(use_limit), int(max_steps), blocks, _index(dev), stream)
    _check(rc, "persistent_epoch launch")
    persistent_epoch.launches += 1
    persistent_epoch.grid = blocks
    return ns, js, cnt[0], X, tot, FREE, used, cnt[1], cnt[2]


persistent_epoch.launches = 0
persistent_epoch.grid = 0
