"""Wrapper of the persistent allocation-epoch kernel (K3).

For tensors on the CPU :func:`persistent_epoch` runs the kernel's plain
version (:mod:`.ref`); for CUDA tensors it launches ``csrc/epoch.cu`` (built
by nvcc on first use, see :mod:`repro_torch._build`) on PyTorch's current
stream, or raises :class:`~repro_torch.kernels.KernelError`.  Both update
the eight state arrays in place and return the
:func:`repro_torch.core.engine_torch.epoch_loop` tuple
``(ns, js, count, X, tot, FREE, used, pidx, pos)``.  ``launches`` counts
kernel launches.
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

_LIB = None


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc runs on the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.epoch_persistent_launch.argtypes = (
            [ptr] * 21 + [i32] * 8 + [ctypes.c_float] + [i32] * 5 + [ptr])
        lib.epoch_persistent_launch.restype = i32
        lib.epoch_persistent_error.argtypes = [i32]
        lib.epoch_persistent_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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
                     use_limit: bool, max_steps: int):
    """Run one whole allocation epoch segment as one kernel launch.

    The arguments are the engine's padded f32 epoch state and constants, as
    for the TPU kernel (``aux`` is the DRF unit share or TSF denominator,
    zeros for the PS-DSF family; ``cap``/``dom`` may be dummies where the
    criterion does not read them).  On CUDA ``feas``/``allowed`` are byte
    masks (bool or uint8) and ``perms`` int32."""
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
    if R > MAX_R or J % 4 or (N * J) % 16:
        raise KernelError(f"persistent_epoch: needs R <= {MAX_R}, J % 4 == 0 "
                         f"and N*J % 16 == 0 (got N={N}, J={J}, R={R})")
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
    ns = torch.empty(max_steps, dtype=torch.int32, device=dev)
    js = torch.empty(max_steps, dtype=torch.int32, device=dev)
    cnt = torch.empty(3, dtype=torch.int32, device=dev)
    vec = torch.empty(max(N, J), dtype=f32, device=dev)
    ok = torch.empty(J, dtype=torch.uint8, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.epoch_persistent_launch(
            D.data_ptr(), TD.data_ptr(), C.data_ptr(), phi.data_ptr(),
            wanted.data_ptr(), allowed.data_ptr(), perms.data_ptr(),
            aux.data_ptr(), X.data_ptr(), tot.data_ptr(), FREE.data_ptr(),
            cap.data_ptr(), dom.data_ptr(), s.data_ptr(), feas.data_ptr(),
            used.data_ptr(), ns.data_ptr(), js.data_ptr(), cnt.data_ptr(),
            vec.data_ptr(), ok.data_ptr(), N, J, R, perms.shape[0],
            int(pidx0), int(pos0), int(j_real), int(limit), float(eps),
            KINDS[kind], int(policy == "rrr"), int(lookahead),
            int(use_limit), int(max_steps), stream)
    if rc != 0:
        raise KernelError("persistent_epoch launch failed: "
                           + lib.epoch_persistent_error(rc).decode())
    persistent_epoch.launches += 1
    return ns, js, cnt[0], X, tot, FREE, used, cnt[1], cnt[2]


persistent_epoch.launches = 0
