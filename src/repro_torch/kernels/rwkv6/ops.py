"""Wrapper of the WKV6 kernel (K6).

For tensors on the CPU :func:`wkv6` runs the kernel's plain version
(:func:`.ref.wkv6_ref`); for CUDA tensors it launches ``csrc/wkv6.cu``
(built by nvcc on first use, see :mod:`repro_torch._build`) on PyTorch's
current stream, or raises :class:`~repro_torch.kernels.KernelError`.  A
call is three CUDA launches (the chunks' own parts, the scan of the state
over the chunks, the chunks' inter-chunk parts) into a scratch of one
(D, D) increment a chunk that the wrapper allocates; ``wkv6.launches``
counts calls, one a layer of the prefill.

K6 has no backward kernel yet: a CUDA call under autograd (grad enabled
and an input that requires grad) raises instead of returning an output
whose inputs would silently get no gradient.  The plain version on the CPU
stays differentiable.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch import _build
from repro_torch.kernels import KernelError
from repro_torch.kernels.rwkv6.ref import wkv6_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
MAX_D = 64
MAX_CHUNK = 64

_LIB = None


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc runs on the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_launch.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
        lib.wkv6_launch.restype = i32
        lib.wkv6_error.argtypes = [i32]
        lib.wkv6_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def wkv6(r, k, v, logw, u, *, chunk: int = 64, state0=None):
    """r/k/v/logw: (B,S,H,D); u: (H,D); state0: (B,H,D,D) or None (zeros)
    -> (y (B,S,H,D) f32, the state after the last token (B,H,D,D) f32).
    Inputs of any float type are read as f32.  S needs no padding: the tail
    of the last chunk counts as zero k and zero log-decay, as the
    reference's padding makes it.  On CUDA, D <= 64 and chunk <= 64."""
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, logw, u, chunk=chunk, state0=state0)
    dev = r.device
    ins = (r, k, v, logw, u) + (() if state0 is None else (state0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise KernelError("wkv6: K6 has no backward kernel yet, so it cannot "
                          "run under autograd on CUDA (RWKV6 trains on the "
                          "CPU's plain version)")
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise KernelError("wkv6: inputs must share one CUDA device (got "
                          + ", ".join(str(t.device) for t in ins) + ")")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise KernelError(f"wkv6: needs r, k, v, logw of one (B,S,H,D) shape "
                          f"(got {[tuple(t.shape) for t in ins[:4]]})")
    B, S, H, D = r.shape
    if (u.shape != (H, D) or (state0 is not None and
                              state0.shape != (B, H, D, D))
            or not 1 <= D <= MAX_D or not 1 <= chunk <= MAX_CHUNK or S < 1):
        raise KernelError(f"wkv6: needs u (H,D), state0 (B,H,D,D), "
                          f"D <= {MAX_D}, chunk <= {MAX_CHUNK} (got r "
                          f"{tuple(r.shape)}, u {tuple(u.shape)}, chunk "
                          f"{chunk})")
    f32 = torch.float32
    r, k, v, logw, u = (t.to(f32).contiguous() for t in (r, k, v, logw, u))
    if state0 is not None:
        state0 = state0.to(f32).contiguous()
    y = torch.empty((B, S, H, D), dtype=f32, device=dev)
    s_end = torch.empty((B, H, D, D), dtype=f32, device=dev)
    nC = -(-S // chunk)
    # each chunk's state increment, then (in place) the state at its start;
    # each chunk's total log-decay
    inc = torch.empty((B, H, nC, D, D), dtype=f32, device=dev)
    tot = torch.empty((B, H, nC, D), dtype=f32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), None if state0 is None else state0.data_ptr(),
            y.data_ptr(), s_end.data_ptr(), inc.data_ptr(), tot.data_ptr(),
            B, S, H, D, int(chunk), stream)
    if rc != 0:
        raise KernelError("wkv6 launch failed: "
                          + lib.wkv6_error(rc).decode())
    wkv6.launches += 1
    return y, s_end


wkv6.launches = 0
