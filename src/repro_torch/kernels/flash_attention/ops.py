"""Wrapper of the flash attention kernel (K5).

For tensors on the CPU :func:`flash_attention` runs the kernel's plain
version (:mod:`.ref`); for CUDA tensors it launches ``csrc/flash.cu`` (built
by nvcc on first use, see :mod:`repro_torch._build`) on PyTorch's current
stream, or raises :class:`~repro_torch.kernels.KernelError`.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch import _build
from repro_torch.kernels import KernelError
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)

_LIB = None


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc runs on the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [ptr] * 4 + [i32] * 7 + [i64] * 9 + [i32, i32, ctypes.c_float,
                                                 ptr])
        lib.flash_attention_launch.restype = i32
        lib.flash_attention_error.argtypes = [i32]
        lib.flash_attention_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,D); k/v: (B,T,K,D) with H % K == 0 -> (B,S,H,D) in q's
    type.  Positions are the indices: key t is visible to query s when
    ``t <= s`` (if causal) and ``s - t < window`` (if window > 0).  Any S
    and T; on CUDA, D in (16, 32, 64, 128, 256) and f32, bf16 or f16."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise KernelError(f"flash_attention: q, k, v must share one CUDA "
                          f"device (got {q.device}, {k.device}, {v.device})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise KernelError(f"flash_attention: needs q, k, v of one type among "
                          f"f32, bf16, f16 (got {q.dtype}, {k.dtype}, "
                          f"{v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise KernelError(f"flash_attention: needs q (B,S,H,D) and k, v "
                          f"(B,T,K,D) (got {tuple(q.shape)}, "
                          f"{tuple(k.shape)}, {tuple(v.shape)})")
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != D or H % K or D not in HEAD_DIMS
            or B * H > 65535 or min(B, S, T) < 1):
        raise KernelError(f"flash_attention: unsupported shapes q "
                          f"{tuple(q.shape)}, k {tuple(k.shape)} (H % K == 0, "
                          f"D in {HEAD_DIMS}, B*H <= 65535)")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise KernelError("flash_attention: the head dim must be contiguous")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, H, K, S, T, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(bool(causal)), int(window), 1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise KernelError("flash_attention launch failed: "
                          + lib.flash_attention_error(rc).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
