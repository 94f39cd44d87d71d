"""Wrapper of the flash attention kernels (K5).

For tensors on the CPU :func:`flash_attention` runs the kernels' plain
version (:mod:`.ref`); for CUDA tensors it launches one of two CUDA
sources (built by nvcc on first use, see :mod:`repro_torch._build`) on
PyTorch's current stream, or raises :class:`~repro_torch.kernels.KernelError`.
Which one is a rule on the type and the head dims alone (:func:`variant`):

- ``"flash_tc"`` (``csrc/flash_tc.cu``, wgmma on the tensor cores, tiles
  fed by TMA): bf16 and f16 with (q/k, v) head dims (64, 64), (128, 128)
  or (256, 256), the head dims of qwen2, qwen3, mistral-nemo and gemma3,
  and (192, 128), deepseek-v2's MLA (v narrower than q and k).  TMA reads
  q, k and v in place, so their base addresses and strides must be
  multiples of 16 bytes (:func:`tma_misalignment`); a call that breaks
  this raises.
- ``"flash"`` (``csrc/flash.cu``, f32 FMAs on the CUDA cores): f32 at any
  supported D (no TF32 enters), and bf16 / f16 at D in (16, 32), with one
  D for q, k and v.

No call gives way from one kernel to the other, or to the plain version.
``flash_attention.launches`` counts every launch, and
``flash_attention.variant_launches`` counts them by variant.
:func:`tolerance` states how far each variant may lie from the plain
version.

Under autograd (grad enabled and an input that requires grad) the call is
a :class:`torch.autograd.Function` whose forward is the same dispatch and
whose backward is :func:`flash_attention_bwd`: on the CPU the plain
version :func:`.ref.flash_attention_bwd_ref`; on CUDA one of two
hand-written kernels, by a rule on the type and the head dims alone
(:func:`bwd_variant`):

- ``"flash_bwd_tc"`` (``csrc/flash_bwd_tc.cu``, every product on wgmma,
  tiles fed by TMA, no atomics): bf16 and f16 at (64, 64), (128, 128)
  and (192, 128).  It takes p from the forward's log-sum-exp, which the
  Function's forward asks ``flash_tc.cu`` for and saves.
- ``"flash_bwd"`` (``csrc/flash_bwd.cu``, f32 sums on the CUDA cores, two
  launches a call and no atomics): every other case the forward takes.

No backward call gives way from one kernel to the other, or to the plain
version.  ``flash_attention.bwd_launches`` counts backward calls on the
card and ``flash_attention.bwd_variant_launches`` counts them by variant;
:func:`bwd_tolerance` states how far each kernel's gradients may lie from
the plain version's.

Both directions are PyTorch custom ops, ``repro_torch::flash_fwd`` and
``repro_torch::flash_bwd`` (:func:`flash_fwd`, :func:`flash_bwd`): their
CUDA implementations are the launches above, their CPU implementations the
plain versions, and their fake implementations give the outputs' shapes,
types and strides without computing, so that a trace under
``FakeTensorMode`` (the dry run, :mod:`repro_torch.launch.dryrun`) holds
K5's calls.  :func:`fwd_flops` and :func:`bwd_flops` are their FLOP
formulas, registered with ``torch.utils.flop_counter``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import _build
from repro_torch.kernels import KernelError, route_devices, row_major
from repro_torch.kernels.flash_attention.ref import (BQ_LSE,
                                                    flash_attention_bwd_ref,
                                                    flash_attention_lse_ref,
                                                    flash_attention_ref)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"flash_tc": CSRC / "flash_tc.cu", "flash": CSRC / "flash.cu"}
ENTRY = {"flash_tc": "flash_tc", "flash": "flash_attention"}
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)
TC_DTYPES = (torch.bfloat16, torch.float16)
#: the tensor-core kernel's (q/k, v) head dims
TC_HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))

#: unit roundoff of the type P is rounded to before the tensor cores' PV
UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
BWD_SOURCES = {"flash_bwd_tc": CSRC / "flash_bwd_tc.cu",
               "flash_bwd": CSRC / "flash_bwd.cu"}
#: the CUDA-core backward, which takes every case the forward takes
BWD_SOURCE = BWD_SOURCES["flash_bwd"]
#: the CUDA-core backward's (q/k, v) head dims, in each of the three types
BWD_HEAD_DIMS = tuple((D, D) for D in HEAD_DIMS) + ((192, 128),)
#: the tensor-core backward's (q/k, v) head dims, bf16 and f16
BWD_TC_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))

_LIBS: dict[str, ctypes.CDLL] = {}


def variant(dtype: torch.dtype, dqk: int, dv: int | None = None) -> str:
    """The kernel a CUDA call of this type and these head dims (q and k's
    ``dqk``, v's ``dv``, by default ``dqk``) launches."""
    if dtype in TC_DTYPES and (dqk, dqk if dv is None else dv) in TC_HEAD_DIMS:
        return "flash_tc"
    return "flash"


def bwd_variant(dtype: torch.dtype, dqk: int, dv: int | None = None) -> str:
    """The backward kernel a CUDA call of this type and these head dims
    launches: ``"flash_bwd_tc"`` for bf16 / f16 at
    :data:`BWD_TC_HEAD_DIMS`, ``"flash_bwd"`` for every other case.

    (256, 256) stays on ``flash_bwd.cu``: a warpgroup of the tensor-core
    kernel's dK/dV launch holds dK and dV of its 64 keys in f32 across the
    whole query loop beside its S^T and dP^T fragments (32 registers
    each), 128 + 128 + 64 registers a thread at (256, 256), beyond the 255
    a thread may have.  f32 (no TF32 enters) and D 16/32 stay there as
    they stay on ``flash.cu`` in the forward."""
    if (dtype in TC_DTYPES
            and (dqk, dqk if dv is None else dv) in BWD_TC_HEAD_DIMS):
        return "flash_bwd_tc"
    return "flash_bwd"


def tolerance(variant_name: str, dtype: torch.dtype, v) -> dict:
    """``rtol``/``atol`` within which the kernel ``variant_name`` equals the
    plain version on the same inputs (v is the call's value tensor).

    Both compute the scores and the softmax in f32 and differ in the order
    of their sums; a bf16 or f16 output may then round to the neighbouring
    number on either side (two output roundings: rtol 2**-7 for bf16,
    2**-10 for f16; f32: rtol 1e-5, atol 2e-5).  ``flash_tc`` also rounds
    P to the input type before the PV product, as every tensor-core flash
    kernel does: with u the type's unit roundoff (2**-8 bf16, 2**-11 f16)
    each weight moves by at most u * p, so the output moves by at most
    ``u * sum_t(p_t |v_t|) / l <= u * max|v|``.  That bound is its atol,
    taken from this call's v."""
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=2e-5)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    if variant_name == "flash_tc":
        return dict(rtol=rtol, atol=UNIT_ROUNDOFF[dtype]
                    * float(v.detach().abs().max()))
    return dict(rtol=rtol, atol=1e-5)


def tma_misalignment(t: torch.Tensor) -> str | None:
    """Why TMA cannot read the (B, rows, heads, D) tensor ``t`` in place
    (its base address or a stride not a multiple of 16 bytes), or None."""
    es = t.element_size()
    if t.data_ptr() % 16:
        return f"base address {t.data_ptr():#x} is not 16-byte aligned"
    bad = [i for i in range(3) if (t.stride(i) * es) % 16]
    if bad:
        return (f"strides {tuple(t.stride())} (elements of {es} bytes): "
                f"dims {bad} are not multiples of 16 bytes")
    return None


def library(variant_name: str = "flash_tc") -> ctypes.CDLL:
    """The built library of one kernel (nvcc runs on the first call)."""
    lib = _LIBS.get(variant_name)
    if lib is None:
        lib = _build.load(SOURCES[variant_name])
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        launch = getattr(lib, ENTRY[variant_name] + "_launch")
        # flash_tc also takes the log-sum-exp's buffer and DV
        tc = variant_name == "flash_tc"
        launch.argtypes = ([ptr] * (5 if tc else 4) + [i32] * (8 if tc else 7)
                           + [i64] * 9 + [i32, i32, ctypes.c_float, ptr])
        launch.restype = i32
        error = getattr(lib, ENTRY[variant_name] + "_error")
        error.argtypes = [i32]
        error.restype = ctypes.c_char_p
        _LIBS[variant_name] = lib
    return lib


def bwd_tolerance(variant_name: str, dtype: torch.dtype) -> float:
    """The relative L2 distance (``||a - b|| / ||b||``, each of dq, dk and
    dv) within which the backward kernel ``variant_name`` equals
    :func:`.ref.flash_attention_bwd_ref` on the same inputs.

    ``flash_bwd`` (``csrc/flash_bwd.cu``): both compute every product and
    sum in f32 from the same inputs and the same forward output, and differ
    only in the order of their sums; then each rounds its gradients to the
    inputs' type.  A rounding to nearest moves an element by at most u
    times its size (u = 2**-8 bf16, 2**-11 f16), and the two may round to
    neighbours on either side: 2u, 2**-7 for bf16 and 2**-10 for f16.  In
    f32 only the sums' orders differ: at most about sqrt(n) u32 times a
    gradient's condition (the sum of its terms' sizes over its size), 1e-4
    for n up to 2**14 terms at a condition up to 200 (u32 = 2**-24).

    ``flash_bwd_tc`` (``csrc/flash_bwd_tc.cu``, bf16 and f16): 4u, 2**-6
    for bf16 and 2**-9 for f16.  Beyond the 2u of the outputs' roundings it
    rounds two operands to the input type before their products, as every
    tensor-core flash backward does: P before dV = P^T dO, and dS before
    dQ = dS K and dK = dS^T Q.  Each rounded element moves by at most u of
    itself, by roundings to nearest that are independent and of mean 0, so
    a gradient y = sum_t a_t b_t whose a_t are rounded moves by a root mean
    square of at most u * ||(sum_t (a_t b_t)**2)**0.5|| / ||y||: u times
    the ratio of its terms' root sum of squares to its size, 1 for terms of
    independent signs (dS sums to 0 along a row, and dO, Q and K carry no
    sign), taken here up to 2: 2u.  p itself comes from the forward's
    log-sum-exp through ex2.approx (2**-22 relative) and the f32 rounding
    of s * scale_log2 - lse2 (|lse2| 2**-24, below 2**-18 while |lse2| <
    64): far below u.  In f16, dS is rounded to f16, whose normal range
    starts at 2**-14: a backward whose dS lies below it (f16 without loss
    scaling) loses those terms; bf16 keeps f32's range."""
    if variant_name == "flash_bwd_tc":
        return 4 * UNIT_ROUNDOFF[dtype]
    return {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}[dtype]


def _check_device(name, *ts) -> None:
    """Raise unless every tensor lies on the CPU or on CUDA (a fake CUDA
    tensor of a trace counts as CUDA; meta tensors pass inside
    :func:`repro_torch.kernels.meta_route`): any other device is refused
    before the op is called."""
    if any(t.device.type not in ("cpu", *route_devices()) for t in ts):
        raise KernelError(f"{name}: needs CPU or CUDA tensors, one CUDA "
                          f"device (got "
                          + ", ".join(str(t.device) for t in ts) + ")")


#: K5's and K6's custom ops (``torch.library``), defined with their schemas
#: and implemented for the CPU and CUDA dispatch keys directly: no Python
#: autograd layer sits between a call and its kernel, as one would with
#: ``torch.library.custom_op`` (K5 and K6 carry their own autograd
#: Functions)
LIB = torch.library.Library("repro_torch", "FRAGMENT")
LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, int window, "
           "bool with_lse) -> (Tensor, Tensor)")
LIB.define("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor dout, "
           "Tensor? lse, bool causal, int window) -> (Tensor, Tensor, Tensor)")


def _lse_rows(S: int) -> int:
    return -(-S // BQ_LSE) * BQ_LSE


def _no_lse(q):
    return q.new_empty((0,), dtype=torch.float32)


def _flash_fwd_cpu(q, k, v, causal, window, with_lse):
    out = row_major(flash_attention_ref(q, k, v, causal=causal,
                                        window=window))
    if not with_lse:
        return out, _no_lse(q)
    B, S, H, _ = q.shape
    lse = torch.full((B, H, _lse_rows(S)), math.inf, dtype=torch.float32)
    lse[..., :S] = flash_attention_lse_ref(q, k, v, causal=causal,
                                           window=window)
    return out, lse


def _flash_fwd_cuda(q, k, v, causal, window, with_lse):
    if with_lse:
        return launch("flash_tc", q, k, v, causal=causal, window=window,
                      with_lse=True)
    return launch(variant(q.dtype, q.shape[-1], v.shape[-1]), q, k, v,
                  causal=causal, window=window), _no_lse(q)


@torch.library.register_fake("repro_torch::flash_fwd")
def _flash_fwd_fake(q, k, v, causal, window, with_lse):
    B, S, H, _ = q.shape
    out = q.new_empty((B, S, H, v.shape[-1]))
    if not with_lse:
        return out, _no_lse(q)
    return out, q.new_empty((B, H, _lse_rows(S)), dtype=torch.float32)


def _flash_bwd_cpu(q, k, v, out, dout, lse, causal, window):
    return tuple(row_major(t) for t in flash_attention_bwd_ref(
        q, k, v, out, dout, causal=causal, window=window))


def _flash_bwd_cuda(q, k, v, out, dout, lse, causal, window):
    return bwd_launch(bwd_variant(q.dtype, q.shape[-1], v.shape[-1]), q, k,
                      v, out, dout, causal=causal, window=window, lse=lse)


@torch.library.register_fake("repro_torch::flash_bwd")
def _flash_bwd_fake(q, k, v, out, dout, lse, causal, window):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            torch.empty_like(k, memory_format=torch.contiguous_format),
            torch.empty_like(v, memory_format=torch.contiguous_format))


LIB.impl("flash_fwd", _flash_fwd_cpu, "CPU")
LIB.impl("flash_fwd", _flash_fwd_cuda, "CUDA")
LIB.impl("flash_bwd", _flash_bwd_cpu, "CPU")
LIB.impl("flash_bwd", _flash_bwd_cuda, "CUDA")

#: ``repro_torch::flash_fwd(q, k, v, causal, window, with_lse)`` -> (out
#: (B,S,H,DV) in q's type, lse): K5's forward.  CUDA: the kernel
#: :func:`variant` names, or ``flash_tc.cu`` with its log-sum-exp where
#: ``with_lse`` (lse then (B, H, S rounded up to :data:`.ref.BQ_LSE`) f32,
#: else empty (0,)).  CPU: the plain versions.  Fake: the shapes.
flash_fwd = torch.ops.repro_torch.flash_fwd.default
#: ``repro_torch::flash_bwd(q, k, v, out, dout, lse, causal, window)`` ->
#: (dq, dk, dv) in the inputs' types: K5's backward.  CUDA: the kernel
#: :func:`bwd_variant` names (``flash_bwd_tc`` reads ``lse``).  CPU: the
#: plain backward (``lse`` unread).  Fake: the shapes.
flash_bwd = torch.ops.repro_torch.flash_bwd.default


@functools.lru_cache(maxsize=4096)
def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a head that the mask lets through: key t is
    visible to query s when ``t <= s`` (if causal) and ``s - t < window``
    (if window > 0), as :func:`.ref.attention_mask` states it."""
    s = np.arange(S, dtype=np.int64)
    hi = np.minimum(s, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(s - window + 1, 0) if window > 0 else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def fwd_flops(q_shape, k_shape, v_shape, causal: bool, window: int) -> int:
    """K5's forward FLOPs, as PERF.md's bound counts them: the two products
    (scores and PV) over the visible pairs, ``B·H·pairs·2·(D + DV)``."""
    B, S, H, D = q_shape
    return B * H * visible_pairs(S, k_shape[1], causal, window) * 2 * (
        D + v_shape[-1])


def bwd_flops(q_shape, k_shape, v_shape, causal: bool, window: int) -> int:
    """K5's backward FLOPs, as PERF.md's bound counts them: the scores
    again, dP = dO V^T, dV = P^T dO, dQ = dS K and dK = dS^T Q over the
    visible pairs, ``2·B·H·pairs·(3D + 2DV)``."""
    B, S, H, D = q_shape
    return 2 * B * H * visible_pairs(S, k_shape[1], causal, window) * (
        3 * D + 2 * v_shape[-1])


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_flop(q_shape, k_shape, v_shape, causal, window, with_lse,
                    *args, **kwargs) -> int:
    return fwd_flops(q_shape, k_shape, v_shape, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _flash_bwd_flop(q_shape, k_shape, v_shape, o_shape, do_shape,
                    lse_shape, causal, window, *args, **kwargs) -> int:
    return bwd_flops(q_shape, k_shape, v_shape, causal, window)


def _forward(q, k, v, causal, window):
    _check_device("flash_attention", q, k, v)
    return flash_fwd(q, k, v, causal, window, False)[0]


class _FlashAttention(torch.autograd.Function):
    """K5 under autograd: the forward op (on the card with the
    log-sum-exp where the backward's rule picks ``flash_bwd_tc``), and the
    backward op (its plain version on the CPU) for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        lse = None
        if (q.device.type != "cpu"
                and bwd_variant(q.dtype, q.shape[-1], v.shape[-1])
                == "flash_bwd_tc"):
            out, lse = flash_fwd(q, k, v, causal, window, True)
        else:
            out = flash_fwd(q, k, v, causal, window, False)[0]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window = ctx.mask
        dout = dout.contiguous()         # autograd's layout, not the caller's
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                         window=window, lse=lse)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,D); k: (B,T,K,D) with H % K == 0; v: (B,T,K,DV) -> (B,S,H,DV)
    in q's type, the scores scaled by ``1/sqrt(D)``.  Positions are the
    indices: key t is visible to query s when ``t <= s`` (if causal) and
    ``s - t < window`` (if window > 0).  Any S and T; on CUDA, f32, bf16 or
    f16 with DV = D in (16, 32, 64, 128, 256), or bf16 / f16 at (D, DV) =
    (192, 128), on the kernel that :func:`variant` names.  Under autograd
    the gradient of q, k and v comes from :func:`flash_attention_bwd`."""
    _check_device("flash_attention", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return flash_fwd(q, k, v, causal, window, False)[0]


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True,
                        window: int = 0, lse=None):
    """The gradient of :func:`flash_attention` at ``(q, k, v)``, whose
    output was ``out``, for the output's gradient ``dout`` -> (dq, dk, dv)
    in the inputs' types.  CPU tensors: the plain version (``lse`` unused).
    CUDA tensors: the kernel that :func:`bwd_variant` names, or
    :class:`KernelError`; nothing gives way to the other kernel or to the
    plain version.  ``lse``: the forward's log-sum-exp
    (``launch("flash_tc", ..., with_lse=True)``), which ``flash_bwd_tc``
    needs and ``flash_bwd`` does not read."""
    _check_device("flash_attention_bwd", q, k, v, out, dout)
    return flash_bwd(q, k, v, out, dout, lse, causal, window)


def bwd_launch(variant_name: str, q, k, v, out, dout, *, causal: bool = True,
               window: int = 0, lse=None):
    """Launch the backward kernel ``variant_name`` on CUDA tensors (the
    entry :func:`flash_attention_bwd` takes; called directly only to time
    or test the CUDA-core kernel where the rule picks the other)."""
    dev = q.device
    ins = (q, k, v, out, dout)
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise KernelError("flash_attention_bwd: q, k, v, out, dout must "
                          "share one CUDA device (got "
                          + ", ".join(str(t.device) for t in ins) + ")")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in ins):
        raise KernelError(f"flash_attention_bwd: needs one type among f32, "
                          f"bf16, f16 (got {[str(t.dtype) for t in ins]})")
    if any(t.dim() != 4 for t in ins) or v.shape[:3] != k.shape[:3]:
        raise KernelError(f"flash_attention_bwd: needs q (B,S,H,D), k "
                          f"(B,T,K,D), v (B,T,K,DV) (got "
                          f"{[tuple(t.shape) for t in ins]})")
    B, S, H, D = q.shape
    T, K, DV = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape[0] != B or k.shape[3] != D or H % K or B * H > 65535
            or out.shape != (B, S, H, DV) or dout.shape != out.shape):
        raise KernelError(f"flash_attention_bwd: unsupported shapes "
                          f"{[tuple(t.shape) for t in ins]} (H % K == 0, "
                          f"B*H <= 65535, out and dout (B,S,H,DV))")
    if any(t.stride(3) != 1 for t in ins):
        raise KernelError("flash_attention_bwd: the head dim must be "
                          "contiguous")
    if variant_name not in BWD_SOURCES:
        raise KernelError(f"flash_attention_bwd: no backward kernel "
                          f"{variant_name!r} (one of {tuple(BWD_SOURCES)})")
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, T, K, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, T, K, DV), dtype=q.dtype, device=dev)
    if variant_name == "flash_bwd_tc":
        if q.dtype not in TC_DTYPES or (D, DV) not in BWD_TC_HEAD_DIMS:
            raise KernelError(f"flash_attention_bwd: flash_bwd_tc takes bf16 "
                              f"or f16 at (D, DV) in {BWD_TC_HEAD_DIMS} (got "
                              f"{q.dtype}, D={D}, DV={DV})")
        for name, t in zip(("q", "k", "v", "out", "dout"), ins):
            why = tma_misalignment(t)
            if why:
                raise KernelError(f"flash_attention_bwd: flash_bwd_tc cannot "
                                  f"read {name}: {why}")
        SP = -(-S // BQ_LSE) * BQ_LSE
        if (lse is None or lse.device != dev or lse.dtype != torch.float32
                or lse.shape != (B, H, SP) or not lse.is_contiguous()
                or lse.data_ptr() % 16):          # the bulk copies' alignment
            raise KernelError(
                f"flash_attention_bwd: flash_bwd_tc needs the forward's "
                f"log-sum-exp, a contiguous (B, H, {SP}) f32 tensor on {dev} "
                f"(launch('flash_tc', ..., with_lse=True)); got "
                + ("none" if lse is None else
                   f"{tuple(lse.shape)} {lse.dtype} on {lse.device}"))
        # the log-sum-exp, the gradients, then Di and each query head's
        # f32 partials of dK and dV
        bufs = (lse, dq, dk, dv, torch.empty((B, H, SP), **f32),
                torch.empty((B, T, H, D), **f32),
                torch.empty((B, T, H, DV), **f32))
        scales = (math.log2(math.e) / math.sqrt(D), 1.0 / math.sqrt(D))
    else:
        if (D, DV) not in BWD_HEAD_DIMS:
            raise KernelError(f"flash_attention_bwd: (D, DV) = ({D}, {DV}) "
                              f"is not among {BWD_HEAD_DIMS}")
        # the gradients, then each row's m, l and Di
        bufs = (dq, dk, dv, *torch.empty((3, B, H, S), **f32))
        scales = (1.0 / math.sqrt(D),)
    lib = bwd_library(variant_name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, variant_name + "_launch")(
            *(t.data_ptr() for t in (*ins, *bufs)), DTYPES[q.dtype], B, H,
            K, S, T, D, DV, *(t.stride(i) for t in ins for i in range(3)),
            int(bool(causal)), int(window), *scales, stream)
    if rc != 0:
        raise KernelError(f"flash_attention_bwd ({variant_name}) launch "
                          f"failed: "
                          + getattr(lib, variant_name + "_error")(rc).decode())
    flash_attention.bwd_launches += 1
    flash_attention.bwd_variant_launches[variant_name] += 1
    return dq, dk, dv


def bwd_library(variant_name: str = "flash_bwd") -> ctypes.CDLL:
    """The built backward kernel (nvcc runs on the first call)."""
    lib = _LIBS.get(variant_name)
    if lib is None:
        lib = _build.load(BWD_SOURCES[variant_name])
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # flash_bwd_tc also takes the log-sum-exp, Di's and the partials'
        # buffers in place of m, l and Di, and scale_log2 beside the scale
        tc = variant_name == "flash_bwd_tc"
        fn = getattr(lib, variant_name + "_launch")
        fn.argtypes = ([ptr] * (12 if tc else 11) + [i32] * 8 + [i64] * 15
                       + [i32, i32] + [ctypes.c_float] * (2 if tc else 1)
                       + [ptr])
        fn.restype = i32
        error = getattr(lib, variant_name + "_error")
        error.argtypes = [i32]
        error.restype = ctypes.c_char_p
        _LIBS[variant_name] = lib
    return lib


def launch(variant_name: str, q, k, v, *, causal: bool = True,
           window: int = 0, with_lse: bool = False):
    """Launch the kernel ``variant_name`` on CUDA tensors (the entry
    :func:`flash_attention` takes; called directly only to time the
    CUDA-core kernel where the rule picks the other).  ``with_lse`` (on
    ``flash_tc`` only) -> (out, lse): lse (B, H, S rounded up to
    :data:`.ref.BQ_LSE`) f32, each row's log-sum-exp in the log2 domain, as
    :func:`.ref.flash_attention_lse_ref` states it (+inf on the rows past
    S); the output's bits are those of the call without it."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise KernelError(f"flash_attention: q, k, v must share one CUDA "
                          f"device (got {q.device}, {k.device}, {v.device})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise KernelError(f"flash_attention: needs q, k, v of one type among "
                          f"f32, bf16, f16 (got {q.dtype}, {k.dtype}, "
                          f"{v.dtype})")
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or v.shape[:3] != k.shape[:3]):
        raise KernelError(f"flash_attention: needs q (B,S,H,D), k (B,T,K,D) "
                          f"and v (B,T,K,DV) (got {tuple(q.shape)}, "
                          f"{tuple(k.shape)}, {tuple(v.shape)})")
    B, S, H, D = q.shape
    T, K, DV = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape[0] != B or k.shape[3] != D or H % K
            or B * H > 65535 or min(B, S, T) < 1):
        raise KernelError(f"flash_attention: unsupported shapes q "
                          f"{tuple(q.shape)}, k {tuple(k.shape)} (H % K == 0, "
                          f"B*H <= 65535)")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise KernelError("flash_attention: the head dim must be contiguous")
    if with_lse and variant_name != "flash_tc":
        raise KernelError(f"flash_attention: {variant_name} writes no "
                          f"log-sum-exp")
    lse = None
    if variant_name == "flash_tc":
        if q.dtype not in TC_DTYPES or (D, DV) not in TC_HEAD_DIMS:
            raise KernelError(f"flash_attention: flash_tc takes bf16 or f16 "
                              f"at (D, DV) in {TC_HEAD_DIMS} (got {q.dtype}, "
                              f"D={D}, DV={DV})")
        for name, t in (("q", q), ("k", k), ("v", v)):
            why = tma_misalignment(t)
            if why:
                raise KernelError(f"flash_attention: TMA cannot read {name}: "
                                  f"{why}")
        scale = math.log2(math.e) / math.sqrt(D)
        dims = (D, DV)
        if with_lse:
            lse = torch.empty((B, H, -(-S // BQ_LSE) * BQ_LSE),
                              dtype=torch.float32, device=dev)
    else:
        if D not in HEAD_DIMS or DV != D:
            raise KernelError(f"flash_attention: flash takes D in {HEAD_DIMS} "
                              f"with one D for q, k and v (got D={D}, "
                              f"DV={DV})")
        scale = 1.0 / math.sqrt(D)
        dims = (D,)
    out = torch.empty((B, S, H, DV), dtype=q.dtype, device=dev)
    lib = library(variant_name)
    entry = ENTRY[variant_name]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if variant_name == "flash_tc":
        ptrs.append(None if lse is None else lse.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry + "_launch")(
            *ptrs, DTYPES[q.dtype], B, H, K, S, T, *dims,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(bool(causal)), int(window), scale, stream)
    if rc != 0:
        raise KernelError(f"flash_attention ({variant_name}) launch failed: "
                          + getattr(lib, entry + "_error")(rc).decode())
    flash_attention.launches += 1
    flash_attention.variant_launches[variant_name] += 1
    return out if lse is None else (out, lse)


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(SOURCES, 0)
flash_attention.bwd_launches = 0
flash_attention.bwd_variant_launches = dict.fromkeys(BWD_SOURCES, 0)
