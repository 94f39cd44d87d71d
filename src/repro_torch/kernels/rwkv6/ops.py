"""Wrapper of the WKV6 kernel (K6) and its backward.

For tensors on the CPU :func:`wkv6` runs the kernel's plain version
(:func:`.ref.wkv6_ref`); for CUDA tensors it launches ``csrc/wkv6.cu``
(built by nvcc on first use, see :mod:`repro_torch._build`) on PyTorch's
current stream, or raises :class:`~repro_torch.kernels.KernelError`.  A
call is three CUDA launches (the chunks' own parts, the scan of the state
over the chunks, the chunks' inter-chunk parts) into a scratch of one
(D, D) increment a chunk that the wrapper allocates; ``wkv6.launches``
counts calls, one a layer of the prefill.

Under autograd (grad enabled and an input that requires grad) the call is
a :class:`torch.autograd.Function` on f32 copies of the inputs (so each
input's gradient comes back in its own type) whose forward is the same
dispatch and whose backward is :func:`wkv6_bwd`: on the CPU the plain
version :func:`.ref.wkv6_bwd_ref`; on CUDA ``csrc/wkv6_bwd.cu``, four
launches (a pre-pass, the adjoint scan over the chunks, one fused chunk
pass whose factored decays run on split-TF32 tensor cores, du) that read
the forward's scratch, which then holds each chunk's starting state and
which the Function keeps.  No call on CUDA gives way to
a plain version; ``wkv6.bwd_launches`` counts backward calls on the card.

Both directions are PyTorch custom ops, ``repro_torch::wkv6_fwd`` and
``repro_torch::wkv6_bwd`` (:func:`wkv6_fwd`, :func:`wkv6_bwd_op`): their
CUDA implementations are the launches above, their CPU implementations the
plain versions, and their fake implementations give the outputs' shapes
without computing (the forward's each chunk's starting state too, which
the backward reads), so that a trace under ``FakeTensorMode`` holds K6's
calls.  :func:`fwd_flops` and :func:`bwd_flops` are their operation counts,
registered with ``torch.utils.flop_counter``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import _build
from repro_torch.kernels import KernelError, route_devices, row_major
from repro_torch.kernels.rwkv6.ref import _work_type, wkv6_bwd_ref, wkv6_ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "wkv6.cu"
BWD_SOURCE = CSRC / "wkv6_bwd.cu"
MAX_D = 64
MAX_CHUNK = 64

_LIBS: dict[str, ctypes.CDLL] = {}


def _load(source: Path, entry: str, n_ptrs: int) -> ctypes.CDLL:
    lib = _LIBS.get(entry)
    if lib is None:
        lib = _build.load(source)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        launch = getattr(lib, entry + "_launch")
        launch.argtypes = [ptr] * n_ptrs + [i32] * 5 + [ptr]
        launch.restype = i32
        error = getattr(lib, entry + "_error")
        error.argtypes = [i32]
        error.restype = ctypes.c_char_p
        _LIBS[entry] = lib
    return lib


def library() -> ctypes.CDLL:
    """The built forward kernel library (nvcc runs on the first call)."""
    return _load(SOURCE, "wkv6", 10)


def bwd_library() -> ctypes.CDLL:
    """The built backward kernel library (nvcc runs on the first call)."""
    return _load(BWD_SOURCE, "wkv6_bwd", 17)


def _check(r, k, v, logw, u, state0, chunk, devices=("cuda",)) -> None:
    """Raise unless the inputs are in the CUDA kernels' contract, on one
    device of a type in ``devices`` (the ops' route: :func:`repro_torch.
    kernels.route_devices`)."""
    ins = (r, k, v, logw, u) + (() if state0 is None else (state0,))
    dev = r.device
    if dev.type not in devices or any(t.device != dev for t in ins):
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


def _launch(r, k, v, logw, u, state0, chunk):
    """K6 on f32 CUDA tensors -> (y, the final state, each chunk's starting
    state (B, H, nC, D, D): the scratch after the launches)."""
    dev = r.device
    f32 = torch.float32
    r, k, v, logw, u = (t.contiguous() for t in (r, k, v, logw, u))
    if state0 is not None:
        state0 = state0.contiguous()
    B, S, H, D = r.shape
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
    return y, s_end, inc


# K6's custom ops, beside K5's in the same library (see
# :data:`repro_torch.kernels.flash_attention.ops.LIB`)
LIB = torch.library.Library("repro_torch", "FRAGMENT")
LIB.define("wkv6_fwd(Tensor r, Tensor k, Tensor v, Tensor logw, Tensor u, "
           "Tensor? state0, int chunk) -> (Tensor, Tensor, Tensor)")
LIB.define("wkv6_bwd(Tensor r, Tensor k, Tensor v, Tensor logw, Tensor u, "
           "Tensor dy, Tensor? state0, Tensor? ds_end, Tensor starts, "
           "int chunk) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")


def _wkv6_fwd_cpu(r, k, v, logw, u, state0, chunk):
    return tuple(row_major(t) for t in wkv6_ref(
        r, k, v, logw, u, chunk=chunk, state0=state0, starts=True))


def _wkv6_fwd_cuda(r, k, v, logw, u, state0, chunk):
    return _launch(r, k, v, logw, u, state0, chunk)


@torch.library.register_fake("repro_torch::wkv6_fwd")
def _wkv6_fwd_fake(r, k, v, logw, u, state0, chunk):
    B, S, H, D = r.shape
    f32 = _work_type(r)
    return (r.new_empty((B, S, H, D), dtype=f32),
            r.new_empty((B, H, D, D), dtype=f32),
            r.new_empty((B, H, -(-S // chunk), D, D), dtype=f32))


def _wkv6_bwd_cpu(r, k, v, logw, u, dy, state0, ds_end, starts, chunk):
    return tuple(row_major(t) for t in wkv6_bwd_ref(
        r, k, v, logw, u, dy, chunk=chunk, state0=state0, ds_end=ds_end))


def _wkv6_bwd_cuda(r, k, v, logw, u, dy, state0, ds_end, starts, chunk):
    return bwd_launch(r, k, v, logw, u, dy, chunk=chunk, state0=state0,
                      ds_end=ds_end, starts=starts)


@torch.library.register_fake("repro_torch::wkv6_bwd")
def _wkv6_bwd_fake(r, k, v, logw, u, dy, state0, ds_end, starts, chunk):
    B, S, H, D = r.shape
    f32 = _work_type(r)
    return (*(r.new_empty((B, S, H, D), dtype=f32) for _ in range(4)),
            r.new_empty((H, D), dtype=f32),
            r.new_empty((B, H, D, D), dtype=f32))


LIB.impl("wkv6_fwd", _wkv6_fwd_cpu, "CPU")
LIB.impl("wkv6_fwd", _wkv6_fwd_cuda, "CUDA")
LIB.impl("wkv6_bwd", _wkv6_bwd_cpu, "CPU")
LIB.impl("wkv6_bwd", _wkv6_bwd_cuda, "CUDA")

#: ``repro_torch::wkv6_fwd(r, k, v, logw, u, state0, chunk)`` on f32
#: tensors -> (y (B,S,H,D), the final state (B,H,D,D), each chunk's
#: starting state (B,H,nC,D,D)): K6's forward.  CUDA: ``wkv6.cu``'s
#: launches (the starting states are their scratch).  CPU: the plain
#: version.  Fake: the shapes.
wkv6_fwd = torch.ops.repro_torch.wkv6_fwd.default
#: ``repro_torch::wkv6_bwd(r, k, v, logw, u, dy, state0, ds_end, starts,
#: chunk)`` on f32 tensors -> (dr, dk, dv, dlogw, du, dstate0): K6's
#: backward.  CUDA: ``wkv6_bwd.cu``, which reads ``starts``, the forward
#: op's starting states.  CPU: the plain backward (``starts`` unread).
#: Fake: the shapes.
wkv6_bwd_op = torch.ops.repro_torch.wkv6_bwd.default


def fwd_flops(B: int, S: int, H: int, D: int, chunk: int = 64) -> int:
    """K6's forward f32 operations, as PERF.md's bound counts them: a chunk
    of C tokens takes the intra-chunk scores (difference, exp, two products
    and a sum a pair and channel), their product with v, and the two (C, D)
    x (D, D) products of the state."""
    C, nC = chunk, -(-S // chunk)
    return B * H * nC * (4 * (C * (C - 1) // 2) * D + 2 * C * C * D
                         + 4 * C * D * D)


def bwd_flops(B: int, S: int, H: int, D: int, chunk: int = 64) -> int:
    """K6's backward f32 operations, as PERF.md's bound counts them: a
    chunk of C tokens (P pairs) takes the scores (9 a pair and channel with
    d_att, att^T dy and the decays' products), dr' and dk'' through the
    decays (4 a pair or token and channel), the four (C, D) x (D, D)
    products of the state's shares and the adjoint's update."""
    C, nC = chunk, -(-S // chunk)
    P = C * (C - 1) // 2
    return B * H * nC * (9 * P * D + 4 * (P + C) * D + 8 * C * D * D
                         + 2 * D * D)


@register_flop_formula(torch.ops.repro_torch.wkv6_fwd)
def _wkv6_fwd_flop(r_shape, *args, **kwargs) -> int:
    chunk = args[5] if len(args) > 5 else kwargs["chunk"]
    return fwd_flops(*r_shape, chunk=chunk)


@register_flop_formula(torch.ops.repro_torch.wkv6_bwd)
def _wkv6_bwd_flop(r_shape, *args, **kwargs) -> int:
    chunk = args[8] if len(args) > 8 else kwargs["chunk"]
    return bwd_flops(*r_shape, chunk=chunk)


class _WKV6(torch.autograd.Function):
    """K6 under autograd on f32 inputs: the forward op (keeping each
    chunk's starting state), and :func:`wkv6_bwd` for the gradient."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0, chunk):
        ctx.set_materialize_grads(False)
        y, s_end, starts = wkv6_fwd(r, k, v, logw, u, state0, chunk)
        ctx.save_for_backward(r, k, v, logw, u, state0, starts)
        ctx.chunk = chunk
        return y, s_end

    @staticmethod
    def backward(ctx, dy, ds_end):
        r, k, v, logw, u, state0, starts = ctx.saved_tensors
        if dy is None:           # only the final state was used
            dy = torch.zeros_like(r)
        dr, dk, dv, dw, du, ds0 = wkv6_bwd(
            r, k, v, logw, u, dy.contiguous(), chunk=ctx.chunk,
            state0=state0, ds_end=ds_end, starts=starts)
        return (dr, dk, dv, dw, du,
                ds0 if ctx.needs_input_grad[5] else None, None)


def wkv6(r, k, v, logw, u, *, chunk: int = 64, state0=None):
    """r/k/v/logw: (B,S,H,D); u: (H,D); state0: (B,H,D,D) or None (zeros)
    -> (y (B,S,H,D) f32, the state after the last token (B,H,D,D) f32).
    Inputs of any float type are read as f32.  S needs no padding: the tail
    of the last chunk counts as zero k and zero log-decay, as the
    reference's padding makes it.  On CUDA, D <= 64 and chunk <= 64.  Under
    autograd the inputs' gradients come from :func:`wkv6_bwd`."""
    ins = (r, k, v, logw, u) + (() if state0 is None else (state0,))
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
    if r.device.type != "cpu":
        _check(r, k, v, logw, u, state0, chunk, route_devices())
    f32 = torch.float32
    r, k, v, logw, u = (t.to(f32) for t in (r, k, v, logw, u))
    if state0 is not None:
        state0 = state0.to(f32)
    if grad:
        return _WKV6.apply(r, k, v, logw, u, state0, chunk)
    return wkv6_fwd(r, k, v, logw, u, state0, chunk)[:2]


def wkv6_bwd(r, k, v, logw, u, dy, *, chunk: int = 64, state0=None,
             ds_end=None, starts=None):
    """The gradient of :func:`wkv6` at ``(r, k, v, logw, u, state0)`` for
    the cotangents ``dy`` of y and ``ds_end`` of the final state (None:
    zero) -> ``(dr, dk, dv, dlogw, du, dstate0)`` f32.  CPU tensors: the
    plain version (``starts`` unread; without it the plain version is
    called directly).  CUDA tensors: ``csrc/wkv6_bwd.cu``, which needs
    ``starts``, each chunk's starting state as the forward op leaves it;
    nothing gives way to the plain version."""
    if starts is None:
        if r.device.type == "cpu":
            return wkv6_bwd_ref(r, k, v, logw, u, dy, chunk=chunk,
                                state0=state0, ds_end=ds_end)
        # refused by the launch's own checks (the states are its input)
        return bwd_launch(r, k, v, logw, u, dy, chunk=chunk, state0=state0,
                          ds_end=ds_end)
    if r.device.type != "cpu":
        _check(r, k, v, logw, u, state0, chunk, route_devices())
    return wkv6_bwd_op(r, k, v, logw, u, dy, state0, ds_end, starts, chunk)


def bwd_launch(r, k, v, logw, u, dy, *, chunk: int = 64, state0=None,
               ds_end=None, starts=None):
    """Launch K6's backward kernel on f32 CUDA tensors (the route
    :func:`wkv6_bwd` takes on the card)."""
    _check(r, k, v, logw, u, state0, chunk)
    B, S, H, D = r.shape
    dev = r.device
    f32 = torch.float32
    nC = -(-S // chunk)
    extra = [t for t in (dy, ds_end, starts) if t is not None]
    if any(t.device != dev for t in extra):
        raise KernelError("wkv6_bwd: dy, ds_end and the saved states must "
                          "lie on the inputs' device")
    ins = (r, k, v, logw, u, dy) + (() if state0 is None else (state0,))
    if any(t.dtype != f32 for t in ins + tuple(extra)):
        raise KernelError(f"wkv6_bwd: needs f32 tensors (got "
                          f"{[str(t.dtype) for t in ins + tuple(extra)]})")
    if (dy.shape != r.shape
            or (ds_end is not None and ds_end.shape != (B, H, D, D))
            or starts is None or starts.shape != (B, H, nC, D, D)
            or not starts.is_contiguous()):
        raise KernelError(
            f"wkv6_bwd: needs dy {tuple(r.shape)}, ds_end {(B, H, D, D)} or "
            f"None, and the forward's contiguous starting states "
            f"{(B, H, nC, D, D)} (got dy {tuple(dy.shape)}, ds_end "
            f"{None if ds_end is None else tuple(ds_end.shape)}, starts "
            f"{None if starts is None else tuple(starts.shape)})")
    r, k, v, logw, u, dy = (t.contiguous() for t in (r, k, v, logw, u, dy))
    if ds_end is not None:
        ds_end = ds_end.contiguous()
    dr, dk, dv, dw = (torch.empty((B, S, H, D), dtype=f32, device=dev)
                      for _ in range(4))
    du = torch.empty((H, D), dtype=f32, device=dev)
    ds0 = torch.empty((B, H, D, D), dtype=f32, device=dev)
    # each chunk's (r * exp(cum_prev))^T dy, then (in place) the state's
    # adjoint after it; each chunk's total log-decay and part of du
    q = torch.empty((B, H, nC, D, D), dtype=f32, device=dev)
    tot = torch.empty((B, H, nC, D), dtype=f32, device=dev)
    dup = torch.empty((B, H, nC, D), dtype=f32, device=dev)
    lib = bwd_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wkv6_bwd_launch(
            *(t.data_ptr() for t in (r, k, v, logw, u, dy, starts)),
            None if ds_end is None else ds_end.data_ptr(),
            *(t.data_ptr() for t in (dr, dk, dv, dw, du, ds0, q, tot, dup)),
            B, S, H, D, int(chunk), stream)
    if rc != 0:
        raise KernelError("wkv6_bwd launch failed: "
                          + lib.wkv6_bwd_error(rc).decode())
    wkv6.bwd_launches += 1
    return dr, dk, dv, dw, du, ds0


wkv6.launches = 0
wkv6.bwd_launches = 0
