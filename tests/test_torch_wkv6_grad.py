"""K6's backward on the CPU: the plain backward ``ref.wkv6_bwd_ref`` (the
gradient written out chunk by chunk in reverse) against ``jax.vjp`` of the
reference's chunked twin ``repro.nn.ssm.wkv6_chunked`` and of its exact
recurrence ``wkv6_scan``, with a ``state0`` and a cotangent for the
returned state, and against ``torch.autograd`` through the plain forward;
an emulation of ``csrc/wkv6_bwd.cu``'s algorithm
(``ref.wkv6_bwd_factored``: the pre-pass, the adjoint scan and the fused
chunk pass, its decays factored over sub-chunks of 16 with the diagonal
blocks exact, its products in split TF32) against the plain backward,
with the two witnesses of its design: under strong decay a single
reference point for the whole chunk overflows where the factored form
stays finite, and one-pass TF32 misses the gate the split holds; the
wrapper's autograd Function on the CPU (the plain backward, bit for bit),
a gradient check in f64, and the device check that refuses what the card
kernel cannot take.  Inputs are made with numpy and given to both
packages.

Tolerances, relative L2 a gradient: 1e-5 where the decays are those of
tests/test_torch_wkv6.py (only the order of f32 sums differs, measured
1e-7 to 3e-6); 1e-4 under strong decay (log-decays near -exp(2 +- 2 sigma),
cum down to -1e4, measured 1e-5 to 6e-5).  Under strong decay the
reference's chunked twin gives no finite dlogw under autodiff: it takes
exp of the pair decays above the diagonal too (positive exponents, inf in
f32) and masks them after, so their zero cotangent times inf is NaN; its
dlogw is held against the exact recurrence's there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.ssm import wkv6_chunked, wkv6_scan as ref_scan
from repro_torch.kernels import KernelError
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import (SUB, _chunks, tf32, tf32_mm,
                                           wkv6_bwd_factored, wkv6_bwd_ref,
                                           wkv6_ref)

TOL, TOL_STRONG = 1e-5, 1e-4
NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")


def _inputs(seed, B, S, H, D, strong=False):
    """-> numpy (r, k, v, logw, u, state0, dy, ds_end) f32."""
    rng = np.random.default_rng(seed)
    scale = 1.0 if strong else 0.5
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) * scale
               for _ in range(3))
    z = rng.standard_normal((B, S, H, D)).astype(np.float32)
    lw = -np.exp(z * 2.0 + 2.0 if strong else z * 0.5).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32) * scale
    s0, ds = (rng.standard_normal((B, H, D, D)).astype(np.float32)
              for _ in range(2))
    dy = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return r, k, v, lw, u, s0, dy, ds


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _plain(args, chunk, with_state=True):
    r, k, v, lw, u, s0, dy, ds = (torch.as_tensor(a) for a in args)
    return wkv6_bwd_ref(r, k, v, lw, u, dy, chunk=chunk,
                        state0=s0 if with_state else None,
                        ds_end=ds if with_state else None)


def _jax_vjp(fn, args):
    r, k, v, lw, u, s0, dy, ds = (jnp.asarray(a) for a in args)
    _, vjp = jax.vjp(fn, r, k, v, lw, u, s0)
    return vjp((dy, ds))


SHAPES = [(2, 128, 2, 16, 32), (1, 70, 2, 16, 32), (2, 100, 2, 8, 48),
          (1, 37, 2, 8, 64), (1, 5, 1, 4, 3), (1, 1, 2, 4, 8),
          (1, 200, 2, 16, 64)]


@pytest.mark.parametrize("B,S,H,D,chunk", SHAPES)
def test_plain_backward_equals_vjp_of_chunked(B, S, H, D, chunk):
    args = _inputs(B * S + D, B, S, H, D)
    got = _plain(args, chunk)
    want = _jax_vjp(lambda *a: wkv6_chunked(*a, chunk=chunk), args)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= TOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("B,S,H,D,chunk", SHAPES[:5])
def test_plain_backward_equals_vjp_of_scan(B, S, H, D, chunk):
    args = _inputs(B * S + H, B, S, H, D)
    got = _plain(args, chunk)
    want = _jax_vjp(lambda *a: ref_scan(*a), args)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), w) <= TOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("S,chunk,seed", [(96, 32, 0), (75, 16, 1),
                                          (50, 8, 2), (64, 64, 3)])
def test_plain_backward_under_strong_decay(S, chunk, seed):
    """Strong decay: every gradient finite; each within 1e-4 of the
    reference chunked twin's vjp, but dlogw, held against the exact
    recurrence's (see the module docstring)."""
    B, H, D = 1, 2, 8
    args = _inputs(seed, B, S, H, D, strong=True)
    got = _plain(args, chunk)
    assert all(torch.isfinite(g).all() for g in got)
    chunked = _jax_vjp(lambda *a: wkv6_chunked(*a, chunk=chunk), args)
    exact = _jax_vjp(lambda *a: ref_scan(*a), args)
    for i, (name, g) in enumerate(zip(NAMES, got)):
        want = exact[i] if name == "dlogw" else chunked[i]
        assert _rel(g.numpy(), want) <= TOL_STRONG, (name, _rel(g.numpy(),
                                                                want))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,D,chunk", SHAPES[:4])
def test_plain_backward_equals_autograd_through_plain_forward(
        B, S, H, D, chunk, with_state):
    args = _inputs(S + chunk, B, S, H, D)
    ins = [torch.as_tensor(a).requires_grad_(True) for a in args[:6]]
    dy, ds = torch.as_tensor(args[6]), torch.as_tensor(args[7])
    y, s = wkv6_ref(*ins[:5], chunk=chunk,
                    state0=ins[5] if with_state else None)
    outs = ((y, s), (dy, ds)) if with_state else ((y,), (dy,))
    want = torch.autograd.grad(outs[0], ins[:6] if with_state else ins[:5],
                               outs[1])
    got = _plain(args, chunk, with_state)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), w.numpy()) <= TOL, (name,
                                                   _rel(g.numpy(), w.numpy()))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,D,chunk,strong", [
    (2, 128, 3, 16, 32, False),    # whole chunks
    (1, 70, 2, 16, 32, False),     # a ragged tail
    (2, 100, 2, 40, 48, False),    # D not a power of two, chunk 48
    (1, 37, 2, 8, 64, False),      # one partial chunk
    (1, 96, 2, 8, 32, True),       # strong decay
    (1, 75, 3, 16, 16, True),      # strong decay, ragged
    (1, 5, 1, 4, 3, False)])       # a chunk of three tokens
def test_three_phase_backward_equals_plain(B, S, H, D, chunk, strong,
                                           with_state):
    args = _inputs(B * S + D, B, S, H, D, strong)
    r, k, v, lw, u, s0, dy, ds = (torch.as_tensor(a) for a in args)
    kw = dict(chunk=chunk, state0=s0 if with_state else None,
              ds_end=ds if with_state else None)
    got = wkv6_bwd_factored(r, k, v, lw, u, dy, **kw)
    want = wkv6_bwd_ref(r, k, v, lw, u, dy, **kw)
    tol = TOL_STRONG if strong else TOL
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        assert _rel(g.numpy(), w.numpy()) <= tol, (name,
                                                   _rel(g.numpy(), w.numpy()))


@pytest.mark.parametrize("B,S,H,D,chunk", [
    (1, 200, 2, 8, 64), (1, 150, 2, 16, 48), (1, 96, 2, 8, 32)])
def test_factored_backward_where_one_reference_point_overflows(B, S, H, D,
                                                               chunk):
    """Strong decay (log-decays -exp(2z + 2)): a single reference point for
    the whole chunk, its start, would scale k by exp(-cum), which passes
    f32's range (inf) on these draws; the emulation's factors, each taken
    against a sub-chunk's own reference, stay <= 1, and its gradients are
    finite and within TOL_STRONG of the plain backward."""
    args = _inputs(S + chunk, B, S, H, D, strong=True)
    r, k, v, lw, u, s0, dy, ds = (torch.as_tensor(a) for a in args)
    cum = torch.cumsum(_chunks(lw, chunk), dim=2)
    assert torch.isinf(_chunks(k, chunk).abs() * torch.exp(-cum)).any()
    kw = dict(chunk=chunk, state0=s0, ds_end=ds)
    got = wkv6_bwd_factored(r, k, v, lw, u, dy, **kw)
    want = wkv6_bwd_ref(r, k, v, lw, u, dy, **kw)
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        assert _rel(g.numpy(), w.numpy()) <= TOL_STRONG, (
            name, _rel(g.numpy(), w.numpy()))


@pytest.mark.parametrize("B,S,H,D,chunk,strong", [
    (1, 130, 2, 64, 64, False), (2, 100, 2, 40, 48, False),
    (1, 96, 2, 8, 32, True)])
def test_split_tf32_holds_the_gate_one_pass_misses(B, S, H, D, chunk,
                                                   strong):
    """The witness that the split is needed: on the same draws the
    emulation's products in split TF32 (hi.hi + hi.lo + lo.hi) stay within
    TOL of the plain backward in every gradient, while one TF32 product
    exceeds the card's 1e-4 gate in at least one."""
    args = _inputs(B * S + D, B, S, H, D, strong)
    r, k, v, lw, u, s0, dy, ds = (torch.as_tensor(a) for a in args)
    kw = dict(chunk=chunk, state0=s0, ds_end=ds)
    want = wkv6_bwd_ref(r, k, v, lw, u, dy, **kw)
    split = wkv6_bwd_factored(r, k, v, lw, u, dy, tf32_mode="split", **kw)
    one = wkv6_bwd_factored(r, k, v, lw, u, dy, tf32_mode="one", **kw)
    errs = [_rel(g.numpy(), w.numpy()) for g, w in zip(split, want)]
    assert max(errs) <= TOL, dict(zip(NAMES, errs))
    errs = [_rel(g.numpy(), w.numpy()) for g, w in zip(one, want)]
    assert max(errs) > 1e-4, dict(zip(NAMES, errs))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S,chunk", [(13, 3), (47, 20), (87, 40),
                                     (121, 56)])
def test_factored_backward_at_chunks_not_a_multiple_of_the_sub_chunk(
        S, chunk, with_state):
    """Chunks of 3, 20, 40 and 56 tokens: the last sub-chunk of 16 padded
    by zero tokens, S a ragged multiple of neither."""
    assert chunk % SUB
    args = _inputs(S * chunk, 2, S, 2, 16)
    r, k, v, lw, u, s0, dy, ds = (torch.as_tensor(a) for a in args)
    kw = dict(chunk=chunk, state0=s0 if with_state else None,
              ds_end=ds if with_state else None)
    got = wkv6_bwd_factored(r, k, v, lw, u, dy, **kw)
    want = wkv6_bwd_ref(r, k, v, lw, u, dy, **kw)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), w.numpy()) <= TOL, (name,
                                                   _rel(g.numpy(), w.numpy()))


def test_tf32_rounding_and_split():
    """tf32 clears the low 13 mantissa bits (a truncation: never larger in
    magnitude, within 2**-10 relative); hi + lo holds x within 2**-21; the
    split product sits within 1e-6 of the f32 one where one pass does not."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * 3.0
    hi = tf32(x)
    bits = hi.view(torch.int32)
    assert torch.equal(bits & 0x1FFF, torch.zeros_like(bits))
    assert (hi.abs() <= x.abs()).all()
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -10).all()
    lo = tf32(x - hi)
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all()
    a, b = (torch.randn((64, 64), generator=g) for _ in range(2))
    exact = (a.double() @ b.double()).float()
    rel = [float((tf32_mm(a, b, m) - exact).norm() / exact.norm())
           for m in (None, "split", "one")]
    assert rel[0] < 1e-6 and rel[1] < 1e-6 and rel[2] > 1e-4, rel


@pytest.mark.parametrize("with_state", [False, True])
def test_function_backward_on_the_cpu_is_the_plain_backward(with_state):
    """Under grad on the CPU the wrapper's Function runs ``wkv6_ref``
    forward (the same bits as without grad) and ``wkv6_bwd_ref`` backward,
    bit for bit, and launches nothing."""
    args = _inputs(11, 2, 70, 2, 16)
    ins = [torch.as_tensor(a).requires_grad_(True) for a in args[:6]]
    dy, ds = torch.as_tensor(args[6]), torch.as_tensor(args[7])
    state0 = ins[5] if with_state else None
    n0 = (ops.wkv6.launches, ops.wkv6.bwd_launches)
    y, s = ops.wkv6(*ins[:5], chunk=32, state0=state0)
    with torch.no_grad():
        y0, s0 = ops.wkv6(*ins[:5], chunk=32, state0=state0)
    assert torch.equal(y, y0) and torch.equal(s, s0)
    torch.autograd.backward((y, s), (dy, ds))
    want = wkv6_bwd_ref(*(t.detach() for t in ins[:5]), dy, chunk=32,
                        state0=None if state0 is None else state0.detach(),
                        ds_end=ds)
    for name, t, w in zip(NAMES, ins, want):
        if name == "dstate0" and not with_state:
            assert t.grad is None
        else:
            assert torch.equal(t.grad, w), name
    assert (ops.wkv6.launches, ops.wkv6.bwd_launches) == n0


def test_function_gives_each_input_its_type_and_skips_unused_cotangents():
    """bf16 inputs get bf16 gradients through the f32 casts; an unused
    final state costs no cotangent (the plain backward reads None), and a
    used final state alone gives a gradient with y's cotangent zero."""
    args = _inputs(5, 1, 40, 2, 8)
    ins = [torch.as_tensor(a).to(torch.bfloat16).requires_grad_(True)
           for a in args[:3]]
    lw = torch.as_tensor(args[3]).requires_grad_(True)
    u = torch.as_tensor(args[4]).requires_grad_(True)
    y, _ = ops.wkv6(*ins, lw, u, chunk=16)
    y.sum().backward()
    assert [t.grad.dtype for t in ins] == [torch.bfloat16] * 3
    assert lw.grad.dtype == u.grad.dtype == torch.float32
    f32 = [t.detach().float() for t in ins]
    want = wkv6_bwd_ref(*f32, lw.detach(), u.detach(), torch.ones(y.shape),
                        chunk=16)
    for t, w in zip(ins, want):
        assert torch.equal(t.grad, w.to(torch.bfloat16))
    assert torch.equal(lw.grad, want[3]) and torch.equal(u.grad, want[4])
    u.grad = None
    _, s = ops.wkv6(*f32, lw.detach(), u, chunk=16)
    s.sum().backward()
    want = wkv6_bwd_ref(*f32, lw.detach(), u.detach(), torch.zeros(y.shape),
                        chunk=16, ds_end=torch.ones(s.shape))
    assert torch.equal(u.grad, want[4])


def test_gradcheck_in_f64():
    """The Function's plain backward against finite differences, f64 (the
    plain versions keep f64 inputs in f64), a ragged tail and a state."""
    g = torch.Generator().manual_seed(0)
    B, S, H, D = 1, 7, 2, 3
    r, k, v = (torch.randn((B, S, H, D), generator=g, dtype=torch.float64)
               * 0.5 for _ in range(3))
    lw = -torch.exp(torch.randn((B, S, H, D), generator=g,
                                dtype=torch.float64) * 0.5)
    u = torch.randn((H, D), generator=g, dtype=torch.float64)
    s0 = torch.randn((B, H, D, D), generator=g, dtype=torch.float64)
    ins = [t.requires_grad_(True) for t in (r, k, v, lw, u, s0)]
    assert torch.autograd.gradcheck(
        lambda *a: ops._WKV6.apply(*a, 3), ins, eps=1e-6, atol=1e-7)


def test_under_grad_off_the_cpu_the_device_check_comes_first():
    """Off the CPU (meta tensors stand in for CUDA ones) a call under grad
    is refused by the device check before anything launches, as without
    grad; the backward's launch is refused the same way."""
    B, S, H, D = 1, 8, 2, 4
    r, k, v, w = (torch.zeros((B, S, H, D), device="meta") for _ in range(4))
    u = torch.zeros((H, D), device="meta", requires_grad=True)
    n0 = (ops.wkv6.launches, ops.wkv6.bwd_launches)
    for grad in (True, False):
        with torch.set_grad_enabled(grad), pytest.raises(KernelError,
                                                         match="CUDA"):
            ops.wkv6(r, k, v, w, u)
    with pytest.raises(KernelError, match="CUDA"):
        ops.wkv6_bwd(r, k, v, w, u.detach(), r)
    assert (ops.wkv6.launches, ops.wkv6.bwd_launches) == n0
