"""K1 and K2 (``csrc/argmin.cu``) on the CPU: the plain-PyTorch emulation
of the kernel's packed (value, key) reduction against the plain versions
(what the wrappers run for CPU tensors) and against the reference's Pallas
kernels in interpret mode, on the same numpy inputs; and the wrappers'
``out=`` contract.  The emulation takes any split of the cells among
blocks: the kernel's own grid-stride split, a random one, one block, one
block a cell.  Equality is exact: value (sign of zero included) and index.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.psdsf_score.ops import masked_argmin1d as pallas_1d
from repro.kernels.psdsf_score.ops import masked_argmin2d as pallas_2d
from repro_torch.kernels import KernelError
from repro_torch.kernels.psdsf_score import ops, ref

N_CASES = len(ref.argmin_cases(np.random.default_rng(0), (2, 2)))


def _exact(got, want):
    """Equal indices and values, the sign of zero included; a NaN value
    equals a NaN."""
    a = [np.float32(float(x)) if k == 0 else int(x)
         for k, x in enumerate(got)]
    b = [np.float32(float(x)) if k == 0 else int(x)
         for k, x in enumerate(want)]
    assert a[1:] == b[1:], (a, b)
    assert a[0] == b[0] or (np.isnan(a[0]) and np.isnan(b[0])), (a, b)
    assert np.signbit(a[0]) == np.signbit(b[0]), (a, b)


def _pallas(fn, s, mask):
    # copies, and a blocking read: JAX on the CPU may alias numpy memory
    return jax.block_until_ready(fn(jnp.array(s), jnp.array(mask),
                                    interpret=True))


def _parts2d(rng, N, J):
    return {"kernel vec, 264 blocks": ref.kernel_parts2d(N, J, 264),
            "kernel vec, 3 blocks": ref.kernel_parts2d(N, J, 3),
            "kernel scalar, 5 blocks": ref.kernel_parts2d(N, J, 5,
                                                          vec=False),
            "random, 7 blocks": torch.as_tensor(rng.integers(0, 7, (N, J))),
            "one block": torch.zeros((N, J), dtype=torch.long),
            "a block a cell": torch.arange(N * J).reshape(N, J)}


@pytest.mark.parametrize("case", range(N_CASES))
@pytest.mark.parametrize("N,J", [(3, 2), (130, 129), (9, 300), (512, 4096)])
def test_masked_argmin2d_emulation_equals_plain_and_pallas(N, J, case):
    rng = np.random.default_rng(N * J + case)
    label, s, feas = ref.argmin_cases(rng, (N, J))[case]
    S, F = torch.as_tensor(s), torch.as_tensor(feas)
    want = ref.masked_argmin2d_ref(S, F)
    _exact(_pallas(pallas_2d, s, feas), want)
    _exact(ops.masked_argmin2d(S, F), want)
    parts = _parts2d(rng, N, J)
    if N * J > 100_000:          # one block a cell: small shapes only
        del parts["a block a cell"]
    for name, p in parts.items():
        try:
            _exact(ref.masked_argmin2d_emulated(S, F, p), want)
        except AssertionError as exc:
            raise AssertionError(f"{label}, {name}: {exc}") from None


def test_masked_argmin2d_emulation_keeps_tile_order():
    """(0, 200) comes first in (n, j) order, but its tile (0, 1) comes
    after the tile (0, 0) of (1, 3): every split picks (1, 3)."""
    s = np.ones((2, 256), np.float32)
    s[0, 200] = s[1, 3] = 0.0
    feas = np.ones((2, 256), bool)
    S, F = torch.as_tensor(s), torch.as_tensor(feas)
    for p in _parts2d(np.random.default_rng(0), 2, 256).values():
        _v, n, j = ref.masked_argmin2d_emulated(S, F, p)
        assert (int(n), int(j)) == (1, 3)
    _exact(_pallas(pallas_2d, s, feas), ref.masked_argmin2d_ref(S, F))


@pytest.mark.parametrize("case", range(N_CASES))
@pytest.mark.parametrize("N", [1, 7, 300, 512, 4096])
def test_masked_argmin1d_emulation_equals_plain_and_pallas(N, case):
    """Scores and mask as strided columns, as the RRR visit passes them."""
    rng = np.random.default_rng(N + 100 * case)
    label, s, ok = ref.argmin_cases(rng, (N,))[case]
    want = ref.masked_argmin1d_ref(torch.as_tensor(s), torch.as_tensor(ok))
    _exact(_pallas(pallas_1d, s, ok), want)
    mat = torch.zeros((N, 3))
    mask = torch.zeros((N, 3), dtype=torch.bool)
    mat[:, 1], mask[:, 1] = torch.as_tensor(s), torch.as_tensor(ok)
    col, okc = mat[:, 1], mask[:, 1]
    assert col.stride(0) == 3
    _exact(ops.masked_argmin1d(col, okc), want)
    parts = {"kernel, 1024 threads": torch.arange(N) % 1024,
             "random, 5 parts": torch.as_tensor(rng.integers(0, 5, N)),
             "one part": torch.zeros(N, dtype=torch.long),
             "a part an entry": torch.arange(N)}
    for name, p in parts.items():
        try:
            _exact(ref.masked_argmin1d_emulated(col, okc, p), want)
        except AssertionError as exc:
            raise AssertionError(f"{label}, {name}: {exc}") from None


def test_ordered_bits_order_the_values():
    v = np.array([-np.inf, -3.4e38, -1.5, -1e-45, -0.0, 0.0, 1e-45, 0.25,
                  3.4e38, np.inf], np.float32)
    o = ref.ordered_bits(torch.as_tensor(v)).tolist()
    assert o == sorted(o)
    assert len(set(o)) == len(o) - 1 and o[4] == o[5]     # -0.0 == +0.0
    for x, k in zip(v, o):
        assert ref._from_ordered(k) == (0.0 if x == 0 else float(x))


def test_first_feasible_nan_is_picked():
    """A feasible NaN orders below every value, as ``torch.argmin`` and
    ``jnp.argmin`` have it: the first feasible NaN in tile order wins over
    a strictly lower finite score, in every split of the cells, as in the
    plain versions and the Pallas kernels.  (0, 200) comes first in (n, j)
    order, but (1, 3) first in tile order; the NaN at (0, 0) is masked."""
    s = np.ones((2, 256), np.float32)
    s[0, 200] = s[1, 3] = s[0, 0] = np.nan
    s[1, 5] = -5.0
    feas = np.ones((2, 256), bool)
    feas[0, 0] = False
    S, F = torch.as_tensor(s), torch.as_tensor(feas)
    want = ref.masked_argmin2d_ref(S, F)
    assert np.isnan(float(want[0]))
    assert (int(want[1]), int(want[2])) == (1, 3)
    _exact(_pallas(pallas_2d, s, feas), want)
    _exact(ops.masked_argmin2d(S, F), want)
    for p in _parts2d(np.random.default_rng(0), 2, 256).values():
        _exact(ref.masked_argmin2d_emulated(S, F, p), want)
    v = np.array([1.0, np.nan, -3.0, np.nan, np.nan], np.float32)
    ok = np.array([True, False, True, True, True])
    V, OK = torch.as_tensor(v), torch.as_tensor(ok)
    want = ref.masked_argmin1d_ref(V, OK)
    assert int(want[1]) == 3
    _exact(_pallas(pallas_1d, v, ok), want)
    for p in (torch.zeros(5), torch.arange(5), torch.tensor([1, 0, 1, 1, 0])):
        _exact(ref.masked_argmin1d_emulated(V, OK, p), want)


@pytest.mark.parametrize("ndim", [1, 2])
def test_out_is_written_and_returned(ndim):
    rng = np.random.default_rng(ndim)
    shape = (40,) if ndim == 1 else (9, 30)
    fn = ops.masked_argmin1d if ndim == 1 else ops.masked_argmin2d
    plain = ref.masked_argmin1d_ref if ndim == 1 else ref.masked_argmin2d_ref
    out = ops.ArgminOut("cpu", ndim)
    assert [v.shape for v in out.views] == [()] * (ndim + 1)
    assert [v.dtype for v in out.views] == [torch.float32] + [
        torch.int32] * ndim
    firsts = []
    for k in range(3):
        s = torch.as_tensor((np.round(rng.standard_normal(shape) * 4) / 4)
                            .astype(np.float32))
        ok = torch.as_tensor(rng.random(shape) < 0.5)
        got = fn(s, ok, out=out)
        assert got is out.views
        _exact(got, plain(s, ok))
        fresh = fn(s, ok)
        _exact(fresh, got)
        assert all(f.data_ptr() != v.data_ptr()
                   for f, v in zip(fresh, out.views))
        firsts.append((fresh, [float(fresh[0])] + [int(x) for x in
                                                    fresh[1:]]))
    # fresh outputs are never overwritten by later calls
    for fresh, values in firsts:
        assert [float(fresh[0])] + [int(x) for x in fresh[1:]] == values


def test_out_of_the_wrong_kind_is_refused():
    s, ok = torch.zeros(8), torch.ones(8, dtype=torch.bool)
    with pytest.raises(KernelError):
        ops.masked_argmin1d(s, ok, out=ops.ArgminOut("cpu", 2))
    with pytest.raises(KernelError):
        ops.masked_argmin2d(s.reshape(2, 4), ok.reshape(2, 4),
                            out=ops.ArgminOut("cpu", 1))
    with pytest.raises(ValueError):
        ops.ArgminOut("cpu", 3)


def test_blocks2d_clamps_and_refuses_key_overflow():
    """K2's tile words (log2 bn, log2 bj, tj, pad) follow ``ref._block``."""
    assert ops._blocks2d(512, 4096, 128, 128) == (7, 7, 32, 0)
    assert ops._blocks2d(3, 300, 128, 128) == (3, 7, 3, 1)
    assert ops._blocks2d(3, 2, 128, 128) == (3, 3, 1, 1)
    assert ops._blocks2d(130, 129, 128, 128) == (7, 7, 2, 1)
    assert ops._blocks2d(512, 4096, 64, 256) == (6, 8, 16, 0)
    with pytest.raises(KernelError, match="int32"):
        ops._blocks2d(65536, 32769, 128, 128)      # 2^16 x (2^15 + 128)
    with pytest.raises(KernelError, match="powers of two"):
        ops._blocks2d(512, 4096, 96, 128)


@pytest.mark.parametrize("n,pad", [(1, 1), (7, 1), (8, 0), (300, 1),
                                   (512, 0), (4096, 0), (4100, 1)])
def test_pad1d_follows_the_reference_tile(n, pad):
    assert ops._pad1d(n) == pad
    assert ops._pad1d(n) == int(n % ref._block(n, 128) != 0)


def test_pad1d_refuses_index_overflow():
    with pytest.raises(KernelError, match="int32"):
        ops._pad1d(2**31)


def test_k2_workspace_belongs_to_its_holder():
    """Each K2 holder carries its own workspace, made ready for the
    kernel (the slot all ones, the ticket 0); K1 needs none."""
    a, b = ops.ArgminOut("cpu", 2), ops.ArgminOut("cpu", 2)
    for out in (a, b):
        assert out.workspace.dtype == torch.int64
        assert out.workspace.tolist() == [-1, 0]
    assert a.workspace.data_ptr() != b.workspace.data_ptr()
    assert ops.ArgminOut("cpu", 1).workspace is None


def test_wrappers_refuse_other_devices():
    s = torch.zeros((2, 4), device="meta")
    ok = torch.ones((2, 4), dtype=torch.bool, device="meta")
    with pytest.raises(KernelError):
        ops.masked_argmin2d(s, ok)
    with pytest.raises(KernelError):
        ops.masked_argmin1d(s[0], ok[0])
