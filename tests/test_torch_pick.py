"""K4's one-launch pick on the CPU: an emulation of ``csrc/argmin.cu``'s
``psdsf_pick_kernel`` (the packed (value, tile key) minimum over any split
of the cells, with the previous grant's pending mirror update applied as
the launch applies it) held equal, bit for bit on (val, n, j), to K4's
plain version and to the reference's Pallas ``psdsf_argmin_tiles`` in
interpret mode; and the ``PickOut`` holder's contract (the pending update,
the host pair) through the wrapper, as the per-grant engine drives it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.psdsf_score.ops import psdsf_argmin as pallas_psdsf_argmin
from repro_torch.kernels import KernelError
from repro_torch.kernels.psdsf_score import ops, ref
from test_torch_cuda import psdsf_inputs

SHAPES = [(5, 3, 2), (130, 129, 2), (300, 257, 3), (128, 128, 8), (1, 1, 1),
          (512, 4096, 2)]
SPLITS = ["kernel grid", "random blocks", "one block"]


def _triple(r):
    return [float(r[0]), int(r[1]), int(r[2])]


def _same(got, want):
    """Equal indices, equal values (NaN equals NaN), the sign of zero
    included."""
    assert got[1:] == want[1:], (got, want)
    assert got[0] == want[0] or (np.isnan(got[0]) and np.isnan(want[0])), (
        got, want)
    assert np.signbit(got[0]) == np.signbit(want[0]), (got, want)


def _parts(split, N, J, seed):
    if split == "kernel grid":
        return ref.pick_parts(N, J)
    if split == "random blocks":
        rng = np.random.default_rng(seed)
        return torch.as_tensor(rng.integers(0, 7, (N, J)))
    return torch.zeros((N, J), dtype=torch.int64)


def _pallas(x, phi, d, res):
    return _triple(pallas_psdsf_argmin(*(jnp.asarray(np.array(a))
                                         for a in (x, phi, d, res)),
                                       interpret=True))


def _torch(arrays):
    return [torch.as_tensor(a).clone() for a in arrays]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("family", ["quantized", "non-dyadic",
                                    "all-infeasible"])
@pytest.mark.parametrize("N,J,R", SHAPES)
def test_pick_emulation_equals_plain_and_pallas(N, J, R, family, split):
    """No update pending: the emulated launch == the plain version ==
    Pallas (interpret; not at the fleet shape, where it takes minutes), on
    the quarter-quantized tie families, non-dyadic quotients (an exhausted
    row and a blocked column included) and nothing feasible, padded shapes
    among them."""
    arrays = psdsf_inputs(N * J + R, N, J, R,
                          "quantized" if family == "all-infeasible"
                          else family)
    if family == "all-infeasible":
        arrays[2] = arrays[2] + np.float32(100.0)
    x, phi, d, res = _torch(arrays)
    got = _triple(ref.psdsf_argmin_emulated(
        x, phi, d, res, _parts(split, N, J, N + J)))
    want = _triple(ref.psdsf_argmin_ref(x, phi, d, res))
    _same(got, want)
    if family == "all-infeasible":
        assert got[1:] == [-1, -1]
    if N * J <= 300 * 257 and split == "kernel grid":
        _same(got, _pallas(*arrays))


def _update(kind, arrays, seed):
    """A grant's pending mirror update that changes the pick: the winner's
    row exhausted, the winner's column zeroed (its agent blocked), or a
    plain grant (units added, the column's residual lowered)."""
    x, phi, d, res = _torch(arrays)
    _, n, j = _triple(ref.psdsf_argmin_ref(x, phi, d, res))
    assert n >= 0
    R = res.shape[1]
    rng = np.random.default_rng(seed)
    if kind == "exhausted row":
        return (n, 1.0, int(rng.integers(res.shape[0])), res[
            int(rng.integers(res.shape[0]))].numpy(), True)
    if kind == "zeroed column":
        return (int(rng.integers(x.shape[0])), 2.0, j, np.zeros(R, np.float32),
                False)
    row = np.maximum(res[j].numpy() - d[n].numpy(), 0).astype(np.float64)
    return (n, 1.0, j, row / 3.0, False)   # thirds: f64 -> f32 rounding


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kind", ["exhausted row", "zeroed column", "grant"])
@pytest.mark.parametrize("family", ["quantized", "non-dyadic"])
@pytest.mark.parametrize("N,J,R", [(5, 3, 2), (130, 129, 2), (300, 257, 3),
                                   (128, 128, 8)])
def test_pending_update_rides_in_the_launch(N, J, R, family, kind, split):
    """An update carried only in the pending words: the emulated launch on
    the stale mirrors == the plain version and Pallas on the updated ones,
    and afterwards the mirrors hold the update (the last block's
    write-back)."""
    arrays = psdsf_inputs(N * J + R + 1, N, J, R, family)
    arrays[3][arrays[3] > 0] += np.float32(5.0)   # a feasible pick at (5, 3)
    upd = _update(kind, arrays, N + J)
    stale = _torch(arrays)
    before = _triple(ref.psdsf_argmin_ref(*stale))
    fresh = _torch(arrays)
    ref.apply_update(fresh[0], fresh[2], fresh[3], upd)
    want = _triple(ref.psdsf_argmin_ref(*fresh))
    mirrors = _torch(arrays)
    got = _triple(ref.psdsf_argmin_emulated(
        *mirrors, _parts(split, N, J, N * J), update=upd))
    _same(got, want)
    if kind != "grant":
        assert got != before        # the update decided this pick
    if split == "kernel grid":
        _same(got, _pallas(*(t.numpy() for t in fresh)))
    for a, b in zip(mirrors, fresh):
        assert torch.equal(a, b)


def test_wrapper_applies_the_holder_update_on_the_cpu():
    """The wrapper with a ``PickOut`` on CPU tensors: the pending update is
    applied to the mirrors in place, the result reaches the views and the
    host pair, and the update is consumed."""
    N, J, R = 130, 129, 2
    arrays = psdsf_inputs(3, N, J, R, "non-dyadic")
    upd = _update("exhausted row", arrays, 1)
    mirrors = _torch(arrays)
    out = ops.PickOut("cpu", R)
    out.defer(*upd)
    with pytest.raises(KernelError, match="pending"):
        out.defer(*upd)
    n0 = ops.psdsf_argmin.launches
    views = ops.psdsf_argmin(*mirrors, out=out)
    assert ops.psdsf_argmin.launches == n0 and views is out.views
    fresh = _torch(arrays)
    ref.apply_update(fresh[0], fresh[2], fresh[3], upd)
    want = _triple(ref.psdsf_argmin_ref(*fresh))
    _same(_triple(views), want)
    assert out.result() == tuple(want[1:]) and out.pending is None
    for a, b in zip(mirrors, fresh):
        assert torch.equal(a, b)
    # nothing pending: the next call leaves the mirrors as they are
    _same(_triple(ops.psdsf_argmin(*mirrors, out=out)), want)
    for a, b in zip(mirrors, fresh):
        assert torch.equal(a, b)


def test_pick_sequence_with_pending_updates_equals_eager_updates():
    """A run of picks as the per-grant engine makes them (each grant's
    update deferred to the next pick) == the same picks with the updates
    written eagerly, and the mirrors agree after every pick."""
    N, J, R = 40, 70, 2
    x, phi, d, res = _torch(psdsf_inputs(11, N, J, R, "quantized"))
    d[N // 2] = torch.as_tensor(d[N // 2 - 1])       # no exhausted row yet
    res = res + 2.0
    lazy = [t.clone() for t in (x, phi, d, res)]
    out = ops.PickOut("cpu", R)
    wanted = np.full(N, 3)
    tot = np.zeros(N)
    picks = 0
    while True:
        eager = _triple(ref.psdsf_argmin_ref(x, phi, d, res))
        got = _triple(ops.psdsf_argmin(*lazy, out=out))
        _same(got, eager)
        for a, b in zip(lazy, (x, phi, d, res)):
            assert torch.equal(a, b)
        _, n, j = got
        if n < 0:
            break
        picks += 1
        tot[n] += 1
        row = (res[j] - d[n]).double().numpy()
        upd = (n, 1.0, j, row, bool(tot[n] >= wanted[n]))
        ref.apply_update(x, d, res, upd)
        out.defer(*upd)
    assert picks > 20


def test_pick_refuses_a_holder_of_the_wrong_width():
    out = ops.PickOut("cpu", 2)
    with pytest.raises(KernelError, match="2 values"):
        out.defer(0, 1.0, 0, np.zeros(3), False)
    with pytest.raises(ValueError):
        ops.PickOut("cpu", 9)
