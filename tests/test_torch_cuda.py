"""The port's kernels on the card: each against its plain version on the
same CUDA tensors, exact equality.  Marked ``cuda``; skipped where no card
is present (run them on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``).

``python tests/test_torch_cuda.py`` prints the digests of
:func:`k5_equal_d_outputs` for the ``repro_torch`` on ``PYTHONPATH`` (run
with an older checkout's ``src`` to record that checkout's outputs)."""
import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch

from repro_torch.core import engine_torch as et

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scores(rng, shape, dev):
    return torch.as_tensor(np.round(rng.standard_normal(shape) * 4) / 4,
                           dtype=torch.float32, device=dev)


def _exact(got, want):
    """Equal indices and values, the sign of zero included; a NaN value
    equals a NaN."""
    a = [float(got[0])] + [int(x) for x in got[1:]]
    b = [float(want[0])] + [int(x) for x in want[1:]]
    assert a[1:] == b[1:], (a, b)
    assert a[0] == b[0] or (np.isnan(a[0]) and np.isnan(b[0])), (a, b)
    assert np.signbit(a[0]) == np.signbit(b[0]), (a, b)


def _cases(rng, shape, dev):
    from repro_torch.kernels.psdsf_score import ref

    return [(label, torch.as_tensor(s, device=dev),
             torch.as_tensor(m, device=dev))
            for label, s, m in ref.argmin_cases(rng, shape)]


@pytest.mark.parametrize("N", [1, 7, 128, 300, 512, 4096])
def test_masked_argmin1d_kernel_equals_plain(dev, N):
    """Every edge case of the contract, with and without ``out``, on a
    contiguous vector and on strided columns (as the RRR visit passes
    them), with a bool and a uint8 mask."""
    from repro_torch.kernels.psdsf_score import ops

    rng = np.random.default_rng(N)
    out = ops.ArgminOut(dev, 1)
    for label, s, ok in _cases(rng, N, dev):
        want = ops.masked_argmin1d_ref(s, ok)
        m = torch.zeros((N, 3), device=dev)
        f = torch.zeros((N, 3), dtype=torch.uint8, device=dev)
        m[:, 1], f[:, 1] = s, ok
        for args in ((s, ok), (m[:, 1], f[:, 1])):
            _exact(ops.masked_argmin1d(*args), want)
            got = ops.masked_argmin1d(*args, out=out)
            assert got is out.views
            _exact(got, want)


@pytest.mark.parametrize("N,J", [(3, 2), (130, 129), (9, 300), (512, 4096),
                                 (4096, 4096)])
def test_masked_argmin2d_kernel_equals_plain(dev, N, J):
    """Every edge case of the contract, with and without ``out``; on rows
    the kernel reads four cells at a time, and on a view whose base and
    row stride are not 16-byte multiples (the kernel's scalar path).  At
    (4096, 4096) there are more reference tiles than blocks."""
    from repro_torch.kernels.psdsf_score import ops

    rng = np.random.default_rng(N * J)
    out = ops.ArgminOut(dev, 2)
    for label, s, feas in _cases(rng, (N, J), dev):
        want = ops.masked_argmin2d_ref(s, feas)
        m = torch.zeros((N, J + 1), device=dev)
        f = torch.zeros((N, J + 1), dtype=torch.uint8, device=dev)
        m[:, 1:], f[:, 1:] = s, feas
        for args in ((s, feas), (m[:, 1:], f[:, 1:])):
            _exact(ops.masked_argmin2d(*args), want)
            got = ops.masked_argmin2d(*args, out=out)
            assert got is out.views
            _exact(got, want)


def test_argmin_kernels_back_to_back(dev):
    """1,000 calls of each kernel on the same ``out``, inputs changing
    between calls, no sync in between: a new strict minimum planted at a
    new cell every call (the earlier ones stay, so only the newest wins),
    and every fifth call with nothing feasible.  K2's workspace must come
    back reset from every launch, or the next call goes wrong.  A call
    with ``out`` allocates nothing."""
    from repro_torch.kernels.psdsf_score import ops

    N, J, calls = 512, 4096, 1000
    rng = np.random.default_rng(0)
    s = _scores(rng, (N, J), dev)
    vec = _scores(rng, J, dev)
    feas = torch.ones((N, J), dtype=torch.bool, device=dev)
    none = torch.zeros_like(feas)
    cells = rng.choice(N * J, calls, replace=False)
    entries = rng.choice(J, calls, replace=False)
    got2 = torch.empty((calls, 3), device=dev)
    got1 = torch.empty((calls, 2), device=dev)
    out1, out2 = ops.ArgminOut(dev, 1), ops.ArgminOut(dev, 2)
    row = feas[0]
    ops.masked_argmin1d(vec, row, out=out1)
    ops.masked_argmin2d(s, feas, out=out2)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(100):
        ops.masked_argmin1d(vec, row, out=out1)
        ops.masked_argmin2d(s, feas, out=out2)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs
    for k in range(calls):
        n, j = divmod(int(cells[k]), J)
        s[n, j] = -100.0 - k
        vec[int(entries[k])] = -100.0 - k
        f = none if k % 5 == 4 else feas
        v, a, b = ops.masked_argmin2d(s, f, out=out2)
        got2[k, 0], got2[k, 1], got2[k, 2] = v, a, b
        v, a = ops.masked_argmin1d(vec, f[0], out=out1)
        got1[k, 0], got1[k, 1] = v, a
    torch.cuda.synchronize()
    big = float(torch.tensor(ops.BIG))
    for k in range(calls):
        n, j = divmod(int(cells[k]), J)
        if k % 5 == 4:
            want2, want1 = [big, -1, -1], [big, -1]
        else:
            want2, want1 = [-100.0 - k, n, j], [-100.0 - k, int(entries[k])]
        assert got2[k].tolist() == want2, k
        assert got1[k].tolist() == want1, k


def test_argmin2d_on_two_streams(dev):
    """Two streams each run K2 back to back on their own inputs and
    ``out``; each holder carries its own workspace, so they never mix."""
    from repro_torch.kernels.psdsf_score import ops

    rng = np.random.default_rng(1)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = [[(_scores(rng, (512, 4096), dev),
                torch.as_tensor(rng.random((512, 4096)) < 0.5, device=dev))
               for _ in range(4)] for _ in streams]
    outs = [ops.ArgminOut(dev, 2) for _ in streams]
    res = [torch.empty((40, 3), device=dev) for _ in streams]
    torch.cuda.synchronize()
    for k in range(40):
        for st, ins, out, r in zip(streams, inputs, outs, res):
            with torch.cuda.stream(st):
                v, n, j = ops.masked_argmin2d(*ins[k % 4], out=out)
                r[k, 0], r[k, 1], r[k, 2] = v, n, j
    torch.cuda.synchronize()
    for ins, r in zip(inputs, res):
        for k in range(40):
            want = ops.masked_argmin2d_ref(*ins[k % 4])
            assert r[k].tolist() == [float(want[0]), int(want[1]),
                                     int(want[2])]


def test_argmin2d_in_a_cuda_graph(dev):
    """One K2 call with ``out`` captured in a CUDA graph with no call
    before it (it allocates nothing and never syncs the host, or the
    capture fails) and replayed on three new inputs copied into its
    buffers."""
    from repro_torch.kernels.psdsf_score import ops

    rng = np.random.default_rng(2)
    s_buf = torch.zeros((512, 4096), device=dev)
    f_buf = torch.zeros((512, 4096), dtype=torch.bool, device=dev)
    out = ops.ArgminOut(dev, 2)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = ops.masked_argmin2d.launches
    with torch.cuda.graph(graph, stream=stream):
        ops.masked_argmin2d(s_buf, f_buf, out=out)
    assert ops.masked_argmin2d.launches == before + 1
    for k in range(3):
        s = _scores(rng, (512, 4096), dev)
        f = torch.as_tensor(rng.random((512, 4096)) < 0.5, device=dev)
        s_buf.copy_(s)
        f_buf.copy_(f)
        graph.replay()
        torch.cuda.synchronize()
        _exact(out.views, ops.masked_argmin2d_ref(s, f))


def test_argmin2d_graph_replay_beside_direct_calls(dev):
    """A graph captured on one stream and replayed on another, while
    direct K2 calls with their own holder run on the capture stream with
    no sync between them: the two share no workspace, so each gets its
    own inputs' minimum."""
    from repro_torch.kernels.psdsf_score import ops

    rng = np.random.default_rng(3)
    N, J, rounds = 512, 4096, 20
    s_buf = torch.zeros((N, J), device=dev)
    f_buf = torch.ones((N, J), dtype=torch.bool, device=dev)
    g_out, d_out = ops.ArgminOut(dev, 2), ops.ArgminOut(dev, 2)
    capture, replay = torch.cuda.Stream(), torch.cuda.Stream()
    capture.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=capture):
        ops.masked_argmin2d(s_buf, f_buf, out=g_out)
    inputs = [(_scores(rng, (N, J), dev),
               torch.as_tensor(rng.random((N, J)) < 0.5, device=dev))
              for _ in range(2 * rounds)]
    g_res = torch.empty((rounds, 3), device=dev)
    d_res = torch.empty((rounds, 3), device=dev)
    torch.cuda.synchronize()
    for k in range(rounds):
        with torch.cuda.stream(replay):
            s_buf.copy_(inputs[2 * k][0])
            f_buf.copy_(inputs[2 * k][1])
            graph.replay()
            v, n, j = g_out.views
            g_res[k, 0], g_res[k, 1], g_res[k, 2] = v, n, j
        with torch.cuda.stream(capture):
            v, n, j = ops.masked_argmin2d(*inputs[2 * k + 1], out=d_out)
            d_res[k, 0], d_res[k, 1], d_res[k, 2] = v, n, j
    torch.cuda.synchronize()
    for k in range(rounds):
        for res, (s, f) in ((g_res, inputs[2 * k]),
                            (d_res, inputs[2 * k + 1])):
            want = ops.masked_argmin2d_ref(s, f)
            assert res[k].tolist() == [float(want[0]), int(want[1]),
                                       int(want[2])], k


@pytest.mark.parametrize("crit", ["drf", "tsf", "psdsf", "rpsdsf"])
@pytest.mark.parametrize("pol", ["pooled", "rrr"])
def test_kernels_grant_like_the_plain_loop(dev, crit, pol):
    rng = np.random.default_rng(5)
    N, J = 24, 40
    D = 2.0 ** rng.integers(-2, 2, (N, 2))
    C = rng.integers(4, 13, (J, 2)).astype(np.float64)
    kw = dict(X=np.zeros((N, J)), D=D, C=C, FREE=C.copy(),
              phi=np.array([0.5, 1.0, 2.0])[np.arange(N) % 3],
              allowed=rng.random((N, J)) > 0.2,
              wanted=rng.integers(1, 9, N).astype(np.float64),
              true_demands=D, per_agent_limit=2)
    seqs = {}
    for kernel in ("persistent", "tiles", None):
        seqs[kernel] = et.run_epoch(crit, pol, rng=np.random.default_rng(1),
                                    kernel=kernel, device=dev, **kw)
    cpu = et.run_epoch(crit, pol, rng=np.random.default_rng(1),
                       device="cpu", **kw)
    assert seqs["persistent"] == seqs[None] == cpu
    assert len(cpu) > 0


@pytest.mark.parametrize("crit", ["drf", "tsf", "psdsf", "rpsdsf"])
@pytest.mark.parametrize("pol", ["pooled", "rrr"])
def test_epoch_ends_when_row_zero_is_exhausted(dev, crit, pol):
    """Only framework 0 wants executors, so the grant that reaches its
    wanted count clears the last feasible row and ends the epoch: the
    kernel's kept feasibility count must reach zero with that clear, stop
    after exactly that grant, and leave the same state as its plain
    version."""
    from repro_torch.kernels.epoch_persistent import ops as k3

    N, J, want = 8, 4096, 5
    f64 = dict(dtype=torch.float64, device=dev)
    C = torch.full((J, 2), 4.0, **f64)
    D = torch.ones((N, 2), **f64)
    wanted = torch.zeros(N, **f64)
    wanted[0] = want
    perms = torch.as_tensor(
        np.stack([np.random.default_rng(k).permutation(J) for k in range(4)])
        if pol == "rrr" else np.arange(J)[None, :], dtype=torch.int32,
        device=dev)
    state = et.epoch_state(
        torch.zeros((N, J), **f64), D, D, C, C.clone(),
        torch.ones(N, **f64), wanted, torch.ones((N, J), dtype=torch.bool,
                                                 device=dev), perms,
        torch.zeros(J, dtype=torch.int32, device=dev), 0, 0, J, 0, 1e-9,
        kind=crit, lookahead=False, use_limit=False)
    kw = dict(kind=crit, policy=pol, lookahead=False, use_limit=False,
              max_steps=16)

    def fresh():
        return tuple(a.clone() if torch.is_tensor(a) else a for a in state)

    a_in, b_in = fresh(), fresh()
    a = k3.persistent_epoch(*a_in, **kw)
    b = k3.persistent_epoch_ref(*b_in, **kw)
    assert int(a[2]) == int(b[2]) == want
    assert bool((a[0][want:] == -1).all()) and float(a[3].sum()) == want
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a_in[6].bool(), b_in[6].bool())      # feas



def _k3_state(dev, crit, pol, N, J, R, seed, pad_n=0, pad_j=0, limit=2):
    """K3's arguments on ``dev``: quarter-quantized demands against
    integer capacities, the last ``pad_n`` frameworks and ``pad_j``
    servers padded as the engine pads them."""
    rng = np.random.default_rng(seed)
    D = rng.integers(1, 9, (N, R)) / 4
    C = rng.integers(2, 9, (J, R)).astype(np.float64)
    wanted = rng.integers(1, 7, N).astype(np.float64)
    allowed = rng.random((N, J)) > 0.25
    D[N - pad_n:] = wanted[N - pad_n:] = allowed[N - pad_n:] = 0
    C[J - pad_j:] = allowed[:, J - pad_j:] = 0
    perms = np.tile(np.arange(J), (16 if pol == "rrr" else 1, 1))
    if pol == "rrr":
        for row in perms:
            row[:J - pad_j] = rng.permutation(J - pad_j)
    g = lambda a, **k: torch.as_tensor(a, device=dev, **k)  # noqa: E731
    return et.epoch_state(
        g(np.zeros((N, J))), g(D), g(D), g(C), g(C.copy()),
        g(np.array([0.5, 1.0, 2.0])[np.arange(N) % 3]), g(wanted),
        g(allowed, dtype=torch.bool), g(perms, dtype=torch.int32),
        torch.zeros(J, dtype=torch.int32, device=dev), 0, 0, J - pad_j,
        limit, 1e-9, kind=crit, lookahead=False, use_limit=bool(limit))


@pytest.mark.parametrize("crit", ["drf", "tsf", "psdsf", "rpsdsf"])
@pytest.mark.parametrize("pol", ["pooled", "rrr"])
@pytest.mark.parametrize("N,J,R,pad_n,pad_j,max_steps", [
    (16, 32, 2, 0, 0, 4096),      # 32 groups: most blocks own nothing
    (64, 256, 4, 13, 56, 4096),   # padded
    (13, 36, 2, 0, 0, 4096),      # 117 groups, fewer than the slices
    (512, 4096, 2, 0, 0, 4096),   # the fleet's shape: the last slice short
    (1024, 8192, 2, 0, 0, 48)])   # slices too large for shared memory
def test_persistent_epoch_kernel_equals_plain(dev, crit, pol, N, J, R, pad_n,
                                             pad_j, max_steps):
    """K3 against its plain version: every returned and in-place array.
    Pooled PS-DSF / rPS-DSF runs on every co-resident block, the other
    pairs on one; at (1024, 8192) a slice no longer fits the shared-memory
    cache and is streamed from L2 at every pick."""
    from repro_torch.kernels.epoch_persistent import ops as k3

    state = _k3_state(dev, crit, pol, N, J, R, N + J, pad_n, pad_j)
    kw = dict(kind=crit, policy=pol, lookahead=False, use_limit=True,
              max_steps=max_steps)
    fresh = lambda: tuple(a.clone() if torch.is_tensor(a) else a  # noqa
                          for a in state)
    a_in, b_in = fresh(), fresh()
    a = k3.persistent_epoch(*a_in, **kw)
    b = k3.persistent_epoch_ref(*b_in, **kw)
    torch.cuda.synchronize()
    wide = pol == "pooled" and crit in ("psdsf", "rpsdsf")
    assert k3.persistent_epoch.grid == (k3.grid_size(dev, R) if wide else 1)
    assert not wide or k3.persistent_epoch.grid > 1
    assert 0 < int(b[2]) <= max_steps
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for i in (3, 4, 5):                                      # cap, dom, s
        assert torch.equal(a_in[i], b_in[i])
    assert torch.equal(a_in[6].bool(), b_in[6].bool())      # feas


@pytest.mark.parametrize("crit", ["psdsf", "rpsdsf"])
def test_persistent_epoch_near_tied_slices(dev, crit):
    """Scores planted so that the first pick has two near-tied parts: the
    slice of cells 200-203 has its least score (cell 202) within the
    tolerance of the global least (0.5, cell 300, another slice), but its
    first cell within ITS tolerance (cell 200) is not.  The kernel takes
    its near-tie round (counted in the profile) and still picks as its
    plain version does.  (N, J) = (16, 32) has 128 groups of four cells,
    so every slice of a grid of 66 blocks or more holds at most 2 groups.)"""
    from repro_torch.kernels.epoch_persistent import ops as k3

    N, J = 16, 32
    assert k3.grid_size(dev, 2) >= 66
    state = list(_k3_state(dev, crit, "pooled", N, J, 2, 7))
    state[6] = torch.ones((N, J), dtype=torch.bool, device=dev)   # feas
    half = np.float32(0.5)
    s = state[5] + 10.0
    s.view(-1)[300] = float(half)
    s.view(-1)[202] = float(np.nextafter(half, 1) * np.float32(1 + 7e-7))
    s.view(-1)[200] = float(half * np.float32(1 + 1.5e-6))
    state[5] = s
    kw = dict(kind=crit, policy="pooled", lookahead=False, use_limit=False,
              max_steps=64)
    fresh = lambda: tuple(a.clone() if torch.is_tensor(a) else a  # noqa
                          for a in state)
    a_in, b_in = fresh(), fresh()
    prof = torch.zeros(k3.PROFILE_WORDS, dtype=torch.int64, device=dev)
    a = k3.persistent_epoch(*a_in, **kw, profile=prof)
    b = k3.persistent_epoch_ref(*b_in, **kw)
    assert int(prof[3]) >= 1                             # near-tie rounds
    assert int(b[2]) > 1
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a_in[5], b_in[5])


@pytest.mark.parametrize("crit", ["drf", "tsf", "psdsf", "rpsdsf"])
@pytest.mark.parametrize("pol", ["pooled", "rrr"])
def test_chained_epoch_on_the_kernel_equals_plain(dev, crit, pol):
    """An epoch of more grants than ``max_steps_cap`` runs as chained K3
    launches, each counting its masks anew from the state the last one
    left: the grants equal the plain loop's on the card and on the CPU."""
    from repro_torch.kernels.epoch_persistent import ops as k3

    rng = np.random.default_rng(11)
    N, J = 40, 96
    D = rng.integers(1, 9, (N, 2)) / 4
    C = rng.integers(4, 13, (J, 2)).astype(np.float64)
    kw = dict(X=np.zeros((N, J)), D=D, C=C, FREE=C.copy(),
              phi=np.array([0.5, 1.0, 2.0])[np.arange(N) % 3],
              allowed=rng.random((N, J)) > 0.2,
              wanted=rng.integers(2, 9, N).astype(np.float64),
              true_demands=D, per_agent_limit=3, max_steps_cap=16)
    n0 = k3.persistent_epoch.launches
    got = et.run_epoch(crit, pol, rng=np.random.default_rng(1),
                       kernel="persistent", device=dev, **kw)
    launches = k3.persistent_epoch.launches - n0
    plain = et.run_epoch(crit, pol, rng=np.random.default_rng(1),
                         kernel=None, device=dev, **kw)
    cpu = et.run_epoch(crit, pol, rng=np.random.default_rng(1),
                       device="cpu", **kw)
    assert len(cpu) > 2 * 16 and launches >= 3
    assert got == plain == cpu


def psdsf_inputs(seed, N, J, R, family):
    """K4's inputs as f32 numpy arrays: quarter-quantized (exact ties, zero
    x) or non-dyadic (phi in {1, 2, 3}, residuals in thirds: division
    rounding), with an exhausted row (d = 3e38: inf and NaN scores) and a
    blocked column.  Shared with the CPU tests (tests/test_torch_psdsf.py),
    so it imports no JAX."""
    rng = np.random.default_rng(seed)
    if family == "quantized":
        x = rng.integers(0, 16, N) / 4
        phi = np.ones(N)
        d = rng.integers(1, 12, (N, R)) / 4
        res = rng.integers(0, 24, (J, R)) / 4
    else:
        x = rng.uniform(0, 20, N)
        phi = np.array([1.0, 2.0, 3.0])[np.arange(N) % 3]
        d = rng.uniform(0.5, 5, (N, R))
        res = rng.integers(0, 25, (J, R)) / 3
    d[N // 2] = 3.0e38
    res[J // 2] = 0.0
    return [a.astype(np.float32) for a in (x, phi, d, res)]


@pytest.mark.parametrize("family", ["quantized", "non-dyadic"])
@pytest.mark.parametrize("N,J,R", [(512, 4096, 2), (300, 257, 3),
                                   (128, 128, 8), (1, 1, 1), (130, 129, 2)])
def test_psdsf_argmin_kernel_equals_plain(dev, N, J, R, family):
    from repro_torch.kernels.psdsf_score import ops

    args = [torch.as_tensor(a, device=dev)
            for a in psdsf_inputs(N * J + R, N, J, R, family)]
    n0 = ops.psdsf_argmin.launches
    got = ops.psdsf_argmin(*args)
    want = ops.psdsf_argmin_ref(*args)
    assert ops.psdsf_argmin.launches == n0 + 1
    assert ([float(got[0]), int(got[1]), int(got[2])]
            == [float(want[0]), int(want[1]), int(want[2])])
    # nothing feasible: every demand above every residual
    args[2].fill_(100.0)
    got = ops.psdsf_argmin(*args)
    assert (int(got[1]), int(got[2])) == (-1, -1)
    assert float(got[0]) == float(ops.psdsf_argmin_ref(*args)[0])


@pytest.mark.parametrize("family", ["quantized", "non-dyadic"])
@pytest.mark.parametrize("N,J,R", [(512, 4096, 2), (300, 257, 3),
                                   (128, 128, 8), (130, 129, 2)])
def test_psdsf_pick_with_pending_updates_equals_plain(dev, N, J, R, family):
    """A run of picks on one ``PickOut`` as the per-grant engine makes
    them: each grant's mirror update (units, the column's new residual row,
    an exhausted row) rides only in the holder's pending words, and the
    launch == the plain version on eagerly updated inputs, the mirrors
    equal after every pick, the pinned pair equal to the views."""
    from repro_torch.kernels.psdsf_score import ops, ref

    arrays = [torch.as_tensor(a, device=dev)
              for a in psdsf_inputs(N + J + R, N, J, R, family)]
    arrays[3] = arrays[3] + 4.0
    eager = [a.clone() for a in arrays]
    lazy = [a.clone() for a in arrays]
    out = ops.PickOut(dev, R)
    tot = np.zeros(N)
    for step in range(24):
        n0 = ops.psdsf_argmin.launches
        views = ops.psdsf_argmin(*lazy, out=out)
        n, j = out.result()
        assert ops.psdsf_argmin.launches == n0 + 1 and views is out.views
        want = ops.psdsf_argmin_ref(*eager)
        _exact(views, want)
        assert (n, j) == (int(views[1]), int(views[2]))
        for a, b in zip(lazy, eager):
            assert torch.equal(a, b)
        if n < 0:
            break
        tot[n] += 1
        row = (eager[3][j] - eager[2][n]).double().cpu().numpy() / 3.0
        upd = (n, 1.0, j, row, bool(tot[n] >= 2 or step % 5 == 4))
        ref.apply_update(eager[0], eager[2], eager[3], upd)
        out.defer(*upd)


def test_psdsf_pick_is_one_launch_and_allocates_nothing(dev):
    """One K4 pick with its holder, a pending update included, is one CUDA
    launch and nothing else on the device (no copy, no memset), and
    allocates no device memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.psdsf_score import ops

    N, J, R = 512, 4096, 2
    args = [torch.as_tensor(a, device=dev)
            for a in psdsf_inputs(5, N, J, R, "non-dyadic")]
    out = ops.PickOut(dev, R)
    ops.psdsf_argmin(*args, out=out)
    out.result()
    out.defer(3, 1.0, 7, np.array([1.5, 2.5]), True)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.psdsf_argmin(*args, out=out)
        out.result()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs
    on_device = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    assert len(on_device) == 1 and "psdsf_pick" in on_device[0], on_device
    assert float(args[2][3, 0]) == _exhausted() and float(
        args[3][7, 1]) == 2.5


def _exhausted():
    from repro_torch.kernels.psdsf_score import ref

    return float(np.float32(ref.EXHAUSTED))


def test_pergrant_allocator_launches_k4(dev):
    """``use_kernel="pergrant"`` on the card: K4 launches once a grant and
    once for the pick that ends the epoch, and grants as on the CPU."""
    from repro_torch.core.online import OnlineAllocator
    from repro_torch.kernels.psdsf_score import ops

    grants, launches = {}, {}
    for device in (dev, "cpu"):
        al = OnlineAllocator(2, criterion="rpsdsf", server_policy="pooled",
                             seed=0, device=device)
        for j, cap in enumerate(((4.0, 14.0), (8.0, 8.0), (6.0, 11.0))):
            al.add_agent(f"a{j}", cap)
        al.register("f0", demand=(2.0, 2.0), wanted_tasks=4, phi=2.0)
        al.register("f1", demand=(1.0, 3.5), wanted_tasks=10**6)
        al.register("f2", demand=(1.0, 1.0), wanted_tasks=10**6, phi=0.5)
        n0 = ops.psdsf_argmin.launches
        grants[str(device)] = [(g.fid, g.agent) for g in
                               al.allocate_batched(use_kernel="pergrant")]
        launches[str(device)] = ops.psdsf_argmin.launches - n0
    assert grants[str(dev)] == grants["cpu"] and grants["cpu"]
    assert launches == {str(dev): len(grants["cpu"]) + 1, "cpu": 0}


# -- K5 flash attention and K6 WKV6 --------------------------------------------

# tolerances by kernel variant: repro_torch.kernels.flash_attention.ops.tolerance
@pytest.mark.parametrize("B,H,K,S,T,D,causal,window", [
    (1, 12, 2, 256, 256, 128, True, 0),    # qwen2-1.5b heads
    (2, 4, 2, 200, 200, 16, True, 5),      # window below the tile, ragged
    (2, 6, 3, 96, 96, 32, True, 17),
    (1, 2, 1, 70, 130, 64, False, 0),      # non-causal, T != S
    (1, 2, 1, 48, 16, 16, False, 4),       # rows with no valid key
    (1, 4, 2, 129, 129, 256, True, 0),     # gemma3 head dim
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_kernel_equals_plain(dev, B, H, K, S, T, D, causal,
                                             window, dtype):
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(dev).manual_seed(S * T + D)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, T, K, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, T, K, D), generator=g, device=dev).to(dtype)
    variant = ("flash_tc" if dtype != torch.float32 and D >= 64 else "flash")
    n0 = ops.flash_attention.launches
    by0 = ops.flash_attention.variant_launches[variant]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    assert ops.flash_attention.variant_launches[variant] == by0 + 1
    want = ops.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **ops.tolerance(variant, dtype, v))


@pytest.mark.parametrize("window", [1024, 0], ids=["windowed", "global"])
def test_flash_tc_hymba_prefill_equals_plain(dev, window):
    """K5 at hymba-1.5b's prefill shape, (4, 25, 2048, 64) x (4, 5, 2048,
    64) bf16 causal (a GQA group of 5): on its 29 local layers with the
    window of 1024 keys, where the 16 query tiles' windows start at
    different key tiles, and on its 3 global layers with none; the
    tensor-core kernel, within its tolerance of the plain version."""
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(dev).manual_seed(24 + window)
    q = torch.randn((4, 2048, 25, 64), generator=g, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((4, 2048, 5, 64), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    by0 = ops.flash_attention.variant_launches["flash_tc"]
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.variant_launches["flash_tc"] == by0 + 1
    want = ops.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               **ops.tolerance("flash_tc", q.dtype, v))


@pytest.mark.parametrize("B", [4, 1])
@pytest.mark.parametrize("S,T", [(1500, 1500), (224, 1500)],
                         ids=["encoder", "cross"])
def test_flash_tc_whisper_noncausal_equals_plain(dev, S, T, B):
    """K5 at whisper-large-v3's two non-causal prefill shapes, bf16, MHA
    (20 heads of 64): the encoder's self-attention over its 1500 frames
    (11 full key tiles and a ragged one of 92 keys, which TMA's box runs
    past) and the decoder's cross-attention, 224 queries (a full query tile
    and a ragged one) against the 1500 frames; at the served batch 4 and
    at 1.  The tensor-core kernel, within its tolerance of the plain
    version."""
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(dev).manual_seed(S + T + B)
    q = torch.randn((B, S, 20, 64), generator=g, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((B, T, 20, 64), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    by0 = ops.flash_attention.variant_launches["flash_tc"]
    got = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.flash_attention.variant_launches["flash_tc"] == by0 + 1
    want = ops.flash_attention_ref(q, k, v, causal=False)
    assert got.shape == want.shape == (B, S, 20, 64)
    torch.testing.assert_close(got.float(), want.float(),
                               **ops.tolerance("flash_tc", q.dtype, v))


@pytest.mark.parametrize("T,causal", [(2048, True), (1601, False),
                                      (65, False)],
                         ids=["self", "cross", "cross-ragged-65"])
def test_flash_tc_vlm_equals_plain(dev, T, causal):
    """K5 at llama-3.2-vision's prefill shapes cut to batch 1, bf16, GQA
    with 64 query heads over 8 kv heads of 128 (query head h reads kv head
    h // 8): its self layers' causal 2048 x 2048, its cross layers'
    non-causal 2048 queries against the 1601 media keys (12 key tiles of
    128 and a ragged one of 65, which TMA's box runs past), and a
    non-causal T of 65 alone (one ragged key tile).  The tensor-core
    kernel, within its tolerance of the plain version."""
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(dev).manual_seed(T + causal)
    q = torch.randn((1, 2048, 64, 128), generator=g, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((1, T, 8, 128), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    by0 = ops.flash_attention.variant_launches["flash_tc"]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.variant_launches["flash_tc"] == by0 + 1
    want = ops.flash_attention_ref(q, k, v, causal=causal)
    assert got.shape == want.shape == (1, 2048, 64, 128)
    torch.testing.assert_close(got.float(), want.float(),
                               **ops.tolerance("flash_tc", q.dtype, v))


# K5 at deepseek-v2's MLA head dims: q and k 192 wide, v 128 wide
@pytest.mark.parametrize("B,H,K,S,T,causal,window", [
    (1, 4, 4, 256, 256, True, 0),       # a kv head a query head, as MLA
    (2, 4, 4, 200, 200, True, 48),      # window, ragged S
    (1, 4, 2, 130, 130, True, 0),       # GQA, ragged tail
    (1, 2, 1, 70, 130, False, 0),       # non-causal, T != S
    (1, 2, 1, 48, 16, False, 4),        # rows with no valid key
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_flash_tc_mla_equals_plain(dev, B, H, K, S, T, causal, window,
                                   dtype):
    """flash_tc.cu's (192, 128) instance == the plain version within
    ``ops.tolerance``; the output is v's head dim."""
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(dev).manual_seed(S * T + K)
    q = torch.randn((B, S, H, 192), generator=g, device=dev).to(dtype)
    k = torch.randn((B, T, K, 192), generator=g, device=dev).to(dtype)
    v = torch.randn((B, T, K, 128), generator=g, device=dev).to(dtype)
    assert ops.variant(dtype, 192, 128) == "flash_tc"
    by0 = ops.flash_attention.variant_launches["flash_tc"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.variant_launches["flash_tc"] == by0 + 1
    want = ops.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.shape == want.shape == (B, S, H, 128)
    torch.testing.assert_close(got.float(), want.float(),
                               **ops.tolerance("flash_tc", dtype, v))
    if not causal and window and S >= T + window:   # rows seeing no key
        assert bool((got[:, T + window - 1:] == 0).all())


def test_flash_tc_mla_reads_the_kv_projection(dev):
    """MLA's call as the port makes it: q and k concatenated (k's RoPE part
    shared by every head), v a view of the (B, S, H, 128 + 128) kv
    projection, read in place."""
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(dev).manual_seed(11)
    B, S, H = 2, 300, 4
    bf = torch.bfloat16
    q = torch.randn((B, S, H, 192), generator=g, device=dev).to(bf)
    kv = torch.randn((B, S, H, 256), generator=g, device=dev).to(bf)
    k_rope = torch.randn((B, S, 1, 64), generator=g, device=dev).to(bf)
    k = torch.cat([kv[..., :128], k_rope.expand(B, S, H, 64)], dim=-1)
    v = kv[..., 128:]
    assert not v.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(),
                               **ops.tolerance("flash_tc", bf, v))


@pytest.mark.parametrize("dtype,dqk,dv", [(torch.float32, 192, 128),
                                          (torch.bfloat16, 192, 192),
                                          (torch.bfloat16, 128, 64)])
def test_unequal_head_dims_off_the_instances_raise(dev, dtype, dqk, dv):
    """f32 at (192, 128) (flash.cu takes one D) and bf16 at a pair that no
    flash_tc instance takes raise KernelError; nothing launches and nothing
    falls back."""
    from repro_torch.kernels import KernelError
    from repro_torch.kernels.flash_attention import ops

    q = torch.zeros((1, 64, 2, dqk), device=dev, dtype=dtype)
    v = torch.zeros((1, 64, 2, dv), device=dev, dtype=dtype)
    n0 = ops.flash_attention.launches
    with pytest.raises(KernelError, match="one D"):
        ops.flash_attention(q, q, v, causal=True)
    assert ops.flash_attention.launches == n0


#: the inputs of :func:`k5_equal_d_outputs`: B, H, K, S, T, causal, window
K5_DIGEST_CASES = ((2, 4, 2, 300, 300, True, 0), (1, 4, 4, 260, 260, True, 48),
                   (1, 2, 1, 96, 200, False, 0))
#: :func:`k5_equal_d_outputs` of flash_tc.cu as it was before its template
#: took (DQK, DV) pairs, one head dim for q, k and v (printed by this file
#: run as a script on that checkout; NVIDIA H100 80GB HBM3)
K5_EQUAL_D_DIGESTS = {
    "64": "c02efe08d3cbcc3d37c8b3f92fee2345e6db29eb04049a5d23b1bed7f4165220",
    "128": "a9f6a87da45fdd5b52e185deca7864eb2f085c864de068890f22e98a9a01af1c",
    "256": "6fc6528d4115a60c0f70faaab578f4aaadb48de11c95fc27fe80355cbe9b0dce"}


def k5_equal_d_outputs(dev):
    """flash_tc.cu at its equal head dims (64, 128, 256), bf16 and f16, on
    inputs drawn on the host from numpy seeds -> {D: sha256 of the
    outputs' bytes}."""
    from repro_torch.kernels.flash_attention import ops

    digests = {}
    for D in (64, 128, 256):
        h = hashlib.sha256()
        for dtype in (torch.bfloat16, torch.float16):
            for B, H, K, S, T, causal, window in K5_DIGEST_CASES:
                rng = np.random.default_rng(S + T + D + window)
                q, k, v = (torch.as_tensor(rng.standard_normal(
                    shape, np.float32)).to(dtype).to(dev) for shape in
                    ((B, S, H, D), (B, T, K, D), (B, T, K, D)))
                out = ops.flash_attention(q, k, v, causal=causal,
                                          window=window)
                h.update(out.cpu().view(torch.int16).numpy().tobytes())
        digests[str(D)] = h.hexdigest()
    return digests


def test_flash_tc_equal_head_dims_give_the_old_bits(dev):
    """The (64, 64), (128, 128) and (256, 256) instances of the (DQK, DV)
    template give the outputs of the one-D kernel before it, bit for bit."""
    assert k5_equal_d_outputs(dev) == K5_EQUAL_D_DIGESTS


def test_flash_attention_kernel_reads_strides(dev):
    """q/k/v as views of a fused projection (non-contiguous heads)."""
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(dev).manual_seed(3)
    qkv = torch.randn((2, 100, 8 + 2 + 2, 64), generator=g, device=dev)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = ops.flash_attention(q, k, v, causal=True, window=0)
    want = ops.flash_attention_ref(q, k, v, causal=True, window=0)
    torch.testing.assert_close(got, want,
                               **ops.tolerance("flash", torch.float32, v))


@pytest.mark.parametrize("D", [64, 128])
def test_flash_tc_reads_a_fused_projection(dev, D):
    """bf16 q/k/v as views of a fused projection: strides and base
    addresses multiples of 16 bytes, read in place by TMA."""
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(dev).manual_seed(D)
    qkv = torch.randn((2, 300, 12 + 2 + 2, D), generator=g,
                      device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :12], qkv[:, :, 12:14], qkv[:, :, 14:]
    assert not q.is_contiguous()
    by0 = ops.flash_attention.variant_launches["flash_tc"]
    got = ops.flash_attention(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert ops.flash_attention.variant_launches["flash_tc"] == by0 + 1
    want = ops.flash_attention_ref(q, k, v, causal=True, window=0)
    torch.testing.assert_close(got.float(), want.float(),
                               **ops.tolerance("flash_tc", torch.bfloat16, v))


@pytest.mark.parametrize("case", ["row stride", "base address"])
def test_flash_tc_refuses_what_tma_cannot_read(dev, case):
    """A bf16 call on the tensor-core kernel whose strides or base address
    are not multiples of 16 bytes raises; nothing launches."""
    from repro_torch.kernels import KernelError
    from repro_torch.kernels.flash_attention import ops

    if case == "row stride":        # heads of 68 elements: 136 bytes
        q = torch.zeros((1, 64, 4, 68), device=dev,
                        dtype=torch.bfloat16)[..., :64]
    else:                           # one element past a 16-byte boundary
        q = torch.zeros(64 * 4 * 64 + 1, device=dev,
                        dtype=torch.bfloat16)[1:].view(1, 64, 4, 64)
    k = torch.zeros((1, 64, 2, 64), device=dev, dtype=torch.bfloat16)
    n0 = ops.flash_attention.launches
    with pytest.raises(KernelError, match="TMA"):
        ops.flash_attention(q, k, k, causal=True)
    assert ops.flash_attention.launches == n0


@pytest.mark.parametrize("B,S,H,D,chunk,strong", [
    (2, 128, 3, 16, 32, False), (1, 70, 2, 64, 64, False),
    (1, 2000, 4, 64, 64, False), (1, 160, 2, 8, 32, True),
    (2, 64, 40, 64, 64, True), (1, 2000, 40, 64, 64, False),
    (2, 100, 3, 40, 48, True), (1, 90, 2, 30, 32, False)])
def test_wkv6_kernel_equals_plain(dev, B, S, H, D, chunk, strong):
    from repro_torch.kernels.rwkv6 import ops

    g = torch.Generator(dev).manual_seed(S + H)
    r, k, v = (torch.randn((B, S, H, D), generator=g, device=dev) * 0.5
               for _ in range(3))
    z = torch.randn((B, S, H, D), generator=g, device=dev)
    lw = -torch.exp(z * 2.0 + 2.0 if strong else z * 0.5)
    u = torch.randn((H, D), generator=g, device=dev) * 0.5
    s0 = torch.randn((B, H, D, D), generator=g, device=dev)
    tol = dict(rtol=1e-3, atol=2e-3) if strong else dict(rtol=0, atol=1e-4)
    for state0 in (None, s0):
        n0 = ops.wkv6.launches
        y, s = ops.wkv6(r, k, v, lw, u, chunk=chunk, state0=state0)
        torch.cuda.synchronize()
        assert ops.wkv6.launches == n0 + 1
        yr, sr = ops.wkv6_ref(r, k, v, lw, u, chunk=chunk, state0=state0)
        assert torch.isfinite(y).all() and torch.isfinite(s).all()
        torch.testing.assert_close(y, yr, **tol)
        torch.testing.assert_close(s, sr, **tol)


def test_wkv6_kernel_reads_unaligned_inputs(dev):
    """Inputs that start off a 16-byte boundary (views one float into their
    storage) take the kernel's single-float loads, with the same result."""
    from repro_torch.kernels.rwkv6 import ops

    B, S, H, D = 1, 100, 2, 16
    g = torch.Generator(dev).manual_seed(3)
    flat = [torch.randn(B * S * H * D + 1, generator=g, device=dev) * 0.5
            for _ in range(4)]
    r, k, v, z = (t[1:].view(B, S, H, D) for t in flat)
    lw = -torch.exp(z)
    u = torch.randn((H, D), generator=g, device=dev) * 0.5
    assert r.data_ptr() % 16 and r.is_contiguous()
    y, s = ops.wkv6(r, k, v, lw, u, chunk=32)
    yr, sr = ops.wkv6_ref(r, k, v, lw, u, chunk=32)
    torch.testing.assert_close(y, yr, rtol=0, atol=1e-4)
    torch.testing.assert_close(s, sr, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "gemma3_12b", "rwkv6_3b",
                                  "granite_moe_3b", "hymba_1_5b"])
def test_model_on_card_equals_cpu(dev, arch):
    """The same weights on the card (K5/K6) and on the CPU (their plain
    versions), f32 compute: prefill logits and cache, then decode steps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import launch_counts
    from repro_torch.models.common import get_family, load_reference_params
    from repro_torch.nn.param import init_params

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32")
    fam = get_family(cfg)
    tree = init_params(fam.template(cfg), torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)), dtype=torch.int32)
    out = {}
    for device in (dev, torch.device("cpu")):
        model = load_reference_params(fam.build(cfg, device=device), tree)
        t = toks.to(device)
        n0 = launch_counts()
        logits, cache = fam.prefill(model, cfg, t[:, :32], max_seq=40)
        n1 = launch_counts()
        steps = [logits]
        for i in range(32, 36):
            lg, cache = fam.decode_step(model, cfg, cache, t[:, i:i + 1], i)
            steps.append(lg)
        out[device.type] = ([x.float().cpu() for x in steps],
                            {k: c.float().cpu() for k, c in cache.items()},
                            {k: n1[k] - n0[k] for k in n0})
    kernel = "wkv6" if cfg.family == "ssm" else "flash_attention"
    assert out["cuda"][2][kernel] == cfg.n_layers
    assert out["cpu"][2] == {"flash_attention": 0, "wkv6": 0}
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for name in out["cpu"][1]:
        # the K/V cache is bf16: an f32 difference in an earlier layer may
        # round a value to the neighbouring bf16 number (rtol), and a value
        # near zero carries that earlier difference, up to about 1e-3 at
        # these magnitudes (atol)
        tol = (dict(rtol=2 ** -7, atol=1e-3) if name in ("k", "v", "conv")
               else dict(rtol=1e-4, atol=1e-4))
        torch.testing.assert_close(out["cuda"][1][name], out["cpu"][1][name],
                                   **tol)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_on_card_equals_cpu(dev, with_state):
    """hymba's Mamba head (the associative scan) on the card and on the
    CPU at a small width (E 256, N 16, S 300), the same weights: in f32
    compute the output, ``h`` and the conv tail within 1e-4; in bf16 the
    card no further from the CPU's f32 result than twice the CPU's bf16,
    plus 1e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import _fill
    from repro_torch.nn import ssm
    from repro_torch.nn.param import Params, init_params

    base = dataclasses.replace(get_config("hymba_1_5b", smoke=True),
                               d_model=256, ssm_state=16)
    tree = init_params(ssm.mamba_template(base),
                       torch.Generator().manual_seed(2))
    tree["A_log"] = torch.rand(tree["A_log"].shape,
                               generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((2, 300, 256)),
                        dtype=torch.float32)
    state = ((torch.as_tensor(rng.standard_normal((2, 256, 16)),
                              dtype=torch.float32),
              torch.as_tensor(rng.standard_normal((2, ssm.CONV_K - 1, 256)),
                              dtype=torch.float32))
             if with_state else None)
    out = {}
    for device in (dev, torch.device("cpu")):
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, compute_dtype=dtype)
            node = Params(ssm.mamba_template(cfg), device=device)
            _fill(node, tree)
            st = None if state is None else (
                state[0].to(device), state[1].to(device, cfg.cdtype()))
            y, (h, tail) = ssm.mamba_apply(node, cfg,
                                           x.to(device, cfg.cdtype()), st)
            out[device.type, dtype] = [a.float().cpu() for a in (y, h, tail)]
    for a, b in zip(out["cuda", "float32"], out["cpu", "float32"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for card, cpu16, cpu32 in zip(out["cuda", "bfloat16"],
                                  out["cpu", "bfloat16"],
                                  out["cpu", "float32"]):
        assert torch.isfinite(card).all()
        assert (float((card - cpu32).abs().max())
                <= 2 * float((cpu16 - cpu32).abs().max()) + 1e-2)


def _moe_layer(impl, dtype, cf):
    """granite-smoke's MoE layer (weights from a seeded generator) in
    ``dtype`` compute, and (4, 256) tokens of inputs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.nn import layers as L
    from repro_torch.nn.param import init_params

    cfg = dataclasses.replace(get_config("granite_moe_3b", smoke=True),
                              moe_impl=impl, capacity_factor=cf,
                              compute_dtype=dtype)
    tree = init_params(L.moe_template(cfg), torch.Generator().manual_seed(0))
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(4, 256, cfg.d_model)), dtype=torch.float32).to(cfg.cdtype())
    return cfg, tree, x


def _moe_run(cfg, tree, x, device):
    from repro_torch.models.common import _fill
    from repro_torch.nn import layers as L
    from repro_torch.nn.param import Params

    params = Params(L.moe_template(cfg), device=device)
    _fill(params, tree)
    routing = []
    out = L.moe_apply(params, cfg, x.to(device), routing=routing)
    return out, routing[0]


@pytest.mark.parametrize("impl", ["grid_local", "grid", "ragged"])
def test_moe_apply_on_card_repeats_bit_for_bit(dev, impl):
    """The MoE layer on the card, bf16 compute, capacity factor 1 (the
    grids drop pairs): two runs on the same inputs give the same bits and
    the same drops.  The combine gathers each token's K outputs and sums
    them in slot order; no scatter-add adds in a racing order."""
    cfg, tree, x = _moe_layer(impl, "bfloat16", 1.0)
    a, ra = _moe_run(cfg, tree, x, dev)
    b, rb = _moe_run(cfg, tree, x, dev)
    assert torch.equal(a, b)
    assert torch.equal(ra.experts, rb.experts)
    assert int(ra.dropped) == int(rb.dropped)
    assert (int(ra.dropped) > 0) == (impl != "ragged")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["grid_local", "grid", "ragged"])
def test_moe_apply_on_card_equals_cpu(dev, impl, dtype):
    """The MoE layer on the card against the CPU at capacity factor 4 (no
    drops, so a token's output depends on its own routing only).  f32
    compute: the same routing and 1e-4, the order of f32 sums.  bf16
    compute: a router logit that rounds the other way can flip a choice,
    so at least 99% of tokens route alike, and on those the outputs agree
    within rtol 2**-5, atol 2**-5 max|out|: each side rounds the router,
    the three products, SiLU and the slot sum to bf16 (2**-9 each,
    relative to what it rounds), and the products' sums cancel, so the
    bound is taken against the largest output."""
    cfg, tree, x = _moe_layer(impl, dtype, 4.0)
    got, rg = _moe_run(cfg, tree, x, dev)
    want, rw = _moe_run(cfg, tree, x, torch.device("cpu"))
    got, same = got.cpu().float(), (rg.experts.cpu() == rw.experts).all(-1)
    want = want.float()
    if dtype == "float32":
        assert bool(same.all())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        return
    assert float(same.float().mean()) >= 0.99
    ok = same.reshape(got.shape[:2])
    torch.testing.assert_close(got[ok], want[ok], rtol=2 ** -5,
                               atol=2 ** -5 * float(want.abs().max()))


@pytest.mark.parametrize("crit", ["drf", "tsf", "psdsf", "rpsdsf"])
@pytest.mark.parametrize("J", [300, 301])
def test_pooled_fill_on_k3_equals_plain(dev, crit, J, monkeypatch):
    """The deterministic pooled fill is one K3 launch on the card and
    equals the same fill with K3 swapped for its plain version; a J that
    is not a multiple of 4 is padded and cropped."""
    from repro_torch.core.filling_torch import progressive_fill_torch
    from repro_torch.kernels.epoch_persistent import ops as k3
    from repro_torch.kernels.epoch_persistent.ref import persistent_epoch_ref

    rng = np.random.default_rng(J)
    N = 40
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    D = t(2.0 ** rng.integers(-2, 2, (N, 2)))
    C = t(rng.integers(4, 13, (J, 2)))
    phi = t(np.array([0.5, 1.0, 2.0])[np.arange(N) % 3])
    allowed = torch.as_tensor(rng.random((N, J)) > 0.2, device=dev)
    kw = dict(criterion=crit, policy="pooled", tie="low", max_steps=16384,
              allowed=allowed)
    n0 = k3.persistent_epoch.launches
    x = progressive_fill_torch(D, C, phi, None, **kw)
    assert k3.persistent_epoch.launches == n0 + 1
    assert x.device.type == "cuda" and x.shape == (N, J)
    monkeypatch.setattr(et, "persistent_epoch", persistent_epoch_ref)
    assert torch.equal(x, progressive_fill_torch(D, C, phi, None, **kw))
    assert k3.persistent_epoch.launches == n0 + 1
    res = C - x.float().T @ D
    fits = (D[:, None, :] <= res[None] + 1e-6).all(-1) & allowed
    assert not fits.any() and int(x.sum()) < 16384


@pytest.mark.parametrize("name,want", [
    ("PS-DSF", [19, 0, 2, 20]), ("rPS-DSF", [19, 2, 2, 19]),
    ("BF-DRF", [19, 2, 2, 19])])
def test_paper_example_rows_on_the_card(dev, name, want):
    """The paper's deterministic schedulers on the card equal the numpy
    filler (PS-DSF and rPS-DSF pooled on K3, BF-DRF on the step loop)."""
    from repro_torch.core.filling import PAPER_SCHEDULERS, progressive_fill
    from repro_torch.core.filling_torch import progressive_fill_torch
    from repro_torch.core.instance import paper_example

    inst = paper_example()
    cfg = PAPER_SCHEDULERS[name]
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    x = progressive_fill_torch(
        t(inst.demands), t(inst.capacities), t(inst.weights), None,
        criterion=cfg.criterion, policy=cfg.server_policy, tie=cfg.tie,
        lookahead=cfg.lookahead)
    assert x.device.type == "cuda"
    assert x.flatten().tolist() == want
    np.testing.assert_array_equal(x.cpu().numpy(),
                                  progressive_fill(inst, cfg, seed=0).x)


def test_paper_tables_on_the_card(dev):
    """``launch.paper_tables`` on the card: its deterministic rows equal the
    CPU run's, the pooled PS-DSF and rPS-DSF fills are one K3 launch
    each, and the trial means stay within 0.8 of the CPU run's."""
    from repro_torch.kernels.epoch_persistent import ops as k3
    from repro_torch.launch import paper_tables

    n0 = k3.persistent_epoch.launches
    got = paper_tables.run(print_csv=False, device=dev)
    assert k3.persistent_epoch.launches == n0 + 2
    want = paper_tables.run(print_csv=False, device="cpu")
    for (table, sched, i, v, p), (*_, w, _) in zip(got, want):
        if sched in paper_tables.DETERMINISTIC:
            assert v == w, (table, sched, i)
        elif table == "T1_alloc_mean":
            assert abs(v - w) <= 0.8, (sched, i, v, w)


def test_rrr_trials_on_the_card_saturate(dev):
    from repro_torch.core.filling_torch import fill_trials_torch
    from repro_torch.core.instance import paper_example

    inst = paper_example()
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    x = fill_trials_torch(
        t(inst.demands), t(inst.capacities), t(inst.weights), 64,
        generator=torch.Generator(device=dev).manual_seed(1),
        criterion="rpsdsf", policy="rrr", tie="random")
    assert x.device.type == "cuda" and x.shape == (64, 2, 2)
    assert (x.reshape(64, 4).cpu() == torch.tensor([19, 2, 2, 19],
                                                   dtype=torch.int32)).all()


# -- the epoch loop and the fill's step loop as captured CUDA graphs --------

LOOP_PATHS = {"plain": dict(select="plain", shards=1),
              "tiles": dict(select="tiles", shards=1),
              "shards2": dict(select="plain", shards=2)}


def _loop_args(dev, crit, N=64, J=300, seed=9):
    """run_loop's arguments for an instance on the card: quantized demands,
    phi != 1, placement constraints, a per-agent limit of 2."""
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    D = torch.as_tensor(2.0 ** rng.integers(-2, 2, (N, 2)), **f64)
    C = torch.as_tensor(rng.integers(4, 13, (J, 2)), **f64)
    perms = torch.as_tensor(np.stack([rng.permutation(J) for _ in range(8)]),
                            dtype=torch.int32, device=dev)
    return et.epoch_state(
        torch.zeros((N, J), **f64), D, D, C, C.clone(),
        torch.as_tensor(np.array([0.5, 1.0, 2.0])[np.arange(N) % 3], **f64),
        torch.as_tensor(rng.integers(1, 9, N), **f64),
        torch.as_tensor(rng.random((N, J)) > 0.2, device=dev), perms,
        torch.zeros(J, dtype=torch.int32, device=dev), 0, 0, J, 2, 1e-9,
        kind=crit, lookahead=False, use_limit=True)


def _fresh(args):
    return [a.clone() if torch.is_tensor(a) else a for a in args]


def _k12():
    from repro_torch.kernels.psdsf_score import ops

    return ops.masked_argmin1d.launches + ops.masked_argmin2d.launches


@pytest.mark.parametrize("path", list(LOOP_PATHS))
@pytest.mark.parametrize("crit", ["drf", "tsf", "psdsf", "rpsdsf"])
@pytest.mark.parametrize("pol", ["pooled", "rrr"])
def test_loop_graph_equals_eager_step(dev, crit, pol, path):
    """``run_loop`` on the card (chunks of ``CHUNK`` steps replayed from a
    captured graph) equals the step function run eagerly, one step and one
    flag read at a time, on every array it returns and every state array;
    a second run replays the cached graph, and on the tiles loop adds one
    K1/K2 launch a step to the counters, dead steps included."""
    args = _loop_args(dev, crit)
    kw = dict(kind=crit, policy=pol, lookahead=False, use_limit=True,
              max_steps=1024, **LOOP_PATHS[path])
    eager_args = _fresh(args)
    tensors = dict(zip(et.LOOP_TENSORS, eager_args[:16]))
    tensors["perms"] = tensors["perms"].long()
    loop = et.EpochLoop(tensors, **kw)
    loop.reset(*eager_args[16:])
    want = et.drive(loop, 1)
    graph_args = _fresh(args)
    got = et.run_loop(*graph_args, **kw)
    count = int(got[2])
    assert count > et.CHUNK
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(graph_args[:8], eager_args[:8]):
        assert torch.equal(a, b)
    c0, k0 = et.CAPTURE_COUNT, _k12()
    again = et.run_loop(*_fresh(args), **kw)
    assert et.CAPTURE_COUNT == c0
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    launched = _k12() - k0
    if path == "tiles":
        assert launched % et.CHUNK == 0 and count <= launched < count + \
            et.CHUNK
    else:
        assert launched == 0


def _bucket_epoch(dev, n_fw, n_ag):
    """The reference's no-retrace instance (tests/test_engine_parity.py)
    on the plain loop: one (8, 8) bucket for 5-8 frameworks and agents."""
    D = np.array([(1.0 + (n % 3), 2.0) for n in range(n_fw)])
    C = np.full((n_ag, 2), 8.0)
    return et.run_epoch(
        "rpsdsf", "pooled", X=np.zeros((n_fw, n_ag)), D=D, C=C,
        FREE=C.copy(), phi=np.ones(n_fw), allowed=np.ones((n_fw, n_ag), bool),
        wanted=np.full(n_fw, 4.0), true_demands=D, kernel=None, device=dev)


def test_same_bucket_epochs_do_not_recapture(dev):
    """The counterpart of the reference's no-retrace test: after a first
    epoch of the bucket, epochs of other shapes in it capture nothing and
    dispatch once each."""
    _bucket_epoch(dev, 5, 5)
    c0, d0 = et.CAPTURE_COUNT, et.DISPATCH_COUNT
    g1 = _bucket_epoch(dev, 6, 6)
    g2 = _bucket_epoch(dev, 7, 8)
    assert g1 and g2
    assert et.DISPATCH_COUNT == d0 + 2, "one dispatch per epoch"
    assert et.CAPTURE_COUNT == c0, "same padded bucket must not recapture"
    assert g2 == _bucket_epoch("cpu", 7, 8)


def test_interleaved_allocators_get_their_own_grants(dev, monkeypatch):
    """Two allocators of one bucket, with K3 swapped for its plain version
    (the graphed loop): begin, begin, commit, commit gives each the grants
    it gets alone."""
    from repro_torch.core.online import OnlineAllocator
    from repro_torch.kernels.epoch_persistent.ref import persistent_epoch_ref

    monkeypatch.setattr(et, "persistent_epoch", persistent_epoch_ref)

    def make(k):
        al = OnlineAllocator(2, criterion="rpsdsf", server_policy="pooled",
                             seed=k, device=dev)
        for j in range(12 + k):
            al.add_agent(f"a{j:02d}", (8.0, 4.0 + 4 * k))
        for n in range(10 - k):
            al.register(f"f{n}", demand=(1.0 + ((n + k) % 3), 1.0 + k),
                        wanted_tasks=6)
        return al

    def pairs(grants):
        return [(g.fid, g.agent) for g in grants]

    alone = [pairs(make(k).allocate_batched(use_kernel="fused"))
             for k in (0, 1)]
    assert alone[0] != alone[1] and all(alone)
    a, b = make(0), make(1)
    ea = a.begin_epoch(use_kernel="fused")
    eb = b.begin_epoch(use_kernel="fused")
    assert pairs(a.commit_epoch(ea)) == alone[0]
    assert pairs(b.commit_epoch(eb)) == alone[1]


def test_replays_sync_only_at_the_flag_read(dev):
    """Loading a segment into a cached graph and replaying its chunks never
    syncs the host; the per-chunk read of the alive flag does."""
    args = _loop_args(dev, "rpsdsf")
    tensors = dict(zip(et.LOOP_TENSORS, args[:16]))
    tensors["perms"] = tensors["perms"].long()
    g = et._graph(tensors, dict(kind="rpsdsf", policy="rrr", lookahead=False,
                                use_limit=True, max_steps=1024,
                                select="tiles", shards=1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with g.use():
            g.load(tensors, *args[16:])
            for _ in range(3):
                g.replay()
            with pytest.raises(RuntimeError):
                g.alive()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert g.alive()


@pytest.mark.parametrize("crit,pol,tie", [
    ("drf", "rrr", "random"), ("rpsdsf", "rrr", "random"),
    ("psdsf", "pooled", "random"), ("drf", "bestfit", "random")])
def test_fill_graph_equals_eager_steps(dev, crit, pol, tie):
    """The fill's step loop on the card (chunks of ``ALIVE_EVERY`` steps
    replayed from a captured graph) equals the same trials stepped eagerly
    on the card, each on its own generator; a second batch of the same
    shape captures nothing."""
    from repro_torch.core import filling_torch as ft

    rng = np.random.default_rng(6)
    N, J, T = 40, 64, 6
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    D, C = t(rng.integers(1, 4, (N, 2))), t(rng.integers(8, 25, (J, 2)))
    phi = t(np.array([0.5, 1.0, 2.0])[np.arange(N) % 3])
    allowed = torch.as_tensor(rng.random((N, J)) > 0.2, device=dev)
    kw = dict(criterion=crit, policy=pol, tie=tie, lookahead=False)
    x = ft.fill_trials_torch(D, C, phi, T, allowed=allowed,
                             generator=torch.Generator(dev).manual_seed(4),
                             **kw)
    gens = ft.trial_generators(torch.Generator(dev).manual_seed(4), T, dev)
    fill = ft.StepFill(D, C, phi, allowed, T, chunk=ft.ALIVE_EVERY, **kw)
    fill.start(gens, None, 4096)
    first = 0
    while bool(fill.flag):
        fill.draw(gens, first, 4096)
        fill.run()
        first += fill.chunk
    assert torch.equal(x, fill.X) and int(x.sum()) > 0
    c0 = ft.CAPTURE_COUNT
    y = ft.fill_trials_torch(D, C, phi, T, allowed=allowed,
                             generator=torch.Generator(dev).manual_seed(4),
                             **kw)
    assert ft.CAPTURE_COUNT == c0 and torch.equal(x, y)


def test_a_capture_that_fails_raises(dev, monkeypatch):
    """A select that syncs the host cannot be captured: the loop raises
    KernelError instead of running the segment eagerly."""
    from repro_torch.kernels import KernelError

    def syncing(vec, ok, out):
        return torch.full((), int(torch.where(ok, vec, 3e38).argmin()),
                          dtype=torch.int32, device=vec.device)

    monkeypatch.setattr(et, "_tiles_1d", syncing)
    args = _loop_args(dev, "drf", N=24, J=40)
    with pytest.raises(KernelError, match="capturing"):
        et.run_loop(*args, kind="drf", policy="pooled", lookahead=False,
                    use_limit=True, max_steps=256, select="tiles")


SERVED = ("qwen2_1_5b", "qwen3_8b", "gemma3_12b", "mistral_nemo_12b",
          "granite_moe_3b", "rwkv6_3b", "deepseek_v2_236b", "hymba_1_5b",
          "whisper_large_v3", "llama32_vision_90b")


def _mla_card_config(**kw):
    """deepseek-smoke's narrow model (E 64, 4 heads, 2 layers, 8 experts)
    with deepseek-v2's head dims: q/k 128 + 64, v 128, a K5 instance
    (deepseek-smoke's 16 + 8 / 16 is none)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek_v2_236b", smoke=True),
                               head_dim=192, qk_nope_dim=128, qk_rope_dim=64,
                               v_head_dim=128, **kw)


def _vlm_card_config(**kw):
    """llama-vision-smoke's narrow model (E 64, 12 media tokens) cut to 2
    groups, with llama-3.2-vision's head dim 128 and its 8:1 GQA (8 query
    heads, 1 kv head): K5's (128, 128) tensor-core instance (the smoke
    config's D 16 goes to ``flash.cu``)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama32_vision_90b", smoke=True),
                               n_layers=10, n_heads=8, n_kv_heads=1,
                               head_dim=128, **kw)


def _served(arch):
    """The smoke config a card test serves: deepseek's and the VLM's with
    K5's dims."""
    from repro_torch.configs import get_config

    if arch == "deepseek_v2_236b":
        return _mla_card_config()
    if arch == "llama32_vision_90b":
        return _vlm_card_config()
    return get_config(arch, smoke=True)


#: the MLA config's first layer on the card against the CPU, bf16 compute:
#: relative L2 of its compressed cache, computed before any attention, so
#: only the matrix products' bf16 roundings differ
MLA_CARD_FIRST_LAYER_REL_L2 = 2 ** -7


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_mla_model_on_card_equals_cpu(dev, monkeypatch):
    """The MLA card config with the same bf16 weights, prefill then four
    decode steps: on the card in bf16 compute (K5's (192, 128) instance,
    once a layer; K5 takes no f32 at these dims) and on the CPU in bf16 and
    in f32 compute (K5's plain version).  The card lies no further from the
    CPU's f32 result than twice the CPU's bf16 result, plus 1e-2, on every
    output (``tests/test_torch_models.py``'s rule for the port against the
    reference in bf16); the first layer's compressed cache equals the CPU's
    bf16 one within the relative L2 above; every K5 launch lies within
    ``ops.tolerance`` of the plain version on its own inputs."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.serve import launch_counts
    from repro_torch.models import lm
    from repro_torch.models.common import load_reference_params
    from repro_torch.nn import layers
    from repro_torch.nn.param import init_params

    cfg = _mla_card_config(param_dtype="bfloat16")
    tree = init_params(lm.template(cfg), torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)), dtype=torch.int32)
    shadow = []

    class Shadow:
        @staticmethod
        def flash_attention(q, k, v, **kw):
            out = ops.flash_attention(q, k, v, **kw)
            if q.is_cuda:
                want = ops.flash_attention_ref(q, k, v, **kw)
                shadow.append(bool(torch.isclose(
                    out.float(), want.float(),
                    **ops.tolerance("flash_tc", q.dtype, v)).all()))
            return out

    out = {}
    monkeypatch.setattr(layers, "_k5", Shadow)
    for device, dtype in ((dev, "bfloat16"), ("cpu", "bfloat16"),
                          ("cpu", "float32")):
        run = dataclasses.replace(cfg, compute_dtype=dtype)
        model = load_reference_params(lm.build(run, device=device), tree)
        t = toks.to(device)
        n0 = launch_counts()
        by0 = ops.flash_attention.variant_launches["flash_tc"]
        logits, cache = lm.prefill(model, run, t[:, :32], max_seq=40)
        n1 = launch_counts()
        by1 = ops.flash_attention.variant_launches["flash_tc"]
        outputs = {"prefill": logits}
        for i in range(32, 36):
            outputs[f"decode{i}"], cache = lm.decode_step(
                model, run, cache, t[:, i:i + 1], i)
        outputs.update(cache)
        out[str(device), dtype] = (
            {k: x.float().cpu() for k, x in outputs.items()},
            n1["flash_attention"] - n0["flash_attention"], by1 - by0)
    card, cpu16, cpu32 = (out["cuda", "bfloat16"], out["cpu", "bfloat16"],
                          out["cpu", "float32"])
    assert card[1:] == (cfg.n_layers, cfg.n_layers)
    assert cpu16[1:] == cpu32[1:] == (0, 0)
    assert shadow == [True] * cfg.n_layers
    for name, want in cpu32[0].items():
        got = card[0][name]
        assert torch.isfinite(got).all(), name
        card_err = float((got - want).abs().max())
        cpu_err = float((cpu16[0][name] - want).abs().max())
        assert card_err <= 2 * cpu_err + 1e-2, (name, card_err, cpu_err)
    for name in ("ckv", "krope"):
        assert _rel_l2(card[0][name][0], cpu16[0][name][0]) \
            <= MLA_CARD_FIRST_LAYER_REL_L2, name


#: the VLM card config on the card against the CPU, bf16 compute: relative
#: L2 of what lies before any attention (group 0's first self layer's k/v)
#: or depends on the media alone (group 0's xk/xv)
VLM_CARD_FIRST_REL_L2 = 2 ** -7


def test_vlm_on_card_equals_cpu(dev, monkeypatch):
    """The VLM card config (2 groups, head dim 128) with the same bf16
    weights and non-zero gates, its prefill on the card in bf16 compute and
    on the CPU: K5 launched on the tensor-core kernel once a self layer,
    causal at (S, S), and once a cross layer, non-causal at (S, M), each
    launch within ``ops.tolerance`` of the plain version on its own inputs;
    group 0's first self layer's k/v and its xk/xv within the relative L2
    above of the CPU's; the logits finite."""
    import collections

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import vlm
    from repro_torch.models.common import load_reference_params
    from repro_torch.launch.serve import make_media
    from repro_torch.nn import layers
    from repro_torch.nn.param import init_params

    cfg = _vlm_card_config(param_dtype="bfloat16")
    tree = init_params(vlm.template(cfg), torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16)
    for name in ("gate_attn", "gate_ffn"):
        tree["groups"]["cross"][name].fill_(0.5)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)), dtype=torch.int32)
    calls, shadow = collections.Counter(), []

    class Shadow:
        @staticmethod
        def flash_attention(q, k, v, causal=True, window=0):
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            if q.is_cuda:
                calls[causal, q.shape[1], k.shape[1]] += 1
                want = ops.flash_attention_ref(q, k, v, causal=causal,
                                               window=window)
                shadow.append(bool(torch.isclose(
                    out.float(), want.float(),
                    **ops.tolerance("flash_tc", q.dtype, v)).all()))
            return out

    monkeypatch.setattr(layers, "_k5", Shadow)
    out = {}
    for device in (dev, torch.device("cpu")):
        model = load_reference_params(vlm.build(cfg, device=device), tree)
        by0 = ops.flash_attention.variant_launches["flash_tc"]
        logits, cache = vlm.prefill(model, cfg, toks.to(device), max_seq=44,
                                    media=make_media(cfg, 2, device))
        out[device.type] = (logits.float().cpu(),
                            {k: c.float().cpu() for k, c in cache.items()},
                            ops.flash_attention.variant_launches["flash_tc"]
                            - by0)
    M = cfg.n_media_tokens
    assert out["cuda"][2] == 10 and out["cpu"][2] == 0
    assert calls == {(True, 40, 40): 8, (False, 40, M): 2}
    assert shadow == [True] * 10
    assert torch.isfinite(out["cuda"][0]).all()
    card, cpu = out["cuda"][1], out["cpu"][1]
    for name in ("k", "v"):
        assert _rel_l2(card[name][0, 0], cpu[name][0, 0]) \
            <= VLM_CARD_FIRST_REL_L2, name
    for name in ("xk", "xv"):
        assert _rel_l2(card[name][0], cpu[name][0]) \
            <= VLM_CARD_FIRST_REL_L2, name


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", SERVED)
def test_graphed_decode_equals_eager(dev, arch, temperature):
    """The decode on its captured graph (one capture) and the same step run
    eagerly, from one prefill's cache, default bf16 compute: every step's
    logits, the tokens and the cache bit for bit, greedy and sampled from
    generators of one seed (whisper's prefill on the stub frontend's
    media, its decode reading the cached cross K/V)."""
    from repro_torch.launch import serve
    from repro_torch.models.common import get_family, init_model

    cfg = _served(arch)
    fam = get_family(cfg)
    model = init_model(fam, cfg, torch.Generator(dev).manual_seed(0))
    P, gen = 24, 9
    prompts = torch.randint(2, cfg.vocab_size, (3, P), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    runs = {}
    with torch.no_grad():
        logits, cache = fam.prefill(model, cfg, prompts, max_seq=P + gen,
                                    media=serve.make_media(cfg, 3, dev))
        first = serve.pick(logits[:, -1])
        for graph in (True, False):
            steps, served = [], {k: v.clone() for k, v in cache.items()}
            n = serve.CAPTURE_COUNT
            out = serve.decode(fam, model, cfg, served, first, P, gen,
                               temperature=temperature,
                               sampler=torch.Generator(dev).manual_seed(5),
                               graph=graph,
                               on_step=lambda lg: steps.append(lg.clone()))
            runs[graph] = (out["tokens"], steps, served,
                           serve.CAPTURE_COUNT - n)
    (tg, sg, cg, ng), (te, se, ce, ne) = runs[True], runs[False]
    assert (ng, ne) == (1, 0)
    np.testing.assert_array_equal(tg, te)
    assert len(sg) == len(se) == gen - 1
    for i, (a, b) in enumerate(zip(sg, se)):
        assert torch.equal(a, b), f"step {i}"
    for name in cache:
        assert torch.equal(cg[name], ce[name]), name


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", SERVED)
def test_graphed_serve_equals_eager_serve(dev, arch, temperature,
                                          monkeypatch):
    """``serve()`` on the card captures one decode graph a call and serves
    the tokens of the same serve on the eager decode."""
    from repro_torch.launch import serve

    kw = dict(smoke=True, batch=2, prompt_len=16, gen=7,
              temperature=temperature, seed=3, device="cuda")
    n = serve.CAPTURE_COUNT
    got = serve.serve(_served(arch), **kw)
    assert got["captures"] == 1 and serve.CAPTURE_COUNT == n + 1
    assert not any(got["launches"]["decode"].values())
    monkeypatch.setattr(serve, "decode", serve.decode_eager)
    want = serve.serve(_served(arch), **kw)
    assert want["captures"] == 0
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_a_decode_capture_that_fails_raises(dev, monkeypatch):
    """A decode step that reads the host cannot be captured: the serve
    raises KernelError after the warm-up and the capture, and no step runs
    eagerly in its place."""
    from repro_torch.kernels import KernelError
    from repro_torch.launch import serve
    from repro_torch.models import lm

    calls, real = [], lm.decode_step

    def syncing(*a, **k):
        capturing = torch.cuda.is_current_stream_capturing()
        calls.append(capturing)
        out = real(*a, **k)
        if capturing:
            out[0].sum().item()
        return out

    monkeypatch.setattr(lm, "decode_step", syncing)
    n = serve.CAPTURE_COUNT
    with pytest.raises(KernelError, match="capturing"):
        serve.serve("qwen2_1_5b", smoke=True, batch=2, prompt_len=8, gen=6,
                    device="cuda")
    assert calls == [False, True] and serve.CAPTURE_COUNT == n


def _mesh_args(dev, crit, N=64, J=304, seed=9):
    """epoch_loop's raw arguments for an instance with J divisible by 8:
    quantized demands, phi != 1, placement constraints, a per-agent limit
    of 2."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    D = torch.as_tensor(2.0 ** rng.integers(-2, 2, (N, 2)), **f32)
    C = torch.as_tensor(rng.integers(4, 13, (J, 2)), **f32)
    perms = torch.as_tensor(np.stack([rng.permutation(J) for _ in range(8)]),
                            dtype=torch.int32, device=dev)
    return (torch.zeros((N, J), **f32), D, D, C, C.clone(),
            torch.as_tensor(np.array([0.5, 1.0, 2.0])[np.arange(N) % 3],
                            **f32),
            torch.as_tensor(rng.integers(1, 9, N), **f32),
            torch.as_tensor(rng.random((N, J)) > 0.2, device=dev), perms,
            torch.zeros(J, dtype=torch.int32, device=dev), 0, 0, J, 2, 1e-9)


@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("crit", ["drf", "tsf", "psdsf", "rpsdsf"])
@pytest.mark.parametrize("pol", ["pooled", "rrr"])
def test_mesh_on_one_card_equals_plain_loop(dev, crit, pol, K):
    """``epoch_loop_mesh`` on K shards of the card (its captured graphs)
    equals the plain loop on the card and the same mesh on the CPU, on
    every returned array; a second run captures nothing."""
    from repro_torch.launch import mesh

    kw = dict(kind=crit, policy=pol, lookahead=False, use_limit=True,
              max_steps=1024)
    args = _mesh_args(dev, crit)
    want = et.epoch_loop(*args, **kw, kernel=None)
    got = et.epoch_loop_mesh(*args, **kw,
                             devices=mesh.shard_devices(K, dev))
    assert int(got[2]) > et.CHUNK
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cpu = et.epoch_loop_mesh(
        *(a.cpu() if torch.is_tensor(a) else a for a in args), **kw,
        devices=mesh.shard_devices(K, "cpu"))
    for a, b in zip(got, cpu):
        assert torch.equal(a.cpu(), b)
    c0 = et.CAPTURE_COUNT
    again = et.epoch_loop_mesh(*args, **kw,
                               devices=mesh.shard_devices(K, dev))
    assert et.CAPTURE_COUNT == c0
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_mesh_captures_once_per_shape_and_shards(dev):
    """The counterpart of the reference's mesh retrace test: a repeated
    (shape, K) key captures at most once."""
    from repro_torch.launch import mesh

    kw = dict(kind="drf", policy="pooled", lookahead=False, use_limit=True,
              max_steps=256)
    et.epoch_loop_mesh(*_mesh_args(dev, "drf"), **kw,
                       devices=mesh.shard_devices(2, dev))
    c0 = et.CAPTURE_COUNT
    et.epoch_loop_mesh(*_mesh_args(dev, "drf", seed=3), **kw,
                       devices=mesh.shard_devices(2, dev))
    assert et.CAPTURE_COUNT == c0
    et.epoch_loop_mesh(*_mesh_args(dev, "drf", J=320), **kw,
                       devices=mesh.shard_devices(2, dev))
    assert et.CAPTURE_COUNT <= c0 + 1
    et.epoch_loop_mesh(*_mesh_args(dev, "drf", J=320, seed=4), **kw,
                       devices=mesh.shard_devices(2, dev))
    assert et.CAPTURE_COUNT <= c0 + 1


def test_devices_clamp_to_the_cards(dev, monkeypatch):
    """``run_epoch(devices=8)`` on a machine with fewer cards takes at most
    that many (one card: the single-device path) and gives the same
    grants."""
    from repro_torch.launch import mesh

    calls, loop = [], et.epoch_loop_mesh

    def spy(*a, **k):
        calls.append(k["devices"])
        return loop(*a, **k)

    monkeypatch.setattr(et, "epoch_loop_mesh", spy)
    rng = np.random.default_rng(1)
    D = 2.0 ** rng.integers(-2, 2, (16, 2))
    C = rng.integers(4, 13, (40, 2)).astype(float)
    kw = dict(X=np.zeros((16, 40)), D=D, C=C, FREE=C.copy(), phi=np.ones(16),
              allowed=np.ones((16, 40), bool), wanted=np.full(16, 4.0),
              true_demands=D, device=dev)
    one = et.run_epoch("rpsdsf", "pooled", **kw)
    eight = et.run_epoch("rpsdsf", "pooled", **kw, devices=8)
    assert one == eight and one
    cards = mesh.device_count(dev)
    assert calls == ([] if cards < 2 else [min(8, 1 << (cards.bit_length()
                                                          - 1))])


# -- K5's backward and the train path on the card -------------------------------

BWD_CASES = [
    # B, H, K, S, T, D, DV, causal, window
    (2, 4, 2, 40, 40, 16, 16, True, 0),
    (1, 4, 4, 130, 130, 32, 32, True, 24),
    (1, 6, 2, 33, 80, 64, 64, False, 0),
    (2, 12, 2, 200, 200, 128, 128, True, 0),
    (1, 3, 1, 70, 50, 128, 128, True, 0),
    (1, 4, 4, 100, 100, 192, 128, True, 0),
    (1, 2, 1, 70, 66, 256, 256, True, 9),
    (1, 2, 1, 30, 20, 16, 16, True, 5),          # rows that see no key
]


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
def test_flash_bwd_kernel_equals_plain(dev, case, dtype):
    """``flash_bwd.cu`` (launched by name: the rule sends bf16 and f16 at
    (64, 64), (128, 128) and (192, 128) to ``flash_bwd_tc``) against
    ``flash_attention_bwd_ref`` on the same CUDA tensors: dq, dk, dv within
    ``ops.bwd_tolerance`` (relative L2), two runs the same bits, one
    launch counted a call."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)

    B, H, K, S, T, D, DV, causal, window = case
    g = torch.Generator(dev).manual_seed(S * T + D)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, T, K, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, T, K, DV), generator=g, device=dev).to(dtype)
    out = flash_attention_ref(q, k, v, causal=causal, window=window)
    dout = torch.randn(out.shape, generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=window)
    n0 = ops.flash_attention.bwd_launches
    by0 = ops.flash_attention.bwd_variant_launches["flash_bwd"]
    got = ops.bwd_launch("flash_bwd", q, k, v, out, dout, **kw)
    again = ops.bwd_launch("flash_bwd", q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.bwd_launches == n0 + 2
    assert ops.flash_attention.bwd_variant_launches["flash_bwd"] == by0 + 2
    want = flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, b)
        assert _rel_l2(a, w) <= ops.bwd_tolerance("flash_bwd", dtype)


#: the tensor-core backward's cases: B, H, K, S, T, D, DV, causal, window
BWD_TC_CASES = [
    (2, 12, 2, 200, 200, 128, 128, True, 0),     # qwen2's heads, ragged
    (1, 3, 1, 70, 50, 128, 128, True, 0),        # causal, S > T
    (1, 6, 2, 33, 80, 64, 64, False, 0),         # non-causal, T != S
    (1, 4, 4, 100, 100, 192, 128, True, 0),      # MLA's head dims
    (2, 16, 4, 333, 333, 192, 128, True, 48),    # MLA, GQA, window
    (1, 4, 2, 300, 300, 64, 64, True, 100),      # sliding window
    (2, 8, 2, 257, 513, 128, 128, False, 70),    # non-causal window
    (1, 2, 1, 48, 16, 64, 64, True, 5),          # rows that see no key
    (1, 6, 6, 640, 640, 128, 128, True, 0),      # five 128-row tiles
]


def _bwd_tc_inputs(dev, case, dtype, views=False):
    """-> (q, k, v, dout) of a case; with ``views`` q, k and v are views
    of one packed (B, S, H + 2K, D) tensor, as a fused projection gives
    them (S == T, D == DV)."""
    B, H, K, S, T, D, DV, causal, window = case
    g = torch.Generator(dev).manual_seed(S * T + D + H)
    if views:
        qkv = torch.randn((B, S, H + 2 * K, D), generator=g, device=dev)
        q, k, v = qkv.to(dtype).split([H, K, K], dim=2)
    else:
        q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
        k = torch.randn((B, T, K, D), generator=g, device=dev).to(dtype)
        v = torch.randn((B, T, K, DV), generator=g, device=dev).to(dtype)
    dout = torch.randn((B, S, H, DV), generator=g, device=dev).to(dtype)
    return q, k, v, dout


@pytest.mark.parametrize("views", [False, True], ids=["contiguous", "views"])
@pytest.mark.parametrize("case", BWD_TC_CASES,
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_flash_bwd_tc_kernel_equals_plain(dev, case, dtype, views):
    """``flash_bwd_tc.cu`` behind the forward kernel's output and
    log-sum-exp against ``flash_attention_bwd_ref`` on the same tensors:
    dq, dk, dv within ``ops.bwd_tolerance("flash_bwd_tc", ...)`` (relative
    L2), two runs the same bits, one launch counted a call on its variant;
    a row that sees no key gets dq = 0."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_mask, flash_attention_bwd_ref)

    B, H, K, S, T, D, DV, causal, window = case
    if views and (S != T or D != DV):
        pytest.skip("a packed qkv tensor has S == T and D == DV")
    assert ops.bwd_variant(dtype, D, DV) == "flash_bwd_tc"
    q, k, v, dout = _bwd_tc_inputs(dev, case, dtype, views)
    kw = dict(causal=causal, window=window)
    out, lse = ops.launch("flash_tc", q, k, v, with_lse=True, **kw)
    n0 = dict(ops.flash_attention.bwd_variant_launches)
    got = ops.flash_attention_bwd(q, k, v, out, dout, lse=lse, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, dout, lse=lse, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.bwd_variant_launches == dict(
        n0, flash_bwd_tc=n0["flash_bwd_tc"] + 2)
    want = flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    tol = ops.bwd_tolerance("flash_bwd_tc", dtype)
    for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, b), name
        assert torch.isfinite(a).all(), name
        assert _rel_l2(a, w) <= tol, (name, _rel_l2(a, w))
    empty = ~attention_mask(S, T, causal, window, dev).any(-1)
    assert (got[0][:, empty] == 0).all()


def test_flash_bwd_tc_needs_the_log_sum_exp(dev):
    """Without the forward's log-sum-exp (or with one of another shape)
    the tensor-core backward raises and launches nothing."""
    from repro_torch.kernels import KernelError
    from repro_torch.kernels.flash_attention import ops

    q, k, v, dout = _bwd_tc_inputs(dev, BWD_TC_CASES[0], torch.bfloat16)
    out, lse = ops.launch("flash_tc", q, k, v, causal=True, with_lse=True)
    n0 = ops.flash_attention.bwd_launches
    for bad in (None, lse[..., :200].contiguous(), lse.double()):
        with pytest.raises(KernelError, match="log-sum-exp"):
            ops.flash_attention_bwd(q, k, v, out, dout, lse=bad)
    assert ops.flash_attention.bwd_launches == n0


@pytest.mark.parametrize("case", [
    (2, 12, 2, 200, 200, 128, 128, True, 0),
    (1, 2, 1, 48, 16, 64, 64, True, 5),          # rows that see no key
    (2, 8, 2, 257, 513, 128, 128, False, 70),
    (1, 4, 4, 100, 100, 192, 128, True, 0),
    (1, 2, 1, 70, 66, 256, 256, True, 9),
], ids=lambda c: "-".join(map(str, c)))
def test_flash_tc_lse_leaves_the_output_bits(dev, case):
    """``flash_tc.cu`` with and without its log-sum-exp: the output bit for
    bit the same; the log-sum-exp within f32 rounding of
    ``flash_attention_lse_ref`` (rtol 1e-5, atol 1e-4 on values up to a
    few tens: the kernel's sums run in another order through ex2.approx),
    +inf on a row with no valid key and on the rows past S."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        BQ_LSE, flash_attention_lse_ref)

    B, H, K, S, T, D, DV, causal, window = case
    q, k, v, _ = _bwd_tc_inputs(dev, case, torch.bfloat16)
    kw = dict(causal=causal, window=window)
    plain = ops.launch("flash_tc", q, k, v, **kw)
    out, lse = ops.launch("flash_tc", q, k, v, with_lse=True, **kw)
    assert torch.equal(out, plain)
    assert lse.shape == (B, H, -(-S // BQ_LSE) * BQ_LSE)
    want = flash_attention_lse_ref(q, k, v, **kw)
    assert torch.isposinf(lse[..., S:]).all()
    got = lse[..., :S]
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


def test_flash_attention_under_grad_runs_the_backward_kernel(dev):
    """Under autograd on the card the wrapper's gradient is the backward
    kernel's, bit for bit, on the forward kernel's output."""
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               .requires_grad_(True) for shape in
               ((2, 96, 12, 128), (2, 96, 2, 128), (2, 96, 2, 128)))
    n0 = ops.flash_attention.bwd_launches
    tc0 = ops.flash_attention.bwd_variant_launches["flash_bwd_tc"]
    out = ops.flash_attention(q, k, v, causal=True)
    dout = torch.randn(out.shape, generator=g, device=dev).to(out.dtype)
    out.backward(dout)
    assert ops.flash_attention.bwd_launches == n0 + 1
    assert ops.flash_attention.bwd_variant_launches["flash_bwd_tc"] == tc0 + 1
    plain, lse = ops.launch("flash_tc", q.detach(), k.detach(), v.detach(),
                            causal=True, with_lse=True)
    assert torch.equal(plain, out.detach())
    want = ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                   out.detach(), dout, causal=True, lse=lse)
    for a, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(a, w)


#: K6's backward kernel against its plain backward, relative L2 a
#: gradient: f32 sums in other orders; under strong decay the exponents
#: are differences of cumulative log-decays near -1e3 to -1e4
WKV6_BWD_REL_L2, WKV6_BWD_REL_L2_STRONG = 1e-4, 1e-3


@pytest.mark.parametrize("B,S,H,D,chunk,strong", [
    (2, 128, 3, 16, 32, False), (1, 70, 2, 64, 64, False),
    (1, 2000, 4, 64, 64, False), (1, 160, 2, 8, 32, True),
    (2, 64, 40, 64, 64, True), (2, 100, 3, 40, 48, True),
    (1, 90, 2, 30, 32, False), (1, 5, 1, 4, 3, False),
    (1, 47, 2, 16, 20, False), (2, 87, 2, 32, 40, True),
    (2, 300, 3, 64, 64, False)])
def test_wkv6_backward_kernel_equals_plain_backward(dev, B, S, H, D, chunk,
                                                    strong):
    """K6's backward kernel (``wkv6_bwd.cu``) behind the forward kernel,
    through autograd, against ``wkv6_bwd_ref`` on the same inputs and
    cotangents, with and without a state0 and a final-state cotangent:
    every gradient within the tolerance, one backward launch a call, two
    launches the same bits, and the forward's output under grad the same
    bits as without.  Chunks of 20 and 40 with S = 2 chunks + 7 straddle
    the kernel's sub-chunks of 16; (2, 300, 3, 64, 64) takes a state0 and
    a final-state cotangent at D 64 over several streams and chunks."""
    from repro_torch.kernels.rwkv6 import ops

    g = torch.Generator(dev).manual_seed(S + H + D)
    r, k, v = (torch.randn((B, S, H, D), generator=g, device=dev) * 0.5
               for _ in range(3))
    z = torch.randn((B, S, H, D), generator=g, device=dev)
    lw = -torch.exp(z * 2.0 + 2.0 if strong else z * 0.5)
    u = torch.randn((H, D), generator=g, device=dev) * 0.5
    s0, ds = (torch.randn((B, H, D, D), generator=g, device=dev)
              for _ in range(2))
    dy = torch.randn((B, S, H, D), generator=g, device=dev)
    tol = WKV6_BWD_REL_L2_STRONG if strong else WKV6_BWD_REL_L2
    for state0, ds_end in ((None, None), (s0, ds)):
        ins = [t.clone().requires_grad_(True) for t in (r, k, v, lw, u)]
        if state0 is not None:
            ins.append(state0.clone().requires_grad_(True))
        n0 = (ops.wkv6.launches, ops.wkv6.bwd_launches)
        y, s = ops.wkv6(*ins[:5], chunk=chunk,
                        state0=ins[5] if state0 is not None else None)
        with torch.no_grad():
            y0, _ = ops.wkv6(r, k, v, lw, u, chunk=chunk, state0=state0)
        assert torch.equal(y.detach(), y0)
        torch.autograd.backward((y, s) if ds_end is not None else (y,),
                                (dy, ds_end) if ds_end is not None else (dy,))
        torch.cuda.synchronize()
        assert (ops.wkv6.launches - n0[0], ops.wkv6.bwd_launches - n0[1]) \
            == (2, 1)
        want = ops.wkv6_bwd_ref(r, k, v, lw, u, dy, chunk=chunk,
                                state0=state0, ds_end=ds_end)
        got = [t.grad for t in ins]
        for name, a, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                              want):
            assert torch.isfinite(a).all(), name
            assert _rel_l2(a, w) <= tol, (name, _rel_l2(a, w))
        _, _, starts = ops._launch(r, k, v, lw, u, state0, chunk)
        once, again = (ops.wkv6_bwd(r, k, v, lw, u, dy, chunk=chunk,
                                    state0=state0, ds_end=ds_end,
                                    starts=starts) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(once, again))
        assert all(torch.equal(a, b) for a, b in zip(once, got))


def test_wkv6_backward_needs_the_forward_states(dev):
    """The backward kernel takes f32 tensors and the forward's starting
    states; without them it raises before it launches."""
    from repro_torch.kernels import KernelError
    from repro_torch.kernels.rwkv6 import ops

    r, k, v = (torch.randn((1, 8, 2, 16), device=dev) for _ in range(3))
    logw = -torch.rand((1, 8, 2, 16), device=dev)
    u = torch.randn((2, 16), device=dev)
    n0 = ops.wkv6.bwd_launches
    with pytest.raises(KernelError, match="starting states"):
        ops.wkv6_bwd(r, k, v, logw, u, r)
    with pytest.raises(KernelError, match="f32"):
        ops.wkv6_bwd(r.half(), k, v, logw, u, r)
    assert ops.wkv6.bwd_launches == n0


TRAINED = SERVED
#: one train step on the card against the CPU's plain versions, and on
#: the card against itself with K5's plain backward, f32 compute: the
#: step's mean gradient, leaf by leaf (relative L2); f32 sums in other
#: orders
TRAIN_CARD_REL_L2 = 1e-4
#: the VLM card config's gradients are ill-conditioned in its forward: a
#: forward that differs by f32 rounding moves them by 1e-3 to 1e-2.  Card
#: against CPU, every leaf read as the optimizer receives it (H100): at
#: most 9.0e-3 (3.8e-3 the median); K5's plain versions (forward and
#: backward) run on the card 8.8e-3 from the CPU, so the gap lies outside
#: K5, and 1.2e-3 from the kernels (the forward kernel's f32 rounding);
#: K5's backward kernel against its plain backward behind the forward
#: kernel 6.4e-6, gated at TRAIN_CARD_REL_L2 below.  A control, the
#: self-attention's dq scaled by 1 + 1e-3 on the card, reads 1.08e-2
#: against the CPU (tests/_torch_card_grads.py prints these).  rwkv6's
#: smoke config, card against CPU (H100): at most 1.22e-4 (7.8e-5 the
#: median; layer 0's ``wr``, ``ln1``, ``mix_w1`` and the embedding), and
#: K6's plain versions (forward and backward) run on the card as far from
#: the CPU, so the gap lies outside K6; K6's backward kernel against its
#: plain backward behind the forward kernel at most 6.1e-6, gated at
#: TRAIN_CARD_REL_L2.  A control, K6's dr scaled by 1 + 1e-3 on the card,
#: reads 1.7e-3 against the CPU
TRAIN_CARD_ARCH_REL_L2 = {"llama32_vision_90b": 1e-2, "rwkv6_3b": 3e-4}


def _train_run(cfg, tree, batch, device):
    """One train step (2 micro-batches, lr 0 on the schedule's first step)
    from ``tree`` on ``device`` -> (loss, {path: the step's mean gradient,
    as the optimizer receives it, before the clip}, K5 forward and backward
    launches, K6 forward and backward launches)."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rwkv6 import ops as k6
    from repro_torch.models.common import get_family, load_reference_params
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import TrainConfig, init_state, make_train_step
    from repro_torch.tree import keypaths, leaves, tree_map

    # a copy: on its own device the loader takes the tensors as views
    model = load_reference_params(get_family(cfg).build(cfg, device=device),
                                  tree_map(torch.clone, tree))
    state = init_state(cfg, model)
    step = make_train_step(cfg, TrainConfig(accum_steps=2, opt=AdamWConfig(
        lr=1e-5, warmup_steps=1, total_steps=10)))
    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    g, update = {}, adamw.update

    def seen(ocfg, params, grads, opt, i):
        g.update(zip(keypaths(grads), (x.double().cpu() for x in leaves(grads))))
        return update(ocfg, params, grads, opt, i)
    def counts():
        return (ops.flash_attention.launches, ops.flash_attention.bwd_launches,
                k6.wkv6.launches, k6.wkv6.bwd_launches)
    n0 = counts()
    with mock.patch.object(adamw, "update", seen):
        metrics = step(state, b)
    n = [b - a for a, b in zip(n0, counts())]
    return float(metrics["loss"]), g, tuple(n[:2]), tuple(n[2:])


def _train_case(arch):
    """-> (config, weights, batch) of ``arch``'s served smoke config for a
    train step: f32 compute but for MLA, the VLM's cross gates 0.5, four
    sequences of 24 tokens and, for the enc-dec and VLM families, media."""
    from repro_torch.models.common import get_family
    from repro_torch.nn.param import init_params

    cfg = _served(arch)
    if not cfg.use_mla:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    tree = init_params(get_family(cfg).template(cfg),
                       torch.Generator().manual_seed(0))
    if cfg.family == "vlm":        # the reference's zero gates: set them
        for name in ("gate_attn", "gate_ffn"):
            tree["groups"]["cross"][name].fill_(0.5)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 25)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("encdec", "vlm"):
        batch["media"] = (rng.standard_normal(
            (4, cfg.n_media_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return cfg, tree, batch


@pytest.mark.parametrize("arch", TRAINED)
def test_train_step_on_card_equals_plain(dev, arch):
    """The same weights and batch, one train step on the card (K5's
    forward and backward kernels), on the card with K5's plain backward
    (``ref.flash_attention_bwd_ref``; one forward, so the same loss bits)
    and on the CPU (the plain versions).  The backward kernel against the
    plain backward: every gradient leaf within :data:`TRAIN_CARD_REL_L2`
    in f32 compute, within ``ops.bwd_tolerance`` in bf16.  f32 compute,
    the card against the CPU: the loss at rtol 1e-5 and every gradient
    leaf within :data:`TRAIN_CARD_REL_L2` (the VLM's within
    :data:`TRAIN_CARD_ARCH_REL_L2`).  The MLA config takes bf16 (K5's (192,
    128) instance is bf16/f16): each run's gradient against the CPU's f32
    one, the card's distance at most twice the CPU's bf16 plus 2e-2.  K5's
    backward launches once a forward call of each micro-batch."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.rwkv6 import ops as k6
    from repro_torch.models.common import get_family

    cfg, tree, batch = _train_case(arch)
    fam = get_family(cfg)
    with torch.no_grad():
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.models.common import load_reference_params

        model = load_reference_params(fam.build(cfg, device=dev), tree)
        n0 = (ops.flash_attention.launches, k6.wkv6.launches)
        fam.forward(model, cfg, torch.as_tensor(batch["tokens"][:2],
                                                device=dev),
                    media=(torch.as_tensor(batch["media"][:2], device=dev)
                           if "media" in batch else None))
        calls = ops.flash_attention.launches - n0[0]
        calls6 = k6.wkv6.launches - n0[1]

    def plain6(*args, starts=None, **kw):
        return k6.wkv6_bwd_ref(*args, **kw)
    card = _train_run(cfg, tree, batch, dev)
    with mock.patch.object(ops, "flash_attention_bwd",
                           ref.flash_attention_bwd_ref), \
            mock.patch.object(k6, "wkv6_bwd", plain6):
        mixed = _train_run(cfg, tree, batch, dev)
    cpu = _train_run(cfg, tree, batch, torch.device("cpu"))
    assert card[2][1] == 2 * calls and card[2][0] >= 2 * card[2][1]
    assert mixed[2] == (card[2][0], 0) and cpu[2] == (0, 0)
    assert card[3][1] == 2 * calls6 and card[3][0] >= 2 * card[3][1]
    assert mixed[3] == (card[3][0], 0) and cpu[3] == (0, 0)
    assert (calls6 > 0) == (cfg.family == "ssm")
    assert mixed[0] == card[0]
    tol = (TRAIN_CARD_REL_L2 if cfg.compute_dtype == "float32"
           else ops.bwd_tolerance(ops.bwd_variant(
               torch.bfloat16, cfg.head_dim, cfg.v_head_dim or cfg.head_dim),
               torch.bfloat16))
    for key, want in mixed[1].items():
        assert _rel_l2(card[1][key], want) <= tol, ("backward", key)
    if not cfg.use_mla:
        assert card[0] == pytest.approx(cpu[0], rel=1e-5)
        tol = TRAIN_CARD_ARCH_REL_L2.get(arch, TRAIN_CARD_REL_L2)
        for key, want in cpu[1].items():
            assert _rel_l2(card[1][key], want) <= tol, key
        return
    truth = _train_run(dataclasses.replace(cfg, compute_dtype="float32"),
                       tree, batch, torch.device("cpu"))[1]
    for key, want in truth.items():
        assert (_rel_l2(card[1][key], want)
                <= 2 * _rel_l2(cpu[1][key], want) + 2e-2), key


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_train_step_backward_launches_by_variant(dev, compute):
    """qwen2's smoke config at head dim 64, one train step of 2
    micro-batches: in bf16 compute every K5 backward (2 layers x 2
    micro-batches) on ``flash_bwd_tc`` behind a forward that wrote its
    log-sum-exp, none on ``flash_bwd``; in f32 compute every one on
    ``flash_bwd``; the loss and every gradient finite."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.common import get_family
    from repro_torch.nn.param import init_params

    cfg = dataclasses.replace(get_config("qwen2_1_5b", smoke=True),
                              head_dim=64, compute_dtype=compute)
    tree = init_params(get_family(cfg).template(cfg),
                       torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 97))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    n0 = dict(ops.flash_attention.bwd_variant_launches)
    loss, grads, (fwd, bwd), _ = _train_run(cfg, tree, batch, dev)
    n1 = ops.flash_attention.bwd_variant_launches
    on = "flash_bwd_tc" if compute == "bfloat16" else "flash_bwd"
    assert bwd == cfg.n_layers * 2 and fwd >= 2 * bwd
    assert {k: n1[k] - n0[k] for k in n1} == dict(
        dict.fromkeys(n1, 0), **{on: bwd})
    assert np.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_rwkv6_train_step_on_card_runs_k6_backward(dev, compute):
    """rwkv6's smoke config, one train step of 2 micro-batches on the card:
    every WKV gradient from K6's backward kernel (one launch a layer and
    micro-batch, behind two forward launches under remat "full"), the
    loss and every gradient finite."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import ops as k6
    from repro_torch.models.common import get_family
    from repro_torch.nn.param import init_params

    cfg = dataclasses.replace(get_config("rwkv6_3b", smoke=True),
                              compute_dtype=compute)
    tree = init_params(get_family(cfg).template(cfg),
                       torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 97))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    loss, grads, k5n, (fwd, bwd) = _train_run(cfg, tree, batch, dev)
    assert k5n == (0, 0)
    assert bwd == cfg.n_layers * 2 and fwd == 2 * bwd
    assert np.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads.values())


if __name__ == "__main__":
    print(json.dumps(k5_equal_d_outputs(torch.device("cuda"))))
