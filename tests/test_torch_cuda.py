"""The port's kernels on the card: each against its plain version on the
same CUDA tensors, exact equality.  Marked ``cuda``; skipped where no card
is present (run them on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``)."""
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


@pytest.mark.parametrize("N", [1, 7, 128, 300, 4096])
def test_masked_argmin1d_kernel_equals_plain(dev, N):
    from repro_torch.kernels.psdsf_score import ops

    rng = np.random.default_rng(N)
    s = _scores(rng, N, dev)
    for ok in (torch.as_tensor(rng.random(N) < 0.5, device=dev),
               torch.zeros(N, dtype=torch.bool, device=dev)):
        got, want = ops.masked_argmin1d(s, ok), ops.masked_argmin1d_ref(s, ok)
        assert [float(got[0]), int(got[1])] == [float(want[0]), int(want[1])]
    # a strided column, as the RRR visit passes it
    m = _scores(rng, (N, 3), dev)
    f = torch.as_tensor(rng.random((N, 3)) < 0.5, device=dev)
    got = ops.masked_argmin1d(m[:, 1], f[:, 1])
    want = ops.masked_argmin1d_ref(m[:, 1], f[:, 1])
    assert [float(got[0]), int(got[1])] == [float(want[0]), int(want[1])]


@pytest.mark.parametrize("N,J", [(3, 2), (130, 129), (9, 300), (512, 4096)])
def test_masked_argmin2d_kernel_equals_plain(dev, N, J):
    from repro_torch.kernels.psdsf_score import ops

    rng = np.random.default_rng(N * J)
    s = _scores(rng, (N, J), dev)
    for feas in (torch.as_tensor(rng.random((N, J)) < 0.5, device=dev),
                 torch.zeros((N, J), dtype=torch.bool, device=dev)):
        got, want = ops.masked_argmin2d(s, feas), ops.masked_argmin2d_ref(
            s, feas)
        assert ([float(got[0]), int(got[1]), int(got[2])]
                == [float(want[0]), int(want[1]), int(want[2])])


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
    wanted count clears the last feasible row and ends the epoch.  Row 0
    lies in the first chunk the kernel's liveness check reads: the kernel
    must see it cleared, stop after exactly that grant, and leave the same
    state as its plain version."""
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
