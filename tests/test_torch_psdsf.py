"""K4 and the per-grant backend on the CPU: the plain version of the fused
PS-DSF argmin (what the wrapper runs for CPU tensors) against the
reference's Pallas kernel in interpret mode, and the port's per-grant
allocator against the reference's, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.instance import make_instance, spark_cluster_heterogeneous
from repro.core.online import OnlineAllocator as RefAllocator
from repro.kernels.psdsf_score.ops import psdsf_argmin as pallas_psdsf_argmin
from repro_torch.core.online import OnlineAllocator
from repro_torch.kernels.psdsf_score import ops
from test_torch_cuda import psdsf_inputs


def _both(x, phi, d, res):
    want = pallas_psdsf_argmin(*(jnp.asarray(a) for a in (x, phi, d, res)),
                               interpret=True)
    got = ops.psdsf_argmin(*(torch.as_tensor(a) for a in (x, phi, d, res)))
    return ([float(got[0]), int(got[1]), int(got[2])],
            [float(want[0]), int(want[1]), int(want[2])])


@pytest.mark.parametrize("family", ["quantized", "non-dyadic"])
@pytest.mark.parametrize("N,J,R", [(5, 3, 2), (100, 64, 4), (300, 257, 3),
                                   (128, 128, 8), (1, 1, 1), (130, 129, 2)])
def test_psdsf_argmin_plain_equals_pallas(N, J, R, family):
    """Value and index, exactly: ties across tiles go in tile order."""
    got, want = _both(*psdsf_inputs(N * J + R, N, J, R, family))
    assert got == want


def test_psdsf_argmin_infeasible():
    d = np.full((4, 2), 100.0, np.float32)
    res = np.ones((3, 2), np.float32)
    got, want = _both(np.ones(4, np.float32), np.ones(4, np.float32), d, res)
    assert got == want and got[1:] == [-1, -1]


def test_psdsf_argmin_tie_goes_to_the_first_tile():
    """(0, 200) comes first in (n, j) order, but its tile (0, 1) comes
    after the tile (0, 0) of (1, 3): the reference kernel picks (1, 3)."""
    d = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    res = np.full((256, 2), 2.0, np.float32)
    res[200, 0] = res[3, 1] = 4.0      # 0.25 at (0, 200) and (1, 3)
    got, want = _both(np.ones(2, np.float32), np.ones(2, np.float32), d, res)
    assert got == want and got[1:] == [1, 3]


# -- the per-grant allocator ------------------------------------------------

def _exhausting_instance():
    """phi != 1, non-dyadic shares, and a framework that reaches its
    wanted count mid-epoch (its row then turns into the 3e38 sentinel)."""
    return make_instance(
        demands=[[2.0, 2.0], [1.0, 3.5], [1.0, 1.0], [0.5, 1.5]],
        capacities=[[4.0, 14.0], [8.0, 8.0], [6.0, 11.0], [9.0, 3.0]],
        weights=[2.0, 1.0, 0.5, 3.0]), [10**6, 3, 10**6, 2]


def _fill(cls, inst, wanted, use_kernel, **kw):
    al = cls(inst.n_resources, criterion="rpsdsf", server_policy="pooled",
             seed=0, **kw)
    for j in range(inst.n_servers):
        al.add_agent(f"a{j:03d}", inst.capacities[j])
    for n in range(inst.n_frameworks):
        al.register(f"f{n:03d}", demand=inst.demands[n],
                    wanted_tasks=wanted[n], phi=inst.weights[n])
    grants = al.allocate_batched(use_kernel=use_kernel)
    return ([(g.fid, g.agent, g.n_executors) for g in grants],
            al.rng.bit_generator.state)


@pytest.mark.parametrize("name", ["heterogeneous", "exhausting"])
def test_pergrant_allocator_equals_reference(name):
    if name == "heterogeneous":
        inst = spark_cluster_heterogeneous()
        wanted = [10**6] * inst.n_frameworks
    else:
        inst, wanted = _exhausting_instance()
    want = _fill(RefAllocator, inst, wanted, "pergrant")
    got = _fill(OnlineAllocator, inst, wanted, "pergrant", device="cpu")
    assert got == want
    assert len(got[0]) > 5
    if name == "exhausting":
        fids = [g[0] for g in got[0]]     # f003 stops at its 2, mid-epoch
        assert fids.count("f003") == 2 and fids[-1] != "f003"
