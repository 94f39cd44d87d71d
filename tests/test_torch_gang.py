"""The port's gang entry points (device="cpu") against the reference's:
``GangScheduler`` placement and priority shares, the gang-to-DES bridge,
and ``cluster_sim.run`` / ``run_des``, on the same inputs."""
import numpy as np
import pytest

from repro.cluster import gang as ref_gang
from repro.core import workloads as ref_workloads
from repro.core.simulator import SimConfig as RefSimConfig
from repro.core.simulator import SparkMesosSim as RefSim
from repro.launch import cluster_sim as ref_cluster_sim
from repro_torch.cluster import gang
from repro_torch.core import workloads
from repro_torch.core.simulator import SimConfig, SparkMesosSim
from repro_torch.launch import cluster_sim


def _constrained(mod, **kw):
    gs = mod.GangScheduler(criterion="rpsdsf", **kw)
    gs.add_slice("fat0", "v5e-64-fat-host")
    gs.add_slice("std0", "v5e-64")
    gs.submit(mod.JobSpec("pinned", "x", "s", 8, (16.0, 100.0, 16.0, 50.0),
                          allowed_slice_types=("v5e-64",)))
    return gs, gs.schedule(), gs.placement("pinned")


def _priority(mod, **kw):
    gs = mod.GangScheduler(criterion="drf", **kw)
    gs.add_slice("fat0", "v5e-64-fat-host")
    gs.submit(mod.JobSpec("prod", "x", "s", 100, (16.0, 100.0, 16.0, 50.0),
                          priority=3.0))
    gs.submit(mod.JobSpec("dev", "y", "s", 100, (16.0, 100.0, 16.0, 50.0),
                          priority=1.0))
    return gs, gs.schedule(), (gs.placement("prod"), gs.placement("dev"))


@pytest.mark.parametrize("case", [_constrained, _priority])
@pytest.mark.parametrize("batched", [False, True])
def test_gang_scheduler_equals_reference(case, batched):
    ref, ref_grants, ref_place = case(ref_gang, batched=batched)
    port, grants, place = case(gang, batched=batched, device="cpu")
    assert grants == ref_grants and place == ref_place
    assert grants
    assert port.utilization() == ref.utilization()
    if case is _constrained:
        assert set(place) <= {"std0"}


def _bridge(gmod, wmod, sim_cls, cfg):
    jobs = [gmod.JobSpec("a", "qwen3_8b", "s", 4,
                         (16.0, 120.0, 32.0, 220.0)),
            gmod.JobSpec("b", "gemma3_12b", "s", 2,
                         (16.0, 160.0, 32.0, 300.0))]
    src = wmod.gang_arrivals(jobs, arrival_gap_s=5.0, mean_task_s=20.0,
                             tasks_per_unit=2)
    agents = gmod.slice_agents({"v5e-64": 3})
    return sim_cls(agents, src, cfg).run()


def test_gang_workload_bridges_to_des():
    want = _bridge(ref_gang, ref_workloads, RefSim,
                   RefSimConfig(criterion="rpsdsf", batched=True, seed=0))
    got = _bridge(gang, workloads, SparkMesosSim,
                  SimConfig(criterion="rpsdsf", batched=True, seed=0,
                            device="cpu"))
    assert sum(len(v) for v in got.job_durations.values()) == 2
    assert got.makespan == want.makespan
    assert got.job_durations == want.job_durations
    np.testing.assert_array_equal(got.timeline, want.timeline)


@pytest.mark.parametrize("batched", [False, True])
def test_cluster_sim_run_equals_reference(batched):
    want = ref_cluster_sim.run("rpsdsf", 0, verbose=False, batched=batched)
    got = cluster_sim.run("rpsdsf", 0, verbose=False, batched=batched,
                          device="cpu")
    assert got == want and len(got) == 6


def test_cluster_sim_des_equals_reference():
    r0, f0, s0 = ref_cluster_sim.run_des("rpsdsf", 0, verbose=False)
    r1, f1, s1 = cluster_sim.run_des("rpsdsf", 0, verbose=False,
                                     device="cpu")
    assert r1.makespan == r0.makespan and f1 == f0 and s1 == s0
    np.testing.assert_array_equal(r1.timeline, r0.timeline)
