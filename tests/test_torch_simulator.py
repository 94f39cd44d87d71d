"""The port's simulator against the reference's: the golden simulator
values (tests/golden_sim_workloads.json, seeds 0-2), and sync and async
fused runs equal to the reference's fused runs on the same scenarios."""
import json
import os

import pytest

from repro.core import metrics as ref_metrics
from repro.core import simulator as ref_sim
from repro_torch.core import metrics
from repro_torch.core import simulator as port_sim
from repro_torch.core.simulator import (
    HOMOGENEOUS_AGENTS,
    PI,
    WC,
    SimConfig,
    SparkMesosSim,
    run_paper_experiment,
)

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "golden_sim_workloads.json")) as _f:
    GOLDEN = json.load(_f)
SCENARIOS = sorted({k.rsplit("/", 1)[0] for k in GOLDEN})


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_golden_sim_values(scenario):
    crit, mode, ag, pol = scenario.split("/")
    for seed in (0, 1, 2):
        want = GOLDEN[f"{scenario}/seed{seed}"]
        r = run_paper_experiment(
            crit, mode, agents=HOMOGENEOUS_AGENTS if ag == "homog" else None,
            server_policy=pol, jobs_per_queue=2, seed=seed, device="cpu")
        assert r.makespan == want["makespan"]
        assert list(r.timeline.shape) == want["timeline_shape"]
        assert float(r.timeline.sum()) == want["timeline_sum"]
        assert r.tasks_speculated == want["tasks_speculated"]
        for g, v in want["job_durations"].items():
            assert list(map(float, r.job_durations[g])) == v


def _fingerprint(sim_mod, metrics_mod, crit, mode, agents, pol, seed,
                 async_epochs, **extra):
    cfg = sim_mod.SimConfig(criterion=crit, server_policy=pol, mode=mode,
                            jobs_per_queue=2, seed=seed, batched=True,
                            use_kernel="fused", async_epochs=async_epochs,
                            **extra)
    hook = metrics_mod.GrantLogHook()
    r = sim_mod.SparkMesosSim(agents, {"Pi": PI, "WordCount": WC}, cfg,
                              hooks=[hook]).run()
    return (r.makespan, r.timeline.shape, float(r.timeline.sum()),
            r.tasks_speculated, hook.grants,
            {g: list(map(float, v)) for g, v in r.job_durations.items()})


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_fused_sync_and_async_equal_reference(scenario):
    crit, mode, ag, pol = scenario.split("/")
    agents = (HOMOGENEOUS_AGENTS if ag == "homog"
              else ref_sim.HETEROGENEOUS_AGENTS)
    for seed in (0, 1, 2):
        want = _fingerprint(ref_sim, ref_metrics, crit, mode, agents, pol,
                            seed, False)
        for async_epochs in (False, True):
            got = _fingerprint(port_sim, metrics, crit, mode, agents, pol,
                               seed, async_epochs, device="cpu")
            assert got == want, f"seed{seed} async={async_epochs}"


def test_async_requires_batched():
    with pytest.raises(ValueError, match="batched"):
        SparkMesosSim([("a0", (4.0, 4.0))], {"Pi": PI, "WordCount": WC},
                      SimConfig(async_epochs=True, batched=False,
                                device="cpu"))
