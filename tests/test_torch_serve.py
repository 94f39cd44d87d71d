"""The port's allocator-as-a-service front end (device="cpu") against the
reference's: the same decisions, grant for grant, and the same cache
statistics on every epoch backend; the multi-tenant smoke; the warm
restart; a reference state directory restarting into the port's service;
and a kernel error that the service does not retry."""
import pickle
import shutil

import pytest

from repro.launch import alloc_serve as ref_serve
from repro_torch.core import invariants
from repro_torch.kernels import KernelError
from repro_torch.launch import alloc_serve

SMALL = dict(n_agents=8, n_frameworks=4, n_profiles=2, rounds=4,
             criterion="rpsdsf", server_policy="pooled", seed=1)


def _recorded(module, monkeypatch, fn, **kw):
    """Run ``fn`` with every drain_epoch's grants recorded; -> (fn's
    result, the grants of every epoch)."""
    epochs = []
    drain = module.AllocatorService.drain_epoch

    def recording(self):
        out = drain(self)
        epochs.append([(g.fid, g.agent, g.n_executors) for g in out])
        return out

    monkeypatch.setattr(module.AllocatorService, "drain_epoch", recording)
    return fn(**kw), epochs


@pytest.mark.parametrize("use_kernel", [False, "pergrant", "fused"])
def test_serve_equals_reference(use_kernel, monkeypatch):
    want, want_epochs = _recorded(ref_serve, monkeypatch, ref_serve.serve,
                                  use_kernel=use_kernel, **SMALL)
    got, got_epochs = _recorded(alloc_serve, monkeypatch, alloc_serve.serve,
                                use_kernel=use_kernel, device="cpu", **SMALL)
    assert got_epochs == want_epochs
    assert sum(map(len, got_epochs)) > 0
    for key in ("epochs", "decisions", "cache"):
        assert got[key] == want[key], key
    assert got["cache"]["hits"] == SMALL["rounds"] - SMALL["n_profiles"]
    assert got["health"]["faults"] == want["health"]["faults"]


def test_multi_tenant_smoke_equals_reference(tmp_path):
    want = ref_serve.multi_tenant_smoke(str(tmp_path / "ref.json"),
                                        rounds=12)
    got = alloc_serve.multi_tenant_smoke(str(tmp_path / "port.json"),
                                         rounds=12, device="cpu")
    assert (tmp_path / "port.json").exists()
    for key in ("admissions", "credits", "tenant_shares", "epochs",
                "decisions", "ledger_invariants"):
        assert got[key] == want[key], key
    assert got["admissions"]["admission_admitted_total"] > 0


def test_serve_warm_restart_recovers_ledger_and_cache(tmp_path):
    agents = [(f"a{j}", (16.0, 64.0)) for j in range(8)]
    profiles = alloc_serve.make_profiles(2, 6, seed=3)
    svc = alloc_serve.AllocatorService(2, agents, seed=3,
                                       state_dir=str(tmp_path),
                                       snapshot_every=3, device="cpu")
    alloc_serve.drive(svc, profiles, rounds=6)
    assert svc.counters()["journal"]["snapshots"] >= 1
    svc.close()

    svc2 = alloc_serve.AllocatorService(2, agents, seed=3,
                                        state_dir=str(tmp_path), device="cpu")
    assert (svc2.recovery_stats["snapshot_loaded"]
            or svc2.recovery_stats["journal_records"] > 0)
    assert svc2.cache_load_stats["loaded"] > 0
    assert invariants.check(svc2.alloc) == []
    _first_repeat_is_a_hit(svc2, profiles[0])
    svc2.close()


def _first_repeat_is_a_hit(svc, profile):
    cache = svc.alloc.epoch_cache
    h0, m0 = cache.hits, cache.misses
    for fid in list(svc.alloc.frameworks):
        svc.complete(fid)
    for req in profile:
        svc.submit(req)
    svc.drain_epoch()
    assert cache.hits == h0 + 1 and cache.misses == m0, cache.stats()


@pytest.mark.parametrize("closed", [True, False], ids=["snapshot", "journal"])
def test_reference_state_dir_restarts_into_the_port(tmp_path, closed):
    """A reference service's snapshot, journal and cache spill are read by
    the port's: the ledger the reference's own restart recovers from the
    same files (checkpoint bytes equal), and the first repeat profile
    served from the recovered cache.  Unclosed, both replay the journal
    past the last snapshot."""
    agents = [(f"a{j}", (16.0, 64.0)) for j in range(8)]
    profiles = ref_serve.make_profiles(2, 6, seed=3)
    sd = tmp_path / "state"
    ref = ref_serve.AllocatorService(2, agents, seed=3, state_dir=str(sd),
                                     snapshot_every=3)
    ref_serve.drive(ref, profiles, rounds=4)   # snapshot after epoch 3
    for req in profiles[1]:      # leave a live ledger behind
        ref.submit(req)
    ref.drain_epoch()
    if closed:
        ref.close()
    else:
        ref.alloc.journal.close()    # flushed, as a killed process leaves it
    for name in ("ref", "port"):
        shutil.copytree(sd, tmp_path / name)

    want = ref_serve.AllocatorService(2, agents, seed=3,
                                      state_dir=str(tmp_path / "ref"))
    svc = alloc_serve.AllocatorService(2, agents, seed=3,
                                       state_dir=str(tmp_path / "port"),
                                       device="cpu")
    assert svc.recovery_stats == want.recovery_stats
    assert svc.recovery_stats["snapshot_loaded"]
    assert (svc.recovery_stats["replayed_records"] > 0) is not closed
    assert svc.cache_load_stats == want.cache_load_stats
    assert svc.cache_load_stats["loaded"] > 0
    assert invariants.check(svc.alloc) == []
    assert (pickle.dumps(svc.alloc.checkpoint())
            == pickle.dumps(want.alloc.checkpoint()))
    assert svc.alloc.frameworks
    _first_repeat_is_a_hit(svc, profiles[0])
    svc.close()
    want.close()


def test_kernel_error_is_not_retried(monkeypatch):
    """Injected faults and transient errors are retried with backoff; a
    KernelError fails the epoch at once."""
    svc = alloc_serve.AllocatorService(2, [("a0", (8.0, 8.0))],
                                       epoch_cache=False, backoff_s=0.0,
                                       criterion="rpsdsf", device="cpu",
                                       use_kernel="pergrant")
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise KernelError("psdsf_argmin: no such kernel")

    from repro_torch.kernels.psdsf_score import ops

    monkeypatch.setattr(ops, "psdsf_argmin", broken)
    svc.submit(alloc_serve.AllocRequest(fid="f0", demand=(1.0, 1.0),
                                        n_executors=2))
    with pytest.raises(KernelError, match="no such kernel"):
        svc.drain_epoch()
    assert len(calls) == 1
    assert svc.epoch_retries == 0 and svc.epoch_failures == 1

    def flaky(*a, **k):          # any other error: retried, then served
        monkeypatch.setattr(ops, "psdsf_argmin", ops.psdsf_argmin_ref)
        raise RuntimeError("transient")

    monkeypatch.setattr(ops, "psdsf_argmin", flaky)
    svc.submit(alloc_serve.AllocRequest(fid="f1", demand=(1.0, 1.0),
                                        n_executors=1))
    assert svc.drain_epoch()
    assert svc.epoch_retries == 1
