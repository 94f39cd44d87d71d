"""The reference's ``tests/test_journal.py``, retargeted to the port:
``repro_torch`` with ``device="cpu"`` (its entry points run on the card
otherwise).  The device-count restore case writes its 8-device checkpoint
in this process on eight logical CPU devices (``mesh.HOST_DEVICES``), so
the epoch runs the port's mesh; the reference writes it in a subprocess
with forced JAX devices.

Durability suite: write-ahead journal, snapshots, crash-consistent
recovery (repro.core.journal) and the persistent epoch cache spill.

The load-bearing guarantees pinned here:

  * checkpoint()/restore() round-trips are bit-exact: arrays, framework
    ledgers AND the rng stream position, so future grant sequences match;
  * recovery = snapshot + journal replay reproduces the uninterrupted
    run's state bit-for-bit (``invariants.recovery_parity``), with the
    PR-8 auditor green on every recovered state;
  * the kill-point property sweep: truncating the journal at EVERY record
    boundary (mid-begin, mid-grants, pre-commit, post-commit) recovers a
    state from which resuming the workload reproduces the uninterrupted
    run's remaining grant trace bit-for-bit — a begun-but-uncommitted
    epoch is deterministically aborted (rng rewound);
  * torn tails truncate, corrupt snapshots degrade to journal-only
    replay, a snapshot newer than the journal tail wins over stale
    records, and a commit digest contradicting its grant records refuses
    to replay;
  * the epoch-cache spill reloads with per-entry digest verification
    (one rotten entry costs one entry), and a warm-restarted serve
    replica answers its first repeat profile from the reloaded cache;
  * restoring a fused-devices checkpoint into a single-device process
    falls back to the host path instead of crashing.
"""
from __future__ import annotations

import functools
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.core import epoch_cache as _epoch_cache
from repro_torch.core import invariants, metrics
from repro_torch.core import journal as J
from repro_torch.core.online import OnlineAllocator as _PortAllocator


# the port's entry points run on the card unless asked for the CPU
OnlineAllocator = functools.partial(_PortAllocator, device="cpu")

N_EPOCHS = 4


def build_alloc(policy="pooled", criterion="drf", seed=0, **kw):
    return OnlineAllocator(2, criterion=criterion, server_policy=policy,
                           seed=seed, **kw)


def _pre_ops(al, e):
    """Deterministic structural churn before epoch ``e`` — every op is
    convergent (register-if-absent, release-what-is-held, absolute
    set_wanted), so re-running it after a partial replay reaches the same
    state the uninterrupted run had."""
    if e == 0:
        for j in range(5):
            if f"a{j}" not in al.state.agent2slot:
                al.add_agent(f"a{j}", (8.0, 16.0))
        for i in range(4):
            if f"fw{i}" not in al.frameworks:
                al.register(f"fw{i}", demand=(1.0 + 0.5 * (i % 3), 2.0),
                            wanted_tasks=5, phi=1.0 + (i % 2))
    if e == 2:
        fw = al.frameworks.get("fw0")
        if fw is not None:
            while fw.tasks.get("a1"):    # absolute target: convergent
                al.release_executor("fw0", "a1")
            al.set_wanted("fw0", 7)
    if e == 3:
        if "fw2" in al.frameworks:
            al.deregister("fw2")
        if "fw9" not in al.frameworks:
            al.register("fw9", demand=(0.5, 1.0), wanted_tasks=4)


def run_script(al, start=0, end=N_EPOCHS):
    """Run epochs [start, end) of the deterministic workload; returns the
    per-epoch grant traces."""
    traces = []
    for e in range(start, end):
        _pre_ops(al, e)
        grants = al.allocate(per_agent_limit=2)
        traces.append([(g.fid, g.agent, int(g.n_executors)) for g in grants])
    return traces


def journaled_run(tmp_path, policy, seed=0):
    al = build_alloc(policy, seed=seed)
    al.journal = J.Journal(os.path.join(tmp_path, J.JOURNAL_FILE),
                           fsync_every=4)
    traces = run_script(al)
    al.journal.close()
    al.journal = None
    return al, traces


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def test_append_scan_roundtrip(tmp_path):
    path = str(tmp_path / "j.wal")
    jn = J.Journal(path, fsync_every=2)
    recs = [{"t": J.AGENT_ADD, "name": f"a{i}", "cap": np.ones(2)}
            for i in range(5)]
    assert [jn.append(r) for r in recs] == list(range(5))
    jn.close()
    payloads, offsets, good_end, torn = J.scan_journal(path)
    assert torn == 0 and len(payloads) == 5 == len(offsets)
    assert good_end == os.path.getsize(path)
    for raw, rec in zip(payloads, recs):
        got = pickle.loads(raw)
        assert got["name"] == rec["name"]


def test_torn_tail_truncated_on_open(tmp_path):
    path = str(tmp_path / "j.wal")
    jn = J.Journal(path)
    for i in range(4):
        jn.append({"t": J.AGENT_ADD, "name": f"a{i}", "cap": np.ones(2)})
    jn.close()
    whole = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b"\x99\x00\x00\x00TORN")   # partial frame
    payloads, _, good_end, torn = J.scan_journal(path)
    assert len(payloads) == 4 and torn == 8 and good_end == whole
    jn2 = J.Journal(path)                  # open truncates the tail
    assert jn2.lsn == 4
    assert jn2.torn_truncated_bytes == 8
    assert os.path.getsize(path) == whole
    jn2.append({"t": J.AGENT_ADD, "name": "a9", "cap": np.ones(2)})
    jn2.close()
    payloads, _, _, torn = J.scan_journal(path)
    assert len(payloads) == 5 and torn == 0


def test_corrupt_mid_record_stops_scan(tmp_path):
    path = str(tmp_path / "j.wal")
    jn = J.Journal(path)
    for i in range(4):
        jn.append({"t": J.AGENT_ADD, "name": f"a{i}", "cap": np.ones(2)})
    jn.close()
    _, offsets, _, _ = J.scan_journal(path)
    raw = bytearray(open(path, "rb").read())
    raw[offsets[2] + J.FRAME.size + 3] ^= 0xFF   # corrupt record 2's payload
    open(path, "wb").write(bytes(raw))
    payloads, _, good_end, torn = J.scan_journal(path)
    assert len(payloads) == 2 and good_end == offsets[2] and torn > 0


def test_foreign_magic_raises(tmp_path):
    path = str(tmp_path / "not-a-journal")
    open(path, "wb").write(b"GARBAGE!" + b"\x00" * 32)
    with pytest.raises(J.JournalError, match="magic"):
        J.scan_journal(path)


def test_grant_digest_is_order_sensitive():
    a = J.grant_digest([("f0", "a0"), ("f1", "a1")])
    b = J.grant_digest([("f1", "a1"), ("f0", "a0")])
    assert a != b
    assert J.grant_digest([]) != b""


# ---------------------------------------------------------------------------
# checkpoint / restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["pooled", "rrr"])
def test_checkpoint_restore_bit_parity(policy):
    al = build_alloc(policy)
    run_script(al, end=2)
    ck = al.checkpoint()
    rb = build_alloc(policy)
    rb.restore(ck)
    assert invariants.recovery_parity(al, rb) == []
    assert invariants.check(rb) == []
    # future epochs draw the identical stream and grant identically
    assert run_script(al, start=2) == run_script(rb, start=2)
    assert invariants.recovery_parity(al, rb) == []


def test_restore_refuses_config_mismatch():
    al = build_alloc("pooled")
    run_script(al, end=1)
    ck = al.checkpoint()
    with pytest.raises(ValueError, match="server_policy"):
        build_alloc("rrr").restore(ck)
    with pytest.raises(ValueError, match="criterion"):
        build_alloc("pooled", criterion="tsf").restore(ck)
    bad = dict(ck)
    bad["format"] = "alloc-ckpt-v0"
    with pytest.raises(ValueError, match="format"):
        build_alloc("pooled").restore(bad)


def test_checkpoint_snapshot_file_roundtrip(tmp_path):
    al = build_alloc("pooled")
    run_script(al, end=2)
    lsn = J.write_snapshot(str(tmp_path), al)
    assert lsn == 0   # no journal attached
    snap = J.load_snapshot(str(tmp_path / J.SNAPSHOT_FILE))
    rb = build_alloc("pooled")
    rb.restore(snap["alloc"])
    assert invariants.recovery_parity(al, rb) == []


def test_corrupt_snapshot_loads_none(tmp_path):
    al = build_alloc("pooled")
    run_script(al, end=1)
    path = str(tmp_path / J.SNAPSHOT_FILE)
    J.save_snapshot(path, {"alloc": al.checkpoint(), "journal_lsn": 0})
    raw = bytearray(open(path, "rb").read())
    raw[len(J.SNAP_MAGIC) + J.FRAME.size + 10] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    assert J.load_snapshot(path) is None
    assert J.load_snapshot(str(tmp_path / "missing.bin")) is None


# ---------------------------------------------------------------------------
# recovery ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["pooled", "rrr"])
def test_journal_only_recovery_parity(tmp_path, policy):
    al, traces = journaled_run(str(tmp_path), policy)
    rec = build_alloc(policy)
    stats = J.recover(rec, str(tmp_path))
    assert not stats["snapshot_loaded"] and stats["replayed_records"] > 0
    assert invariants.check(rec) == []
    invariants.assert_recovery_parity(al, rec)


@pytest.mark.parametrize("policy", ["pooled", "rrr"])
def test_snapshot_plus_tail_recovery_parity(tmp_path, policy):
    al = build_alloc(policy)
    al.journal = J.Journal(str(tmp_path / J.JOURNAL_FILE), fsync_every=4)
    run_script(al, end=2)
    J.write_snapshot(str(tmp_path), al, al.journal)
    run_script(al, start=2)              # the tail past the snapshot
    al.journal.close()
    al.journal = None
    rec = build_alloc(policy)
    stats = J.recover(rec, str(tmp_path))
    assert stats["snapshot_loaded"] and stats["snapshot_lsn"] > 0
    assert stats["replayed_records"] > 0
    assert stats["skipped_older_than_snapshot"] == 0
    assert invariants.check(rec) == []
    invariants.assert_recovery_parity(al, rec)


def test_corrupt_snapshot_degrades_to_journal_replay(tmp_path):
    al = build_alloc("pooled")
    al.journal = J.Journal(str(tmp_path / J.JOURNAL_FILE))
    run_script(al, end=2)
    J.write_snapshot(str(tmp_path), al, al.journal)
    run_script(al, start=2)
    al.journal.close()
    al.journal = None
    path = str(tmp_path / J.SNAPSHOT_FILE)
    raw = bytearray(open(path, "rb").read())
    raw[len(J.SNAP_MAGIC) + J.FRAME.size + 5] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    rec = build_alloc("pooled")
    stats = J.recover(rec, str(tmp_path))
    assert stats["snapshot_corrupt"] and not stats["snapshot_loaded"]
    # the journal covers the run from the empty allocator: full parity
    invariants.assert_recovery_parity(al, rec)


def test_snapshot_newer_than_journal_tail(tmp_path):
    """A snapshot covering more records than the (damaged/replaced)
    journal holds: trust the self-contained snapshot, skip the stale
    records entirely instead of double-applying them."""
    al = build_alloc("pooled")
    al.journal = J.Journal(str(tmp_path / J.JOURNAL_FILE), fsync_every=4)
    run_script(al)
    J.write_snapshot(str(tmp_path), al, al.journal)
    al.journal.close()
    al.journal = None
    jpath = str(tmp_path / J.JOURNAL_FILE)
    _, offsets, _, _ = J.scan_journal(jpath)
    with open(jpath, "r+b") as f:        # journal loses its tail half
        f.truncate(offsets[len(offsets) // 2])
    rec = build_alloc("pooled")
    stats = J.recover(rec, str(tmp_path))
    assert stats["snapshot_loaded"]
    assert stats["skipped_older_than_snapshot"] == len(offsets) // 2
    assert stats["replayed_records"] == 0
    assert invariants.check(rec) == []
    invariants.assert_recovery_parity(al, rec)


def test_commit_digest_mismatch_refuses_replay(tmp_path):
    jn = J.Journal(str(tmp_path / J.JOURNAL_FILE))
    jn.append({"t": J.AGENT_ADD, "name": "a0", "cap": np.array([8.0, 16.0])})
    jn.append({"t": J.FW_REGISTER, "fid": "f0",
               "demand": np.array([1.0, 2.0]), "wanted": 2, "phi": 1.0,
               "allowed": None})
    al0 = build_alloc("pooled")
    jn.append({"t": J.EPOCH_BEGIN, "engine": "host", "fp": b"", "pal": None,
               "rng_state0": al0.rng.bit_generator.state})
    jn.append({"t": J.GRANT, "fid": "f0", "agent": "a0"})
    jn.append({"t": J.EPOCH_COMMIT, "rng_state": al0.rng.bit_generator.state,
               "n_grants": 1,
               "seq_digest": J.grant_digest([("f0", "WRONG")]),
               "fault": al0.fault_stats.as_dict(),
               "health": al0.device_health.state_dict()})
    jn.close()
    with pytest.raises(J.JournalError, match="digest"):
        J.recover(build_alloc("pooled"), str(tmp_path))


def test_nested_epoch_begin_refuses_replay(tmp_path):
    jn = J.Journal(str(tmp_path / J.JOURNAL_FILE))
    al0 = build_alloc("pooled")
    for _ in range(2):
        jn.append({"t": J.EPOCH_BEGIN, "engine": "host", "fp": b"",
                   "pal": None, "rng_state0": al0.rng.bit_generator.state})
    jn.close()
    with pytest.raises(J.JournalError, match="nested"):
        J.recover(build_alloc("pooled"), str(tmp_path))


def test_unknown_record_type_refuses_replay(tmp_path):
    jn = J.Journal(str(tmp_path / J.JOURNAL_FILE))
    jn.append({"t": "from-the-future"})
    jn.close()
    with pytest.raises(J.JournalError, match="unknown"):
        J.recover(build_alloc("pooled"), str(tmp_path))


# ---------------------------------------------------------------------------
# kill-point property sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["pooled", "rrr"])
def test_kill_point_sweep_every_record_boundary(tmp_path, policy):
    """Crash the journal at EVERY record boundary: each prefix must
    recover to an auditor-green state from which resuming the workload
    reproduces the uninterrupted run's remaining traces bit-for-bit (a
    cut inside an epoch bracket deterministically aborts that epoch; the
    resumed run re-executes it on the rewound rng stream)."""
    src = str(tmp_path / "full")
    os.makedirs(src)
    ref_al, ref_traces = journaled_run(src, policy)
    jpath = os.path.join(src, J.JOURNAL_FILE)
    payloads, offsets, good_end, _ = J.scan_journal(jpath)
    recs = [pickle.loads(p) for p in payloads]
    cuts = offsets + [good_end]
    for i, cut in enumerate(cuts):
        d = str(tmp_path / f"cut{i}")
        os.makedirs(d)
        raw = open(jpath, "rb").read()[:cut]
        open(os.path.join(d, J.JOURNAL_FILE), "wb").write(raw)
        rec_al = build_alloc(policy)
        stats = J.recover(rec_al, d)
        assert stats["replayed_records"] + stats["recovered_aborts"] >= 0
        assert invariants.check(rec_al) == [], f"auditor red at cut {i}"
        kept = recs[:i]
        committed = sum(1 for r in kept if r["t"] == J.EPOCH_COMMIT)
        in_bracket = (sum(1 for r in kept if r["t"] == J.EPOCH_BEGIN)
                      > committed)
        assert stats["recovered_aborts"] == (1 if in_bracket else 0)
        resumed = run_script(rec_al, start=committed)
        assert resumed == ref_traces[committed:], \
            f"resumed trace diverged after cut at record {i}"
        invariants.assert_recovery_parity(ref_al, rec_al)


def _ten_alloc(policy, seed=0):
    from repro_torch.core.preemption import PreemptionPolicy
    from repro_torch.core.tenancy import TenancyConfig

    return build_alloc(policy, seed=seed, preemption=PreemptionPolicy(),
                       tenancy=TenancyConfig(floors=(("a", 0.25),),
                                             max_admissions_per_epoch=2,
                                             queue_jump_cost=1.0,
                                             shield_cost=1.0,
                                             shield_epochs=2))


def _ten_pre_ops(al, e):
    """Control-plane churn before epoch ``e`` — convergent like _pre_ops:
    arrivals submit-if-absent, spends are guarded by the replay-restored
    jump/shield counters, so a partial replay plus a re-run reaches the
    uninterrupted run's exact control-plane state."""
    cp = al.tenancy
    if e == 0:
        for j in range(4):
            if f"a{j}" not in al.state.agent2slot:
                al.add_agent(f"a{j}", (8.0, 16.0))
        for i in range(5):
            fid = f"fw{i}"
            if fid not in al.frameworks and not cp.has_queued(fid):
                al.submit_admission(fid, demand=(1.0 + 0.5 * (i % 3), 2.0),
                                    wanted_tasks=4,
                                    tenant="a" if i % 2 else "b",
                                    now=float(i))
    if e == 1:
        for i in range(5, 8):
            fid = f"fw{i}"
            if fid not in al.frameworks and not cp.has_queued(fid):
                al.submit_admission(fid, demand=(0.5, 1.0), wanted_tasks=3,
                                    tenant="c", now=float(i))
    if e == 2:
        # spend the credits epochs 0-1 accrued: one queue jump, one shield
        if cp.jumps_total == 0:
            for entry in cp.queue:
                if cp.balance(entry.tenant) >= 1.0:
                    al.spend_queue_jump(entry.fid)
                    break
        if cp.shields_total == 0 and cp.balance("a") >= 1.0:
            al.spend_shield("a")
    if e == 3:
        if "fw0" in al.frameworks:
            al.set_wanted("fw0", 6)


def _ten_run_script(al, start=0, end=N_EPOCHS):
    traces = []
    for e in range(start, end):
        _ten_pre_ops(al, e)
        grants = al.allocate(per_agent_limit=2)
        traces.append([(g.fid, g.agent, int(g.n_executors)) for g in grants])
    return traces


@pytest.mark.parametrize("policy", ["pooled", "rrr"])
def test_kill_point_sweep_tenancy_records(tmp_path, policy):
    """The kill-point property over the control-plane record vocabulary:
    a tenancy workload whose journal carries admit-enqueue / admit /
    credit records (accrue, spend-jump AND spend-shield) recovers at
    EVERY record boundary auditor-green, resumes to the reference traces,
    and lands with queue contents and credit balances bit-identical
    (``ControlPlane.state_dict`` equality + full recovery parity)."""
    src = str(tmp_path / "full")
    os.makedirs(src)
    ref_al = _ten_alloc(policy)
    ref_al.journal = J.Journal(os.path.join(src, J.JOURNAL_FILE),
                               fsync_every=4)
    ref_traces = _ten_run_script(ref_al)
    ref_al.journal.close()
    ref_al.journal = None
    jpath = os.path.join(src, J.JOURNAL_FILE)
    payloads, offsets, good_end, _ = J.scan_journal(jpath)
    recs = [pickle.loads(p) for p in payloads]
    kinds = {r["t"] for r in recs}
    assert {J.ADMIT_ENQUEUE, J.ADMIT, J.CREDIT} <= kinds, \
        f"workload never journaled the tenancy records: {kinds}"
    ops = {r["op"] for r in recs if r["t"] == J.CREDIT}
    assert {"accrue", "spend-jump", "spend-shield"} <= ops, ops
    cuts = offsets + [good_end]
    for i, cut in enumerate(cuts):
        d = str(tmp_path / f"cut{i}")
        os.makedirs(d)
        raw = open(jpath, "rb").read()[:cut]
        open(os.path.join(d, J.JOURNAL_FILE), "wb").write(raw)
        rec_al = _ten_alloc(policy)
        J.recover(rec_al, d)
        assert invariants.check(rec_al) == [], f"auditor red at cut {i}"
        committed = sum(1 for r in recs[:i] if r["t"] == J.EPOCH_COMMIT)
        resumed = _ten_run_script(rec_al, start=committed)
        assert resumed == ref_traces[committed:], \
            f"resumed trace diverged after cut at record {i}"
        assert rec_al.tenancy.state_dict() == ref_al.tenancy.state_dict(), \
            f"control-plane state diverged after cut at record {i}"
        invariants.assert_recovery_parity(ref_al, rec_al)


def test_torn_final_record_recovery(tmp_path):
    """A SIGKILL mid-append leaves a partial final frame: recovery
    truncates it and lands on the last whole record's state."""
    al, ref_traces = journaled_run(str(tmp_path), "pooled")
    jpath = str(tmp_path / J.JOURNAL_FILE)
    with open(jpath, "ab") as f:
        f.write(J.FRAME.pack(10_000, 12345))
        f.write(b"half a rec")
    rec = build_alloc("pooled")
    stats = J.recover(rec, str(tmp_path))
    assert stats["torn_bytes"] > 0
    assert invariants.check(rec) == []
    invariants.assert_recovery_parity(al, rec)


# ---------------------------------------------------------------------------
# abort semantics (satellite: idempotent abort + epochs_aborted counter)
# ---------------------------------------------------------------------------

def test_abort_epoch_idempotent_no_epoch():
    al = build_alloc("pooled")
    assert al.abort_epoch() is False          # nothing in flight: no-op
    assert al.abort_epoch() is False
    assert al.fault_counters()["epochs_aborted"] == 0


def test_abort_epoch_idempotent_double_abort():
    al = build_alloc("rrr")
    run_script(al, end=1)
    state0 = al.rng.bit_generator.state
    epoch = al.begin_epoch(use_kernel="fused")
    assert al.abort_epoch(epoch) is True
    assert al.abort_epoch(epoch) is False     # second abort: no-op
    assert al.abort_epoch() is False
    assert al.rng.bit_generator.state == state0
    assert al.fault_counters()["epochs_aborted"] == 1


def test_dangling_fused_begin_recovers_as_abort(tmp_path):
    """A process that dies between begin_epoch and commit_epoch leaves an
    unclosed bracket; recovery aborts it deterministically and the counter
    surfaces it."""
    al = build_alloc("rrr")
    al.journal = J.Journal(str(tmp_path / J.JOURNAL_FILE), fsync_every=1)
    run_script(al, end=2)
    twin = build_alloc("rrr")               # uninterrupted reference
    run_script(twin, end=2)
    al.begin_epoch(use_kernel="fused")       # dies here: never committed
    al.journal.sync()
    al.journal._f.close()                    # simulated SIGKILL
    rec = build_alloc("rrr")
    stats = J.recover(rec, str(tmp_path))
    assert stats["recovered_aborts"] == 1
    assert rec.fault_counters()["epochs_aborted"] == 1
    assert invariants.check(rec) == []
    # the dangling epoch aborted: recovered == reference that never began
    invariants.assert_recovery_parity(twin, rec)
    assert run_script(rec, start=2) == run_script(twin, start=2)


# ---------------------------------------------------------------------------
# cache spill edges
# ---------------------------------------------------------------------------

def _mk_outcome(i):
    seq = tuple((n, n % 3) for n in range(i + 1))
    return _epoch_cache.EpochOutcome(
        seq, seq_digest=_epoch_cache.seq_digest_of(seq))


def test_cache_spill_one_corrupt_entry_among_valid(tmp_path):
    cache = _epoch_cache.EpochCache()
    keys = [bytes([i]) * 20 for i in range(5)]
    for i, k in enumerate(keys):
        cache.store(k, _mk_outcome(i))
    path = str(tmp_path / J.CACHE_FILE)
    cache.save(path)
    raw = bytearray(open(path, "rb").read())
    off = len(_epoch_cache._SPILL_MAGIC)
    for _ in range(2):                       # walk to the 3rd frame
        ln, _ = _epoch_cache._FRAME.unpack_from(raw, off)
        off += _epoch_cache._FRAME.size + ln
    raw[off + _epoch_cache._FRAME.size + 7] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    cold = _epoch_cache.EpochCache()
    res = cold.load(path)
    assert res == {"loaded": 4, "dropped": 1, "torn_bytes": 0}
    assert cold.load_dropped == 1 and len(cold) == 4
    for i, k in enumerate(keys):
        if k in cold._entries:
            assert cold._entries[k] == cache._entries[k]


def test_cache_spill_digest_mismatch_dropped(tmp_path):
    cache = _epoch_cache.EpochCache()
    good = _mk_outcome(2)
    bad = good._replace(seq=((9, 9),) + good.seq[1:])   # stale digest
    undigested = _epoch_cache.EpochOutcome(((0, 0),))   # no digest at all
    cache.store(b"g" * 20, good)
    cache.store(b"b" * 20, bad)
    cache.store(b"u" * 20, undigested)
    path = str(tmp_path / J.CACHE_FILE)
    cache.save(path)
    cold = _epoch_cache.EpochCache()
    res = cold.load(path)
    assert res["loaded"] == 1 and res["dropped"] == 2
    assert b"g" * 20 in cold._entries


def test_cache_spill_torn_tail(tmp_path):
    cache = _epoch_cache.EpochCache()
    for i in range(4):
        cache.store(bytes([i]) * 20, _mk_outcome(i))
    path = str(tmp_path / J.CACHE_FILE)
    cache.save(path)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-9])
    cold = _epoch_cache.EpochCache()
    res = cold.load(path)
    assert res["loaded"] == 3 and res["torn_bytes"] > 0


def test_cache_spill_foreign_file(tmp_path):
    path = str(tmp_path / J.CACHE_FILE)
    open(path, "wb").write(b"NOTACACH" + b"\x00" * 64)
    cold = _epoch_cache.EpochCache()
    assert cold.load(path) == {"loaded": 0, "dropped": 0, "torn_bytes": 0}
    assert cold.load(str(tmp_path / "missing")) == {
        "loaded": 0, "dropped": 0, "torn_bytes": 0}


# ---------------------------------------------------------------------------
# serve warm restart (in-process twin of the CI kill-restart smoke)
# ---------------------------------------------------------------------------

def test_serve_warm_restart_recovers_ledger_and_cache(tmp_path):
    from repro_torch.launch.alloc_serve import (AllocatorService, drive,
                                                make_profiles)

    agents = [(f"a{j}", (16.0, 64.0)) for j in range(8)]
    profiles = make_profiles(2, 6, seed=3)
    svc = AllocatorService(2, agents, seed=3, state_dir=str(tmp_path),
                           snapshot_every=3, device="cpu")
    drive(svc, profiles, rounds=6)
    counters = svc.counters()
    assert counters["journal_lag_fsync"] >= 0
    assert "journal" in counters and counters["journal"]["snapshots"] >= 1
    svc.close()

    svc2 = AllocatorService(2, agents, seed=3, state_dir=str(tmp_path),
                            device="cpu")
    assert (svc2.recovery_stats["snapshot_loaded"]
            or svc2.recovery_stats["journal_records"] > 0)
    assert svc2.cache_load_stats["loaded"] > 0
    assert invariants.check(svc2.alloc) == []
    cache = svc2.alloc.epoch_cache
    h0, m0 = cache.hits, cache.misses
    for fid in list(svc2.alloc.frameworks):
        svc2.complete(fid)
    for req in profiles[0]:
        svc2.submit(req)
    svc2.drain_epoch()
    assert cache.hits == h0 + 1 and cache.misses == m0, cache.stats()
    health = svc2.health()
    assert health["counters"]["journal_lag_snapshot"] >= 0
    svc2.close()


# ---------------------------------------------------------------------------
# device-count mismatch on restore
# ---------------------------------------------------------------------------

def test_restore_under_smaller_device_count_falls_back_to_host(tmp_path,
                                                              monkeypatch):
    """A checkpoint written by an 8-device process restores into a
    1-device runtime and keeps allocating — the engine clamps the device
    request and small epochs resolve to the host path; no crash, auditor
    green, and the host twin agrees bit-for-bit.  The 8-device checkpoint
    is written in this process on eight logical CPU devices
    (``mesh.HOST_DEVICES``), so its epoch runs the port's mesh; the
    reference writes it in a subprocess with eight forced JAX devices."""
    from repro_torch.core import engine_torch
    from repro_torch.launch import mesh

    calls, loop = [], engine_torch.epoch_loop_mesh

    def spy(*a, **k):
        calls.append(k["devices"])
        return loop(*a, **k)

    monkeypatch.setattr(engine_torch, "epoch_loop_mesh", spy)
    monkeypatch.setattr(mesh, "HOST_DEVICES", 8)
    al = build_alloc("rrr")
    run_script(al, end=1)
    g8 = al.allocate_batched(use_kernel="fused", devices=8)
    assert calls == [8] and g8
    one = build_alloc("rrr")
    run_script(one, end=1)
    assert ([(g.fid, g.agent) for g in g8] == [
        (g.fid, g.agent) for g in one.allocate_batched(use_kernel="fused")])
    out = tmp_path / "ckpt.pkl"
    out.write_bytes(pickle.dumps(al.checkpoint()))
    monkeypatch.setattr(mesh, "HOST_DEVICES", 1)
    ck = pickle.loads(out.read_bytes())
    al = build_alloc("rrr")
    al.restore(ck)
    assert invariants.check(al) == []
    twin = build_alloc("rrr")
    twin.restore(ck)
    g1 = al.allocate_batched(use_kernel="auto", devices=8)  # clamps, no crash
    g2 = twin.allocate_batched(use_kernel=False)
    assert ([(g.fid, g.agent) for g in g1]
            == [(g.fid, g.agent) for g in g2])
    assert invariants.check(al) == []
    assert calls == [8]


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_journal_stats_hook(tmp_path):
    al = build_alloc("pooled")
    al.journal = J.Journal(str(tmp_path / J.JOURNAL_FILE), fsync_every=64)
    hook = metrics.JournalStatsHook()
    hook.on_start(SimpleNamespace(alloc=al))
    run_script(al, end=2)
    hook.on_sample(metrics.Sample(t=1.0, alloc=None, busy=np.zeros(2)))
    assert hook.fsync_lag and hook.fsync_lag[0] >= 0
    summary = hook.summary()
    assert summary == al.journal.counters()
    assert summary["lsn"] > 0
    al.journal.close()
    # no journal attached: hook stays inert
    inert = metrics.JournalStatsHook()
    inert.on_start(SimpleNamespace(alloc=build_alloc("pooled")))
    inert.on_sample(metrics.Sample(t=1.0, alloc=None, busy=np.zeros(2)))
    assert inert.summary() == {}


def test_journal_counters_shape(tmp_path):
    jn = J.Journal(str(tmp_path / "j.wal"), fsync_every=3)
    for i in range(4):
        jn.append({"t": J.AGENT_ADD, "name": f"a{i}", "cap": np.ones(2)})
    c = jn.counters()
    assert c["lsn"] == 4
    assert c["records_since_fsync"] == 1      # 3 fsynced, 1 pending
    assert c["fsyncs"] >= 1
    jn.sync()
    assert jn.counters()["records_since_fsync"] == 0
    jn.mark_snapshot()
    assert jn.counters()["records_since_snapshot"] == 0
    jn.close()
