"""The training substrate of the port: data pipeline, optimizer,
compression, checkpointing and the fault monitors, retargeted from the
reference's ``tests/test_substrate.py`` and ``tests/test_tolerance.py``,
and held against the reference where both packages compute the same
thing: the token stream bit for bit, AdamW on the same gradients, the
int8 codes, checkpoints read across the two stores, the copied modules.
The training entry point restarted from a checkpoint repeats the
uninterrupted run's losses bit for bit.  All on the CPU."""
import difflib
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as RefStore
from repro.data.pipeline import HostDataLoader as RefLoader
from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.data.pipeline import (DataConfig, HostDataLoader,
                                       PackedSequenceIterator)
from repro_torch.fault.tolerance import (ElasticController, HeartbeatMonitor,
                                         RescalePlan, StragglerMonitor,
                                         VirtualClock)
from repro_torch.launch import train as T
from repro_torch.optim import adamw, compress
from repro_torch.tree import keypaths, leaves, tree_map, unflatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=1000, seq_len=64, global_batch=4)
    a = HostDataLoader(cfg)
    b1 = next(a)
    b2 = next(a)
    st = a.state()
    b3 = next(a)
    c = HostDataLoader(cfg)
    c.restore(st)
    np.testing.assert_array_equal(b3["tokens"], next(c)["tokens"])
    d = HostDataLoader(cfg)
    np.testing.assert_array_equal(b1["tokens"], next(d)["tokens"])
    assert not np.array_equal(b1["tokens"], b2["tokens"])


def test_data_labels_are_shifted_tokens():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=2)
    assert PackedSequenceIterator(cfg).next_sequence().shape == (33,)
    b = next(HostDataLoader(cfg))
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_host_partitioning_disjoint_and_stable():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4)
    h0 = HostDataLoader(cfg, host_id=0, n_hosts=2)
    h1 = HostDataLoader(cfg, host_id=1, n_hosts=2)
    bs = next(HostDataLoader(cfg, host_id=0, n_hosts=1))
    np.testing.assert_array_equal(
        np.concatenate([next(h0)["tokens"], next(h1)["tokens"]]),
        bs["tokens"])


@pytest.mark.parametrize("vocab,seq,batch", [(151936, 128, 4), (512, 32, 3)])
def test_loader_stream_equals_reference_bit_for_bit(vocab, seq, batch):
    """The port's loader is the reference's numpy code: the same batches,
    the same state, through a restore."""
    cfg = DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch)
    port, ref = HostDataLoader(cfg), RefLoader(cfg)
    for _ in range(4):
        a, b = next(port), next(ref)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert port.state() == ref.state()
    again = HostDataLoader(cfg)
    again.restore(ref.state())
    np.testing.assert_array_equal(next(again)["tokens"], next(ref)["tokens"])


# ---------------------------------------------------------------------------
# optimizer + compression
# ---------------------------------------------------------------------------

def _step(i):
    return torch.tensor(i, dtype=torch.int32)


def test_adamw_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.init(params)
    for i in range(150):
        adamw.update(cfg, params, {"w": 2 * params["w"]}, opt, _step(i))
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_schedule_warmup_and_cosine():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    assert float(adamw.schedule(cfg, _step(0))) == 0.0
    assert float(adamw.schedule(cfg, _step(10))) == pytest.approx(1.0,
                                                                  rel=1e-3)
    assert float(adamw.schedule(cfg, _step(100))) == pytest.approx(0.1,
                                                                   rel=1e-2)


def test_grad_clip_bounds_update():
    cfg = adamw.AdamWConfig(lr=0.1, clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros(3)}
    m = adamw.update(cfg, params, {"w": torch.full((3,), 1e6)},
                     adamw.init(params), _step(0))
    assert float(m["grad_norm"]) > 1e5      # reported before the clip


def test_global_norm_past_f32_range_still_clips():
    """The port sums the global norm in f64: gradients of 1e20 give a
    finite norm (the reference's f32 sum is inf there and its clip scale
    0), and the clipped step moves the weights beyond weight decay, by
    about lr an element (Adam's first step is sign-like)."""
    kw = dict(lr=0.1, clip_norm=1.0, warmup_steps=0, weight_decay=0.0)
    g = np.full(4, 1e20, np.float32)
    params = {"w": torch.zeros(4)}
    m = adamw.update(adamw.AdamWConfig(**kw), params,
                     {"w": torch.from_numpy(g)}, adamw.init(params), _step(0))
    assert float(m["grad_norm"]) == pytest.approx(2e20, rel=1e-6)
    np.testing.assert_allclose(params["w"].numpy(), -0.1, rtol=1e-4)
    rg = {"w": jnp.asarray(g)}
    assert not np.isfinite(float(ref_adamw.global_norm(rg)))


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_equals_reference_on_the_same_gradients(clip):
    """Three AdamW steps of each package on one tree and the same
    gradients (clipped at 1.0, and not): parameters, moments and metrics
    equal to f32 rounding (rtol 1e-6); the schedule's learning rate too."""
    rng = np.random.default_rng(0)
    p0 = {"b": rng.standard_normal(3).astype(np.float32),
          "a": {"w": rng.standard_normal((4, 5)).astype(np.float32),
                "v": rng.standard_normal(7).astype(np.float32)}}
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=clip)
    cfg, rcfg = adamw.AdamWConfig(**kw), ref_adamw.AdamWConfig(**kw)
    params = tree_map(torch.tensor, p0)
    opt = adamw.init(params)
    rparams = tree_map(jnp.asarray, p0)
    ropt = ref_adamw.init(rparams)
    for i in range(3):
        g = tree_map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32) * 3, p0)
        m = adamw.update(cfg, params, tree_map(torch.tensor, g), opt,
                         _step(i))
        rparams, ropt, rm = ref_adamw.update(rcfg, rparams,
                                             tree_map(jnp.asarray, g), ropt,
                                             jnp.int32(i))
        for key in ("grad_norm", "lr"):
            assert float(m[key]) == pytest.approx(float(rm[key]), rel=1e-6)
    for got, want in zip(leaves([params, opt["m"], opt["v"]]),
                         leaves([rparams, ropt["m"], ropt["v"]])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_compression_error_feedback_reduces_bias():
    g = {"w": torch.linspace(-1, 1, 1024)}
    ef = compress.init_error_feedback(g)
    total = torch.zeros(1024)
    for _ in range(50):
        codes, scales, ef = compress.compress_with_feedback(g, ef)
        total += compress.decompress(codes, scales)["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(),
                               atol=1e-3)


def test_quantize_roundtrip_bounded():
    g = torch.tensor([0.0, 0.5, -1.0, 127.0])
    q, s = compress.quantize(g)
    assert float((compress.dequantize(q, s) - g).abs().max()) <= (
        float(s) / 2 + 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_codes_equal_reference(seed):
    """The int8 codes and scale of one tensor, ties to even included (the
    grid of the half steps), and the error-feedback step over a tree."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(4096) * 3).astype(np.float32)
    g[:8] = np.array([0.5, 1.5, -2.5, 126.5, -126.5, 3.0, 0.0, -0.0],
                     np.float32) * (np.abs(g).max() / 127.0)
    q, s = compress.quantize(torch.tensor(g))
    rq, rs = ref_compress.quantize(jnp.asarray(g))
    assert q.dtype == torch.int8 and float(s) == float(rs)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    tree = {"a": g, "b": [g[:100] * 7]}
    ef = tree_map(lambda a: np.full(a.shape, 1e-3, np.float32), tree)
    codes, scales, new_ef = compress.compress_with_feedback(
        tree_map(torch.tensor, tree), tree_map(torch.tensor, ef))
    rcodes, rscales, ref_ef = ref_compress.compress_with_feedback(
        tree_map(jnp.asarray, tree), tree_map(jnp.asarray, ef))
    for a, b in zip(leaves(codes), leaves(rcodes)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(leaves(new_ef), leaves(ref_ef)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.linspace(-3, 3, 5).to(torch.bfloat16),
                  "d": [torch.ones(4), torch.tensor(7.5)]},
            "step": torch.tensor(3, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = _tree()
    store.save(5, tree, extras={"note": "x"})
    out, extras = store.restore(tree)
    for got, want in zip(leaves(out), leaves(tree)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert extras["note"] == "x"
    with open(os.path.join(tmp_path, "step_000000005", "manifest.json")) as f:
        assert '"b/d/1"' in f.read()


def test_checkpoint_keep_k_and_latest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        store.save(s, {"a": torch.zeros(2)})
    assert store.all_steps() == [3, 4]
    assert store.latest_step() == 4
    with open(os.path.join(tmp_path, "LATEST")) as f:
        assert f.read() == "4"


def test_checkpoint_async_snapshots_before_the_write(tmp_path):
    """The tree is copied to host memory before save returns: a later
    in-place update does not reach the checkpoint."""
    store = CheckpointStore(str(tmp_path), keep=2)
    w = torch.ones(8)
    store.save(7, {"a": w}, blocking=False)
    w.add_(1.0)
    store.wait()
    assert store.latest_step() == 7
    out, _ = store.restore({"a": w})
    assert torch.equal(out["a"], torch.ones(8))


def test_checkpoint_restores_onto_the_target_device(tmp_path):
    """Restore places each tensor where asked, or where the structure's
    leaf lies (the one-process counterpart of reshard on load)."""
    store = CheckpointStore(str(tmp_path))
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    store.save(1, tree)
    out, _ = store.restore({"w": torch.empty(4, 4, device="meta")})
    assert out["w"].device.type == "meta"
    out, _ = store.restore({"w": torch.empty(4, 4, device="meta")},
                           device="cpu")
    assert torch.equal(out["w"], tree["w"])
    with pytest.raises(ValueError, match="leaves"):
        store.restore({"w": tree["w"], "x": tree["w"]})


def test_checkpoint_read_across_the_two_stores(tmp_path):
    """A plain dict tree (f32, bf16, int32 leaves) written by either
    package's store is read by the other, keys, types and values."""
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"c": np.linspace(-3, 3, 5).astype(np.float32),
                  "d": np.array([1.5, -2.25, 3.0], np.float32)}}
    port_tree = tree_map(torch.tensor, tree)
    port_tree["b"]["d"] = port_tree["b"]["d"].to(torch.bfloat16)
    ref_tree = tree_map(jnp.asarray, tree)
    ref_tree["b"]["d"] = ref_tree["b"]["d"].astype(jnp.bfloat16)

    CheckpointStore(str(tmp_path / "p")).save(3, port_tree, extras={"k": 1})
    out, extras = RefStore(str(tmp_path / "p")).restore(ref_tree)
    assert extras == {"k": 1} and out["b"]["d"].dtype == jnp.bfloat16
    for got, want in zip(leaves(out), leaves(port_tree)):
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      want.float().numpy())

    RefStore(str(tmp_path / "r")).save(4, ref_tree, extras={"k": 2})
    store = CheckpointStore(str(tmp_path / "r"))
    assert store.latest_step() == 4
    out, extras = store.restore(port_tree)
    assert extras == {"k": 2} and out["b"]["d"].dtype == torch.bfloat16
    for got, want in zip(leaves(out), leaves(port_tree)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_tree_walks_like_jax():
    """Sorted dict keys, list items in order; paths named as the
    reference's store names them."""
    tree = {"z": [1, 2], "a": {"y": 3, "b": 4}}
    assert leaves(tree) == [4, 3, 1, 2]
    assert keypaths(tree) == ["a/b", "a/y", "z/0", "z/1"]
    assert unflatten(tree, [10, 20, 30, 40]) == {"a": {"b": 10, "y": 20},
                                                 "z": [30, 40]}


# ---------------------------------------------------------------------------
# fault tolerance (tests/test_substrate.py and tests/test_tolerance.py)
# ---------------------------------------------------------------------------

def test_heartbeat_detects_silence():
    clock = [0.0]
    hb = HeartbeatMonitor(3, timeout=10.0, clock=lambda: clock[0])
    clock[0] = 5.0
    hb.beat(0)
    hb.beat(1)
    clock[0] = 12.0
    assert hb.failed_hosts() == [2]


def test_virtual_clock():
    clk = VirtualClock()
    assert clk() == 0.0
    assert clk.advance(2.5) == 2.5
    clk.t = 10.0
    assert clk() == 10.0


def test_heartbeat_virtual_time_end_to_end():
    clk = VirtualClock()
    mon = HeartbeatMonitor(3, timeout=5.0, clock=clk)
    assert mon.failed_hosts() == []
    clk.advance(4.0)
    mon.beat(0)
    clk.advance(3.0)
    assert mon.failed_hosts() == [1, 2]
    mon.beat(1)
    mon.beat(2)
    assert mon.failed_hosts() == []
    clk.advance(4.5)
    assert mon.failed_hosts() == [0]


def test_heartbeat_explicit_now_overrides_clock():
    mon = HeartbeatMonitor(2, timeout=10.0, clock=lambda: 0.0)
    mon.beat(0, now=100.0)
    mon.beat(1, now=103.0)
    assert mon.failed_hosts(now=112.0) == [0]
    assert mon.failed_hosts(now=114.0) == [0, 1]
    assert mon.failed_hosts(now=105.0) == []


def test_heartbeat_boundary_is_strict():
    clk = VirtualClock()
    mon = HeartbeatMonitor(1, timeout=5.0, clock=clk)
    clk.advance(5.0)
    assert mon.failed_hosts() == []
    clk.advance(0.001)
    assert mon.failed_hosts() == [0]


def test_straggler_monitor_flags_slow_host():
    sm = StragglerMonitor(4, threshold=1.5, min_steps=3)
    for _ in range(6):
        for h in range(4):
            sm.record(h, 1.0 if h != 2 else 3.0)
    assert sm.stragglers() == [2]


def test_straggler_min_steps_gate():
    mon = StragglerMonitor(4, min_steps=5)
    for _ in range(4):
        for h in range(3):
            mon.record(h, 1.0)
        mon.record(3, 10.0)
    assert mon.stragglers() == []


def test_straggler_needs_three_qualifying_hosts():
    mon = StragglerMonitor(2, min_steps=1)
    mon.record(0, 1.0)
    mon.record(1, 50.0)
    assert mon.stragglers() == []


def test_straggler_ema_forgives_a_single_spike():
    mon = StragglerMonitor(4, alpha=0.2, threshold=1.5, min_steps=3)
    for h in range(4):
        for _ in range(10):
            mon.record(h, 1.0)
    mon.record(3, 4.0)
    mon.record(3, 1.0)
    assert mon.stragglers() == []


def _controller(clk, n=4, timeout=5.0):
    hb = HeartbeatMonitor(n, timeout=timeout, clock=clk)
    st = StragglerMonitor(n, min_steps=1)
    return hb, st, ElasticController(hb, st, latest_step=lambda: 42)


def test_plan_none_when_membership_unchanged():
    _hb, _st, ctl = _controller(VirtualClock())
    assert ctl.plan(current_hosts=4) is None


def test_plan_on_failure_and_scale_up():
    clk = VirtualClock()
    hb, _st, ctl = _controller(clk)
    clk.advance(6.0)
    for h in (1, 2, 3):
        hb.beat(h)
    plan = ctl.plan(current_hosts=4, offered_hosts=2)
    assert isinstance(plan, RescalePlan)
    assert (plan.old_hosts, plan.new_hosts, plan.restore_step) == (4, 5, 42)
    assert "failed=[0]" in plan.reason and "scale_up=+2" in plan.reason


def test_plan_combines_failures_and_stragglers():
    clk = VirtualClock()
    hb, st, ctl = _controller(clk)
    clk.advance(6.0)
    for h in (0, 1, 2):
        hb.beat(h)
        st.record(h, 1.0)
    st.record(2, 1.0)
    st.record(0, 1.0)
    st.record(1, 9.0)
    plan = ctl.plan(current_hosts=4)
    assert plan.new_hosts == 2
    assert "stragglers=[1]" in plan.reason and "failed=[3]" in plan.reason


# ---------------------------------------------------------------------------
# the copies, and the training entry point
# ---------------------------------------------------------------------------

def _read(*parts):
    with open(os.path.join(ROOT, "src", *parts)) as f:
        return f.read()


def test_fault_tolerance_is_the_reference_copy():
    """``diff -u``: the same file (it imports nothing of either package)."""
    ref = _read("repro", "fault", "tolerance.py")
    assert _read("repro_torch", "fault", "tolerance.py") == ref


def test_strategy_is_the_reference_copy():
    """``diff -u``: the port's ``distributed/strategy.py`` is the
    reference's with its three imports rewritten, nothing else."""
    ref = _read("repro", "distributed", "strategy.py").splitlines()
    port = _read("repro_torch", "distributed", "strategy.py").splitlines()
    diff = [l for l in difflib.unified_diff(ref, port, lineterm="", n=0)
            if l[:1] in "+-" and not l.startswith(("+++", "---"))]
    assert len(diff) == 6
    assert all(l[1:].startswith("from repro") for l in diff)
    assert "\n".join(port).replace("repro_torch.", "repro.") == "\n".join(ref)


def test_data_pipeline_differs_only_in_its_jax_lines():
    """``diff -u``: the port's copy drops ``import jax`` and differs
    otherwise only inside ``device_put_batch``'s body (a DTensor on a
    ``DeviceMesh`` where the reference puts a JAX sharding), nothing
    else."""
    ref = _read("repro", "data", "pipeline.py").splitlines()
    port = _read("repro_torch", "data", "pipeline.py").splitlines()
    head = "def device_put_batch(batch: dict, mesh, rules) -> dict:"
    r0, p0 = ref.index(head), port.index(head)
    # everything before the function: one line gone, ``import jax``
    diff = [l for l in difflib.unified_diff(ref[:r0], port[:p0], lineterm="",
                                            n=0)
            if l[:1] in "+-" and not l.startswith(("+++", "---"))]
    assert diff == ["-import jax"]
    # the function itself: every line of the reference's but the three
    # that name JAX's sharding is kept, in its order; the port's own lines
    # place a leaf as a DTensor
    rb, pb = ref[r0:], port[p0:]
    jax_lines = [l for l in rb if "jax" in l or "NamedSharding" in l]
    assert len(jax_lines) == 3
    kept = [l for l in pb if l.strip() and l in rb]
    assert kept == [l for l in rb if l.strip() and l not in jax_lines]
    assert not [l for l in pb if "jax" in l]


def test_train_restart_from_checkpoint_repeats_the_run(tmp_path):
    """Kill/restart: the run restarted from its step-6 checkpoint (the
    parameters, moments, step and the loader's cursor) gives the
    uninterrupted run's losses of steps 7-12 bit for bit."""
    kw = dict(steps=12, batch=2, seq=32, log_every=100, device="cpu")
    full = T.train("qwen2-1.5b", ckpt_dir=str(tmp_path / "a"), ckpt_every=6,
                   **kw)
    assert CheckpointStore(str(tmp_path / "a")).all_steps() == [6, 12]
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_000000006",
                    tmp_path / "b" / "step_000000006")
    resumed = T.train("qwen2-1.5b", ckpt_dir=str(tmp_path / "b"),
                      ckpt_every=100, resume=True, **kw)
    assert len(resumed["losses"]) == 6
    assert resumed["losses"] == full["losses"][6:]
    assert all(np.isfinite(full["losses"]))
    for a, b in zip(leaves(T.saved(full["state"])),
                    leaves(T.saved(resumed["state"]))):
        assert torch.equal(a, b)


def test_train_cli_on_the_cpu(capsys):
    r = T.main(["--arch", "qwen2-1.5b", "--steps", "3", "--batch", "2",
                "--seq", "16", "--device", "cpu"])
    assert len(r["losses"]) == 3 and r["device"] == "cpu"
    assert "mean loss" in capsys.readouterr().out


def test_train_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.train("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.main(["--arch", "qwen2-1.5b"])
