"""The dry run's op-trace analysis (``repro_torch.launch.trace_analysis``)
and K5's and K6's custom ops, on the CPU.

* The custom ops: each op's fake implementation gives the plain version's
  shapes, types and strides over a grid of shapes (causal and not,
  windows, GQA, (192, 128), odd S and T; K6 with and without state0);
  ``torch.library.opcheck`` passes; each FLOP formula gives PERF.md's
  counts at the shapes named there.
* The recorder counts a custom op by its formula, never the ops inside its
  CPU implementation.
* Per device: a model-sharded product traced on fake meshes of 1, 2 and 4
  ranks counts its local FLOPs, the whole product's divided by the ranks.
* Against the reference: for every family's smoke config, the port's trace
  FLOPs of the train step, the prefill and the decode (un-meshed, the
  reference's parameters carried across) equal
  ``repro.launch.hlo_analysis.analyze`` of the reference's same function
  compiled on one CPU device, once each side's attention and WKV term is
  taken out: on the port's side the custom ops' formulas, on the
  reference's side its XLA twins' products by the formulas
  :func:`ref_attention_flops` and :func:`ref_wkv_flops` state, on the same
  calls.  The remainders agree within 0.1%.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels.flash_attention import ops as k5
from repro_torch.kernels.flash_attention.ref import BQ_LSE
from repro_torch.kernels.rwkv6 import ops as k6
from repro_torch.launch import trace_analysis as ta

# (B, S, T, H, K, D, DV, causal, window)
K5_GRID = [
    (2, 16, 16, 4, 2, 16, 16, True, 0),
    (1, 33, 33, 4, 4, 32, 32, True, 5),
    (2, 7, 19, 6, 2, 16, 16, False, 0),
    (1, 9, 9, 8, 1, 64, 64, False, 4),
    (1, 17, 17, 2, 2, 192, 128, True, 0),
]
# (B, S, H, D, chunk, state0)
K6_GRID = [(1, 16, 2, 4, 8, False), (2, 37, 3, 8, 16, True),
           (1, 5, 2, 4, 64, True), (2, 64, 1, 16, 64, False)]


def _k5_inputs(case, dtype=torch.float32, grad=False):
    B, S, T, H, K, D, DV, causal, window = case
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, S, H, D), generator=g, dtype=dtype)
    k = torch.randn((B, T, K, D), generator=g, dtype=dtype)
    v = torch.randn((B, T, K, DV), generator=g, dtype=dtype)
    if grad:
        for t in (q, k, v):
            t.requires_grad_(True)
    return q, k, v, causal, window


def _k6_inputs(case, grad=False):
    B, S, H, D, chunk, with_state = case
    g = torch.Generator().manual_seed(1)
    r, k, v = (torch.randn((B, S, H, D), generator=g) for _ in range(3))
    logw = -torch.rand((B, S, H, D), generator=g)
    u = torch.randn((H, D), generator=g)
    s0 = torch.randn((B, H, D, D), generator=g) if with_state else None
    if grad:
        for t in (r, k, v, logw, u):
            t.requires_grad_(True)
    return r, k, v, logw, u, s0, chunk


def _meta(ts):
    return [(tuple(t.shape), t.dtype, t.stride()) for t in ts]


def _fake_of(fn, args):
    """``fn`` on fake copies of ``args`` (tensors only)."""
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) if torch.is_tensor(a) else a
                 for a in args]
        return fn(*fargs)


@pytest.mark.parametrize("case", K5_GRID, ids=str)
@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_fwd_fake_matches_plain(case, with_lse):
    args = (*_k5_inputs(case), with_lse)
    real = k5.flash_fwd(*args)
    fake = _fake_of(k5.flash_fwd, args)
    assert _meta(fake) == _meta(real)
    B, S, H = case[0], case[1], case[3]
    want = (B, H, -(-S // BQ_LSE) * BQ_LSE) if with_lse else (0,)
    assert tuple(real[1].shape) == want


@pytest.mark.parametrize("case", K5_GRID, ids=str)
def test_flash_bwd_fake_matches_plain(case):
    q, k, v, causal, window = _k5_inputs(case)
    out = k5.flash_fwd(q, k, v, causal, window, False)[0]
    args = (q, k, v, out, torch.randn_like(out), None, causal, window)
    assert _meta(_fake_of(k5.flash_bwd, args)) == _meta(k5.flash_bwd(*args))


@pytest.mark.parametrize("case", K6_GRID, ids=str)
def test_wkv6_ops_fake_match_plain(case):
    args = _k6_inputs(case)
    real = k6.wkv6_fwd(*args)
    assert _meta(_fake_of(k6.wkv6_fwd, args)) == _meta(real)
    r, k, v, logw, u, s0, chunk = args
    bargs = (r, k, v, logw, u, torch.randn_like(r), s0,
             torch.randn_like(real[1]), real[2], chunk)
    assert _meta(_fake_of(k6.wkv6_bwd_op, bargs)) == _meta(
        k6.wkv6_bwd_op(*bargs))


@pytest.mark.parametrize("case", K5_GRID[:3], ids=str)
def test_flash_ops_pass_opcheck(case):
    q, k, v, causal, window = _k5_inputs(case)
    torch.library.opcheck(k5.flash_fwd, (q, k, v, causal, window, True))
    out = k5.flash_fwd(q, k, v, causal, window, False)[0]
    torch.library.opcheck(k5.flash_bwd, (q, k, v, out, torch.randn_like(out),
                                         None, causal, window))


@pytest.mark.parametrize("case", K6_GRID[:2], ids=str)
def test_wkv6_ops_pass_opcheck(case):
    args = _k6_inputs(case)
    torch.library.opcheck(k6.wkv6_fwd, args)
    r, k, v, logw, u, s0, chunk = args
    y, s_end, starts = k6.wkv6_fwd(*args)
    torch.library.opcheck(k6.wkv6_bwd_op, (r, k, v, logw, u,
                                           torch.randn_like(r), s0, None,
                                           starts, chunk))


def test_flop_formulas_give_perf_counts():
    """PERF.md's operation counts: K5 at qwen2-1.5b's prefill (51.5 GFLOP)
    and training shape backward (257.8 GFLOP), K6 at rwkv6-3b's prefill
    (10.7 GFLOP) and training shape backward (19.45 GFLOP)."""
    fwd = k5.fwd_flops((4, 2048, 12, 128), (4, 2048, 2, 128),
                       (4, 2048, 2, 128), True, 0)
    bwd = k5.bwd_flops((2, 4096, 12, 128), (2, 4096, 2, 128),
                       (2, 4096, 2, 128), True, 0)
    assert fwd == 4 * 12 * (2048 * 2049 // 2) * 2 * 256
    assert round(fwd / 1e9, 1) == 51.6 and round(bwd / 1e9, 1) == 257.8
    assert round(k6.fwd_flops(4, 2048, 40, 64) / 1e9, 1) == 10.7
    assert round(k6.bwd_flops(2, 4096, 40, 64) / 1e9, 2) == 19.45
    # the visible pairs against the mask itself
    from repro_torch.kernels.flash_attention.ref import attention_mask
    for S, T, causal, window in ((9, 9, True, 0), (7, 19, False, 0),
                                 (33, 33, True, 5), (9, 9, False, 4),
                                 (19, 7, True, 3)):
        assert k5.visible_pairs(S, T, causal, window) == int(
            attention_mask(S, T, causal, window, "cpu").sum())


def test_registered_formulas_are_the_recorders():
    """``torch.utils.flop_counter`` counts the custom ops by the same
    formulas the recorder uses."""
    from torch.utils.flop_counter import FlopCounterMode

    q, k, v, causal, window = _k5_inputs(K5_GRID[1], grad=True)
    with FlopCounterMode(display=False) as fc, ta.Recorder() as rec:
        k5.flash_attention(q, k, v, causal=causal, window=window).sum(
        ).backward()
    assert fc.get_total_flops() == ta.analyze(rec.trace).flops == (
        k5.fwd_flops(q.shape, k.shape, v.shape, causal, window)
        + k5.bwd_flops(q.shape, k.shape, v.shape, causal, window))


def test_recorder_counts_a_custom_op_by_its_formula_alone():
    """The plain versions behind the CPU ops run ``bmm``s; the recorder
    sees the op and not them, so nothing is counted twice."""
    q, k, v, causal, window = _k5_inputs(K5_GRID[0], grad=True)
    r, kk, vv, logw, u, s0, chunk = _k6_inputs(K6_GRID[1], grad=True)
    with ta.Recorder() as rec:
        out = k5.flash_attention(q, k, v, causal=causal, window=window)
        y, s = k6.wkv6(r, kk, vv, logw, u, chunk=chunk, state0=s0)
        (out.sum() + y.sum() + s.sum()).backward()
    names = [op.name for op in rec.trace.ops]
    assert "aten.bmm.default" not in names
    assert [rec.trace.calls("repro_torch." + n) for n in
            ("flash_fwd", "flash_bwd", "wkv6_fwd", "wkv6_bwd")] == [1] * 4
    want = (k5.fwd_flops(q.shape, k.shape, v.shape, causal, window)
            + k5.bwd_flops(q.shape, k.shape, v.shape, causal, window)
            + k6.fwd_flops(*r.shape, chunk=chunk)
            + k6.bwd_flops(*r.shape, chunk=chunk))
    assert ta.analyze(rec.trace).flops == want
    # the same ops on the plain versions, outside a custom op, count bmms
    with ta.Recorder() as plain:
        k5.flash_attention_ref(q.detach(), k, v, causal=causal)
    assert plain.trace.calls("aten.bmm") == 2


def test_bytes_skip_views_and_factories_and_peak_counts_live():
    x = torch.randn(64, 32)
    w = torch.randn(32, 16)
    with ta.Recorder() as rec:
        y = (x @ w).t().contiguous()
        z = torch.zeros(8)
    ops = {op.name: op for op in rec.trace.ops}
    mm = ops["aten.mm.default"]
    assert mm.flops == 2 * 64 * 32 * 16
    assert mm.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert ops["aten.t.default"].bytes == 0
    assert ops["aten.zeros.default"].bytes == 0
    # the product and its transposed copy at once, then the copy and z
    assert rec.trace.peak_bytes == 2 * 4 * 64 * 16
    assert rec.live_bytes == 4 * 64 * 16 + 4 * 8
    del y, z


def _gather_and_double(world, shape, fake):
    """(the recorder's peak, its live bytes after) an all-gather of ones
    over ``world`` ranks of a fake group, waited and doubled, on real or
    fake tensors."""
    import torch.distributed as dist

    c10d = torch.ops._c10d_functional
    with FakeTensorMode() if fake else contextlib.nullcontext():
        x = torch.ones(shape)
        with ta.Recorder() as rec:
            # the collective's output kept, as a redistribution keeps it
            gathered = c10d.all_gather_into_tensor(
                x, world, dist.group.WORLD.group_name)
            # a view of the waited tensor, doubled: a quarter of it
            z = c10d.wait_tensor(gathered)[:shape[0]] * 2
            live = rec.live_bytes
    del gathered, z
    return rec.trace.peak_bytes, live


def test_a_collectives_wait_counts_its_input_once():
    """An all-gather's ``wait_tensor`` returns its input in an eager run;
    under ``FakeTensorMode`` it makes a new storage.  The recorder counts
    the gathered tensor once either way, a view of the waited one included:
    the same peak, the gathered bytes and a quarter more, all live at the
    end."""
    from repro_torch.launch.dryrun import fake_group

    world, shape = 4, (256, 64)
    with fake_group(world):
        got = [_gather_and_double(world, shape, fake) for fake in (False,
                                                                   True)]
    gathered = 4 * world * shape[0] * shape[1]
    assert got[0] == got[1] == (gathered * 5 // 4, gathered * 5 // 4)


def test_meta_ops_repeat_from_their_layouts():
    """On meta tensors a repeated op that makes new tensors is answered from
    the layouts its first call gave: the same shapes, strides and types,
    new storages, the same records; an op that writes or aliases an
    operand, and an op on CPU tensors, always runs."""
    x = torch.empty((6, 4), device="meta").t()
    y = torch.empty((4, 1), device="meta")
    with ta.Recorder() as rec:
        a = x * y
        b = x * y
        x.add_(1)
        c = x.t()
        cpu = torch.ones(3) * 2
    want = torch.empty((6, 4)).t() * torch.empty((4, 1))
    for t in (a, b):
        assert (t.shape, t.stride(), t.dtype, t.device.type) == (
            want.shape, want.stride(), want.dtype, "meta")
    assert a.untyped_storage()._cdata != b.untyped_storage()._cdata
    assert len(rec._layouts) == 1
    assert [op.name for op in rec.trace.ops] == [
        "aten.mul.Tensor", "aten.mul.Tensor", "aten.add_.Tensor",
        "aten.t.default", "aten.ones.default", "aten.mul.Tensor"]
    assert rec.trace.ops[0] == rec.trace.ops[1]
    assert c.untyped_storage()._cdata == x.untyped_storage()._cdata
    assert cpu.tolist() == [2.0] * 3


def test_top_ops_rank_the_ops_by_bytes():
    """``top_ops``, the counterpart of ``top_instructions``: the ops by
    name and operand shapes, by the bytes they move in all."""
    x, w = torch.randn(64, 32), torch.randn(32, 16)
    with ta.Recorder() as rec:
        for _ in range(3):
            x @ w
        x + 1
    (b0, n0, f0, name0, shapes0), (b1, n1, _f1, name1, _s1) = ta.top_ops(
        rec.trace, 2)
    assert (name0, shapes0, n0) == ("aten.mm.default", ((64, 32), (32, 16)),
                                    3)
    assert b0 == 3 * 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert f0 == 3 * 2 * 64 * 32 * 16
    assert (name1, n1, b1) == ("aten.add.Tensor", 1, 2 * 4 * 64 * 32)


def test_per_device_flops_divide_by_the_ranks():
    """A (256, 64) x (64, 96) product with the weight's columns sharded
    over a "model" axis of 1, 2 and 4 fake ranks: the recorder counts the
    rank's local product, the whole one's divided by the ranks (a counter
    above DTensor would see the whole product on every rank)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import fake_group

    whole = 2 * 256 * 64 * 96
    for n in (1, 2, 4):
        with fake_group(n):
            mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("model",))
            with FakeTensorMode():
                x = DTensor.from_local(torch.randn(256, 64), mesh,
                                       [Replicate()], run_check=False)
                w = DTensor.from_local(torch.randn(64, 96 // n), mesh,
                                       [Shard(1)], run_check=False)
                with ta.Recorder() as rec:
                    y = x @ w
                assert y.placements == (Shard(1),)
        assert ta.analyze(rec.trace).flops * n == whole
        assert not dist.is_initialized()


def test_a_meshed_trace_needs_dtensors_propagation_marked(monkeypatch):
    """DTensor runs each op once more on global shapes to work out its
    output's: the recorder counts only the rank's local ops while that
    propagation is marked.  Unmarked, the same product would count the
    whole product beside the local one; and where the torch build has no
    method to mark, a DTensor's op is refused rather than counted."""
    import contextlib

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.launch.dryrun import fake_group

    def product(n, rows):
        mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("model",))
        with FakeTensorMode():
            x = DTensor.from_local(torch.randn(rows, 32), mesh,
                                   [Replicate()], run_check=False)
            w = DTensor.from_local(torch.randn(32, 80 // n), mesh,
                                   [Shard(1)], run_check=False)
            with ta.Recorder() as rec:
                x @ w
        return rec.trace

    with fake_group(2):
        marked = product(2, 136)
    assert ta.analyze(marked).flops == 2 * 136 * 32 * 40
    assert all((32, 80) not in op.shapes for op in marked.ops)

    @contextlib.contextmanager
    def unmarked():
        yield True

    with monkeypatch.context() as m, fake_group(2):
        m.setattr(ta, "_marked_propagation", unmarked)
        seen = product(2, 144)          # new shapes: not in DTensor's cache
    assert any((32, 80) in op.shapes for op in seen.ops)
    assert ta.analyze(seen).flops > 2 * 144 * 32 * 40

    with monkeypatch.context() as m, fake_group(2):
        m.delattr(ShardingPropagator, ta._PROPAGATE)
        with pytest.raises(RuntimeError, match="meshed trace is refused"):
            product(2, 152)
    assert not dist.is_initialized()


def test_collectives_are_counted_once_by_result_bytes():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import fake_group

    with fake_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        with FakeTensorMode():
            x = DTensor.from_local(torch.randn(8, 16), mesh, [Shard(0)],
                                   run_check=False)
            with ta.Recorder() as rec:
                x.redistribute(mesh, [Replicate()])
    t = ta.analyze(rec.trace)
    assert t.collective_count == {"all-gather": 1}
    assert t.collective_bytes == {"all-gather": 4 * 32 * 16}
    assert not dist.is_initialized()


# -- FLOPs against the reference's HLO analysis -----------------------------

#: each family's smoke config, as ``tests/test_torch_train.py`` runs them
FAMILIES = {"qwen2_1_5b": {}, "granite_moe_3b": {"capacity_factor": 0.5},
            "deepseek_v2_236b": {}, "rwkv6_3b": {}, "hymba_1_5b": {},
            "whisper_large_v3": {}, "llama32_vision_90b": {}}
B, S = 2, 16
#: a longer sequence where the step must span two of K6's chunks of 64
#: (on one chunk XLA drops the unused final state's products)
FAMILY_S = {"rwkv6_3b": 128}
#: the remainders' relative gap
FLOP_RTOL = 1e-3


def ref_attention_flops(op) -> float:
    """The reference's attention term for one of the port's K5 calls: its
    XLA twin at these shapes is the dense form
    (``_gqa_scores_softmax_out``, ``src/repro/nn/layers.py:104``), two
    ``dot``s over every (query, key) pair, ``2·B·H·S·T·(D + DV)``; its
    backward four more (dq and dk from the scores' gradient, the
    probabilities' gradient and dv), ``4·B·H·S·T·(D + DV)``."""
    (B_, S_, H, D), (_, T, _, _), (_, _, _, DV) = op.shapes[:3]
    pair_dots = 2 * B_ * H * S_ * T * (D + DV)
    return pair_dots * (2 if "flash_bwd" in op.name else 1)


def ref_wkv_flops(op) -> float:
    """The reference's WKV term for one of the port's K6 calls: its XLA
    twin (``wkv6_chunked``, ``src/repro/nn/ssm.py:118``) takes three
    ``dot``s a chunk of c tokens: the intra-chunk ``att @ v``, ``2·c²·D``,
    and the chunk's state ``k_dec^T v`` and ``r_dec @ S``, ``2·c·D²``
    each (its scores are a product and a sum, no ``dot``): ``B·nC·H·(2c²D
    + 4cD²)``; its backward two ``dot``s for each.  (On a single chunk XLA
    drops the state's products of a train step, whose final state is
    unused: the train case spans two chunks, :data:`FAMILY_S`.)"""
    B_, S_, H, D = op.shapes[0]
    c = 64
    fwd = B_ * -(-S_ // c) * H * (2 * c * c * D + 4 * c * D * D)
    return fwd * (2 if "wkv6_bwd" in op.name else 1)


def moe_decode_flops(cfg, ops, tokens: int):
    """The MoE decode's expert term on each side -> (port, reference).  The
    port's decode runs its dropless form: every expert on every token of
    the step, three ``bmm``s a layer over the experts (``nn/layers.py``'s
    ``moe_apply``), ``2·G·T·E·F`` each.  The reference's runs
    ``jax.lax.ragged_dot`` (``src/repro/nn/layers.py:602``), which XLA
    lowers on the CPU as one dense ``dot`` of the T·K routed rows against
    every group's weights, ``2·(T·K)·G·E·F`` each."""
    G, K, E = cfg.n_experts, cfg.experts_per_token, cfg.d_model
    port = sum(op.flops for op in ops if op.name == "aten.bmm.default"
               and op.shapes[0][0] == G)
    ref = cfg.n_layers * 3 * 2 * tokens * K * G * E * cfg.d_ff
    return port, ref


def _port_side(arch, kind):
    """-> (the port's trace of the smoke step ``kind`` on the CPU from the
    reference's parameters, the reference's analysed HLO FLOPs)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.launch.hlo_analysis import analyze
    from repro.models.common import get_family as ref_family
    from repro.models.common import lm_loss as ref_lm_loss
    from repro.nn.param import init_params as ref_init
    from repro_torch.configs import get_config
    from repro_torch.models import common as C
    from repro_torch.train import steps

    kw = {**FAMILIES[arch], "compute_dtype": "float32"}
    rc = dataclasses.replace(ref_config(arch, smoke=True), **kw)
    pc = dataclasses.replace(get_config(arch, smoke=True), **kw)
    rfam, pfam = ref_family(rc), C.get_family(pc)
    tree = jax.tree.map(np.asarray, ref_init(rfam.template(rc),
                                             jax.random.key(0)))
    model = C.load_reference_params(pfam.build(pc), tree)
    rparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(0)
    S = FAMILY_S.get(arch, globals()["S"])
    toks = rng.integers(0, pc.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if pc.family in ("encdec", "vlm"):
        batch["media"] = (rng.standard_normal(
            (B, pc.n_media_tokens, pc.d_model)) * 0.02).astype(np.float32)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.as_tensor(v) for k, v in batch.items()}
    media_r, media_p = rb.get("media"), pb.get("media")
    rec = ta.Recorder()
    if kind == "train":
        # the reference's loss and gradient (``train/steps.py:40-46``): its
        # optimizer takes no ``dot``, so the step's FLOPs are these
        def loss_fn(params, b):
            params = jax.tree.map(lambda p: p.astype(rc.cdtype()), params)
            logits = rfam.forward(params, rc, b["tokens"],
                                  media=b.get("media"))
            return ref_lm_loss(logits, b["labels"])
        lowered = jax.jit(jax.value_and_grad(loss_fn)).lower(rparams, rb)
        state = steps.init_state(pc, model)
        step = steps.make_train_step(pc, steps.TrainConfig(accum_steps=1))
        with rec:
            step(state, pb)
    elif kind == "prefill":
        lowered = jax.jit(lambda p, t, m: rfam.prefill(p, rc, t, media=m)
                          ).lower(rparams, rb["tokens"], media_r)
        with torch.no_grad(), rec:
            pfam.prefill(model, pc, pb["tokens"], media=media_p)
    else:
        rcache = rfam.init_cache(rc, B, S)
        tok = rb["tokens"][:, :1]
        lowered = jax.jit(lambda p, c, t, pos: rfam.decode_step(
            p, rc, c, t, pos)).lower(rparams, rcache, tok, jnp.int32(3))
        cache = pfam.init_cache(pc, B, S)
        with torch.no_grad(), rec:
            pfam.decode_step(model, pc, cache, pb["tokens"][:, :1], 3)
    return rec.trace, analyze(lowered.compile().as_text()).flops, pc


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_trace_flops_equal_the_reference_hlo_flops(arch, kind):
    trace, ref_flops, cfg = _port_side(arch, kind)
    custom = [op for op in trace.ops if op.name.startswith("repro_torch.")]
    port_rest = ta.analyze(trace).flops - sum(op.flops for op in custom)
    ref_rest = ref_flops - sum(
        ref_wkv_flops(op) if "wkv6" in op.name else ref_attention_flops(op)
        for op in custom)
    if kind == "decode" and cfg.n_experts:
        port_moe, ref_moe = moe_decode_flops(cfg, trace.ops, B)
        assert port_moe > 0
        port_rest -= port_moe
        ref_rest -= ref_moe
    assert port_rest > 0
    assert abs(port_rest - ref_rest) <= FLOP_RTOL * ref_rest, (
        f"{arch} {kind}: port {port_rest:.6e} (custom ops "
        f"{sum(op.flops for op in custom):.4e} in {len(custom)} calls), "
        f"reference {ref_rest:.6e} (HLO {ref_flops:.6e})")
