"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* Parameter bytes: for each of the 10 archs on both production meshes,
  the bytes one rank holds of the abstract parameters and their count
  equal the reference's, computed here with its ``ShardingRules.
  param_pspecs`` on ``make_abstract_mesh`` and its dry run's rule of
  dividing a leaf by the product of the mesh axes its spec names.  The
  reference's ``launch/dryrun.py`` is not imported: its import sets
  ``XLA_FLAGS`` for every later subprocess of the worker.
* One full-size cell through the CLI, ``--arch qwen2-1.5b --shape
  decode_32k --mesh single``, writes an artifact with every key, and no
  process group outlives it.
* An un-meshed cell traced on meta tensors holds the fake trace's ops,
  bytes and peak; meta tensors take the card's route only in a trace.
* The reference's "baseline" profile on a cut cell through the CLI, and
  the MoE families' cells, cut, on both production meshes.
* The refusals: a second process group, ``abstract_params`` outside a
  fake mode off meta; ``make_mesh`` takes a CUDA mesh without a card on a
  fake group only.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import strategy
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.common import param_tree
from repro_torch.nn import layers as L
from repro_torch.nn import param as pm
from repro_torch.tree import leaves


def _ref_param_stats(arch, multi_pod):
    """The reference's ``param_bytes_per_device`` and ``n_params``
    (``src/repro/launch/dryrun.py:38-61``, ``:163-164``), its specs from
    ``param_pspecs`` on the abstract production mesh."""
    from repro.configs import get_config as ref_config
    from repro.distributed import strategy as ref_strategy
    from repro.distributed.sharding import use_mesh_rules
    from repro.launch.mesh import make_abstract_mesh
    from repro.models.common import get_family as ref_family
    from repro.nn import param as ref_pm

    cfg = ref_config(arch)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = make_abstract_mesh(shape, axes)
    rules = ref_strategy.rules_for(cfg)
    tmpl = ref_family(cfg).template(cfg)
    with use_mesh_rules(mesh, rules):
        specs = rules.param_pspecs(tmpl)
    itemsize = np.dtype(cfg.param_dtype).itemsize
    total = 0.0

    def walk(t, s):
        nonlocal total
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k])
            return
        k = 1
        for ax in s:
            if ax is None:
                continue
            for a in ((ax,) if isinstance(ax, str) else ax):
                k *= mesh.shape[a]
        total += t.size * itemsize / k
    walk(tmpl, specs)
    return total, ref_pm.count_params(tmpl)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_per_device_equal_the_reference(arch, multi_pod):
    cfg = get_config(arch)
    rules = strategy.rules_for(cfg)
    with dryrun.fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        with FakeTensorMode():
            model = dryrun.abstract_model(cfg, mesh, rules, "cpu")
        params = param_tree(model)
        got = (float(dryrun._local_bytes(params)),
               sum(p.numel() for p in leaves(params)))
    assert got == _ref_param_stats(arch, multi_pod)
    assert not dist.is_initialized()


#: every key of a port artifact (the reference's, ``trace_s`` for its
#: ``compile_s``, the trace's block for ``xla_cost_analysis``)
KEYS = {"profile", "rules", "n_layers", "arch", "shape", "kind", "mesh", "mesh_shape",
        "n_devices", "seq_len", "global_batch", "trace_s", "trace_device",
        "param_bytes_per_device", "n_params", "memory_analysis",
        "trace_analysis", "hlo_flops", "hlo_hbm_bytes", "collective_bytes",
        "collective_count", "total_collective_bytes", "trip_counts"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "alias_bytes",
               "peak_bytes", "temp_bytes"}


def test_full_size_cell_through_the_cli(tmp_path, capsys):
    """qwen2-1.5b's decode_32k on the (16, 16) mesh: one token at batch
    128 against a 32k cache, traced at full size."""
    rc = dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                      "--mesh", "single", "--out", str(tmp_path)])
    assert rc == 0, capsys.readouterr().out[-2000:]
    assert not dist.is_initialized()
    with open(tmp_path / "qwen2_1_5b__decode_32k__single.json") as f:
        art = json.load(f)
    assert set(art) == KEYS and set(art["memory_analysis"]) == MEMORY_KEYS
    assert art["n_devices"] == 256 and art["mesh_shape"] == {"data": 16,
                                                             "model": 16}
    assert art["trace_s"] < 20
    ref_bytes, ref_n = _ref_param_stats("qwen2-1.5b", False)
    assert (art["param_bytes_per_device"], art["n_params"]) == (ref_bytes,
                                                                ref_n)
    mem = art["memory_analysis"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > ref_bytes
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    # the cache is the decode's argument and its output, updated in place
    assert mem["alias_bytes"] > 0 and mem["output_bytes"] > mem["alias_bytes"]
    assert art["hlo_flops"] > 0 and art["total_collective_bytes"] > 0
    assert art["trip_counts"] == [["layers", 28]]
    # a decode launches no K5 or K6 (its attention reads the cache)
    assert set(art["trace_analysis"]["custom_op_calls"].values()) == {0}
    # an existing artifact is skipped, not traced again
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0
    assert "[skip]" in capsys.readouterr().out


def test_trace_cell_un_meshed_counts_the_custom_ops():
    """An un-meshed smoke train step (chip_smoke.py's dry-run phase's
    form): the trace holds K5's forward twice a layer and micro-batch
    (remat "full") and its backward once, and the arguments are the
    parameters, the two moments, the step and the batch."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.train.steps import TrainConfig

    cfg = get_config("qwen2-1.5b", smoke=True)
    assert cfg.remat == "full"
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    rules = strategy.rules_for(cfg)
    with FakeTensorMode():
        cell = dryrun.trace_cell(cfg, ShapeSpec("t", 32, 4, "train"), mesh,
                                 rules, "cpu", TrainConfig(accum_steps=2))
    trace = cell["trace"]
    want = cfg.n_layers * 2
    assert trace.calls("repro_torch.flash_fwd") == 2 * want
    assert trace.calls("repro_torch.flash_bwd") == want
    n = sum(p.numel() for p in leaves(param_tree(cell["model"])))
    assert cell["argument_bytes"] == 3 * 4 * n + 4 + 2 * 4 * 4 * 32
    assert trace.peak_bytes > cell["argument_bytes"]
    assert cell["loops"] == [("layers", cfg.n_layers), ("microbatches", 2)]


def _un_meshed(cfg, kind, device):
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.train.steps import TrainConfig

    shape = ShapeSpec("t", 32 if kind == "train" else 24, 4, kind)
    args = (cfg, shape, make_abstract_mesh((1, 1), ("data", "model")),
            strategy.rules_for(cfg), device, TrainConfig(accum_steps=2))
    if device == "meta":
        return dryrun.trace_cell(*args)
    with FakeTensorMode():
        return dryrun.trace_cell(*args)


@pytest.mark.parametrize("arch,kind", [("rwkv6-3b", "train"),
                                       ("qwen2-1.5b", "prefill"),
                                       ("qwen2-1.5b", "train")])
def test_an_un_meshed_trace_on_meta_is_the_fake_ones(arch, kind):
    """An un-meshed cell traced on meta tensors, with no fake mode, holds
    the ops of the same cell traced under ``FakeTensorMode``: the same
    names, operand shapes, FLOPs and bytes, the same peak and arguments.
    Meta tensors take the card's route through the wrappers; the only
    route that differs from the CPU's is K5's under grad, whose forward
    keeps the log-sum-exp for ``flash_bwd_tc``: there the log-sum-exp's
    bytes are the difference, a (B, H, S rounded up) f32 block a layer
    and micro-batch, written by each forward and read by the backward."""
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.flash_attention.ref import BQ_LSE

    cfg = get_config(arch, smoke=True)
    # qwen2's heads at 128, as the full config's: K5's backward is then
    # flash_bwd_tc's, whose route differs from the CPU's
    lse_route = arch == "qwen2-1.5b"
    if lse_route:
        cfg = dataclasses.replace(cfg, head_dim=128)
    meta, fake = (_un_meshed(cfg, kind, d) for d in ("meta", "cpu"))
    m, f = meta["trace"], fake["trace"]
    assert [op.name for op in m.ops] == [op.name for op in f.ops]
    assert [op.flops for op in m.ops] == [op.flops for op in f.ops]
    assert meta["argument_bytes"] == fake["argument_bytes"]
    assert m.calls("repro_torch.flash_fwd") == (
        f.calls("repro_torch.flash_fwd"))
    if not (lse_route and kind == "train"):
        assert [(op.shapes, op.bytes) for op in m.ops] == [
            (op.shapes, op.bytes) for op in f.ops]
        assert m.peak_bytes == f.peak_bytes
        return
    assert k5.bwd_variant(torch.bfloat16, 128, 128) == "flash_bwd_tc"
    lse = 2 * cfg.n_heads * BQ_LSE * 4          # B 2, S 32 <= BQ_LSE
    fwd, bwd = (m.calls("repro_torch." + n) for n in ("flash_fwd",
                                                       "flash_bwd"))
    assert fwd == 2 * bwd > 0
    assert sum(op.bytes for op in m.ops) - sum(op.bytes for op in f.ops) \
        == (fwd + bwd) * lse
    assert m.peak_bytes >= f.peak_bytes


def test_meta_takes_the_card_route_only_in_a_trace():
    """Outside a dry run's trace a meta tensor is no device's: K5's and
    K6's wrappers refuse it, as before the meta route."""
    from repro_torch.kernels import KernelError, meta_route
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.rwkv6 import ops as k6

    q = torch.empty((1, 8, 2, 16), device="meta")
    r = torch.empty((1, 8, 2, 4), device="meta")
    u = torch.empty((2, 4), device="meta")
    for call in (lambda: k5.flash_attention(q, q, q),
                 lambda: k6.wkv6(r, r, r, r, u)):
        with pytest.raises(KernelError, match="CUDA"):
            call()
        with meta_route():
            out = call()
        assert all(t.device.type == "meta" for t in
                   (out if isinstance(out, tuple) else (out,)))
    with pytest.raises(KernelError, match="CUDA"):
        k5.flash_attention(q, q, q)


def test_baseline_profile_traces_a_cut_cell(tmp_path, capsys):
    """``--profile baseline``: qwen2-1.5b's prefill_32k on the (16, 16)
    mesh cut to 2 layers, through the CLI.  The artifact names its profile,
    its depth and its rules (the reference's baseline overrides: no
    weight-gather FSDP, the grids' capacity replicated), and its attention
    is the reference's dense one: no K5 call."""
    rc = dryrun.main(["--arch", "qwen2-1.5b", "--shape", "prefill_32k",
                      "--mesh", "single", "--profile", "baseline",
                      "--layers", "2", "--out", str(tmp_path)])
    assert rc == 0, capsys.readouterr().out[-2000:]
    assert not dist.is_initialized()
    name = "qwen2_1_5b__prefill_32k__single__baseline__2layers.json"
    with open(tmp_path / name) as f:
        art = json.load(f)
    assert art["profile"] == "baseline" and art["n_layers"] == 2
    assert art["rules"]["moe_cap"] is None
    assert art["rules"]["_weight_gather"] is False
    assert art["rules"]["batch"] == ["pod", "data"]
    assert set(art["trace_analysis"]["custom_op_calls"].values()) == {0}
    assert art["trip_counts"] == [["layers", 2]]


#: the MoE cells, each cut to 2 layers and, for a train cell, to one of
#: its micro-batches (the loop repeats the same ops): the (X, C) grid's
#: experts a rank holds (granite's replicated, deepseek's over "model")
MOE_CELLS = [(arch, shape, mesh) for arch in ("granite-moe-3b-a800m",
                                              "deepseek-v2-236b")
             for shape in ("train_4k", "decode_32k")
             for mesh in ("single", "multi")]


@pytest.mark.parametrize("arch,shape_name,mesh_name", MOE_CELLS)
def test_moe_cells_trace_on_the_production_meshes(arch, shape_name,
                                                  mesh_name):
    """The MoE families through the rules on the fake (16, 16) and (2, 16,
    16) meshes: granite's batch-local grids (experts replicated, tensor
    parallelism inside them), deepseek's global grid (experts over
    "model", the capacity replicated) and the dropless decode.  A train
    cell's grid rows are its rank's: granite's (X, B·C/ranks, E) with its
    own batch rows, deepseek's (X/16, C, E); K5's forward runs twice a
    layer (remat "full") and its backward once; the decode runs no K5."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.train.steps import TrainConfig

    cfg, rules = dryrun.cell_config(arch, layers=2)
    shape = SHAPES[shape_name]
    accum = strategy.train_config_for(cfg, shape_name).accum_steps
    if shape.kind == "train":
        shape = dataclasses.replace(shape,
                                    global_batch=shape.global_batch // accum)
    multi = mesh_name == "multi"
    with dryrun.fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        with FakeTensorMode(), dryrun.use_mesh_rules(mesh, rules):
            cell = dryrun.trace_cell(cfg, shape, mesh, rules, "cpu",
                                     TrainConfig(accum_steps=1))
    assert not dist.is_initialized()
    trace = cell["trace"]
    calls = {n: trace.calls("repro_torch." + n)
             for n in ("flash_fwd", "flash_bwd")}
    assert calls == ({"flash_fwd": 4, "flash_bwd": 2}
                     if shape.kind == "train" else
                     {"flash_fwd": 0, "flash_bwd": 0})
    # the gathers by index: the grid's rows (train), the rows each token
    # takes of the experts' outputs (the dropless decode)
    index = [(op.shapes[0], op.shapes[1]) for op in trace.ops
             if op.name == "aten.index.Tensor"]
    X, K = cfg.n_experts, cfg.experts_per_token
    ranks = 32 if multi else 16
    bl = shape.global_batch // ranks            # a rank's batch rows
    if shape.kind == "train" and arch.startswith("granite"):
        C = L._capacity(shape.seq_len, cfg)
        assert (X, bl, C) in [i for _, i in index]
    elif shape.kind == "train":
        C = L._capacity(shape.global_batch * shape.seq_len, cfg)
        assert (X // 16, C) in [i for _, i in index]
    else:
        # deepseek's rank holds 10 of the experts and points a pair of
        # another's at a zero row
        rows = bl * X if arch.startswith("granite") else bl * X // 16 + 1
        assert (rows, (bl, K)) in [(r[0], i) for r, i in index]


#: decode cells traced at two cache lengths on the (16, 16) mesh: (arch,
#: layers, batch, lengths).  qwen2-1.5b and deepseek-v2-236b (MLA) at
#: decode_32k's batch 128 (the positions over "model"), gemma3-12b at
#: long_500k's batch 1 (the positions over both axes) cut to 6 layers,
#: five local (window 1024) and one global
FLASH_DECODE_CELLS = [("qwen2-1.5b", 2, 128, (32768, 65536)),
                      ("deepseek-v2-236b", 2, 128, (32768, 65536)),
                      ("gemma3-12b", 6, 1, (524288, 1048576))]


@pytest.mark.parametrize("arch,layers,batch,lengths", FLASH_DECODE_CELLS)
def test_decode_collectives_do_not_grow_with_the_cache(arch, layers, batch,
                                                       lengths):
    """Flash-decode over the position-sharded cache: the decode's
    collectives (kind, count and bytes) are the same at both cache
    lengths; what moves is per-layer maxima, sums and the (B, 1, H, D)
    output, never a cache's positions.  The parent's decode gathered each
    layer's cache whole, so its bytes doubled with the length."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import trace_analysis

    cfg, rules = dryrun.cell_config(arch, layers=layers)
    totals = []
    with dryrun.fake_group(256):
        mesh = make_production_mesh(multi_pod=False, device="cpu")
        for T in lengths:
            shape = ShapeSpec("decode", T, batch, "decode")
            with FakeTensorMode(), dryrun.use_mesh_rules(mesh, rules):
                cell = dryrun.trace_cell(cfg, shape, mesh, rules, "cpu")
            totals.append(trace_analysis.analyze(cell["trace"]))
    assert not dist.is_initialized()
    a, b = totals
    assert a.collective_bytes == b.collective_bytes
    assert a.collective_count == b.collective_count
    # the combine: a max, a sum and the f32 output of every layer, all
    # reduced over each mesh dimension that splits the positions
    axes = 1 if batch % 16 == 0 else 2
    assert a.collective_count["all-reduce"] >= 3 * layers * axes
    # no collective takes an operand with a dimension of positions, a
    # rank's block or the whole
    T = lengths[1]
    moved = [op.shapes for op in cell["trace"].ops if op.collective
             and {T, T // 16 ** axes} & {d for s in op.shapes for d in s}]
    assert not moved, moved


def test_fake_group_is_destroyed_and_refuses_a_second():
    with pytest.raises(RuntimeError, match="boom"):
        with dryrun.fake_group(4):
            assert dist.get_world_size() == 4 and dist.get_rank() == 0
            with pytest.raises(RuntimeError, match="already running"):
                with dryrun.fake_group(2):
                    pass
            raise RuntimeError("boom")
    assert not dist.is_initialized()


def test_cuda_mesh_without_a_card_on_a_fake_group_only():
    """The dry run names the card's device type on a fake group with no
    card; a real group without a card still refuses a CUDA mesh."""
    assert not torch.cuda.is_available()
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        assert mesh.device_type == "cuda"
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            make_mesh((1, 1), ("data", "model"), "cuda")
    finally:
        dist.destroy_process_group()


def test_abstract_params_hold_one_ranks_shards():
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True))
    rules = strategy.rules_for(cfg)
    model = dryrun.get_family(cfg).build(cfg, device="meta")
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        pm.abstract_params(model, device="cpu")
    with dryrun.fake_group(8):
        mesh = make_mesh((4, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            model = dryrun.abstract_model(cfg, mesh, rules, "cpu")
        tok = model.embed["tok"]
        # (vocab, embed): vocab over model, embed over data
        assert tuple(tok.shape) == (cfg.padded_vocab, cfg.d_model)
        assert tuple(tok.to_local().shape) == (cfg.padded_vocab // 2,
                                               cfg.d_model // 4)
        assert not tok.requires_grad
    assert not dist.is_initialized()
