"""The port's distributed layer on ranks of a gloo process group on the CPU.

Eight ranks on a (4, 2) ("data", "model") mesh, one subprocess that spawns
them (``tests/_torch_multirank_run.py``): qwen2, rwkv6, granite-moe and
deepseek-v2 smoke configs in f32 (the MoE ones at capacity factor 0.5, so
their grids drop pairs, each layer as many as one process drops), the
reference's parameters carried across, train 4 sharded steps of
B 8, S 32 in 2 micro-batches by the reference's ``TrainConfig(accum_steps=2)``
and decode one step on the sharded cache, as the reference's
``tests/test_multidevice.py`` tries to.  The reference's own 8-device run
fails inside jax (a sharded gather it refuses), so each sharded run is held
to the port's single-process run of the same inputs, which
``tests/test_torch_train.py`` holds to the reference's step.  The first
step's gradients are held leaf by leaf, so a gradient summed wrongly over
the ranks shows whatever the optimizer's step does with it.  Then a GQA
config whose ranks hold fewer q heads than a KV group, one step at lr 3e-3
with no warm-up, ``device_put_batch``'s shards and ``compressed_psum_along``
over each mesh axis.  The decode of those cases (batch 8: the cache's
positions split over "model" = 2) and four decode-only cases at batch 1 or
2, where "batch" leaves "data" free and the cache's positions take both
axes, 8 blocks of 8: qwen2-smoke, gemma3-smoke (window 8, a global layer
every 6), hymba-smoke and deepseek-smoke's MLA run flash-decode
(``layers.gqa_decode_block``, ``mla_decode_block``); their logits are held
to one process's, and each rank's shard of every position cache keeps its
rows but the one written.  Last, one gloo rank on the (1, 1) mesh: the
meshed step equals the un-meshed one bit for bit."""
import dataclasses
import importlib.util
import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "_torch_multirank_run", os.path.join(ROOT, "tests",
                                         "_torch_multirank_run.py"))
RUN = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(RUN)

#: the sharded runs against the single-process run, f32: losses (relative),
#: the parameters after the last step (relative L2 over the whole tree, and
#: each element absolute where the steps are the reference schedule's
#: warm-up) and the decode logits (absolute)
LOSS_RTOL, PARAM_REL_L2, PARAM_ATOL, LOGITS_ATOL = 1e-5, 1e-4, 1e-5, 1e-4
#: the first step's gradients: each leaf's relative L2 (no leaf is left
#: out) and the global norm's relative gap
GRAD_REL_L2, GRAD_NORM_RTOL = 1e-4, 1e-5
#: the subprocess's own limit (import, spawn and every case)
TIMEOUT_S = 480


F32 = {"compute_dtype": "float32"}


def _ref_tree(arch, **kw):
    """The reference's parameters for the smoke config of ``arch`` with the
    fields ``kw``, drawn by ``jax.random.key(0)``, as numpy arrays."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models.common import get_family as ref_family
    from repro.nn.param import init_params

    rcfg = dataclasses.replace(ref_get_config(arch, True), **kw)
    params = init_params(ref_family(rcfg).template(rcfg), jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _batch(cfg, B=8, S=32, seed=1):
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}


#: the MoE cases' capacity factor: every layer's grids drop pairs
MOE_F32 = {**F32, "capacity_factor": 0.5}
#: the cases of the sharded run
NAMES = ("qwen2", "rwkv6", "gqa", "granite", "deepseek")


def _cases():
    """name -> {"cfg", "tree", "batch", "steps", "opt", "rules"}: qwen2,
    rwkv6 and the MoE cases on the reference's ``TrainConfig(accum_steps=2)``
    schedule (lr 3e-4 warmed up over 100 steps); the GQA case one step that
    moves the weights (lr 3e-3, no warm-up: ``chip_smoke.dist_train``'s
    AdamW, ``opt`` None).  granite-smoke runs granite's own rules (its
    experts replicated, tensor parallelism inside them: batch-local grids
    with no collective in the routing); deepseek-smoke the default ones
    (its 8 experts over "model", the global grid's capacity over "data":
    the grid's partial sums reduce-scattered)."""
    from repro_torch.distributed import strategy
    from repro_torch.optim.adamw import AdamWConfig

    out = {}
    for name, arch, fields, steps, opt, rules in (
            ("qwen2", "qwen2-1.5b", F32, RUN.STEPS, AdamWConfig(), None),
            ("rwkv6", "rwkv6-3b", F32, RUN.STEPS, AdamWConfig(), None),
            # 4 q heads to 1 KV head: a rank's 2 q heads are fewer than
            # the group of 4
            ("gqa", "qwen2-1.5b", {**F32, "n_kv_heads": 1}, 1, None, None),
            ("granite", "granite-moe-3b-a800m", MOE_F32, RUN.STEPS,
             AdamWConfig(), strategy.RULE_OVERRIDES["granite-moe-3b-a800m"]),
            ("deepseek", "deepseek-v2-236b", MOE_F32, RUN.STEPS,
             AdamWConfig(), None)):
        cfg = dataclasses.replace(get_config(arch, smoke=True), **fields)
        out[name] = {"cfg": cfg, "tree": _ref_tree(arch, **fields),
                     "batch": _batch(cfg), "steps": steps, "opt": opt,
                     "rules": rules}
    return out


#: the decode-only cases: name -> (arch, batch, position); the cache's
#: 64 positions split into 8 blocks of 8, the position at a block's start
#: (qwen2, deepseek), inside one (gemma3: its local layers' window of 8
#: spans blocks 3 and 4, the other six wholly masked) and the last (hymba)
DECODE_CASES = {"qwen2": ("qwen2-1.5b", 1, 40),
                "gemma3": ("gemma3-12b", 1, 37),
                "hymba": ("hymba-1.5b", 2, 63),
                "deepseek": ("deepseek-v2-236b", 1, 24)}
DECODE_T = 64


def _decode_cases():
    """name -> {"cfg", "tree", "cache", "tokens", "pos"}: the smoke config
    in f32, parameters drawn by the port's ``init_model`` (seed 5), a cache
    of seeded normal rows in every entry, and seeded tokens."""
    from repro_torch.models.common import get_family, init_model

    out = {}
    for name, (arch, B, pos) in DECODE_CASES.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), **F32)
        fam = get_family(cfg)
        rng = np.random.default_rng(7)
        out[name] = {
            "cfg": cfg, "pos": pos,
            "tree": _param_tree_np(init_model(
                fam, cfg, torch.Generator().manual_seed(5))),
            "cache": {k: rng.normal(size=v.shape).astype(np.float32)
                      for k, v in fam.init_cache(cfg, B, DECODE_T,
                                                 device="meta").items()},
            "tokens": rng.integers(0, cfg.vocab_size, (B, 1)).astype(
                np.int32)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the inputs, the eight ranks' result, each case's single-process
    result; a decode-only case's under "decode NAME")."""
    work = tmp_path_factory.mktemp("multirank")
    inputs = {"cases": _cases(), "decode": _decode_cases()}
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_multirank_run.py"), str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:         # the spawner and its ranks
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, f"stderr:\n{err[-4000:]}"
    with open(work / "result.pkl", "rb") as f:
        result = pickle.load(f)
    single = {name: RUN.run_case(c["cfg"], c["tree"], c["batch"],
                                 steps=c["steps"], opt=c["opt"])
              for name, c in inputs["cases"].items()}
    for name, c in inputs["decode"].items():
        single["decode " + name] = RUN.decode_case(
            c["cfg"], c["tree"], c["cache"], c["tokens"], c["pos"])
    return inputs, result, single


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


@pytest.mark.parametrize("name,part", [
    (name, part) for name in NAMES
    for part in ("losses", "params", "logits")])
def test_sharded_run_matches_single_process(runs, name, part):
    """Eight ranks against one process: the losses of every step, every
    parameter after the last, the decode step's logits."""
    inputs, result, single = runs
    case = inputs["cases"][name]
    got, want = result[name][part], single[name][part]
    if part == "losses":
        assert len(got) == len(want) == case["steps"]
        gaps = [abs(float(g) / float(w) - 1) for g, w in zip(got, want)]
        print(f"{name} losses: relative gap {max(gaps):.3e}")
        for g, w in zip(got, want):
            assert np.isfinite(float(g))
            assert abs(float(g) - float(w)) <= LOSS_RTOL * abs(float(w))
        if len(got) > 1:            # the fixed batch is learned
            assert float(got[-1]) < float(got[0])
    elif part == "params":
        assert len(got) == len(want)
        assert all(g.shape == w.shape for g, w in zip(got, want))
        flat = [torch.cat([t.reshape(-1) for t in ts]) for ts in (got, want)]
        rel, gap = _rel_l2(*flat), float((flat[0] - flat[1]).abs().max())
        leaf = max(_rel_l2(g, w) for g, w in zip(got, want))
        print(f"{name} parameters: relative L2 {rel:.3e}, max abs {gap:.3e}, "
              f"largest leaf relative L2 {leaf:.3e}")
        assert rel <= PARAM_REL_L2
        # at lr 3e-3 an element whose gradient is within f32's rounding of
        # zero takes Adam's normalised step of about +-lr in either run
        if case["opt"] is not None:
            assert gap <= PARAM_ATOL
    else:
        assert got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        gap = float((got - want).abs().max())
        print(f"{name} decode logits: max abs {gap:.3e}")
        assert gap <= LOGITS_ATOL


@pytest.mark.parametrize("name", NAMES)
def test_sharded_first_step_gradients_match_single_process(runs, name):
    """The first step's gradients (each DTensor's whole, before the
    optimizer) against one process's, leaf by leaf, and their global norm:
    a Partial summed twice or a replicated input's gradient left unsummed
    moves the leaves it reaches by O(1)."""
    _inputs, result, single = runs
    got, want = result[name]["grads"], single[name]["grads"]
    assert len(got) == len(want) > 0
    assert all(g.shape == w.shape for g, w in zip(got, want))
    rels = [_rel_l2(g, w) for g, w in zip(got, want)]
    norm = [float(r[name]["grad_norms"][0]) for r in (result, single)]
    print(f"{name} first-step gradients: largest leaf relative L2 "
          f"{max(rels):.3e} (leaf {rels.index(max(rels))} of {len(rels)}), "
          f"global norm gap {abs(norm[0] / norm[1] - 1):.3e}")
    assert all(np.isfinite(r) for r in rels)
    assert max(rels) <= GRAD_REL_L2, rels
    assert abs(norm[0] - norm[1]) <= GRAD_NORM_RTOL * norm[1]


@pytest.mark.parametrize("name", ["granite", "deepseek"])
def test_sharded_moe_drops_the_single_process_pairs(runs, name):
    """Each MoE layer call's dropped (token, slot) pairs, summed over the
    ranks, equal one process's exactly: granite's batch-local grids by
    batch row, deepseek's global grid over every token in their global
    order (each rank ranks the gathered experts of all of them).  At
    capacity factor 0.5 every call drops pairs; a call is a layer's
    forward on a micro-batch (remat's recomputation stops at the layer's
    last saved tensor, before the MoE call returns)."""
    inputs, result, single = runs
    case = inputs["cases"][name]
    got, want = result[name]["dropped"], single[name]["dropped"]
    print(f"{name} dropped pairs by call: {got}")
    assert len(want) == case["steps"] * RUN.ACCUM * case["cfg"].n_layers
    assert got == want and min(want) > 0


@pytest.mark.parametrize("name", DECODE_CASES)
def test_position_split_decode_logits_match_single_process(runs, name):
    """Flash-decode over 8 position blocks: every rank's logits within
    ``LOGITS_ATOL`` of one process's."""
    ranks, want = runs[1]["ranks"], runs[2]["decode " + name]["logits"]
    assert all(set(r["decoded"][name]["blocks"].values()) == {8}
               for r in ranks)
    gaps = [float((r["decoded"][name]["logits"] - want).abs().max())
            for r in ranks]
    print(f"{name} split decode logits: max abs {max(gaps):.3e}")
    assert all(bool(torch.isfinite(r["decoded"][name]["logits"]).all())
               for r in ranks)
    assert max(gaps) <= LOGITS_ATOL


@pytest.mark.parametrize("name", DECODE_CASES)
def test_position_split_decode_writes_one_row_of_the_local_shard(runs,
                                                                 name):
    """Each rank's shard of every position cache after the step equals it
    before, but for the row at the position; the one rank that holds that
    row wrote one process's row into it (within ``LOGITS_ATOL``)."""
    ranks, want = runs[1]["ranks"], runs[2]["decode " + name]["rows"]
    assert all(all(r["decoded"][name]["kept"].values()) for r in ranks)
    for k, row in want.items():
        held = [r["decoded"][name]["rows"][k] for r in ranks
                if k in r["decoded"][name]["rows"]]
        assert len(held) == 1, k
        assert float((held[0] - row).abs().max()) <= LOGITS_ATOL, k


def test_device_put_batch_shards_are_rows_of_the_host_batch(runs):
    """Each rank holds the rows of its "data" coordinate, whole sequences,
    the same on both "model" ranks."""
    ranks = runs[1]["ranks"]
    assert len(ranks) == 8
    assert all(r["shards_ok"] for r in ranks)
    assert sorted(r["coords"] for r in ranks) == [(d, m) for d in range(4)
                                                  for m in range(2)]


@pytest.mark.parametrize("axis", RUN.MESH_AXES)
def test_compressed_psum_along_sums_the_local_decodes(runs, axis):
    """``compressed_psum_along`` over one mesh axis = the sum of the
    decoded codes (``q.float() * s``) of the ranks on that axis's group."""
    from repro_torch.optim import compress
    from repro_torch.tree import leaves

    ranks = runs[1]["ranks"]

    def decoded(r):
        g = torch.Generator().manual_seed(100 + r)
        mine = {"w": torch.randn((6, 5), generator=g),
                "b": [torch.randn((7,), generator=g)]}
        codes, scales, _ = compress.compress_with_feedback(
            mine, compress.init_error_feedback(mine))
        return leaves(compress.decompress(codes, scales))

    for rank, r in enumerate(ranks):
        d, m = r["coords"]
        group = [i for i, o in enumerate(ranks)
                 if (o["coords"][1] == m if axis == "data"
                     else o["coords"][0] == d)]
        assert rank in group and len(group) == (4 if axis == "data" else 2)
        want = [sum(parts) for parts in zip(*(decoded(i) for i in group))]
        got = leaves(r["psum"][axis])
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b",
                                  "granite-moe-3b-a800m", "deepseek-v2-236b"])
def test_one_rank_mesh_step_is_the_unmeshed_step_bit_for_bit(arch):
    """One gloo rank, the (1, 1) smoke mesh (every placement a size-1
    shard or a replica): the meshed smoke step (the config as it is, bf16
    compute; the MoE configs at capacity factor 0.5, so their grids drop
    pairs) gives the un-meshed step's losses, parameters, dropped pairs
    and decode logits bit for bit."""
    import torch.distributed as dist

    from repro_torch.distributed import strategy
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.common import get_family, init_model

    cfg = get_config(arch, smoke=True)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    ref_tree = _param_tree_np(init_model(get_family(cfg), cfg,
                                         torch.Generator().manual_seed(3)))
    batch = _batch(cfg)
    want = RUN.run_case(cfg, ref_tree, batch, steps=2)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_smoke_mesh("cpu")
        got = RUN.run_case(cfg, ref_tree, batch, mesh,
                           strategy.rules_for(cfg), steps=2)
    finally:
        dist.destroy_process_group()
    for part in ("losses", "params"):
        assert len(got[part]) == len(want[part])
        for g, w in zip(got[part], want[part]):
            assert torch.equal(g, w), part
    assert torch.equal(got["logits"], want["logits"])
    assert got["dropped"] == want["dropped"]
    assert (min(want["dropped"]) > 0) if cfg.is_moe else not want["dropped"]


def _param_tree_np(model):
    """A model's parameters as the reference's tree of numpy arrays (each
    stack's layers stacked on a leading axis)."""
    from repro_torch.models.common import param_tree

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return np.stack([x.detach().numpy() for x in t])
        return t.detach().numpy()
    return conv(param_tree(model))


def test_dry_run_trace_has_the_real_runs_collectives(runs):
    """The dry run's trace of the same step (a fake group of 8 ranks in
    this process, the same (4, 2) CPU mesh, config, batch and rules, under
    ``FakeTensorMode``) makes the collectives the real gloo ranks made:
    the same count and result bytes of each kind, as the recorder counted
    them there, and the same count as ``CommDebugMode`` did.  On a CPU mesh
    DTensor makes a shard-to-shard move an all-gather and a chunk (gloo
    has no all-to-all), in the fake trace as in the real run."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import strategy
    from repro_torch.distributed.sharding import use_mesh_rules
    from repro_torch.launch import dryrun, trace_analysis
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.steps import TrainConfig

    inputs, result, _single = runs
    real = result["recorded"]
    case = inputs["cases"]["qwen2"]
    cfg, (B, S) = case["cfg"], case["batch"]["tokens"].shape
    rules = strategy.rules_for(cfg)
    with dryrun.fake_group(8):
        mesh = make_mesh(RUN.MESH_SHAPE, RUN.MESH_AXES, "cpu")
        with FakeTensorMode(), use_mesh_rules(mesh, rules):
            cell = dryrun.trace_cell(cfg, ShapeSpec("train", S, B, "train"),
                                     mesh, rules, "cpu",
                                     TrainConfig(accum_steps=RUN.ACCUM))
    assert not dist.is_initialized()
    fake = trace_analysis.analyze(cell["trace"])
    assert fake.collective_count == real["collective_count"]
    assert fake.collective_bytes == real["collective_bytes"]
    assert "all-to-all" not in fake.collective_count
    by_name = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter"}
    assert {by_name[k]: v for k, v in real["comm"].items()} == \
        fake.collective_count
