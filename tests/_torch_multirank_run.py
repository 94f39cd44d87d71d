"""The port's sharded train and decode on eight gloo ranks of a (4, 2)
("data", "model") mesh on the CPU, for ``tests/test_torch_multirank.py``.

    python tests/_torch_multirank_run.py WORKDIR

reads ``WORKDIR/inputs.pkl`` (the cases: each a config, the reference's
parameters as numpy arrays, a host batch, its steps, its AdamW and its rule
overrides, where not the config's own ``strategy.rules_for``; and the
decode-only cases: a config, parameters, a host cache, tokens and a
position), spawns the ranks, which meet through a ``FileStore`` in
``WORKDIR``, and writes what rank 0 gathered to ``WORKDIR/result.pkl``,
with the collectives of one more qwen2 step that rank 0 recorded
(:func:`record_step`).  :func:`run_case` and :func:`decode_case` are also
the single-process runs the test holds the ranks to (``mesh`` None)."""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESH_SHAPE, MESH_AXES = (4, 2), ("data", "model")
STEPS, ACCUM = 4, 2


def run_case(cfg, tree, batch, mesh=None, rules=None, steps=STEPS,
             accum=ACCUM, opt=None):
    """``steps`` train steps of ``cfg`` from the parameter tree ``tree`` on
    the host batch (``accum`` micro-batches; ``chip_smoke.dist_train``, by
    AdamW ``opt``, by default lr 3e-3 with no warm-up), then one decode step
    on the cache (f32, zeros) at position 0 with the batch's first tokens
    (``chip_smoke.dist_decode``): un-meshed (``mesh`` None) or sharded by
    ``rules``.  -> {"losses", "grad_norms", "params", "grads" (the first
    step's), "dropped" (each MoE layer call's dropped pairs), "logits"} on
    the host."""
    if ROOT not in sys.path:        # chip_smoke.py holds the one harness
        sys.path.append(ROOT)
    from chip_smoke import dist_decode, dist_train

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models.common import get_family

    cpu = torch.device("cpu")
    B, S = batch["tokens"].shape
    run = dist_train(cpu, cfg, batch, steps, accum, mesh, rules, tree=tree,
                     grads=True, opt=opt)
    cache = get_family(cfg).init_cache(cfg, B, S, dtype=torch.float32)
    logits = dist_decode(cpu, cfg, run["state"]["model"],
                         ShapeSpec("decode", S, B, "decode"), cache,
                         torch.as_tensor(batch["tokens"][:, :1]), 0, mesh,
                         rules)
    return {"losses": run["losses"], "grad_norms": run["grad_norms"],
            "params": run["params"], "grads": run["grads"],
            "dropped": run["dropped"], "logits": logits}


def decode_case(cfg, tree, cache, tokens, pos, mesh=None, rules=None):
    """One decode step of ``cfg`` from the parameter tree ``tree`` at
    ``pos`` on the host cache ``cache`` (numpy arrays) with ``tokens``
    (B, 1) (``chip_smoke.dist_decode``), un-meshed (``mesh`` None) or with
    the cache placed by ``cache_specs`` under ``rules``.  -> {"logits";
    "rows": each position cache's rows at ``pos`` after the step, (layers,
    B, ...), where this rank holds them (no entry where it does not); on a mesh
    "kept": each position cache's local shard after the step equals it
    before but for the rows at ``pos``; "blocks": the positions' blocks}."""
    if ROOT not in sys.path:
        sys.path.append(ROOT)
    from chip_smoke import dist_decode
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import (placements, shard_block,
                                                  use_mesh_rules)
    from repro_torch.launch.inputs import cache_specs
    from repro_torch.models.common import get_family, load_reference_params

    fam = get_family(cfg)
    host = {k: torch.as_tensor(v) for k, v in cache.items()}
    seq = {k: a.index("cache_seq")
           for k, a in fam.cache_logical_axes(cfg).items()
           if "cache_seq" in a}
    first = next(iter(seq))
    shape = ShapeSpec("decode", host[first].shape[seq[first]],
                      tokens.shape[0], "decode")
    model = load_reference_params(fam.build(cfg), tree)
    logits, after = dist_decode(torch.device("cpu"), cfg, model, shape, host,
                                torch.as_tensor(tokens), pos, mesh, rules,
                                with_cache=True)
    out = {"logits": logits, "rows": {}, "kept": {}, "blocks": {}}
    if mesh is None:
        out["rows"] = {k: after[k].select(d, pos).clone()
                       for k, d in seq.items()}
        return out
    with use_mesh_rules(mesh, rules):
        specs = cache_specs(cfg, shape, mesh, rules)
        for k, d in seq.items():
            pl = placements(specs[k].spec, mesh)
            before = distribute_tensor(host[k], mesh, pl,
                                       src_data_rank=None).to_local()
            now = after[k].to_local()
            idx, n = shard_block(mesh, pl, d)
            tl = now.shape[d]
            others = torch.tensor([i for i in range(tl)
                                   if idx * tl + i != pos])
            out["kept"][k] = torch.equal(now.index_select(d, others),
                                         before.index_select(d, others))
            out["blocks"][k] = n
            if idx * tl <= pos < (idx + 1) * tl:
                out["rows"][k] = now.select(d, pos - idx * tl).clone()
    return out


def record_step(cfg, tree, batch, mesh, rules):
    """One train step of ``cfg`` on the mesh from the parameter tree (the
    dry run's form: ``accum`` micro-batches, the reference's
    ``TrainConfig``), recorded by ``CommDebugMode`` and by the dry run's op
    recorder (``repro_torch.launch.trace_analysis``).  -> {"comm": the
    collectives ``CommDebugMode`` counted, by name; "collective_count",
    "collective_bytes": the recorder's, by the reference's names}."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.distributed.sharding import use_mesh_rules
    from repro_torch.launch import trace_analysis
    from repro_torch.models.common import get_family, load_reference_params
    from repro_torch.nn.param import distribute
    from repro_torch.train.steps import (TrainConfig, init_state,
                                         make_train_step)

    with use_mesh_rules(mesh, rules):
        model = distribute(load_reference_params(get_family(cfg).build(cfg),
                                                 tree), mesh, rules)
        state = init_state(cfg, model)
        b = device_put_batch(batch, mesh, rules)
        step = make_train_step(cfg, TrainConfig(accum_steps=ACCUM))
        with CommDebugMode() as comm, trace_analysis.Recorder() as rec:
            step(state, b)
    totals = trace_analysis.analyze(rec.trace)
    return {"comm": {str(k).split(".")[-1]: v
                     for k, v in comm.get_comm_counts().items()},
            "collective_count": totals.collective_count,
            "collective_bytes": totals.collective_bytes}


def _rank(rank, world, workdir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        from repro_torch.data.pipeline import device_put_batch
        from repro_torch.distributed import strategy
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.optim import compress

        with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        mesh = make_mesh(MESH_SHAPE, MESH_AXES, "cpu")
        result = {}
        for name, case in inputs["cases"].items():
            cfg = case["cfg"]
            rules = (strategy.rules_for(cfg) if case.get("rules") is None
                     else strategy.make_rules(**case["rules"]))
            result[name] = run_case(cfg, case["tree"], case["batch"], mesh,
                                    rules, steps=case["steps"],
                                    opt=case["opt"])

        decoded = {}            # each rank's, gathered below
        for name, case in inputs["decode"].items():
            cfg = case["cfg"]
            decoded[name] = decode_case(
                cfg, case["tree"], case["cache"], case["tokens"],
                case["pos"], mesh, strategy.rules_for(cfg))

        # one step as the dry run traces it, its collectives recorded
        case = inputs["cases"]["qwen2"]
        result["recorded"] = record_step(case["cfg"], case["tree"],
                                         case["batch"], mesh,
                                         strategy.rules_for(case["cfg"]))

        # device_put_batch: this rank's shard is its rows of the host batch
        batch = inputs["cases"]["qwen2"]["batch"]
        rules = strategy.rules_for(inputs["cases"]["qwen2"]["cfg"])
        db = device_put_batch(batch, mesh, rules)
        d = mesh.get_local_rank("data")
        rows = batch["tokens"].shape[0] // MESH_SHAPE[0]
        shards_ok = all(np.array_equal(db[k].to_local().numpy(),
                                       v[d * rows:(d + 1) * rows])
                        for k, v in batch.items())

        # compressed_psum_along: each rank's own codes, summed over an axis
        def grads_of(r):
            g = torch.Generator().manual_seed(100 + r)
            return {"w": torch.randn((6, 5), generator=g),
                    "b": [torch.randn((7,), generator=g)]}
        mine = grads_of(rank)
        codes, scales, _ = compress.compress_with_feedback(
            mine, compress.init_error_feedback(mine))
        psum = {axis: compress.compressed_psum_along(codes, scales, mesh,
                                                     axis)
                for axis in MESH_AXES}
        gathered = [None] * world
        dist.all_gather_object(gathered, {
            "shards_ok": shards_ok, "psum": psum, "decoded": decoded,
            "coords": (mesh.get_local_rank("data"),
                       mesh.get_local_rank("model"))})
        if rank == 0:
            result["ranks"] = gathered
            with open(os.path.join(workdir, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def main(workdir):
    import torch.multiprocessing as mp

    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    mp.spawn(_rank, args=(world, workdir), nprocs=world)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    main(sys.argv[1])
