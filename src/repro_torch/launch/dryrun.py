"""The dry run: trace every (arch x shape x mesh) cell of the port and
extract its roofline inputs, without allocating a single model byte -- the
reference's ``launch/dryrun.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 33 cells x 2 meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-moe-3b-a800m --profile baseline
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-v2-236b --shape train_4k --layers 2

Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__<profile>][__<n>layers].json
(the profile named where it is not "optimized"; ``--layers`` cuts the depth)

Where the reference lowers and compiles each cell on 512 forced host
devices, the port runs the cell's step eagerly as rank 0 of a ``"fake"``
process group of 256 or 512 ranks (started here and destroyed when the
cell ends), under ``FakeTensorMode``: every tensor is a shape without
storage, every collective returns at once, and K5's and K6's custom ops
run their fake implementations.  :mod:`repro_torch.launch.trace_analysis`
records the ops rank 0 executes on its shards.  The parameters are
:func:`repro_torch.nn.param.abstract_params` (one rank's shards, never the
whole tensor).  The trace's device is the card's, ``cuda``, where the
PyTorch build has CUDA; a CPU-only build cannot take an autograd step on
fake CUDA tensors (its autograd asks CUDA for a stream and aborts), so
there the tensors are fake CPU tensors and the meshes CPU meshes, and the
artifact's ``trace_device`` says so.

An un-meshed cell (:func:`trace_cell` with an ``AbstractMesh``, as the
card's smoke script holds the real step against) may also trace on meta
tensors, with no ``FakeTensorMode``: meta tensors then take the card's
route through K5's and K6's wrappers (:func:`repro_torch.kernels.
meta_route`) to the same fake implementations, and the trace holds the
same ops, bytes and peak as on fake CUDA tensors, in less time (a fake
tensor's every op passes through the fake mode's Python dispatch; a meta
tensor's runs its meta kernel).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, canonical, get_config
from repro_torch.configs.shapes import SHAPES, shapes_for
from repro_torch.distributed import strategy
from repro_torch.distributed.sharding import (from_shard, placements,
                                              use_mesh_rules)
from repro_torch.kernels import meta_route
from repro_torch.launch import inputs, trace_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import get_family, param_tree
from repro_torch.nn import param as pm
from repro_torch.train.steps import init_state, make_train_step
from repro_torch.tree import leaves

#: profile -> (config overrides, rule overrides), the reference's: "baseline"
#: the paper-faithful placements (dense attention, no weight-gather FSDP,
#: the MoE dispatch grids' capacity replicated), "optimized" K5's attention
#: and the per-arch grid sharding (weight-gather FSDP off: the reference
#: measured it slower)
PROFILES = {
    "baseline": ({"attention_impl": "dense"},
                 {"_weight_gather": False, "moe_cap": None}),
    "optimized": ({}, {"_weight_gather": False}),
}

#: the custom ops whose calls an artifact counts
CUSTOM_OPS = ("repro_torch.flash_fwd", "repro_torch.flash_bwd",
              "repro_torch.wkv6_fwd", "repro_torch.wkv6_bwd")


def default_device() -> str:
    """The trace's device: the card's where the build has CUDA."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


@contextlib.contextmanager
def fake_group(world_size: int):
    """Rank 0 of a ``"fake"`` process group of ``world_size`` ranks, for
    the duration (the counterpart of the reference's forced host device
    count); destroyed on the way out, whatever happens.  Refuses to start
    while another group runs."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "one is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of tensors (a DTensor by its local
    shard)."""
    return sum(trace_analysis._local(t).numel() * t.element_size()
               for t in leaves(tree) if torch.is_tensor(t))


def abstract_input(sds, device):
    """A fake tensor of the stand-in ``sds``
    (:class:`~repro_torch.launch.inputs.ShapeDtypeStruct`): on a
    ``DeviceMesh`` a DTensor of its spec's placements made from this rank's
    shard, else the whole (fake) tensor."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = sds.sharding.mesh
    if not isinstance(mesh, DeviceMesh):
        return torch.zeros(sds.shape, dtype=sds.dtype, device=device)
    return from_shard(sds.shape, placements(sds.spec, mesh), mesh,
                      lambda local: torch.zeros(local, dtype=sds.dtype,
                                                device=device))


def abstract_model(cfg, mesh, rules, device):
    """The family's model of ``cfg`` with :func:`~repro_torch.nn.param.
    abstract_params` (the caller holds a ``FakeTensorMode``): on a
    ``DeviceMesh`` each leaf this rank's shard of its rules' placements,
    else the whole fake leaf."""
    from torch.distributed.device_mesh import DeviceMesh

    model = get_family(cfg).build(cfg, device="meta")
    return pm.abstract_params(
        model, mesh=mesh if isinstance(mesh, DeviceMesh) else None,
        rules=rules, device=device)


def trace_cell(cfg, shape, mesh, rules, device, tcfg=None):
    """Build the abstract parameters, state and inputs of one cell and run
    its step under :class:`~repro_torch.launch.trace_analysis.Recorder`
    (``mesh`` a ``DeviceMesh`` or an :class:`~repro_torch.launch.mesh.
    AbstractMesh` for an un-meshed run; the caller holds a
    ``FakeTensorMode``, but for an un-meshed run on ``device="meta"``).
    -> dict: the recorder's ``trace``, the model, ``argument_bytes``,
    ``output_bytes``, ``alias_bytes`` and the loops as run."""
    from torch.distributed.device_mesh import DeviceMesh

    if torch.device(device).type == "meta":
        if isinstance(mesh, DeviceMesh):
            raise ValueError("a meshed cell traces under a FakeTensorMode; "
                             "meta tensors are for un-meshed cells")
        with meta_route():
            return _trace(cfg, shape, mesh, rules, device, tcfg)
    return _trace(cfg, shape, mesh, rules, device, tcfg)


def _trace(cfg, shape, mesh, rules, device, tcfg):
    fam = get_family(cfg)
    model = abstract_model(cfg, mesh, rules, device)
    loops = [(name, len(getattr(model, name))) for name in model.stack_names]
    rec = trace_analysis.Recorder()

    def fake(sds):
        return abstract_input(sds, device)

    if shape.kind == "train":
        tcfg = tcfg or strategy.train_config_for(cfg, shape.name)
        state = init_state(cfg, model)
        batch = {k: fake(v) for k, v in
                 inputs.batch_specs(cfg, shape, mesh, rules).items()}
        args = (state["params"], state["opt"], state["step"], batch)
        arg_bytes = _local_bytes(args)
        rec.hold(args)
        step = make_train_step(cfg, tcfg)
        with rec:
            out = step(state, batch)
        loops.append(("microbatches", tcfg.accum_steps))
        alias = _local_bytes((state["params"], state["opt"], state["step"]))
        out_bytes = alias + _local_bytes(out)
    elif shape.kind == "prefill":
        pre = {k: fake(v) for k, v in
               inputs.prefill_specs(cfg, shape, mesh, rules).items()}
        arg_bytes = _local_bytes((param_tree(model), pre))
        rec.hold((param_tree(model), pre))
        with torch.no_grad(), rec:
            out = fam.prefill(model, cfg, pre["tokens"],
                              media=pre.get("media"))
        alias, out_bytes = 0, _local_bytes(out)
    elif shape.kind == "decode":
        dec = inputs.decode_specs(cfg, shape, mesh, rules)
        cache = {k: fake(v) for k, v in dec["cache"].items()}
        tokens = fake(dec["tokens"])
        pos = torch.zeros((1,), dtype=torch.int64, device=device)
        args = (param_tree(model), cache, tokens, pos)
        arg_bytes = _local_bytes(args)
        rec.hold(args)
        with torch.no_grad(), rec:
            out = fam.decode_step(model, cfg, cache, tokens, pos)
        alias = _local_bytes(cache)            # updated in place
        out_bytes = _local_bytes(out)
    else:
        raise ValueError(shape.kind)
    return dict(trace=rec.trace, model=model, argument_bytes=arg_bytes,
                output_bytes=out_bytes, alias_bytes=alias, loops=loops)


def cell_config(arch: str, profile: str = "optimized", layers=None):
    """The config and the rules of a cell in ``profile`` (the reference's
    ``build_cell``: the profile's config and rule overrides on the arch's
    own), its depth cut to ``layers`` where given."""
    cfg_over, rule_over = PROFILES[profile]
    cfg = dataclasses.replace(get_config(arch), **cfg_over)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    base = strategy.rules_for(cfg)
    return cfg, dataclasses.replace(base, rules={**base.rules, **rule_over})


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               profile: str = "optimized", layers=None):
    """Trace one cell on its production mesh in ``profile``
    (:data:`PROFILES`), at its depth or cut to ``layers``; returns the
    artifact dict."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, rules = cell_config(arch, profile, layers)
    shape = SHAPES[shape_name]
    device = default_device()
    n_dev = 512 if multi_pod else 256
    with fake_group(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        t0 = time.time()
        with FakeTensorMode(), use_mesh_rules(mesh, rules):
            cell = trace_cell(cfg, shape, mesh, rules, device)
        trace_s = time.time() - t0
        model = cell["model"]
        params = param_tree(model)
        param_bytes = _local_bytes(params)
        n_params = sum(p.numel() for p in leaves(params))
        mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    trace = cell["trace"]
    totals = trace_analysis.analyze(trace, cell["loops"])
    peak = trace.peak_bytes
    return {
        "profile": profile,
        "rules": {k: list(v) if isinstance(v, tuple) else v
                  for k, v in sorted(rules.rules.items())},
        "n_layers": cfg.n_layers,
        "arch": canonical(arch),
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "multi" if multi_pod else "single",
        "mesh_shape": mesh_shape,
        "n_devices": n_dev,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "trace_s": round(trace_s, 1),
        "trace_device": device,
        # per-device static memory (exact, from the shardings)
        "param_bytes_per_device": float(param_bytes),
        "n_params": int(n_params),
        # per device, from the shardings and the trace's live storages
        "memory_analysis": {
            "argument_bytes": cell["argument_bytes"],
            "output_bytes": cell["output_bytes"],
            "alias_bytes": cell["alias_bytes"],
            "peak_bytes": peak,
            "temp_bytes": peak - cell["argument_bytes"],
        },
        "trace_analysis": {
            "flops": totals.flops,
            "hbm_bytes": totals.hbm_bytes,
            "ops": len(trace.ops),
            "custom_op_calls": {name: trace.calls(name)
                                for name in CUSTOM_OPS},
        },
        # whole-step totals of rank 0 (every iteration traced)
        "hlo_flops": totals.flops,
        "hlo_hbm_bytes": totals.hbm_bytes,
        "collective_bytes": totals.collective_bytes,
        "collective_count": totals.collective_count,
        "total_collective_bytes": totals.total_collective_bytes,
        "trip_counts": totals.trip_counts[:12],
    }


def _where(exc: BaseException) -> str:
    """The innermost frame of the port that an exception passed through,
    as ``file:line``."""
    where = ""
    for fr in traceback.extract_tb(exc.__traceback__):
        if "repro_torch" in fr.filename:
            where = (fr.filename[fr.filename.index("repro_torch"):]
                     + f":{fr.lineno}")
    return where


def cell_tag(arch, shape_name, mesh_name, profile="optimized",
             layers=None) -> str:
    """A cell's artifact name: ``<arch>__<shape>__<mesh>``, then the
    profile where it is not "optimized" and the depth of a cut cell."""
    tag = f"{canonical(arch)}__{shape_name}__{mesh_name}"
    if profile != "optimized":
        tag += f"__{profile}"
    return tag + (f"__{layers}layers" if layers else "")


def run_cells(cells, meshes, out_dir: str, fail_fast: bool = False,
              profile: str = "optimized", layers=None):
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch, shape_name in cells:
        for mesh_name in meshes:
            tag = cell_tag(arch, shape_name, mesh_name, profile, layers)
            path = os.path.join(out_dir, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (artifact exists)")
                continue
            print(f"[trace] {tag} ...", flush=True)
            try:
                art = build_cell(arch, shape_name, mesh_name == "multi",
                                 profile, layers)
                with open(path, "w") as f:
                    json.dump(art, f, indent=1)
                mem = art["memory_analysis"]
                print(
                    f"[ok] {tag}: {art['trace_s']}s, "
                    f"params/dev={art['param_bytes_per_device']/2**30:.2f}GiB, "
                    f"peak/dev={mem['peak_bytes']/2**30:.2f}GiB, "
                    f"flops={art['hlo_flops']:.3e}, "
                    f"coll={art['total_collective_bytes']:.3e}B",
                    flush=True,
                )
                results.append((tag, "ok"))
            except Exception as e:  # noqa: BLE001 -- report and continue
                msg = str(e).strip().splitlines()
                print(f"[FAIL] {tag}: {type(e).__name__}: "
                      f"{msg[0] if msg else ''} at {_where(e)}", flush=True)
                traceback.print_exc()
                results.append((tag, f"FAIL {type(e).__name__} at "
                                     f"{_where(e)}"))
                if fail_fast:
                    raise
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--profile", default="optimized",
                    choices=list(PROFILES))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each cell to this many layers (a quick trace)")
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCHS for s in shapes_for(a)]
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        shapes = [args.shape] if args.shape else shapes_for(args.arch)
        cells = [(args.arch, s) for s in shapes]

    results = run_cells(cells, meshes, args.out, args.fail_fast,
                        args.profile, args.layers)
    print("\n== dry-run summary ==")
    for tag, status in results:
        print(f"{status:24s} {tag}")
    n_fail = sum(1 for _, s in results if s != "ok")
    print(f"{len(results) - n_fail}/{len(results)} cells OK")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
