"""The port's sharding rules against the reference's, entry for entry: every
template leaf of every architecture (full and smoke configs) and every
model input (train batch, prefill, decode cache and tokens), on the
single-pod (16, 16), the multi-pod (2, 16, 16) and the (1, 1) smoke
meshes.  The resolution is pure shape logic on both sides, so the meshes
are abstract (the reference's ``make_abstract_mesh``, the port's); the
reference's ``PartitionSpec`` and the port's are compared as tuples.
Then the annotations' overrides and switches, the placements seam and the
meshes' refusals."""
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.distributed import sharding as ref_sh
from repro.distributed import strategy as ref_strategy
from repro.launch import inputs as ref_inputs
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.models.common import get_family as ref_family
from repro.nn import param as ref_pm
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, shapes_for
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import strategy
from repro_torch.launch import inputs
from repro_torch.launch import mesh as M
from repro_torch.models.common import get_family
from repro_torch.nn import param as pm

MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
    "smoke": ((1, 1), ("data", "model")),
}
CASES = [(arch, smoke, mesh) for arch in ARCHS for smoke in (False, True)
         for mesh in MESHES]


def _meshes(name):
    shape, axes = MESHES[name]
    return M.make_abstract_mesh(shape, axes), ref_abstract_mesh(shape, axes)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _dtype_name(dt):
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def test_archs_are_the_references():
    assert tuple(ARCHS) == tuple(REF_ARCHS)


@pytest.mark.parametrize("arch,smoke,mesh", CASES)
def test_template_specs_match_reference(arch, smoke, mesh):
    """Every template leaf resolves to the reference's spec under the
    architecture's rules (``strategy.rules_for``)."""
    cfg, rcfg = get_config(arch, smoke=smoke), ref_get_config(arch, smoke)
    m, rm = _meshes(mesh)
    rules, rrules = strategy.rules_for(cfg), ref_strategy.rules_for(rcfg)
    assert rules.rules == rrules.rules
    port = _flat(rules.param_sharding(get_family(cfg).template(cfg), m))
    ref = _flat(ref_pm.tree_map_specs(
        lambda p: rrules.pspec(p.axes, p.shape, rm),
        ref_family(rcfg).template(rcfg)))
    assert [path for path, _ in port] == [path for path, _ in ref]
    for (path, got), (_, want) in zip(port, ref):
        assert isinstance(got.spec, sh.PartitionSpec)
        assert tuple(got.spec) == tuple(want), path
    # the same through param_pspecs inside the rules' context
    with sh.use_mesh_rules(m, rules):
        specs = _flat(rules.param_pspecs(get_family(cfg).template(cfg)))
    assert [tuple(s) for _, s in specs] == [tuple(s) for _, s in ref]


def _input_specs(fn, rfn, cfg, rcfg, shape_name, m, rm, rules, rrules):
    got = _flat(fn(cfg, SHAPES[shape_name], m, rules))
    want = _flat(rfn(rcfg, REF_SHAPES[shape_name], rm, rrules))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape), (shape_name, path)
        assert _dtype_name(g.dtype) == _dtype_name(w.dtype), (shape_name,
                                                              path)
        assert tuple(g.spec) == tuple(w.sharding.spec), (shape_name, path)
    return len(got)


@pytest.mark.parametrize("arch,smoke,mesh", CASES)
def test_input_specs_match_reference(arch, smoke, mesh):
    """``batch_specs``, ``prefill_specs``, ``cache_specs`` and
    ``decode_specs`` at each of the architecture's shapes: the same shapes,
    types and specs as the reference's ShapeDtypeStructs."""
    cfg, rcfg = get_config(arch, smoke=smoke), ref_get_config(arch, smoke)
    m, rm = _meshes(mesh)
    rules, rrules = strategy.rules_for(cfg), ref_strategy.rules_for(rcfg)
    n = 0
    for shape_name in shapes_for(arch):
        for fn, rfn in ((inputs.batch_specs, ref_inputs.batch_specs),
                        (inputs.prefill_specs, ref_inputs.prefill_specs),
                        (inputs.cache_specs, ref_inputs.cache_specs),
                        (inputs.decode_specs, ref_inputs.decode_specs)):
            n += _input_specs(fn, rfn, cfg, rcfg, shape_name, m, rm, rules,
                              rrules)
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logical_axes_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert (get_family(cfg).cache_logical_axes(cfg)
            == ref_family(rcfg).cache_logical_axes(rcfg))


# ---------------------------------------------------------------------------
# the reference's own rule tests (tests/test_substrate.py), on the port
# ---------------------------------------------------------------------------

def test_rules_divisibility_fallback():
    rules = sh.make_rules()
    big = M.make_abstract_mesh((16, 16), ("data", "model"))
    assert rules.pspec(("heads", None), (12, 128), big) == sh.P(None, None)
    assert rules.pspec(("heads", None), (32, 128), big) == sh.P("model", None)
    assert rules.pspec(("batch", "seq"), (256, 4096), big) == sh.P("data",
                                                                   None)


def test_rules_no_duplicate_axes():
    rules = sh.make_rules()
    m = M.make_abstract_mesh((1, 1), ("data", "model"))
    spec = rules.pspec(("batch", "cache_seq", "kv_heads", None),
                       (128, 32768, 8, 128), m)
    flat = [a for s in spec if s for a in ((s,) if isinstance(s, str) else s)]
    assert len(flat) == len(set(flat))


# ---------------------------------------------------------------------------
# overrides, switches and the placements seam
# ---------------------------------------------------------------------------

class _Shaped:
    """Stands in for a tensor: ``constrain`` reads only its shape."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("case", ["constrain_override", "gather_embed",
                                  "gather_vocab", "gather_switched_off"])
def test_annotation_overrides_match_reference(case, monkeypatch):
    """``constrain``'s per-call override, ``weight_gather``'s override of
    "embed" (and "vocab" with it) and its ``_weight_gather`` switch resolve
    to the specs the reference's hand its sharding constraint."""
    import jax

    m, rm = _meshes("pod")
    x = _Shaped((256, 4096))
    if case == "constrain_override":
        axes, over = ("batch", "mlp"), {}
        fn = lambda t, a: sh.constrain(t, a, override={"batch": None})
        rfn = lambda t, a: ref_sh.constrain(t, a, override={"batch": None})
    else:
        axes = ("vocab", "embed") if case == "gather_vocab" else ("embed",
                                                                  "mlp")
        over = {"_weight_gather": False} if case == "gather_switched_off" \
            else {}
        fn, rfn = sh.weight_gather, ref_sh.weight_gather
    seen, want = [], []
    resolve = sh.ShardingRules.pspec

    def spy(self, a, shape, mesh):
        spec = resolve(self, a, shape, mesh)
        seen.append(tuple(spec))
        return spec
    monkeypatch.setattr(sh.ShardingRules, "pspec", spy)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda t, s: want.append(tuple(s.spec)) or t)
    with sh.use_mesh_rules(m, sh.make_rules(**over)):
        assert fn(x, axes) is x
    with ref_sh.use_mesh_rules(rm, ref_sh.make_rules(**over)):
        assert rfn(x, axes) is x
    assert seen == want
    assert seen == {"constrain_override": [(None, "model")],
                    "gather_embed": [(None, "model")],
                    "gather_vocab": [(None, None)],
                    "gather_switched_off": []}[case]


def test_annotations_outside_a_mesh_are_the_identity():
    t = torch.ones(3)
    assert sh.constrain(t, ("batch",)) is t
    assert sh.weight_gather(t, ("embed",)) is t
    assert sh.active_rules() is None and sh.active_mesh() is None
    assert not sh.is_distributed(t)
    f = lambda: 1                                          # noqa: E731
    assert sh.bind_rules(f) is f


class _FakeMesh:
    """Stands in for a ``DeviceMesh``: its axis names (all the seam reads)."""

    def __init__(self, names):
        self.mesh_dim_names = names


@pytest.mark.parametrize("spec,names,want", [
    (("data", None), ("data", "model"), ("S0", "R")),
    ((None, "model"), ("data", "model"), ("R", "S1")),
    ((("pod", "data"), "model"), ("pod", "data", "model"),
     ("S0", "S0", "S1")),
    ((("data", "model"), None), ("data", "model"), ("S0", "S0")),
    ((None, None), ("data", "model"), ("R", "R")),
])
def test_placements_shard_each_mesh_dim_major_first(spec, names, want):
    pl = sh.placements(spec, _FakeMesh(names))
    got = tuple("R" if isinstance(p, sh.Replicate) else f"S{p.dim}"
                for p in pl)
    assert got == want


@pytest.mark.parametrize("spec", [(("model", "data"), None),
                                  ("data", "data"), ("gpu", None)])
def test_placements_refuse_what_they_cannot_place(spec):
    """An entry whose axes are out of mesh order is refused, not reordered;
    so is a mesh axis on two dims and an axis the mesh lacks."""
    with pytest.raises(ValueError):
        sh.placements(spec, _FakeMesh(("data", "model")))


def test_meshes_raise_without_a_process_group():
    """No fallback: a device mesh needs a running group of the right size."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    for make in (M.make_smoke_mesh, M.make_production_mesh,
                 lambda device="cpu": M.make_production_mesh(
                     multi_pod=True, device=device)):
        with pytest.raises(RuntimeError, match="process group"):
            make(device="cpu")
    am = M.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert am.shape == {"pod": 2, "data": 16, "model": 16}
    assert sh.axis_sizes(am) == am.shape


def test_production_mesh_refuses_a_world_of_other_size(tmp_path):
    """A one-rank group cannot hold the 256- or 512-rank production mesh;
    the one-rank smoke mesh it can."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for multi in (False, True):
            with pytest.raises(ValueError, match="ranks"):
                M.make_production_mesh(multi_pod=multi, device="cpu")
        m = M.make_smoke_mesh("cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert sh.axis_sizes(m) == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("H,Hk,n,want", [
    (12, 2, 1, [(0, 2)]),
    (12, 2, 2, [(0, 1), (1, 2)]),
    (12, 2, 4, [(0, 1), (0, 1), (1, 2), (1, 2)]),
    (12, 2, 12, [(i // 6, i // 6 + 1) for i in range(12)]),
    (4, 1, 2, [(0, 1), (0, 1)]),
    (8, 8, 4, [(0, 2), (2, 4), (4, 6), (6, 8)]),
])
def test_gqa_kv_block_keeps_the_global_ratio(H, Hk, n, want):
    """Each q head block reads the KV heads its heads map to under g = H /
    Hk, also where a block holds fewer heads than a group."""
    from repro_torch.nn.layers import _kv_block
    got = [_kv_block(H, Hk, i, n) for i in range(n)]
    assert got == want
    g = H // Hk
    for i, (a, b) in enumerate(got):
        heads = range(i * H // n, (i + 1) * H // n)
        assert {h // g for h in heads} == set(range(a, b))


@pytest.mark.parametrize("H,Hk,n", [(12, 2, 3), (12, 3, 2)])
def test_gqa_kv_block_refuses_a_split_that_breaks_the_ratio(H, Hk, n):
    """A block of 4 q heads against groups of 6 (or 6 against 4) would
    straddle a group unevenly."""
    from repro_torch.nn.layers import _kv_block
    with pytest.raises(ValueError, match="GQA"):
        _kv_block(H, Hk, 0, n)


def test_params_keep_each_leafs_logical_axes():
    """``Params`` keeps each leaf's logical axes for ``distribute``; a
    model built without a mesh holds plain tensors."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    fam = get_family(cfg)
    model = fam.build(cfg)
    node = model.layers[0].attn
    assert node._axes["wq"] == ("embed", "heads", None)
    assert model.embed._axes["tok"] == ("vocab", "embed")
    leaves = [p for p in model.parameters()]
    assert all(not hasattr(p, "placements") for p in leaves)
    assert pm.count_params(fam.template(cfg)) == sum(p.numel() for p in leaves)
