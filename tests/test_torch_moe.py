"""The port's MoE layer and the MoE LM (granite-moe-3b) against the JAX
package, on the CPU.

The reference's parameters (``init_params(..., jax.random.key(0))``) are
carried into the port with ``load_reference_params``; inputs come from a
numpy seed and go through both packages.

Tolerances.  In f32 compute (``dataclasses.replace(cfg,
compute_dtype="float32")``) the two packages differ only in the order of
f32 sums, as in ``tests/test_torch_models.py``: ``atol = rtol = 1e-4`` on
layer outputs and logits, and ``atol 1e-4, rtol 2**-7`` (two bf16 ulps) on
the K/V caches, which are bf16 in both.  The routing (each token's top-k
experts) and the number of (token, slot) pairs dropped past capacity are
integers and must be equal.  The decode-against-forward checks are the
reference's own (``tests/test_archs_smoke.py``), at its ``atol 2e-2`` in
bf16 compute.
"""
import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_config
from repro.models.common import get_family as ref_family
from repro.nn import layers as RL
from repro.nn.param import init_params as ref_init
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.common import (_fill, get_family,
                                        load_reference_params)
from repro_torch.nn import layers as L
from repro_torch.nn.param import Params

ARCH = "granite_moe_3b"
B, S = 2, 16
F32_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-4, rtol=2 ** -7)
REF_DECODE_ATOL = 2e-2          # tests/test_archs_smoke.py
IMPLS = ("grid_local", "grid", "ragged")


def _cfgs(**kw):
    """(reference, port) granite-smoke configs with ``kw`` replaced."""
    return (dataclasses.replace(ref_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def _layer(rc, pc):
    """The reference's MoE parameters and the port's, carried across."""
    tree = ref_init(RL.moe_template(rc), jax.random.key(0))
    params = Params(L.moe_template(pc))
    _fill(params, jax.tree.map(np.asarray, tree))
    return tree, params


def _x(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).normal(
        size=(*shape, cfg.d_model)).astype(np.float32)


def _ref_routing(tree, rc, x):
    """The reference's top-k experts (T, K) and its capacity drops, counted
    from its routing: an expert takes C pairs of a group (a batch row for
    ``grid_local``, all tokens for ``grid``) and drops the rest."""
    Bx, Sx, E = x.shape
    X, K = rc.n_experts, rc.experts_per_token
    dt = jnp.dtype(rc.compute_dtype)
    logits = jnp.einsum("te,ex->tx", jnp.asarray(x).astype(dt).reshape(-1, E),
                        tree["router"].astype(dt))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    top_i = np.asarray(jax.lax.top_k(probs, K)[1])
    if rc.moe_impl == "ragged":
        return top_i, 0
    groups, n = (1, Bx * Sx) if rc.moe_impl == "grid" else (Bx, Sx)
    C = max(1, min(math.ceil(n * K / X * rc.capacity_factor), n))
    counts = np.stack([np.bincount(g, minlength=X)
                       for g in top_i.reshape(groups, -1)])
    return top_i, int(np.maximum(counts - C, 0).sum())


def _moe_pair(impl, shared=0, cf=4.0, seed=0):
    """-> (reference out, port out, reference routing, port Routing)."""
    rc, pc = _cfgs(compute_dtype="float32", moe_impl=impl,
                   capacity_factor=cf, n_shared_experts=shared)
    tree, params = _layer(rc, pc)
    x = _x(pc, seed)
    want = np.asarray(RL.moe_apply(tree, rc, jnp.asarray(x.copy())))
    routing = []
    got = L.moe_apply(params, pc, torch.as_tensor(x), routing=routing)
    assert len(routing) == 1
    return want, got.numpy(), _ref_routing(tree, rc, x), routing[0]


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_apply_equals_reference(impl, shared):
    """Each dispatch form, with and without a shared expert, at the smoke
    config's capacity factor 4.0 (nothing dropped)."""
    want, got, (ref_experts, ref_dropped), routing = _moe_pair(impl, shared)
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_array_equal(routing.experts.numpy(), ref_experts)
    assert int(routing.dropped) == ref_dropped == 0


@pytest.mark.parametrize("cf", [0.5, 1.0])
@pytest.mark.parametrize("impl", ["grid_local", "grid"])
def test_capacity_drops_equal_reference(impl, cf):
    """Below capacity factor 1 pairs are dropped: the port drops as many as
    the reference's routing does (a non-zero count) and its output, where
    each dropped pair contributes nothing, equals the reference's."""
    want, got, (ref_experts, ref_dropped), routing = _moe_pair(impl, cf=cf)
    np.testing.assert_array_equal(routing.experts.numpy(), ref_experts)
    assert int(routing.dropped) == ref_dropped > 0
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_dropless_drops_nothing_at_any_capacity():
    """The dropless form ignores the capacity factor, as ``ragged_dot``
    does."""
    want, got, (_, ref_dropped), routing = _moe_pair("ragged", cf=0.5)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert int(routing.dropped) == ref_dropped == 0


def test_dropless_equals_grid_without_drops():
    """At a capacity nothing exceeds, the dropless form and both grids give
    the same bits: each pair's products are the same rows, summed over the
    slots in the same order."""
    _, pc = _cfgs(compute_dtype="float32", capacity_factor=8.0)
    _, params = _layer(*_cfgs(compute_dtype="float32"))
    x = torch.as_tensor(_x(pc, 5))
    outs = [L.moe_apply(params, dataclasses.replace(pc, moe_impl=impl), x)
            for impl in IMPLS]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)


class _OpCount(TorchDispatchMode):
    """Counts the operations that compute (views and reshapes excluded)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and func is not torch.ops.aten._unsafe_view.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_decode_ops_do_not_depend_on_experts_or_routing():
    """The decode's dropless form loops over nothing: the operations one
    call computes (each a kernel launch on the card, 19 of them) are the
    same for 8 and for 40 experts (granite's) and for any routing."""
    counts = set()
    for X, seed in ((8, 0), (8, 1), (40, 2)):
        _, pc = _cfgs(n_experts=X)
        params = Params(L.moe_template(pc))
        for p in params.parameters():
            p.data.normal_(generator=torch.Generator().manual_seed(seed))
        x = torch.as_tensor(_x(pc, seed, (4, 1))).to(pc.cdtype())
        L.moe_apply(params, pc, x, dropless=True)        # casts made once
        with _OpCount() as ops:
            L.moe_apply(params, pc, x, dropless=True)
        counts.add(ops.n)
    assert len(counts) == 1, counts
    assert counts.pop() <= 20


def _model_pair(dtype="float32", **kw):
    rc, pc = _cfgs(compute_dtype=dtype, **kw)
    params = ref_init(ref_family(rc).template(rc), jax.random.key(0))
    model = load_reference_params(get_family(pc).build(pc),
                                  jax.tree.map(np.asarray, params))
    return rc, params, pc, model


def _np(x):
    if torch.is_tensor(x):      # a copy: the port's decode updates in place
        return x.float().numpy().copy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("impl", ["grid_local", "grid"])
def test_model_with_drops_equals_reference(impl):
    """granite-smoke at capacity factor 0.5, so every prefill layer drops
    pairs: forward, prefill (logits and the whole cache) and two decode
    steps (dropless) equal the reference's in f32 compute, and the layers'
    routing drops pairs."""
    rc, params, pc, model = _model_pair(moe_impl=impl, capacity_factor=0.5)
    rf = ref_family(rc)
    toks = np.random.default_rng(1).integers(
        0, pc.vocab_size, (B, S)).astype(np.int32)
    half = S // 2
    ref, port = {}, {}
    ref["forward"] = _np(rf.forward(params, rc, jnp.asarray(toks)))
    routing = []
    port["forward"] = _np(lm.forward(model, pc, torch.as_tensor(toks),
                                     routing=routing))
    assert len(routing) == pc.n_layers
    assert all(int(r.dropped) > 0 for r in routing)
    lg, cache = rf.prefill(params, rc, jnp.asarray(toks[:, :half]), max_seq=S)
    plg, pcache = lm.prefill(model, pc, torch.as_tensor(toks[:, :half]),
                             max_seq=S)
    ref["prefill"], port["prefill"] = _np(lg), _np(plg)
    for t in (half, half + 1):
        lg, cache = rf.decode_step(params, rc, cache,
                                   jnp.asarray(toks[:, t:t + 1]), t)
        plg, pcache = lm.decode_step(model, pc, pcache,
                                     torch.as_tensor(toks[:, t:t + 1]), t)
        ref[f"decode{t}"], port[f"decode{t}"] = _np(lg), _np(plg)
    for name in ref:
        np.testing.assert_allclose(port[name], ref[name], err_msg=name,
                                   **F32_TOL)
    for name in cache:
        np.testing.assert_allclose(_np(pcache[name]), _np(cache[name]),
                                   err_msg=name, **CACHE_TOL)


def _decode_rounded_attention(cfg, q, k, v, is_global):
    """The forward's attention as the decode computes it (probabilities
    rounded to the compute type before the PV product), where K5 keeps
    them in f32: the reference's forward and decode round alike."""
    pos = torch.arange(q.shape[1])[None]
    mask = L.causal_window_mask(pos, pos, cfg.window, is_global)
    return L._gqa_scores_softmax_out(cfg, q, k, v, mask[:, None, None])


def _tokens(cfg, seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))


def test_decode_matches_forward():
    """The reference's check (``tests/test_archs_smoke.py``
    ``test_decode_matches_forward``) on the port: at the smoke config's
    capacity factor 4.0 nothing is dropped, so the token-by-token decode
    (dropless) agrees with the teacher-forcing forward (the capacity grid)
    within the reference's 2e-2, bf16 compute, with the forward's attention
    rounded as the decode's."""
    _, _, cfg, model = _model_pair("bfloat16")
    toks = _tokens(cfg, 3)
    with mock.patch.object(L, "attention_core", _decode_rounded_attention):
        full = lm.forward(model, cfg, toks)
    cache = lm.init_cache(cfg, B, S)
    outs = []
    for t in range(S):
        logits, cache = lm.decode_step(model, cfg, cache, toks[:, t:t + 1], t)
        outs.append(logits)
    np.testing.assert_allclose(_np(torch.cat(outs, dim=1)), _np(full),
                               rtol=0, atol=REF_DECODE_ATOL)


def test_prefill_then_decode_consistent():
    """The reference's ``test_prefill_then_decode_consistent`` on the port:
    prefill(S/2) then one decode step agree with the forward over the whole
    sequence, within its 2e-2 (bf16 compute; the attention rounded as the
    decode's)."""
    _, _, cfg, model = _model_pair("bfloat16")
    toks = _tokens(cfg, 4)
    half = S // 2
    with mock.patch.object(L, "attention_core", _decode_rounded_attention):
        full = _np(lm.forward(model, cfg, toks))
        logits_p, cache = lm.prefill(model, cfg, toks[:, :half], max_seq=S)
    np.testing.assert_allclose(_np(logits_p[:, -1]), full[:, half - 1],
                               atol=REF_DECODE_ATOL)
    logits, cache = lm.decode_step(model, cfg, cache,
                                   toks[:, half:half + 1], half)
    np.testing.assert_allclose(_np(logits[:, 0]), full[:, half],
                               atol=REF_DECODE_ATOL)


def test_get_family_takes_moe_and_mla():
    """The MoE LMs resolve to the port's ``lm``, deepseek-v2 (MLA attention
    and MoE) too, and its template's attention is MLA's; deepseek-smoke
    serves on the CPU."""
    import repro_torch.launch.serve as port_serve

    assert get_family(get_config("granite_moe_3b")) is lm
    assert get_family(get_config("granite_moe_3b", smoke=True)) is lm
    for smoke in (False, True):
        cfg = get_config("deepseek_v2_236b", smoke=smoke)
        assert get_family(cfg) is lm
        assert set(lm.layer_template(cfg)["attn"]) == set(
            L.mla_template(cfg))
    out = port_serve.serve("deepseek_v2_236b", device="cpu", batch=2,
                           prompt_len=8, gen=3)
    assert out["tokens"].shape == (2, 3) and out["drop_share"] == 0.0


def test_full_granite_fits_the_card():
    """granite-moe-3b-a800m at full width and depth: about 3.30 B
    parameters, 13.2 GB in its f32 parameter type, under PERF.md's 40 GB
    limit; its grid-local capacity at a 2048-token prompt is 512."""
    from repro_torch.nn.param import count_params

    cfg = get_config("granite_moe_3b")
    n = count_params(lm.template(cfg))
    assert 3.2e9 < n < 3.4e9
    assert n * 4 < 40e9
    assert cfg.moe_impl == "grid_local"
    assert L._capacity(2048, cfg) == 512


@pytest.mark.parametrize("cf,dropping", [(4.0, False), (0.5, True)])
def test_serve_reports_drop_share(cf, dropping, monkeypatch):
    """``serve`` returns the prefill's capacity-drop share: the dropped
    (token, slot) pairs of every layer over L·B·S·K, counted again here
    from a prefill's routing on the same weights and prompts."""
    import repro_torch.launch.serve as port_serve

    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              moe_impl="grid_local", capacity_factor=cf)
    monkeypatch.setattr(port_serve, "get_config", lambda a, smoke: cfg)
    kw = dict(batch=2, prompt_len=12, gen=3, seed=4)
    got = port_serve.serve(ARCH, device="cpu", **kw)
    model = port_serve.init_model(lm, cfg, torch.Generator().manual_seed(0))
    prompts = torch.as_tensor(np.random.default_rng(4).integers(
        2, cfg.vocab_size, size=(2, 12)), dtype=torch.int32)
    routing = []
    with torch.no_grad():
        lm.prefill(model, cfg, prompts, max_seq=15, routing=routing)
    dropped = sum(int(r.dropped) for r in routing)
    assert got["drop_share"] == dropped / (cfg.n_layers * 2 * 12 * 2)
    assert (dropped > 0) == dropping



def test_forced_experts_give_the_same_bits():
    """``layers._top_k`` is the seam through which the card smoke forces a
    prefill's experts to another run's: forced to a run's own choices (the
    values read back from the probabilities), the prefill gives that run's
    bits and drops, layer by layer."""
    _, _, cfg, model = _model_pair("bfloat16", moe_impl="grid_local",
                                   capacity_factor=0.5)
    toks = _tokens(cfg, 6)
    own = []
    logits, cache = lm.prefill(model, cfg, toks, max_seq=S, routing=own)
    experts = iter([r.experts for r in own])

    def forced(probs, k):
        top_i = next(experts)
        return probs.gather(1, top_i), top_i

    routing = []
    with mock.patch.object(L, "_top_k", forced):
        logits_f, cache_f = lm.prefill(model, cfg, toks, max_seq=S,
                                       routing=routing)
    assert torch.equal(logits, logits_f)
    for name in cache:
        assert torch.equal(cache[name], cache_f[name])
    drops = [int(r.dropped) for r in own]
    assert drops == [int(r.dropped) for r in routing] and min(drops) > 0


#: (arch, moe_impl, dropless): granite's batch-local grid, deepseek-v2's
#: global grid (with its shared expert), and the dropless decode of each
CONSTRAIN_CASES = [("granite_moe_3b", "grid_local", False),
                   ("deepseek_v2_236b", "grid", False),
                   ("granite_moe_3b", "grid_local", True),
                   ("deepseek_v2_236b", "grid", True)]


@pytest.mark.parametrize("arch,impl,dropless", CONSTRAIN_CASES)
def test_moe_constraints_are_the_references(arch, impl, dropless):
    """Every ``constrain`` of one MoE layer, as (logical axes, shape), in
    both packages, call for call: the batch-local grid (B, X, C, E) and its
    hidden activations under ("batch", "experts", None, None), the global
    grid (X, C, E) under ("experts", "moe_cap", None), a shared expert's,
    the output's.  The reference's module attribute is patched in this
    test; no file of it changes."""
    rc = dataclasses.replace(ref_config(arch, smoke=True),
                             compute_dtype="float32", moe_impl=impl)
    pc = dataclasses.replace(get_config(arch, smoke=True),
                             compute_dtype="float32", moe_impl=impl)
    tree, params = _layer(rc, pc)
    x = _x(pc, 7)
    calls = {"ref": [], "port": []}

    def recorder(name, fn):
        def rec(t, axes, *a, **kw):
            calls[name].append((tuple(axes), tuple(t.shape)))
            return fn(t, axes, *a, **kw)
        return rec

    with mock.patch.object(RL, "constrain", recorder("ref", RL.constrain)):
        RL.moe_apply(tree, rc, jnp.asarray(x), dropless=dropless)
    with mock.patch.object(L, "constrain", recorder("port", L.constrain)):
        L.moe_apply(params, pc, torch.as_tensor(x), dropless=dropless)
    assert calls["port"] == calls["ref"]
    X, K = pc.n_experts, pc.experts_per_token
    grids = [c for c in calls["port"] if c[0][0] != "batch" or
             c[0][1] == "experts"]
    if dropless:
        assert grids == []
    elif impl == "grid":
        C = L._capacity(B * S, pc)
        assert grids == [(("experts", "moe_cap", None), (X, C, pc.d_model)),
                         (("experts", "moe_cap", None), (X, C, pc.d_ff))]
    else:
        C = L._capacity(S, pc)
        axes = ("batch", "experts", None, None)
        assert grids == [(axes, (B, X, C, pc.d_model)),
                         (axes, (B, X, C, pc.d_ff))]
