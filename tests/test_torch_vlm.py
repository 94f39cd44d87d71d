"""The port's VLM family (llama-3.2-vision) against the JAX package, on the
CPU: llama-vision-smoke (one group of 4 self layers and 1 cross layer, d
64, 4 heads, 2 kv heads of 16, 12 media tokens) and its 2-group variant
(``n_layers=10``), so that every path is also run past the first group.

The reference's parameters are carried across with
``load_reference_params`` (the nested ``groups`` stack).  Its gates are
initialised to zero, which makes every cross layer the identity, so the
tests that hold the cross path draw ``gate_attn`` and ``gate_ffn`` from a
numpy seed (``uniform(0.3, 0.9)``, one a group) into the numpy tree before
it is loaded into both packages.  Media and tokens come from numpy seeds.
Tolerances: f32 ``atol = rtol = 1e-4`` (the two differ in the order of f32
sums); the bf16 caches ``rtol = 2**-7`` (``tests/test_torch_models.py``: a
value within 1e-6 of a rounding boundary may land on the neighbouring bf16
number).  llama-vision-smoke with the reference's own (zero) gates is
also in ``tests/test_torch_models.py``'s ``ARCHS`` and so in
``tests/test_torch_decode_graph.py``."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_nosync import NoSync
from test_torch_models import DecodeRounded, _np

import repro.launch.serve as ref_serve
from repro.configs import get_config as ref_config
from repro.models.common import get_family as ref_family
from repro.nn.param import count_params as ref_count
from repro.nn.param import init_params as ref_init
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as k5
from repro_torch.launch import serve as port_serve
from repro_torch.models import common, vlm
from repro_torch.models.common import get_family, load_reference_params
from repro_torch.nn import layers
from repro_torch.nn.param import count_params

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_CACHE_TOL = dict(atol=1e-4, rtol=2 ** -7)
ARCH = "llama32_vision_90b"
GROUPS = [1, 2]
B, S = 2, 16


def _cfgs(groups, dtype="float32"):
    """-> (reference config, port config): llama-vision-smoke with
    ``groups`` groups in ``dtype`` compute."""
    kw = dict(compute_dtype=dtype, n_layers=vlm.GROUP * groups)
    return (dataclasses.replace(ref_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def _tree(rc, gates=True):
    """The reference's parameters (``jax.random.key(0)``) as numpy, the
    gates drawn non-zero where ``gates``."""
    tree = jax.tree.map(np.asarray, ref_init(ref_family(rc).template(rc),
                                             jax.random.key(0)))
    if gates:
        G = rc.n_layers // vlm.GROUP
        rng = np.random.default_rng(G)
        for name in ("gate_attn", "gate_ffn"):
            tree["groups"]["cross"][name] = rng.uniform(
                0.3, 0.9, G).astype(np.float32)
    return tree


def _pair(groups, dtype="float32", gates=True):
    """-> (ref cfg, ref family, ref params, port cfg, port family, model)
    on one tree."""
    rc, pc = _cfgs(groups, dtype)
    tree = _tree(rc, gates)
    return (rc, ref_family(rc), jax.tree.map(jnp.asarray, tree), pc,
            get_family(pc), load_reference_params(vlm.build(pc), tree))


def _media(cfg, seed=11, batch=B):
    m = (np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_media_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return jnp.asarray(m), torch.as_tensor(m)


def _tokens(cfg, seed, n=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


def _close_caches(cache, rcache):
    assert set(cache) == set(rcache) == {"k", "v", "xk", "xv"}
    for name in cache:
        assert cache[name].dtype == torch.bfloat16
        assert cache[name].shape == tuple(rcache[name].shape), name
        np.testing.assert_allclose(_np(cache[name]), _np(rcache[name]),
                                   err_msg=name, **BF16_CACHE_TOL)


@pytest.mark.parametrize("groups", GROUPS)
def test_forward_equals_reference(groups):
    """The forward's logits == the reference's (f32), gates non-zero."""
    rc, rf, params, pc, pf, model = _pair(groups)
    rm, pm = _media(pc)
    toks = _tokens(pc, 1)
    want = rf.forward(params, rc, jnp.asarray(toks), media=rm)
    got = pf.forward(model, pc, torch.as_tensor(toks), media=pm)
    assert got.shape == (B, S, pc.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("groups", GROUPS)
def test_prefill_and_decode_equal_reference(groups):
    """The prefill's last logits and its four caches (k/v (G, 4, B, T, K,
    D), xk/xv (G, B, M, K, D)), then two decode steps' logits and the
    caches after them == the reference's (f32 compute, bf16 caches), gates
    non-zero.  The decode starts from the reference's prefill cache in
    both packages: a cache value the two prefills rounded to neighbouring
    bf16 numbers moves a later score by its ulp, which the reference's
    init (scores of hundreds of standard deviations) carries to the logits
    at about 1e-3."""
    rc, rf, params, pc, pf, model = _pair(groups)
    rm, pm = _media(pc)
    toks = _tokens(pc, 2)
    want, rcache = rf.prefill(params, rc, jnp.asarray(toks[:, :8]),
                              max_seq=S, media=rm)
    got, cache = pf.prefill(model, pc, torch.as_tensor(toks[:, :8]),
                            max_seq=S, media=pm)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    _close_caches(cache, rcache)
    assert cache["k"].shape == (groups, vlm.GROUP - 1, B, S, 2, 16)
    assert not cache["k"][:, :, :, 8:].any()
    cache = {name: torch.tensor(_np(c)).to(torch.bfloat16)
             for name, c in rcache.items()}
    for t in (8, 9):
        want, rcache = rf.decode_step(params, rc, rcache,
                                      jnp.asarray(toks[:, t:t + 1]), t)
        got, cache = pf.decode_step(model, pc, cache,
                                    torch.as_tensor(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"step {t}",
                                   **F32_TOL)
    _close_caches(cache, rcache)


@pytest.mark.parametrize("groups", GROUPS)
def test_media_reach_the_logits(groups):
    """With non-zero gates a change to the media moves the logits, in both
    packages alike (f32); with the reference's zero gates it does not."""
    rc, rf, params, pc, pf, model = _pair(groups)
    toks = torch.as_tensor(_tokens(pc, 3))
    _rm, pm = _media(pc)
    pm2 = pm.clone()
    pm2[:, -1] += 0.5
    a = pf.forward(model, pc, toks, media=pm)
    b = pf.forward(model, pc, toks, media=pm2)
    assert float((a - b).abs().max()) > 1e-3
    np.testing.assert_allclose(_np(b), _np(rf.forward(
        params, rc, jnp.asarray(toks.numpy()), media=jnp.asarray(
            pm2.numpy()))), **F32_TOL)
    _rc, _rf, _p, pc, pf, model = _pair(groups, gates=False)
    assert torch.equal(pf.forward(model, pc, toks, media=pm),
                       pf.forward(model, pc, toks, media=pm2))


@pytest.mark.parametrize("groups", GROUPS)
def test_encode_to_cache_in_the_media_type(groups):
    """``encode_to_cache`` projects f32 media in f32 and rounds them into
    the bf16 cache: bit for bit the reference's, in f32 and in bf16
    compute.  In bf16 compute the prefill projects the media rounded to
    bf16, so its ``xk``/``xv`` differ from ``encode_to_cache``'s, and they
    differ at exactly the elements where the reference's do."""
    for dtype in ("float32", "bfloat16"):
        rc, rf, params, pc, pf, model = _pair(groups, dtype)
        rm, pm = _media(pc)
        want = rf.encode_to_cache(params, rc, rm, rf.init_cache(rc, B, S))
        got = pf.encode_to_cache(model, pc, pm, pf.init_cache(pc, B, S))
        for name in ("xk", "xv"):
            assert np.array_equal(_np(got[name]), _np(want[name])), name
        if dtype == "float32":
            continue
        toks = _tokens(pc, 4, 8)
        _lg, rcache = rf.prefill(params, rc, jnp.asarray(toks), max_seq=S,
                                 media=rm)
        _lg, cache = pf.prefill(model, pc, torch.as_tensor(toks), max_seq=S,
                                media=pm)
        for name in ("xk", "xv"):
            ref_diff = _np(rcache[name]) != _np(want[name])
            port_diff = _np(cache[name]) != _np(got[name])
            assert ref_diff.any(), name
            np.testing.assert_array_equal(port_diff, ref_diff, err_msg=name)


@pytest.mark.parametrize("groups", GROUPS)
def test_encode_to_cache_then_decode_equals_reference(groups):
    """``encode_to_cache`` into a fresh cache and three decode steps ==
    the reference's (f32 compute): each step's logits and the self K/V
    written at the step's position."""
    rc, rf, params, pc, pf, model = _pair(groups)
    rm, pm = _media(pc)
    rcache = rf.encode_to_cache(params, rc, rm, rf.init_cache(rc, B, 8))
    cache = pf.encode_to_cache(model, pc, pm, pf.init_cache(pc, B, 8))
    toks = _tokens(pc, 5, 3)
    for t in range(3):
        want, rcache = rf.decode_step(params, rc, rcache,
                                      jnp.asarray(toks[:, t:t + 1]), t)
        got, cache = pf.decode_step(model, pc, cache,
                                    torch.as_tensor(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"step {t}",
                                   **F32_TOL)
    _close_caches(cache, rcache)


@pytest.mark.parametrize("groups", GROUPS)
def test_prefill_then_decode_consistent(groups):
    """The reference's own check on the port, default bf16 compute, gates
    non-zero: the prefill of the first half agrees with the forward over
    the whole sequence at the reference's 2e-2, and one decode step after
    it at 5e-2, the port's decode-vs-forward policy
    (``tests/test_torch_models.py``: the forward's attention keeps K5's f32
    probabilities)."""
    _rc, _rf, _p, cfg, fam, model = _pair(groups, "bfloat16")
    toks = torch.as_tensor(_tokens(cfg, 4), dtype=torch.int32)
    media = _media(cfg)[1]
    full = _np(fam.forward(model, cfg, toks, media=media))
    logits, cache = fam.prefill(model, cfg, toks[:, :8], max_seq=S,
                                media=media)
    np.testing.assert_allclose(_np(logits)[:, -1], full[:, 7], atol=2e-2)
    logits, cache = fam.decode_step(model, cfg, cache, toks[:, 8:9], 8)
    np.testing.assert_allclose(_np(logits)[:, 0], full[:, 8], atol=5e-2)


@pytest.mark.parametrize("groups", GROUPS)
def test_decode_matches_forward(groups):
    """Token-by-token decode from ``encode_to_cache`` agrees with the
    teacher-forcing forward (default bf16 compute, gates non-zero; the
    reference's ``tests/test_archs_smoke.py`` check) at its 2e-2, with the
    forward's attentions rounded as the decode's
    (``test_torch_models.DecodeRounded``): with K5's f32 probabilities the
    gap is 0.21 at one group and 0.42 at two, all of it those
    probabilities; rounded, 0.002 and 0.016, where the reference's own
    gaps are 0.002 and 0.013 (its forward's media K/V are projected from
    bf16 media, its decode's from f32 media, in both packages)."""
    _rc, _rf, _p, cfg, fam, model = _pair(groups, "bfloat16")
    toks = torch.as_tensor(_tokens(cfg, 3), dtype=torch.int32)
    media = _media(cfg)[1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "_k5", DecodeRounded)
        full = fam.forward(model, cfg, toks, media=media)
    cache = fam.encode_to_cache(model, cfg, media, fam.init_cache(cfg, B, S))
    outs = []
    for t in range(S):
        logits, cache = fam.decode_step(model, cfg, cache, toks[:, t:t + 1],
                                        t)
        outs.append(logits)
    np.testing.assert_allclose(_np(torch.cat(outs, dim=1)), _np(full),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("groups", GROUPS)
def test_prefill_attention_calls(groups):
    """The prefill's K5 calls, counted through the ``layers._k5`` seam as
    the card's smoke counts them by (causal, S, T, window): each self
    layer once causal at (S, S), each cross layer once non-causal at (S,
    M), no window; the decode calls none."""
    _rc, pc = _cfgs(groups, "bfloat16")
    model = common.init_model(vlm, pc, torch.Generator().manual_seed(0))
    calls = collections.Counter()

    class Counting:
        @staticmethod
        def flash_attention(q, k, v, causal=True, window=0):
            calls[causal, q.shape[1], k.shape[1], window] += 1
            return k5.flash_attention(q, k, v, causal=causal, window=window)

    toks = torch.as_tensor(_tokens(pc, 0, 9), dtype=torch.int32)
    M = pc.n_media_tokens
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "_k5", Counting)
        _lg, cache = vlm.prefill(model, pc, toks, max_seq=12,
                                 media=_media(pc)[1])
        assert calls == {(True, 9, 9, 0): (vlm.GROUP - 1) * groups,
                         (False, 9, M, 0): groups}
        calls.clear()
        vlm.decode_step(model, pc, cache, toks[:, :1], 9)
        assert not calls


def test_full_template_counts():
    """The full llama-3.2-vision-90b template counts as the reference's:
    87,666,799,656 parameters, a self layer 855,654,400, a cross layer
    855,654,658 (its two gates), the embeddings 2,101,354,496; the cut to
    2 of its 20 groups 10,657,899,012 (21.316 GB in bf16), built on the
    meta device with its nested stacks."""
    rc, pc = ref_config(ARCH), get_config(ARCH)
    n = count_params(vlm.template(pc))
    assert n == ref_count(ref_family(rc).template(rc)) == 87_666_799_656
    assert count_params(vlm.self_layer_template(pc)) == 855_654_400
    assert count_params(vlm.cross_layer_template(pc)) == 855_654_658
    assert count_params(vlm.template(pc)["embed"]) == 2_101_354_496
    cut = dataclasses.replace(pc, n_layers=10, param_dtype="bfloat16")
    model = vlm.build(cut, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 10_657_899_012
    assert count_params(vlm.template(cut)) == 10_657_899_012
    assert model.param_bytes() == 21_315_798_024
    assert len(model.groups) == 2 and len(model.groups[1].self) == 4
    assert model.stack_names == ("groups",)
    assert model.groups[0].node_names == ("cross",)
    assert model.groups[0].stack_names == ("self",)


def test_loader_fills_the_nested_stacks():
    """``load_reference_params`` fills ``groups[g].self[j]`` from the
    reference's ``[g, j]`` and ``groups[g].cross`` from ``[g]``, the gates
    as 0-d tensors, on the 2-group variant."""
    rc, pc = _cfgs(2)
    tree = _tree(rc)
    model = load_reference_params(vlm.build(pc), tree)
    for g in range(2):
        for j in range(vlm.GROUP - 1):
            np.testing.assert_array_equal(
                model.groups[g].self[j]["attn"]["wq"].numpy(),
                tree["groups"]["self"]["attn"]["wq"][g, j])
            np.testing.assert_array_equal(
                model.groups[g].self[j]["ffn"]["wo"].numpy(),
                tree["groups"]["self"]["ffn"]["wo"][g, j])
        np.testing.assert_array_equal(
            model.groups[g].cross["xattn"]["wk"].numpy(),
            tree["groups"]["cross"]["xattn"]["wk"][g])
        for name in ("gate_attn", "gate_ffn"):
            gate = model.groups[g].cross[name]
            assert gate.shape == () and float(gate) == float(
                tree["groups"]["cross"][name][g]) != 0
    assert not torch.equal(model.groups[0].self[0]["attn"]["wq"],
                           model.groups[0].self[1]["attn"]["wq"])


def test_loader_refuses_a_tree_of_another_layout():
    """A tree whose group lacks ``cross``, or with an LM's ``layers``, is
    refused; the full tree loads."""
    rc, pc = _cfgs(1)
    tree = _tree(rc, gates=False)
    model = vlm.build(pc)
    with pytest.raises(ValueError, match="cross"):
        load_reference_params(model, {**tree, "groups": {
            "self": tree["groups"]["self"]}})
    with pytest.raises(ValueError, match="layers"):
        load_reference_params(model, {**tree, "layers": tree["groups"]})
    load_reference_params(model, tree)


def test_init_model_takes_the_drawn_tensors_as_views():
    """``init_model`` builds the 2-group variant on the meta device and
    takes the drawn tensors as views: every parameter holds memory on the
    generator's device, a layer's weight shares the storage of the drawn
    (G, 4, ...) tensor, and the gates keep the reference's zeros."""
    _rc, pc = _cfgs(2)
    model = common.init_model(vlm, pc, torch.Generator().manual_seed(0))
    assert all(p.device.type == "cpu" for p in model.parameters())
    a = model.groups[0].self[0]["attn"]["wq"]
    b = model.groups[1].self[3]["attn"]["wq"]
    assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    assert not torch.equal(a, b)
    for g in range(2):
        assert model.groups[g].cross["gate_attn"].shape == ()
        assert float(model.groups[g].cross["gate_ffn"]) == 0.0


def test_serve_tokens_equal_reference(monkeypatch):
    """``serve(device="cpu")`` and the reference's ``serve()`` on the
    reference's weights with non-zero gates (2 groups, f32 compute, the
    stub frontend's media; whisper's serve shape in
    ``tests/test_torch_encdec.py``): the same greedy tokens, no kernel
    launched, no graph captured.  The caches are bf16 in both packages, so
    a prefill value rounded the other way moves later logits by about
    1e-3: at batch 3 the third row's ninth token is a near tie (the
    reference's top two logits 3e-5 apart) and the packages pick
    differently there (``test_prefill_and_decode_equal_reference`` holds
    the logits from one cache)."""
    rc, pc = _cfgs(2)
    tree = _tree(rc)
    monkeypatch.setattr(ref_serve, "get_config", lambda a, smoke: rc)
    monkeypatch.setattr(ref_serve, "init_params", lambda t, key, dtype=None:
                        jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(port_serve, "get_config", lambda a, smoke: pc)
    monkeypatch.setattr(port_serve, "init_model", lambda fam, cfg, gen:
                        load_reference_params(fam.build(cfg), tree))
    kw = dict(batch=2, prompt_len=12, gen=9, seed=3)
    want = ref_serve.serve("llama-3.2-vision-90b", **kw)
    got = port_serve.serve("llama-3.2-vision-90b", device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens"].shape == (2, 9)
    assert got["captures"] == 0
    assert not any(n for phase in got["launches"].values()
                   for n in phase.values())


def test_decode_step_writes_in_place_without_sync():
    """A decode step under ``NoSync(host_data=True)`` on the 2-group
    variant: it writes k/v only at ``[g, j, :, pos]``, leaves ``xk``/``xv``
    as they were, keeps the cache's storage, and equals the reference's
    step (f32)."""
    rc, rf, params, pc, pf, model = _pair(2)
    rm, pm = _media(pc)
    toks = _tokens(pc, 6, 9)
    _lg, rcache = rf.prefill(params, rc, jnp.asarray(toks[:, :8]),
                             max_seq=12, media=rm)
    _lg, cache = pf.prefill(model, pc, torch.as_tensor(toks[:, :8]),
                            max_seq=12, media=pm)
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    pos = torch.full((1,), 8, dtype=torch.int64)
    step = torch.as_tensor(toks[:, 8:9], dtype=torch.int32)
    with torch.no_grad(), NoSync(host_data=True):
        logits, out = pf.decode_step(model, pc, cache, step, pos)
    want, rcache = rf.decode_step(params, rc, rcache,
                                  jnp.asarray(toks[:, 8:9]), jnp.int32(8))
    assert out is cache and {k: v.data_ptr() for k, v in out.items()} == ptrs
    np.testing.assert_allclose(_np(logits), _np(want), **F32_TOL)
    for name in ("k", "v"):
        changed = cache[name] != before[name]
        assert changed.any(dim=(0, 1, 2, 4, 5)).nonzero().flatten() \
            .tolist() == [8], name
        assert changed[:, :, :, 8].any(dim=(2, 3, 4)).all(), name
        np.testing.assert_allclose(_np(cache[name]), _np(rcache[name]),
                                   err_msg=name, **BF16_CACHE_TOL)
    for name in ("xk", "xv"):
        assert torch.equal(cache[name], before[name]), name


def test_decode_step_takes_the_batch_from_xk():
    """``DecodeStep``'s buffers take the served batch from the cache's
    ``xk`` (axis 1 of ``k`` is a group's self layer, 4): a batch of 3
    steps with (3, 1) tokens."""
    _rc, pc = _cfgs(2)
    model = common.init_model(vlm, pc, torch.Generator().manual_seed(0))
    cache = vlm.init_cache(pc, 3, 12)
    assert common.cache_batch(vlm, cache) == 3
    ds = port_serve.DecodeStep(vlm, model, pc, cache, 4)
    assert ds.tok.shape == (3, 1) and ds.tokens.shape == (3, 4)
    with torch.no_grad():
        ds.start(torch.ones((3, 1), dtype=torch.int32), 0)
        assert ds.step().shape == (3, 1, pc.padded_vocab)


def test_vlm_resolves_and_serves_on_the_cli(capsys):
    """``get_family`` gives the port's vlm module, and the CLI serves the
    smoke config on the CPU."""
    assert get_family(get_config("llama-3.2-vision-90b")) is vlm
    assert get_family("vlm") is vlm
    r = port_serve.main(["--arch", "llama-3.2-vision-90b", "--smoke",
                         "--device", "cpu", "--batch", "2", "--prompt-len",
                         "12", "--gen", "4"])
    assert r["tokens"].shape == (2, 4)
    assert "sample row" in capsys.readouterr().out


def test_media_is_required():
    """The VLM forward and prefill refuse to run without media."""
    _rc, pc = _cfgs(1)
    model = common.init_model(vlm, pc, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="media"):
        vlm.forward(model, pc, toks)
    with pytest.raises(ValueError, match="media"):
        vlm.prefill(model, pc, toks)
