"""The port's MLA attention (deepseek-v2's multi-head latent attention)
against the JAX package, on the CPU.

The reference's parameters (``init_params(..., jax.random.key(0))``) are
carried into the port with ``load_reference_params`` or ``_fill``; inputs
come from a numpy seed and go through both packages.  On the CPU the port's
prefill attention runs K5's plain version.

Both query paths are held: deepseek-smoke's q LoRA (``q_lora_rank`` 32) and
the direct ``wq`` (``q_lora_rank=0``).  Each is held against both branches
of the reference's ``mla_apply``: its dense scores, and its chunked online
softmax, forced at the test's 16 tokens with a small
``attention_chunk_min_t`` and ``attention_kblock``.  The port has one path
for both (K5).

Tolerances.  In f32 compute the port takes one (dn + dr)-wide product for
the scores where the reference sums two, so the two differ only in the
order of f32 sums: ``atol = rtol = 1e-4`` on layer outputs and logits
(``tests/test_torch_models.py``'s), and two bf16 ulps (``rtol = 2**-7``,
``atol 1e-4``) on the compressed caches, which are bf16 in both.  The
absorbed decode against the forward is the reference's own check
(``tests/test_attention_impls.py``, f32, 2e-5).  The model-level checks of
deepseek-smoke itself (forward, prefill and its caches, decode steps, the
decode against the forward in bf16 at the reference's 6e-2, the serve's
tokens, a step without a host sync) run with the other architectures in
``tests/test_torch_models.py`` and ``tests/test_torch_decode_graph.py``;
here they run again on the ``wq`` path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_nosync import NoSync

import repro.launch.serve as ref_serve
import repro_torch.launch.serve as port_serve
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

ARCH = "deepseek_v2_236b"
B, S = 2, 16
F32_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-4, rtol=2 ** -7)
QPATHS = {"q_lora": {}, "wq": {"q_lora_rank": 0}}
# the reference's chunked branch at 16 tokens: key blocks of 4, engaged
# from 8 tokens
BRANCHES = {"dense": {},
            "chunked": {"attention_chunk_min_t": 8, "attention_kblock": 4}}


def _cfgs(dtype="float32", **kw):
    """(reference, port) deepseek-smoke configs with ``kw`` replaced."""
    kw = dict(compute_dtype=dtype, **kw)
    return (dataclasses.replace(ref_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def _layer(rc, pc, seed=0):
    """The reference's MLA parameters and the port's, carried across."""
    tree = ref_init(RL.mla_template(rc), jax.random.key(seed))
    params = Params(L.mla_template(pc))
    _fill(params, jax.tree.map(np.asarray, tree))
    return tree, params


def _x(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).normal(
        size=(*shape, cfg.d_model)).astype(np.float32)


def _np(x):
    if torch.is_tensor(x):      # a copy: the port's decode updates in place
        return x.float().numpy().copy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _positions(n, start=0):
    return np.broadcast_to(np.arange(start, start + n, dtype=np.int32),
                           (B, n))


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("qpath", QPATHS)
def test_mla_apply_equals_reference(qpath, branch):
    """The full-sequence layer, f32 compute: the port (K5's plain version
    on the CPU) against the reference's dense or chunked branch."""
    rc, pc = _cfgs(**QPATHS[qpath], **BRANCHES[branch])
    tree, params = _layer(rc, pc)
    x, pos = _x(pc, 1), _positions(S)
    want = RL.mla_apply(tree, rc, jnp.asarray(x.copy()), jnp.asarray(pos))
    got = L.mla_apply(params, pc, torch.as_tensor(x),
                      torch.as_tensor(pos.copy()))
    assert got.shape == (B, S, pc.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)


@pytest.mark.parametrize("qpath", QPATHS)
def test_mla_prefill_rows_are_the_reference_cache_rows(qpath):
    """``mla_prefill``'s c_kv and k_rope, the rows the port's prefill
    caches, equal what the reference's prefill computes a second time for
    its cache (f32 compute, before the cache's bf16)."""
    rc, pc = _cfgs(**QPATHS[qpath])
    tree, params = _layer(rc, pc)
    x, pos = _x(pc, 2), _positions(S)
    h = jnp.asarray(x.copy())
    ckv = jnp.einsum("bse,er->bsr", h, tree["wkv_a"])
    kr = rc.kv_lora_rank
    c_kv = RL.rmsnorm(tree["kv_norm"], ckv[..., :kr], rc.norm_eps)
    k_rope = RL.rope(ckv[..., kr:][:, :, None, :], jnp.asarray(pos),
                     rc.rope_theta)[:, :, 0, :]
    out, got_ckv, got_krope = L.mla_prefill(params, pc, torch.as_tensor(x),
                                            torch.as_tensor(pos.copy()))
    np.testing.assert_allclose(got_ckv.numpy(), _np(c_kv), **F32_TOL)
    np.testing.assert_allclose(got_krope.numpy(), _np(k_rope), **F32_TOL)
    np.testing.assert_allclose(
        out.numpy(), L.mla_apply(params, pc, torch.as_tensor(x),
                                 torch.as_tensor(pos.copy())).numpy(),
        rtol=0, atol=0)


@pytest.mark.parametrize("pos", [0, 5, 15])
@pytest.mark.parametrize("qpath", QPATHS)
def test_mla_decode_equals_reference(qpath, pos):
    """One decode step at ``pos`` against bf16 caches of random rows, f32
    compute: the output and both caches equal the reference's, and the
    port writes row ``pos`` alone, in place."""
    rc, pc = _cfgs(**QPATHS[qpath])
    tree, params = _layer(rc, pc)
    rng = np.random.default_rng(pos)
    x = _x(pc, 10 + pos, (B, 1))
    ckv = rng.normal(size=(B, S, pc.kv_lora_rank)).astype(np.float32)
    krope = rng.normal(size=(B, S, pc.qk_rope_dim)).astype(np.float32)
    ckv_t = torch.as_tensor(ckv).to(torch.bfloat16)
    krope_t = torch.as_tensor(krope).to(torch.bfloat16)
    before = (ckv_t.clone(), krope_t.clone())
    want, want_ckv, want_krope = RL.mla_decode(
        tree, rc, jnp.asarray(x.copy()), jnp.asarray(ckv, jnp.bfloat16),
        jnp.asarray(krope, jnp.bfloat16), jnp.int32(pos))
    got, got_ckv, got_krope = L.mla_decode(
        params, pc, torch.as_tensor(x), ckv_t, krope_t,
        torch.full((1,), pos, dtype=torch.int64))
    assert got_ckv is ckv_t and got_krope is krope_t          # in place
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)
    for name, g, w, old in (("ckv", got_ckv, want_ckv, before[0]),
                            ("krope", got_krope, want_krope, before[1])):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **CACHE_TOL)
        others = torch.arange(S) != pos
        assert torch.equal(g[:, others], old[:, others]), name
        assert not torch.equal(g[:, pos], old[:, pos]), name


def _model_pair(qpath, dtype="float32"):
    rc, pc = _cfgs(dtype, **QPATHS[qpath])
    tree = ref_init(ref_family(rc).template(rc), jax.random.key(0))
    model = load_reference_params(get_family(pc).build(pc),
                                  jax.tree.map(np.asarray, tree))
    return rc, tree, pc, model


@pytest.mark.parametrize("qpath", QPATHS)
def test_absorbed_decode_equals_forward_in_f32(qpath):
    """The reference's ``test_mla_decode_exact_in_f32`` on the port: token
    by token, the absorbed-query decode over an f32 compressed cache equals
    the full-rank forward (K5's plain version) within 2e-5."""
    _rc, _tree, pc, model = _model_pair(qpath)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, pc.vocab_size, (B, 12)).astype(np.int32))
    with torch.no_grad():
        full = lm.forward(model, pc, toks)
        cache = lm.init_cache(pc, B, 12, dtype=torch.float32)
        outs = []
        for t in range(12):
            logits, cache = lm.decode_step(model, pc, cache,
                                           toks[:, t:t + 1], t)
            outs.append(logits)
    np.testing.assert_allclose(_np(torch.cat(outs, dim=1)), _np(full),
                               rtol=0, atol=2e-5)


def test_wq_model_equals_reference():
    """deepseek-smoke with ``q_lora_rank=0`` in f32 compute: forward,
    prefill (logits, ``ckv``, ``krope``) and two decode steps equal the
    reference's."""
    rc, tree, pc, model = _model_pair("wq")
    rf = ref_family(rc)
    toks = np.random.default_rng(1).integers(
        0, pc.vocab_size, (B, S)).astype(np.int32)
    half = S // 2
    ref, port = {}, {}
    ref["forward"] = _np(rf.forward(tree, rc, jnp.asarray(toks)))
    port["forward"] = _np(lm.forward(model, pc, torch.as_tensor(toks)))
    lg, cache = rf.prefill(tree, rc, jnp.asarray(toks[:, :half]), max_seq=S)
    plg, pcache = lm.prefill(model, pc, torch.as_tensor(toks[:, :half]),
                             max_seq=S)
    ref["prefill"], port["prefill"] = _np(lg), _np(plg)
    assert set(pcache) == set(cache) == {"ckv", "krope"}
    for name in cache:
        assert pcache[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(pcache[name]), _np(cache[name]),
                                   err_msg=f"prefill {name}", **CACHE_TOL)
    for t in (half, half + 1):
        lg, cache = rf.decode_step(tree, rc, cache,
                                   jnp.asarray(toks[:, t:t + 1]), t)
        plg, pcache = lm.decode_step(model, pc, pcache,
                                     torch.as_tensor(toks[:, t:t + 1]), t)
        ref[f"decode{t}"], port[f"decode{t}"] = _np(lg), _np(plg)
    for name in ref:
        np.testing.assert_allclose(port[name], ref[name], err_msg=name,
                                   **F32_TOL)
    for name in cache:
        np.testing.assert_allclose(_np(pcache[name]), _np(cache[name]),
                                   err_msg=f"decoded {name}", **CACHE_TOL)


def test_init_cache_is_the_reference_layout():
    """An MLA model's cache is the compressed one, bf16 zeros of the
    reference's shapes."""
    rc, pc = _cfgs()
    want = ref_family(rc).init_cache(rc, 3, 20)
    got = lm.init_cache(pc, 3, 20)
    assert set(got) == set(want) == {"ckv", "krope"}
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape)
        assert got[name].dtype == torch.bfloat16
        assert not got[name].any()


def test_wq_serve_tokens_equal_reference(monkeypatch):
    """``serve()`` of both packages on the reference's weights, f32
    compute, ``wq`` path: the same greedy tokens; nothing launched."""
    rc, tree, pc, _model = _model_pair("wq")
    tree = jax.tree.map(np.asarray, tree)
    monkeypatch.setattr(ref_serve, "get_config", lambda a, smoke: rc)
    monkeypatch.setattr(port_serve, "get_config", lambda a, smoke: pc)
    monkeypatch.setattr(port_serve, "init_model", lambda fam, cfg, gen:
                        load_reference_params(fam.build(cfg), tree))
    kw = dict(batch=2, prompt_len=12, gen=8, seed=4)
    want = ref_serve.serve(ARCH, **kw)
    got = port_serve.serve(ARCH, device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["launches"] == {"prefill": {"flash_attention": 0, "wkv6": 0},
                               "decode": {"flash_attention": 0, "wkv6": 0}}


def test_serve_takes_a_config():
    """``serve`` takes a ModelConfig where it takes an architecture's name:
    deepseek-smoke given as its config serves the tokens of its name."""
    kw = dict(batch=2, prompt_len=8, gen=5, device="cpu")
    want = port_serve.serve("deepseek-v2-236b", smoke=True, **kw)
    got = port_serve.serve(get_config(ARCH, smoke=True), smoke=False, **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["drop_share"] == want["drop_share"] == 0.0


def test_wq_decode_step_never_syncs():
    """The ``wq`` path's captured step (``decode_step``, the pick, the
    buffer writes and the increments) syncs nothing with the host and makes
    no tensor from host data."""
    _rc, _tree, pc, model = _model_pair("wq", "bfloat16")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, pc.vocab_size, (B, S)).astype(np.int32))
    with torch.no_grad():
        _lg, cache = lm.prefill(model, pc, toks[:, :8], max_seq=S)
        ds = port_serve.DecodeStep(lm, model, pc, cache, 4)
        assert ds.graph is None                  # eager on the CPU
        ds.start(toks[:, 8:9], 8)
        with NoSync(host_data=True):
            for _ in range(3):
                ds.step()
    assert int(ds.pos) == 11 and int(ds.index) == 4


def test_full_deepseek_cut_to_four_layers():
    """deepseek-v2-236b at full width: its template counts as the
    reference's; one layer holds 3.972 B parameters (MLA 149.2 M, the
    routed experts 3,774.9 M, the shared 47.2 M, the router 0.8 M) and the
    embeddings 1.049 B, so 4 layers stored in bf16 come to 33.9 GB; its
    global capacity grid at 4 x 2048 tokens is 384 deep."""
    from repro.nn.param import count_params as ref_count
    from repro_torch.nn.param import count_params

    rc, pc = ref_config(ARCH), get_config(ARCH)
    assert count_params(lm.template(pc)) == ref_count(
        ref_family(rc).template(rc))
    layer = lm.layer_template(pc)
    n_mla = count_params(layer["attn"])
    n_experts = sum(count_params(layer["ffn"][k]) for k in ("wi", "wg",
                                                            "wo"))
    assert round(n_mla / 1e5) == 1492
    assert round(n_experts / 1e5) == 37749
    assert round(count_params(layer["ffn"]["shared"]) / 1e5) == 472
    assert round(count_params(layer) / 1e6) == 3972
    cut = dataclasses.replace(pc, n_layers=4, param_dtype="bfloat16")
    n = count_params(lm.template(cut))
    assert round(n * 2 / 1e8) == 339
    assert cut.moe_impl == "grid" and L._capacity(4 * 2048, cut) == 384
    model = lm.build(cut, device="meta")
    assert model.param_bytes() == n * 2
