"""The port's decode step as the reference's jitted, cache-donating
``decode_step``, on the CPU: the position a 1-element device tensor (the
reference's traced ``int32``) gives the reference's logits and cache and
the int path's bits; the static-buffer decode loop
(``repro_torch.launch.serve.DecodeStep``, run eagerly here as the card
replays it) gives the reference serve's greedy tokens and a plain loop's
tokens and logits, greedy and sampled; a step syncs nothing with the host;
the warm-up before a capture leaves the served cache as it was.

Tolerances as in ``tests/test_torch_models.py``: in f32 compute 1e-4 on
logits and WKV states, and two bf16 ulps (``rtol = 2**-7``) on the bf16 K/V
caches.  Everything else is bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_nosync import NoSync
from test_torch_models import ARCHS, F32_TOL, _np, _pair, _tokens

import repro.launch.serve as ref_serve
import repro_torch.launch.serve as port_serve
from repro.configs import get_config as ref_config
from repro.models.common import get_family as ref_family
from repro.nn.param import init_params as ref_init
from repro_torch.configs import get_config
from repro_torch.models import common
from repro_torch.models.common import get_family, load_reference_params
from repro_torch.nn import layers

B, S = 2, 16
HALF = S // 2


def _pos(t):
    return torch.full((1,), t, dtype=torch.int64)


def _copy(cache):
    return {k: v.clone() for k, v in cache.items()}


def _port(arch, dtype="bfloat16"):
    """-> (cfg, family, model, tokens) of the port on the reference's
    weights."""
    _rc, _rf, _params, pc, pf, model = _pair(arch, dtype)
    return pc, pf, model, torch.as_tensor(_tokens(pc, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_position_equals_reference(arch):
    """Two decode steps after a prefill, the port's position a (1,) int64
    tensor and the reference's ``jnp.int32``: logits and every cache
    tensor, f32 compute."""
    rc, rf, params, pc, pf, model = _pair(arch, "float32")
    toks = _tokens(rc, 2)
    _lg, rcache = rf.prefill(params, rc, jnp.asarray(toks[:, :HALF]),
                             max_seq=S)
    _lg, pcache = pf.prefill(model, pc, torch.as_tensor(toks[:, :HALF]),
                             max_seq=S)
    for t in (HALF, HALF + 1):
        want, rcache = rf.decode_step(params, rc, rcache,
                                      jnp.asarray(toks[:, t:t + 1]),
                                      jnp.int32(t))
        got, pcache = pf.decode_step(model, pc, pcache,
                                     torch.as_tensor(toks[:, t:t + 1]),
                                     _pos(t))
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"step {t}",
                                   **F32_TOL)
    for name, want in rcache.items():
        tol = (dict(atol=1e-4, rtol=2 ** -7) if name in ("k", "v")
               else F32_TOL)
        np.testing.assert_allclose(_np(pcache[name]), _np(want),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_position_equals_int_position(arch):
    """The same decode steps with the position as an int and as a tensor
    give the same logits and caches bit for bit (default bf16 compute)."""
    cfg, fam, model, toks = _port(arch)
    _lg, cache = fam.prefill(model, cfg, toks[:, :HALF], max_seq=S)
    by_int, by_tensor = _copy(cache), _copy(cache)
    for t in range(HALF, S):
        a, _ = fam.decode_step(model, cfg, by_int, toks[:, t:t + 1], t)
        b, _ = fam.decode_step(model, cfg, by_tensor, toks[:, t:t + 1],
                               _pos(t))
        assert torch.equal(a, b), t
    for name in cache:
        assert torch.equal(by_int[name], by_tensor[name]), name


def _attention_decode_int(params, cfg, x, cache_k, cache_v, pos, is_global):
    """The decode attention as it was with an int position: positions by
    ``torch.full``, the cache written by an int index."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32)
    q, k, v = layers._qkv(params, cfg, x, positions)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    pk = torch.arange(cache_k.shape[1], dtype=torch.int32)[None, :]
    mask = layers.causal_window_mask(positions, pk, cfg.window, is_global)
    out = layers._gqa_scores_softmax_out(cfg, q, cache_k.to(q.dtype),
                                         cache_v.to(q.dtype),
                                         mask[:, None, None, :, :])
    return layers._out_proj(params, out)


@pytest.mark.parametrize("pos", [3, 13])
@pytest.mark.parametrize("is_global", [False, True])
def test_attention_decode_equals_int_indexed_write(is_global, pos):
    """gemma-smoke's decode attention (window 8) with the tensor position
    equals the int-indexed form bit for bit: output, and the cache with the
    token's k/v written at ``pos`` (inside and past the window)."""
    cfg, _fam, model, _toks = _port("gemma3_12b")
    params = model.layers[0]["attn"]
    g = torch.Generator().manual_seed(pos)
    x = torch.randn((B, 1, cfg.d_model), generator=g).to(cfg.cdtype())
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    ck = torch.randn(shape, generator=g).to(torch.bfloat16)
    cv = torch.randn(shape, generator=g).to(torch.bfloat16)
    want_k, want_v = ck.clone(), cv.clone()
    want = _attention_decode_int(params, cfg, x, want_k, want_v, pos,
                                 is_global)
    got, got_k, got_v = layers.attention_decode(params, cfg, x, ck, cv,
                                                _pos(pos), is_global)
    assert torch.equal(got, want)
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
    assert got_k is ck and got_v is cv                   # in place


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_embed_scale_keeps_the_bits(dtype):
    """gemma's embedding factor, a float made once, gives the bits of the
    product with ``sqrt`` of the 0-d tensor in the compute type."""
    cfg = dataclasses.replace(get_config("gemma3_12b", smoke=True),
                              compute_dtype=str(dtype).split(".")[1])
    fam = get_family(cfg)
    model = common.init_model(fam, cfg, torch.Generator().manual_seed(0))
    toks = torch.as_tensor(_tokens(cfg, 5))
    x = model.embed["tok"][toks.long()].to(dtype)
    want = x * torch.sqrt(torch.tensor(cfg.d_model, dtype=dtype))
    got = common.embed_tokens(model.embed, cfg, toks)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_loop_tokens_equal_reference_serve(arch, monkeypatch):
    """``serve()`` on the CPU (the static-buffer loop, run eagerly) and the
    reference's ``serve()`` on the reference's weights, f32 compute: the
    same greedy tokens, and no graph captured."""
    rc = dataclasses.replace(ref_config(arch, smoke=True),
                             compute_dtype="float32")
    pc = dataclasses.replace(get_config(arch, smoke=True),
                             compute_dtype="float32")
    tree = jax.tree.map(np.asarray, ref_init(ref_family(rc).template(rc),
                                             jax.random.key(0)))
    monkeypatch.setattr(ref_serve, "get_config", lambda a, smoke: rc)
    monkeypatch.setattr(port_serve, "get_config", lambda a, smoke: pc)
    monkeypatch.setattr(port_serve, "init_model", lambda fam, cfg, gen:
                        load_reference_params(fam.build(cfg), tree))
    kw = dict(batch=3, prompt_len=9, gen=7, seed=6)
    want = ref_serve.serve(arch, **kw)
    before = port_serve.CAPTURE_COUNT
    got = port_serve.serve(arch, device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens"].shape == (3, 7) and got["tokens"].dtype == np.int32
    assert got["captures"] == 0 and port_serve.CAPTURE_COUNT == before
    assert got["capture_s"] >= 0 and got["decode_s"] > 0


def _plain_loop(fam, model, cfg, cache, first, gen, temperature, sampler):
    """The decode as a plain loop of ``decode_step`` with int positions."""
    tok, toks, steps = first, [first], []
    for i in range(gen - 1):
        logits, cache = fam.decode_step(model, cfg, cache, tok, HALF + i)
        steps.append(logits.clone())
        tok = port_serve.pick(logits[:, 0], temperature, sampler)
        toks.append(tok)
    return torch.cat(toks, dim=1).numpy(), steps


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_loop_equals_plain_loop(arch, temperature):
    """The static-buffer loop (:func:`decode`, eager on the CPU) and a plain
    loop of ``decode_step``: the same tokens and every step's logits bit for
    bit, greedy and sampled from generators of one seed."""
    cfg, fam, model, toks = _port(arch)
    gen = S - HALF
    with torch.no_grad():
        _lg, cache = fam.prefill(model, cfg, toks[:, :HALF], max_seq=S)
        first = toks[:, HALF:HALF + 1]
        want, want_steps = _plain_loop(
            fam, model, cfg, _copy(cache), first, gen, temperature,
            torch.Generator().manual_seed(7))
        steps = []
        got = port_serve.decode(
            fam, model, cfg, cache, first, HALF, gen,
            temperature=temperature,
            sampler=torch.Generator().manual_seed(7),
            on_step=lambda lg: steps.append(lg.clone()))
    np.testing.assert_array_equal(got["tokens"], want)
    assert len(steps) == len(want_steps) == gen - 1
    for i, (a, b) in enumerate(zip(steps, want_steps)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_never_syncs(arch):
    """What a captured step runs (``decode_step``, the greedy pick, the
    buffer writes and the increments) syncs nothing with the host and makes
    no tensor from host data."""
    cfg, fam, model, toks = _port(arch)
    with torch.no_grad():
        _lg, cache = fam.prefill(model, cfg, toks[:, :HALF], max_seq=S)
        ds = port_serve.DecodeStep(fam, model, cfg, cache, 4)
        assert ds.graph is None                  # eager on the CPU
        ds.start(toks[:, HALF:HALF + 1], HALF)
        with NoSync(host_data=True):
            for _ in range(3):
                ds.step()
    assert int(ds.pos) == HALF + 3 and int(ds.index) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_warm_up_leaves_the_served_cache(arch):
    """The warm-up step before a capture runs on a clone: the served cache
    (RWKV6's state, which a step advances in place, included) stays as the
    prefill left it bit for bit, while the step did run."""
    cfg, fam, model, toks = _port(arch)
    with torch.no_grad():
        _lg, cache = fam.prefill(model, cfg, toks[:, :HALF], max_seq=S)
        before = _copy(cache)
        ds = port_serve.DecodeStep(fam, model, cfg, cache, 4, graph=False)
        ds.warm()
    assert int(ds.pos) == 1                      # the step ran
    for name in cache:
        assert torch.equal(cache[name], before[name]), name


def test_serve_on_the_eager_decode(monkeypatch):
    """``serve.decode`` swapped for ``decode_eager`` (as a run that records
    ``decode_step`` swaps it) serves the same tokens."""
    kw = dict(smoke=True, batch=2, prompt_len=8, gen=5, device="cpu")
    want = port_serve.serve("qwen2-1.5b", **kw)
    monkeypatch.setattr(port_serve, "decode", port_serve.decode_eager)
    got = port_serve.serve("qwen2-1.5b", **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
