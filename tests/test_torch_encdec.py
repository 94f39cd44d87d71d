"""The port's enc-dec family (whisper) against the JAX package, on the CPU:
the sinusoidal positions, the cross-attention (with K5's plain version for
its prefill core and the plain softmax over a cache), and whisper-smoke (2
encoder and 2 decoder layers, 24 media frames) whole.

Inputs are drawn from numpy seeds; the reference's parameters are carried
across with ``load_reference_params`` (the model's two stacks and its
``enc_norm``) or ``_fill`` (one layer's node).  Tolerances: f32 ``atol =
rtol = 1e-4`` (the two differ in the order of f32 sums); the bf16 caches
``rtol = 2**-7`` (``tests/test_torch_models.py``: a value within 1e-6 of a
rounding boundary may land on the neighbouring bf16 number).
whisper-smoke's forward, prefill caches, decode steps, decode graph and
no-sync step are also in ``tests/test_torch_models.py`` and
``tests/test_torch_decode_graph.py`` (``ARCHS``)."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_nosync import NoSync
from test_torch_models import _media, _np, _pair

import repro.launch.serve as ref_serve
from repro.configs import get_config as ref_config
from repro.models.common import get_family as ref_family
from repro.nn import layers as ref_layers
from repro.nn.param import count_params as ref_count
from repro.nn.param import init_params as ref_init
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as k5
from repro_torch.launch import serve as port_serve
from repro_torch.models import common, encdec
from repro_torch.models.common import get_family, load_reference_params
from repro_torch.nn import layers
from repro_torch.nn.param import Params, count_params

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_CACHE_TOL = dict(atol=1e-4, rtol=2 ** -7)
ARCH = "whisper_large_v3"


def _cfg(dtype="float32"):
    return dataclasses.replace(get_config(ARCH, smoke=True),
                               compute_dtype=dtype)


@pytest.mark.parametrize("dim", [16, 64, 1280])
@pytest.mark.parametrize("lead", [(1500,), (1,), (3, 7)],
                         ids=["encoder", "decode", "2d"])
def test_sinusoidal_pos_equals_reference(lead, dim):
    """``sinusoidal_pos`` == the reference's on whisper's encoder positions
    (0-1499), a decode step's (1,) position and a 2-D batch of positions,
    at whisper-smoke's, a middle and whisper-large-v3's widths (f32).  XLA's
    and PyTorch's f32 ``exp`` differ by an ulp on some frequencies, which
    moves the angle ``p * freq`` (freq <= 1) by at most one f32 ulp of
    ``p``, and its sine and cosine by no more: the atol is that ulp where
    it passes 1e-4 (2**-13 at whisper's 1500 frames)."""
    n = int(np.prod(lead))
    pos = (np.arange(n) if lead == (1500,) else
           np.random.default_rng(n).integers(0, 448, n)).reshape(lead)
    want = ref_layers.sinusoidal_pos(jnp.asarray(pos, jnp.int32), dim)
    got = layers.sinusoidal_pos(torch.as_tensor(pos), dim)
    assert got.dtype == torch.float32 and got.shape == (*lead, dim)
    atol = max(1e-4, float(np.spacing(np.float32(pos.max()))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=atol)


def _xattn(cfg, seed):
    """One cross-attention node's weights drawn from a numpy seed (the
    norms' scales too, so a missing or misplaced norm shows) -> (the
    reference's tree, the port's node)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, sub in layers.cross_attention_template(cfg).items():
        if isinstance(sub, dict):
            tree[name] = {"scale": (1 + 0.3 * rng.standard_normal(
                sub["scale"].shape)).astype(np.float32)}
        else:
            tree[name] = (rng.standard_normal(sub.shape)
                          / np.sqrt(sub.shape[0])).astype(np.float32)
    node = Params(layers.cross_attention_template(cfg))
    common._fill(node, tree)
    return jax.tree.map(jnp.asarray, tree), node


@pytest.mark.parametrize("S,M", [(7, 24), (16, 5), (1, 33)])
def test_cross_attention_apply_equals_reference(S, M):
    """``cross_attention_apply`` (K5's plain version, non-causal, M != S)
    == the reference's (f32), with its K/V made inside and passed in."""
    cfg = _cfg()
    ref_tree, node = _xattn(cfg, S * M)
    rng = np.random.default_rng(S + M)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    media = rng.standard_normal((2, M, cfg.d_model)).astype(np.float32)
    want = ref_layers.cross_attention_apply(ref_tree, ref_config(
        ARCH, smoke=True), jnp.asarray(x), jnp.asarray(media))
    xt, mt = torch.as_tensor(x), torch.as_tensor(media)
    got = layers.cross_attention_apply(node, cfg, xt, mt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    kv = layers.cross_attention_kv(node, cfg, mt)
    assert torch.equal(layers.cross_attention_apply(node, cfg, xt, None,
                                                    kv=kv), got)


@pytest.mark.parametrize("M", [24, 5])
def test_cross_attention_cached_equals_reference(M):
    """``cross_attention_cached`` on the cached (k-normed) K/V == the
    reference's (f32); the K/V of ``cross_attention_kv`` equal the
    reference's ``_cross_kv``, and the one-token result equals
    ``cross_attention_apply`` over the same media."""
    from repro.models import encdec as ref_encdec

    cfg = _cfg()
    ref_tree, node = _xattn(cfg, M)
    rng = np.random.default_rng(M)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    media = rng.standard_normal((3, M, cfg.d_model)).astype(np.float32)
    rk, rv = ref_encdec._cross_kv({"xattn": ref_tree}, ref_config(
        ARCH, smoke=True), jnp.asarray(media))
    k, v = layers.cross_attention_kv(node, cfg, torch.as_tensor(media))
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), **F32_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), **F32_TOL)
    want = ref_layers.cross_attention_cached(ref_tree, ref_config(
        ARCH, smoke=True), jnp.asarray(x), rk, rv)
    got = layers.cross_attention_cached(node, cfg, torch.as_tensor(x), k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    whole = layers.cross_attention_apply(node, cfg, torch.as_tensor(x),
                                         torch.as_tensor(media))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **F32_TOL)


def test_encode_equals_reference():
    """whisper-smoke's ``encode`` (sinusoids, 2 bidirectional layers on
    K5's plain version, ``enc_norm``) == the reference's (f32), and
    ``trace`` holds each layer's output."""
    rc, rf, params, pc, pf, model = _pair(ARCH, "float32")
    rm, pm = _media(pc)
    want = rf.encode(params, rc, rm)
    trace = []
    got = pf.encode(model, pc, pm, trace=trace)
    assert got.shape == (2, pc.n_media_tokens, pc.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert len(trace) == pc.n_encoder_layers
    assert not torch.equal(trace[0], trace[1])


def test_encoder_attends_both_ways():
    """A change to the last media frame moves the encoder's first frame
    (no causal mask), in both packages alike (f32)."""
    rc, rf, params, pc, pf, model = _pair(ARCH, "float32")
    rm, pm = _media(pc)
    pm2 = pm.clone()
    pm2[:, -1] += 0.5
    a, b = pf.encode(model, pc, pm), pf.encode(model, pc, pm2)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4
    np.testing.assert_allclose(_np(b), _np(rf.encode(params, rc, jnp.asarray(
        pm2.numpy()))), **F32_TOL)


def test_prefill_caches_equal_reference():
    """whisper-smoke's prefill == the reference's (f32 compute): the last
    logits, k/v padded to ``max_seq`` and the cross K/V of both decoder
    layers within the bf16 cache tolerance.  The port computes a layer's
    cross K/V once, for its K5 call and its cache: the cached ``xk``/``xv``
    equal, bit for bit, the reference's expression for them
    (``_cross_kv`` on the encoder output, which the port's
    ``encode_to_cache`` computes)."""
    rc, rf, params, pc, pf, model = _pair(ARCH, "float32")
    rm, pm = _media(pc)
    toks = np.random.default_rng(3).integers(0, pc.vocab_size, (2, 10))
    want, rcache = rf.prefill(params, rc, jnp.asarray(toks), max_seq=14,
                              media=rm)
    got, cache = pf.prefill(model, pc, torch.as_tensor(toks), max_seq=14,
                            media=pm)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert set(cache) == set(rcache) == {"k", "v", "xk", "xv"}
    for name in cache:
        assert cache[name].dtype == torch.bfloat16
        assert cache[name].shape == tuple(rcache[name].shape), name
        np.testing.assert_allclose(_np(cache[name]), _np(rcache[name]),
                                   err_msg=name, **BF16_CACHE_TOL)
    assert not cache["k"][:, :, 10:].any()
    again = pf.encode_to_cache(model, pc, pm, pf.init_cache(pc, 2, 14))
    for name in ("xk", "xv"):
        assert torch.equal(cache[name], again[name]), name


def test_encode_to_cache_then_decode_equals_reference():
    """``encode_to_cache`` into a fresh cache and three decode steps ==
    the reference's (f32 compute): the cross K/V, each step's logits and
    the self K/V written at the step's position."""
    rc, rf, params, pc, pf, model = _pair(ARCH, "float32")
    rm, pm = _media(pc)
    rcache = rf.encode_to_cache(params, rc, rm, rf.init_cache(rc, 2, 8))
    cache = pf.encode_to_cache(model, pc, pm, pf.init_cache(pc, 2, 8))
    for name in ("xk", "xv"):
        np.testing.assert_allclose(_np(cache[name]), _np(rcache[name]),
                                   err_msg=name, **BF16_CACHE_TOL)
    toks = np.random.default_rng(5).integers(0, pc.vocab_size, (2, 3))
    for t in range(3):
        want, rcache = rf.decode_step(params, rc, rcache,
                                      jnp.asarray(toks[:, t:t + 1]), t)
        got, cache = pf.decode_step(model, pc, cache,
                                    torch.as_tensor(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"step {t}",
                                   **F32_TOL)
    for name in cache:
        np.testing.assert_allclose(_np(cache[name]), _np(rcache[name]),
                                   err_msg=name, **BF16_CACHE_TOL)


def test_prefill_then_decode_consistent():
    """The reference's own check on the port (its
    ``test_prefill_then_decode_consistent``, which covers the other
    families): prefill of the first half and one decode step agree with the
    forward over the whole sequence, default bf16 compute.  The prefill's
    last logits at the reference's 2e-2; the decode step at 5e-2, the
    port's decode-vs-forward policy (``tests/test_torch_models.py``: the
    forward's attention keeps K5's f32 probabilities)."""
    _rc, _rf, _params, cfg, fam, model = _pair(ARCH, "bfloat16")
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)
    media = _media(cfg)[1]
    full = _np(fam.forward(model, cfg, toks, media=media))
    logits, cache = fam.prefill(model, cfg, toks[:, :8], max_seq=16,
                                media=media)
    np.testing.assert_allclose(_np(logits)[:, -1], full[:, 7], atol=2e-2)
    logits, cache = fam.decode_step(model, cfg, cache, toks[:, 8:9], 8)
    np.testing.assert_allclose(_np(logits)[:, 0], full[:, 8], atol=5e-2)


def test_prefill_attention_calls():
    """The prefill's K5 calls, counted through the ``layers._k5`` seam as
    the card's smoke counts them: each encoder layer once non-causal at (M,
    M), each decoder layer once causal at (S, S) and once non-causal at (S,
    M); no window; the decode calls none."""
    cfg = _cfg("bfloat16")
    model = common.init_model(encdec, cfg, torch.Generator().manual_seed(0))
    calls = collections.Counter()

    class Counting:
        @staticmethod
        def flash_attention(q, k, v, causal=True, window=0):
            calls[causal, q.shape[1], k.shape[1], window] += 1
            return k5.flash_attention(q, k, v, causal=causal, window=window)

    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)), dtype=torch.int32)
    M = cfg.n_media_tokens
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "_k5", Counting)
        _lg, cache = encdec.prefill(model, cfg, toks, max_seq=12,
                                    media=_media(cfg)[1])
        assert calls == {(False, M, M, 0): cfg.n_encoder_layers,
                         (True, 9, 9, 0): cfg.n_layers,
                         (False, 9, M, 0): cfg.n_layers}
        calls.clear()
        encdec.decode_step(model, cfg, cache, toks[:, :1], 9)
        assert not calls


def test_whisper_full_template_counts():
    """The full whisper-large-v3 template counts as the reference's:
    1,534,614,016 parameters, the encoder 629,227,520 (19,663,360 a
    layer), the decoder 838,987,776 (26,218,368 a layer), the embedding
    66,397,440; the model builds on the meta device with that many, its
    two stacks 32 layers each, and its ``param_bytes`` counts both stacks
    (f32)."""
    rc, pc = ref_config(ARCH), get_config(ARCH)
    t = encdec.template(pc)
    n = count_params(t)
    assert n == ref_count(ref_family(rc).template(rc)) == 1_534_614_016
    assert count_params(t["encoder"]) == 629_227_520
    assert count_params(encdec.enc_layer_template(pc)) == 19_663_360
    assert count_params(t["decoder"]) == 838_987_776
    assert count_params(encdec.dec_layer_template(pc)) == 26_218_368
    assert count_params(t["embed"]) == 66_397_440
    model = encdec.build(pc, device="meta")
    assert sum(p.numel() for p in model.parameters()) == n
    assert len(model.encoder) == len(model.decoder) == 32
    assert model.param_bytes() == 4 * n
    assert model.stack_names == ("encoder", "decoder")
    assert model.node_names == ("embed", "enc_norm")


def test_loader_refuses_a_tree_of_another_layout():
    """The generalised loader fills exactly the model's nodes and stacks:
    a tree without ``enc_norm``, or with an LM's ``layers``, is refused;
    the LMs' ``{"embed", "layers"}`` still loads into an LM."""
    rc = ref_config(ARCH, smoke=True)
    tree = jax.tree.map(np.asarray, ref_init(ref_family(rc).template(rc),
                                             jax.random.key(0)))
    model = encdec.build(_cfg())
    with pytest.raises(ValueError, match="enc_norm"):
        load_reference_params(model, {k: v for k, v in tree.items()
                                      if k != "enc_norm"})
    with pytest.raises(ValueError, match="layers"):
        load_reference_params(model, {**tree, "layers": tree["decoder"]})
    load_reference_params(model, tree)
    np.testing.assert_array_equal(
        model.decoder[1]["xattn"]["wk"].numpy(), tree["decoder"]["xattn"][
            "wk"][1])
    lc = ref_config("qwen2_1_5b", smoke=True)
    lm_tree = jax.tree.map(np.asarray, ref_init(ref_family(lc).template(lc),
                                                jax.random.key(0)))
    pc = get_config("qwen2_1_5b", smoke=True)
    lm_model = load_reference_params(get_family(pc).build(pc), lm_tree)
    assert lm_model.stack_names == ("layers",)


def test_init_model_takes_the_drawn_tensors_as_views():
    """``init_model`` builds whisper-smoke on the meta device and takes the
    drawn tensors: every parameter holds memory on the generator's device,
    and the encoder's and decoder's layers differ."""
    cfg = _cfg()
    model = common.init_model(encdec, cfg, torch.Generator().manual_seed(0))
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert not torch.equal(model.encoder[0]["attn"]["wq"],
                           model.encoder[1]["attn"]["wq"])
    assert model.decoder[0]["xattn"]["wk"].shape == (
        cfg.d_model, cfg.n_kv_heads, cfg.head_dim)


def test_serve_tokens_equal_reference(monkeypatch):
    """``serve(device="cpu")`` and the reference's ``serve()`` on the
    reference's weights, f32 compute, the stub frontend's media: the same
    greedy tokens, no kernel launched, no graph captured."""
    rc = dataclasses.replace(ref_config(ARCH, smoke=True),
                             compute_dtype="float32")
    pc = _cfg()
    tree = jax.tree.map(np.asarray, ref_init(ref_family(rc).template(rc),
                                             jax.random.key(0)))
    monkeypatch.setattr(ref_serve, "get_config", lambda a, smoke: rc)
    monkeypatch.setattr(port_serve, "get_config", lambda a, smoke: pc)
    monkeypatch.setattr(port_serve, "init_model", lambda fam, cfg, gen:
                        load_reference_params(fam.build(cfg), tree))
    kw = dict(batch=2, prompt_len=12, gen=9, seed=3)
    want = ref_serve.serve("whisper-large-v3", **kw)
    got = port_serve.serve("whisper-large-v3", device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["captures"] == 0
    assert not any(n for phase in got["launches"].values()
                   for n in phase.values())


def test_decode_step_writes_in_place_without_sync():
    """A decode step under ``NoSync(host_data=True)``: it writes k/v at
    ``pos`` only, leaves the cross K/V as they were, keeps the cache's
    storage, and equals the reference's step (f32)."""
    rc, rf, params, pc, pf, model = _pair(ARCH, "float32")
    rm, pm = _media(pc)
    toks = np.random.default_rng(6).integers(0, pc.vocab_size, (2, 9))
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
        changed = (cache[name] != before[name]).any(dim=(0, 1, 3, 4))
        assert changed.nonzero().flatten().tolist() == [8], name
        np.testing.assert_allclose(_np(cache[name]), _np(rcache[name]),
                                   err_msg=name, **BF16_CACHE_TOL)
    for name in ("xk", "xv"):
        assert torch.equal(cache[name], before[name]), name


def test_whisper_resolves_and_serves_on_the_cli(capsys):
    """``get_family`` gives the port's encdec module, and the CLI serves
    the smoke config on the CPU."""
    assert get_family(get_config("whisper-large-v3")) is encdec
    r = port_serve.main(["--arch", "whisper-large-v3", "--smoke", "--device",
                         "cpu", "--batch", "2", "--prompt-len", "12",
                         "--gen", "4"])
    assert r["tokens"].shape == (2, 4)
    assert "sample row" in capsys.readouterr().out


def test_media_is_required():
    """The enc-dec forward and prefill refuse to run without media."""
    cfg = _cfg()
    model = common.init_model(encdec, cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="media"):
        encdec.forward(model, cfg, toks)
    with pytest.raises(ValueError, match="media"):
        encdec.prefill(model, cfg, toks)
