"""The port's hybrid family (hymba) against the JAX package, on the CPU:
the associative scan, the Mamba head's depthwise conv and selective SSM,
and hymba-smoke (window 8, global layer 0) whole.

Inputs are drawn from numpy seeds; the reference's parameters are carried
across with ``load_reference_params``.  Tolerances: f32 ``atol = rtol =
1e-4`` (the two differ in the order of f32 sums, and XLA flushes
denormals); in bf16 compute the port lies no further from the reference's
f32 result than twice the reference in bf16, plus 1e-2
(``tests/test_torch_models.py``'s rule).  hymba-smoke's forward, prefill
caches and decode steps against the reference, its decode graph and its
no-sync step are also in ``tests/test_torch_models.py`` and
``tests/test_torch_decode_graph.py`` (``ARCHS``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_nosync import NoSync
from test_torch_models import _np, _pair

import repro.launch.serve as ref_serve
from repro.configs import get_config as ref_config
from repro.models.common import get_family as ref_family
from repro.nn import ssm as ref_ssm
from repro.nn.param import count_params as ref_count
from repro.nn.param import init_params as ref_init
from repro_torch.configs import get_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import common, hymba
from repro_torch.models.common import get_family, load_reference_params
from repro_torch.nn import ssm
from repro_torch.nn.param import Params, count_params

F32_TOL = dict(atol=1e-4, rtol=1e-4)
SCAN_LENGTHS = (1, 2, 3, 7, 16, 33)


def _ref_combine(a, b):
    return (a[0] * b[0], b[0] * a[1] + b[1])


def _scan_inputs(S, seed, lead=(2,), tail=(5, 3)):
    rng = np.random.default_rng(seed)
    decay = rng.uniform(0.3, 1.0, (*lead, S, *tail)).astype(np.float32)
    drive = rng.standard_normal((*lead, S, *tail)).astype(np.float32)
    return decay, drive


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", SCAN_LENGTHS)
def test_associative_scan_equals_jax(S, with_state):
    """The port's scan of the Mamba combine == ``jax.lax.associative_scan``
    on both outputs, at odd and even lengths, with and without the
    prepended ``(1, h0)`` a state adds."""
    decay, drive = _scan_inputs(S, S)
    if with_state:
        h0 = np.random.default_rng(S + 100).standard_normal(
            (2, 1, 5, 3)).astype(np.float32)
        decay = np.concatenate([np.ones_like(decay[:, :1]), decay], axis=1)
        drive = np.concatenate([h0, drive], axis=1)
    want = jax.lax.associative_scan(
        _ref_combine, (jnp.asarray(decay), jnp.asarray(drive)), axis=1)
    got = ssm.associative_scan(ssm.scan_combine, (torch.from_numpy(decay),
                                                  torch.from_numpy(drive)),
                               dim=1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("S", [2, 7, 16, 33, 100])
def test_associative_scan_equals_the_recurrence(S):
    """The scan's second output is the sequential recurrence ``h_t =
    decay_t h_{t-1} + drive_t``; along a negative ``dim`` too."""
    decay, drive = (torch.from_numpy(x) for x in _scan_inputs(S, S + 7))
    h, want = torch.zeros_like(drive[:, 0]), []
    for t in range(S):
        h = decay[:, t] * h + drive[:, t]
        want.append(h)
    want = torch.stack(want, dim=1)
    for dim in (1, -3):
        _, got = ssm.associative_scan(ssm.scan_combine, (decay, drive),
                                      dim=dim)
        torch.testing.assert_close(got, want, **F32_TOL)


def test_softplus_equals_jax():
    """``ssm.softplus`` is ``jax.nn.softplus`` (``logaddexp(x, 0)``) in f32
    across the range a step size takes, past ``F.softplus``'s threshold of
    20 included."""
    x = np.concatenate([np.linspace(-60, 60, 4001),
                        np.random.default_rng(0).standard_normal(4000) * 3]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _mamba_params(cfg, seed):
    """A Mamba head's parameters with every leaf drawn (``A_log``,
    ``dt_bias`` and ``D`` too, whose template values are constants), as a
    numpy tree and as the port's :class:`Params`."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in ssm.mamba_template(cfg).items():
        scale = p.scale if p.scale is not None else p.shape[0] ** -0.5
        tree[name] = (rng.standard_normal(p.shape) * scale).astype(np.float32)
    tree["A_log"] = rng.uniform(-1, 1, tree["A_log"].shape).astype(np.float32)
    tree["dt_bias"] = rng.uniform(-2, 1, tree["dt_bias"].shape).astype(
        np.float32)
    tree["D"] = rng.uniform(0.5, 1.5, tree["D"].shape).astype(np.float32)
    node = Params(ssm.mamba_template(cfg))
    common._fill(node, tree)
    return tree, node


def _cfg(dtype="float32"):
    return dataclasses.replace(get_config("hymba_1_5b", smoke=True),
                               compute_dtype=dtype)


@pytest.mark.parametrize("with_tail", [False, True])
def test_depthwise_conv_equals_reference(with_tail):
    """The causal depthwise conv and its tail, with and without a carried
    tail, f32."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    w = rng.standard_normal((ssm.CONV_K, 64)).astype(np.float32)
    tail = (rng.standard_normal((2, ssm.CONV_K - 1, 64)).astype(np.float32)
            if with_tail else None)
    want, want_tail = ref_ssm._depthwise_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if tail is None else jnp.asarray(tail))
    got, got_tail = ssm._depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if tail is None else torch.from_numpy(tail))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))
    assert got_tail.shape == (2, ssm.CONV_K - 1, 64)


def _mamba_pair(cfg, tree, node, x, state):
    """-> (reference (out, h, tail), port (out, h, tail)) as f32 arrays."""
    dt = jnp.dtype(cfg.compute_dtype)
    ref_state = None if state is None else (jnp.asarray(state[0]),
                                            jnp.asarray(state[1]).astype(dt))
    out, (h, tail) = ref_ssm.mamba_apply(
        jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(x).astype(dt),
        ref_state)
    port_state = None if state is None else (
        torch.from_numpy(state[0]),
        torch.from_numpy(state[1]).to(cfg.cdtype()))
    pout, (ph, ptail) = ssm.mamba_apply(
        node, cfg, torch.from_numpy(x).to(cfg.cdtype()), port_state)
    assert ph.dtype == torch.float32 and ptail.dtype == cfg.cdtype()
    return (tuple(_np(a) for a in (out, h, tail)),
            tuple(_np(a) for a in (pout, ph, ptail)))


def _mamba_inputs(cfg, S, with_state, seed):
    rng = np.random.default_rng(seed)
    E, N = cfg.d_model, cfg.ssm_state
    x = rng.standard_normal((2, S, E)).astype(np.float32)
    state = None
    if with_state:
        state = (rng.standard_normal((2, E, N)).astype(np.float32),
                 rng.standard_normal((2, ssm.CONV_K - 1, E)).astype(
                     np.float32))
    return x, state


@pytest.mark.parametrize("S", [1, 16, 33])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_f32_equals_reference(with_state, S):
    """``mamba_apply`` == ``repro.nn.ssm.mamba_apply`` in f32 compute: the
    output, the last ``h`` and the conv tail, with and without a carried
    state (S = 1 is the decode's one combine)."""
    cfg = _cfg()
    tree, node = _mamba_params(cfg, 11)
    x, state = _mamba_inputs(cfg, S, with_state, S)
    ref, port = _mamba_pair(cfg, tree, node, x, state)
    for name, a, b in zip(("out", "h", "tail"), port, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **F32_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_bf16_within_reference_error(with_state):
    """In bf16 compute the port's output and state lie no further from the
    reference's f32 result than twice the reference in bf16, plus 1e-2."""
    tree, node = _mamba_params(_cfg(), 12)
    x, state = _mamba_inputs(_cfg(), 16, with_state, 5)
    ref32, _ = _mamba_pair(_cfg(), tree, node, x, state)
    ref16, port16 = _mamba_pair(_cfg("bfloat16"), tree, node, x, state)
    for name, want, r16, p16 in zip(("out", "h", "tail"), ref32, ref16,
                                    port16):
        assert np.isfinite(p16).all(), name
        ref_err = np.abs(r16 - want).max()
        port_err = np.abs(p16 - want).max()
        assert port_err <= 2 * ref_err + 1e-2, (name, port_err, ref_err)


def test_mamba_state_carries_across_a_split():
    """The port's head over a whole sequence == over its first 10 positions
    and then the rest from the state it returned (f32)."""
    cfg = _cfg()
    _tree, node = _mamba_params(cfg, 13)
    x = torch.from_numpy(_mamba_inputs(cfg, 23, False, 9)[0])
    whole, (h, tail) = ssm.mamba_apply(node, cfg, x)
    a, state = ssm.mamba_apply(node, cfg, x[:, :10])
    b, (h2, tail2) = ssm.mamba_apply(node, cfg, x[:, 10:], state)
    torch.testing.assert_close(torch.cat([a, b], dim=1), whole, **F32_TOL)
    torch.testing.assert_close(h2, h, **F32_TOL)
    assert torch.equal(tail2, tail)


def test_hymba_full_template_counts():
    """The full hymba-1.5b template counts as the reference's: 1,342,030,464
    parameters, 40,337,602 a layer; the model builds on the meta device
    with that many."""
    rc, pc = ref_config("hymba_1_5b"), get_config("hymba_1_5b")
    n = count_params(hymba.template(pc))
    assert n == ref_count(ref_family(rc).template(rc)) == 1_342_030_464
    assert count_params(hymba.layer_template(pc)) == 40_337_602
    model = hymba.build(pc, device="meta")
    assert sum(p.numel() for p in model.parameters()) == n
    assert [pc.is_global_layer(i) for i in range(32)].count(True) == 3


def test_hymba_prefill_then_decode_consistent():
    """The reference's own check on the port (its
    ``test_prefill_then_decode_consistent``): prefill of the first half and
    one decode step agree with the forward over the whole sequence, default
    bf16 compute.  The prefill's last logits at the reference's 2e-2; the
    decode step at 5e-2, the port's decode-vs-forward policy
    (``tests/test_torch_models.py``: the forward's attention keeps K5's f32
    probabilities)."""
    _rc, _rf, _params, cfg, fam, model = _pair("hymba_1_5b", "bfloat16")
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)
    full = _np(fam.forward(model, cfg, toks))
    logits, cache = fam.prefill(model, cfg, toks[:, :8], max_seq=16)
    np.testing.assert_allclose(_np(logits)[:, -1], full[:, 7], atol=2e-2)
    logits, cache = fam.decode_step(model, cfg, cache, toks[:, 8:9], 8)
    np.testing.assert_allclose(_np(logits)[:, 0], full[:, 8], atol=5e-2)


def test_hymba_window_bites():
    """hymba-smoke's window (8) at S = 16 changes the local layer's output:
    the forward with the window equals the reference's, and differs from
    the same model with every layer global, in both packages alike (f32)."""
    rc, rf, params, pc, pf, model = _pair("hymba_1_5b", "float32")
    toks = np.random.default_rng(8).integers(0, pc.vocab_size, (2, 16))
    got = _np(pf.forward(model, pc, torch.as_tensor(toks)))
    np.testing.assert_allclose(got, _np(rf.forward(params, rc,
                                                   jnp.asarray(toks))),
                               **F32_TOL)
    rc0, pc0 = (dataclasses.replace(c, window=0) for c in (rc, pc))
    got0 = _np(pf.forward(model, pc0, torch.as_tensor(toks)))
    np.testing.assert_allclose(got0, _np(rf.forward(params, rc0,
                                                    jnp.asarray(toks))),
                               **F32_TOL)
    assert np.abs(got - got0)[:, 8:].max() > 1e-3    # past the window
    np.testing.assert_allclose(got[:, :8], got0[:, :8], **F32_TOL)


def test_hymba_serve_tokens_equal_reference(monkeypatch):
    """``serve(device="cpu")`` and the reference's ``serve()`` on the
    reference's weights, f32 compute, a prompt longer than the window: the
    same greedy tokens, no kernel launched, no graph captured."""
    rc = dataclasses.replace(ref_config("hymba_1_5b", smoke=True),
                             compute_dtype="float32")
    pc = _cfg()
    tree = jax.tree.map(np.asarray, ref_init(ref_family(rc).template(rc),
                                             jax.random.key(0)))
    monkeypatch.setattr(ref_serve, "get_config", lambda a, smoke: rc)
    monkeypatch.setattr(port_serve, "get_config", lambda a, smoke: pc)
    monkeypatch.setattr(port_serve, "init_model", lambda fam, cfg, gen:
                        load_reference_params(fam.build(cfg), tree))
    kw = dict(batch=2, prompt_len=20, gen=6, seed=2)
    want = ref_serve.serve("hymba-1.5b", **kw)
    got = port_serve.serve("hymba-1.5b", device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["captures"] == 0
    assert not any(n for phase in got["launches"].values()
                   for n in phase.values())


def test_hymba_decode_step_writes_in_place_without_sync():
    """A decode step under ``NoSync(host_data=True)``: it writes k/v at
    ``pos`` only and overwrites ``h`` and ``conv`` in the cache's own
    storage, which the reference's returned state equals (f32)."""
    rc, rf, params, pc, pf, model = _pair("hymba_1_5b", "float32")
    toks = np.random.default_rng(6).integers(0, pc.vocab_size, (2, 9))
    _lg, rcache = rf.prefill(params, rc, jnp.asarray(toks[:, :8]), max_seq=12)
    _lg, cache = pf.prefill(model, pc, torch.as_tensor(toks[:, :8]),
                            max_seq=12)
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
    for name in ("h", "conv"):
        assert not torch.equal(cache[name], before[name]), name
        tol = F32_TOL if name == "h" else dict(atol=1e-4, rtol=2 ** -7)
        np.testing.assert_allclose(_np(cache[name]), _np(rcache[name]),
                                   err_msg=name, **tol)


def test_hymba_resolves_and_serves_on_the_cli(capsys):
    """``get_family`` gives the port's hymba module, and the CLI serves the
    smoke config on the CPU."""
    assert get_family(get_config("hymba-1.5b")) is hymba
    r = port_serve.main(["--arch", "hymba-1.5b", "--smoke", "--device",
                         "cpu", "--batch", "2", "--prompt-len", "12",
                         "--gen", "4"])
    assert r["tokens"].shape == (2, 4)
    assert "sample row" in capsys.readouterr().out
