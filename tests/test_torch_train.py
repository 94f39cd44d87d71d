"""The port's training path against the JAX package's, on the CPU.

Every family's smoke config (qwen2; granite-moe with a capacity factor of
0.5, so the grid drops pairs; deepseek's MLA; rwkv6; hymba; whisper; and
llama-3.2-vision with its cross gates drawn non-zero) starts both packages
from the reference's parameters (``init_params(..., jax.random.key(0))``,
carried across by ``load_reference_params``) and takes the same numpy
tokens, labels (a few of them -1, ignored) and media.  On the CPU the
port's attention and WKV run K5's and K6's plain versions, and K5's
gradient its plain backward (``ref.flash_attention_bwd_ref``).

Tolerances.  In f32 compute (``compute_dtype="float32"``) the two differ
only in the order of f32 sums: the loss at rtol 1e-5, each gradient leaf
at a relative L2 distance of 1e-4 (the reference's stacked leaf against
the port's per-layer tensors stacked; 3e-4 for llama-vision-smoke, whose
f32 gradients are worse conditioned, see ``ARCH_TOL``).  After three AdamW
steps (lr 1e-5, so that the gradients of steps 2 and 3 are taken at the
same parameters in both; the schedule's first step is 0): each step's loss
at rtol 1e-5, both moments at the gradients' tolerance, and each
parameter leaf's update at a relative L2 of 1e-2, since Adam's step
``m / sqrt(v)`` is scale-free: an element whose gradient is f32 noise in
both packages moves by up to lr either way (measured: at most 4.4e-3, the
VLM's ``wq``).  The optimizer alone, on the same gradients, is held
exactly in ``tests/test_torch_train_substrate.py``.  In bf16 compute the
frameworks round at other places (XLA fuses elementwise chains in f32),
so, as ``tests/test_torch_models.py`` does for the logits, each package's
bf16 gradient is held to the f32 gradient: the port's distance at most
twice the reference's plus 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.common import get_family as ref_family
from repro.models.common import lm_loss as ref_lm_loss
from repro.nn.layers import moe_aux_loss as ref_moe_aux_loss
from repro.nn.param import init_params as ref_init
from repro.optim.adamw import AdamWConfig as RefAdamW
from repro.train import steps as ref_steps
from repro_torch.configs import get_config
from repro_torch.models import common as C
from repro_torch.nn import layers as L
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import steps
from repro_torch.tree import leaves, leaves_with_paths

#: each family's smoke config, with what it needs to exercise its path
CASES = {
    "qwen2_1_5b": {},
    "granite_moe_3b": {"capacity_factor": 0.5},      # the grid drops pairs
    "deepseek_v2_236b": {},
    "rwkv6_3b": {},
    "hymba_1_5b": {},
    "whisper_large_v3": {},
    "llama32_vision_90b": {},                        # gates set below
}
B, S = 2, 16
GRAD_TOL = 1e-4
#: llama-vision-smoke's f32 gradients are worse conditioned (four self
#: layers and a gated cross layer deep): two f32 runs that sum in other
#: orders differ by up to 1.1e-4 here (embed/tok, groups/self/attn/wq),
#: where the other families' stay under 4e-5
ARCH_TOL = {"llama32_vision_90b": 3e-4}
OPT = dict(lr=1e-5, warmup_steps=1, total_steps=10)
UPDATE_TOL = 1e-2


def _cfgs(arch, dtype="float32", **kw):
    kw = {**CASES[arch], **kw, "compute_dtype": dtype}
    return (dataclasses.replace(ref_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def _tree(rc):
    """The reference's parameters as numpy; the VLM's gates non-zero."""
    tree = jax.tree.map(np.asarray, ref_init(ref_family(rc).template(rc),
                                             jax.random.key(0)))
    if rc.family == "vlm":
        rng = np.random.default_rng(3)
        for name in ("gate_attn", "gate_ffn"):
            g = tree["groups"]["cross"][name]
            tree["groups"]["cross"][name] = rng.uniform(
                0.3, 0.9, g.shape).astype(np.float32)
    return tree


def _pair(arch, dtype="float32", **kw):
    """-> (ref cfg, ref params, port cfg, port model) from one tree."""
    rc, pc = _cfgs(arch, dtype, **kw)
    tree = _tree(rc)
    model = C.load_reference_params(C.get_family(pc).build(pc), tree)
    return rc, jax.tree.map(jnp.asarray, tree), pc, model


def _batch(cfg, batch=B, seed=0):
    """-> (reference batch, port batch): tokens and labels (B, S) int32,
    two labels -1, and media for the enc-dec and VLM families."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, S + 1)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:].copy()
    labels[0, 3] = labels[-1, -1] = -1
    b = {"tokens": tokens, "labels": labels}
    if cfg.family in ("encdec", "vlm"):
        b["media"] = (rng.standard_normal(
            (batch, cfg.n_media_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _ref_loss_fn(rc):
    """The reference's ``loss_fn`` (``train/steps.py:38-46``)."""
    fam = ref_family(rc)

    def loss_fn(params, batch):
        params = jax.tree.map(lambda p: p.astype(rc.cdtype()), params)
        logits = fam.forward(params, rc, batch["tokens"],
                             media=batch.get("media"))
        return ref_lm_loss(logits, batch["labels"])
    return loss_fn


def _port_loss(pc, model, batch):
    logits = C.get_family(pc).forward(model, pc, batch["tokens"],
                                      media=batch.get("media"))
    return C.lm_loss(logits, batch["labels"])


def _port_grads(pc, model, batch):
    """-> (loss, {path: the port's per-layer gradients stacked})."""
    model.requires_grad_(True)
    for p in model.parameters():
        p.grad = None
    loss = _port_loss(pc, model, batch)
    loss.backward()
    return float(loss.detach()), _stacked(C.param_tree(model), lambda p: p.grad)


def _stacked(tree, get=lambda t: t):
    """{path: array} of a port tree in the reference's layout: a stacked
    leaf's per-layer tensors stacked on a new leading axis."""
    out = {}
    for path, leaf in leaves_with_paths(tree):
        key = "/".join(str(k) for k in path)
        if isinstance(path[-1], int):       # one layer of a stacked leaf
            key = key.rsplit("/", 1)[0]
            out.setdefault(key, []).append(get(leaf).detach().float().numpy())
        else:
            out[key] = get(leaf).detach().float().numpy()
    return {k: np.stack(v) if isinstance(v, list) else v
            for k, v in out.items()}


def _ref_flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(jnp.asarray(x, jnp.float32))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_l2(a, b):
    nb = np.linalg.norm(b.astype(np.float64))
    d = np.linalg.norm(a.astype(np.float64) - b.astype(np.float64))
    return d / nb if nb > 0 else d


def _assert_trees_close(port, ref, tol, what):
    assert set(port) == set(ref), what
    for key, want in ref.items():
        got = port[key].reshape(want.shape)
        assert _rel_l2(got, want) <= tol, (what, key, _rel_l2(got, want))


# -- loss and gradients --------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(CASES))
def test_loss_and_gradients_equal_reference(arch):
    rc, params, pc, model = _pair(arch)
    rb, pb = _batch(rc)
    loss, grads = jax.jit(jax.value_and_grad(_ref_loss_fn(rc)))(params, rb)
    ploss, pgrads = _port_grads(pc, model, pb)
    assert ploss == pytest.approx(float(loss), rel=1e-5)
    _assert_trees_close(pgrads, _ref_flat(grads),
                        ARCH_TOL.get(arch, GRAD_TOL), "grad")
    assert all(np.isfinite(g).all() for g in pgrads.values())


def _ref_steps(rc, params, batch, tcfg, n):
    step = jax.jit(ref_steps.make_train_step(rc, tcfg))
    state = ref_steps.init_state(rc, params)
    losses = []
    for _ in range(n):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", sorted(CASES))
def test_three_adamw_steps_equal_reference(arch, accum):
    """Three train steps of each package from one start: every step's loss,
    then each parameter's update and both moments; with ``accum_steps=2`` a
    batch of 4 cut into two micro-batches of 2."""
    rc, params, pc, model = _pair(arch)
    rb, pb = _batch(rc, batch=2 * accum)
    rstate, rlosses = _ref_steps(rc, params, rb, ref_steps.TrainConfig(
        accum_steps=accum, opt=RefAdamW(**OPT)), 3)
    state = steps.init_state(pc, model)
    step = steps.make_train_step(pc, steps.TrainConfig(
        accum_steps=accum, opt=AdamWConfig(**OPT)))
    losses = [float(step(state, pb)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(losses, rlosses, rtol=1e-5)
    assert int(state["step"]) == int(rstate["step"]) == 3
    tol = ARCH_TOL.get(arch, GRAD_TOL)
    start = _ref_flat(params)
    _assert_trees_close(
        {k: v - start[k].reshape(v.shape)
         for k, v in _stacked(state["params"]).items()},
        {k: v - start[k] for k, v in _ref_flat(rstate["params"]).items()},
        UPDATE_TOL, "update")
    for name in ("m", "v"):
        _assert_trees_close(_stacked(state["opt"][name]),
                            _ref_flat(rstate["opt"][name]), tol, name)


# -- remat -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(CASES))
def test_remat_policies_give_the_same_gradients(arch):
    """"full", "dots" and "none" recompute the same operations on the same
    inputs: the same gradients bit for bit."""
    rc, _, _, _ = _pair(arch)
    tree = _tree(rc)
    _, pb = _batch(rc)
    out = {}
    for policy in ("full", "dots", "none"):
        _, pc = _cfgs(arch, remat=policy)
        model = C.load_reference_params(C.get_family(pc).build(pc), tree)
        out[policy] = _port_grads(pc, model, pb)
    for policy in ("dots", "none"):
        assert out[policy][0] == out["full"][0]
        for key, g in out["full"][1].items():
            np.testing.assert_array_equal(out[policy][1][key], g,
                                          err_msg=f"{policy} {key}")


def test_remat_runs_layers_under_checkpoint_only_under_grad(monkeypatch):
    """Under grad a layer body goes through ``torch.utils.checkpoint``; a
    serve (no grad) and remat "none" call it directly."""
    calls = []
    real = C.checkpoint
    monkeypatch.setattr(C, "checkpoint", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    _, pc = _cfgs("qwen2_1_5b")
    layer = C.remat(lambda x: x * 2, pc)
    x = torch.ones(3, requires_grad=True)
    layer(x).sum().backward()
    assert len(calls) == 1 and torch.equal(x.grad, torch.full((3,), 2.0))
    with torch.no_grad():
        layer(x)
    C.remat(lambda x: x, dataclasses.replace(pc, remat="none"))(x)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="remat"):
        C.remat(lambda x: x, dataclasses.replace(pc, remat="all"))


# -- bf16 ------------------------------------------------------------------------

def test_bf16_gradients_within_reference_error():
    """qwen2-smoke in bf16 compute (the configs' default): each package's
    gradient against the same package's f32 gradient; the port's distance
    at most twice the reference's plus 2e-2, leaf by leaf."""
    arch = "qwen2_1_5b"
    out = {}
    for dtype in ("float32", "bfloat16"):
        rc, params, pc, model = _pair(arch, dtype)
        rb, pb = _batch(rc)
        _, g = jax.value_and_grad(_ref_loss_fn(rc))(params, rb)
        out[dtype] = (_ref_flat(g), _port_grads(pc, model, pb)[1])
    (r32, p32), (r16, p16) = out["float32"], out["bfloat16"]
    for key in r32:
        ref_err = _rel_l2(r16[key], r32[key])
        port_err = _rel_l2(p16[key].reshape(r32[key].shape), p32[key].reshape(
            r32[key].shape))
        assert port_err <= 2 * ref_err + 2e-2, (key, port_err, ref_err)


# -- the MoE auxiliary loss -----------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16), (1, 33)])
def test_moe_aux_loss_equals_reference(shape):
    rc, params, pc, model = _pair("granite_moe_3b")
    x = np.random.default_rng(5).standard_normal(
        (*shape, rc.d_model)).astype(np.float32)
    want = ref_moe_aux_loss(jax.tree.map(lambda a: a[0],
                                         params["layers"]["ffn"]), rc,
                            jnp.asarray(x))
    got = L.moe_aux_loss(model.layers[0]["ffn"], pc, torch.as_tensor(x))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


# -- Params.cast under grad, and the serve's cache ----------------------------

def test_cast_under_grad_reaches_the_weight_and_leaves_the_serve_cache():
    """Under grad ``Params.cast`` is a cast inside the graph (the f32 leaf
    gets its gradient, nothing is cached); under ``no_grad`` the serve's
    copy is made once, kept, and forgotten by ``drop_casts``."""
    _, pc = _cfgs("qwen2_1_5b")
    model = C.get_family(pc).build(pc)
    for p in model.parameters():
        torch.nn.init.normal_(p)
    attn = model.layers[0]["attn"]
    with torch.no_grad():
        served = attn.cast("wq", torch.bfloat16)
        assert attn.cast("wq", torch.bfloat16) is served
    model.requires_grad_(True)
    assert attn.grad_dtype == pc.cdtype()
    w = attn.cast("wq", torch.bfloat16)
    assert w.requires_grad and w is not served
    (w.float() ** 2).sum().backward()
    assert attn["wq"].grad is not None
    assert torch.equal(attn.wq.grad, 2 * attn.wq.detach().to(
        torch.bfloat16).float())
    assert attn._casts == {("wq", torch.bfloat16): served}
    with torch.no_grad():
        assert attn.cast("wq", torch.bfloat16) is served
        attn["wq"].add_(1.0)
        model.drop_casts()
        fresh = attn.cast("wq", torch.bfloat16)
    assert torch.equal(fresh, attn.wq.detach().to(torch.bfloat16))
    model.requires_grad_(False)
    assert attn.grad_dtype is None and not attn.wq.requires_grad


def test_grad_dtype_casts_every_leaf_read_under_grad():
    """With ``requires_grad_`` the leaves read under grad come in the
    compute type (the reference's cast of the whole tree), norms' scales
    included; outside grad they are the f32 parameters."""
    _, pc = _cfgs("qwen2_1_5b", "bfloat16")
    model = C.get_family(pc).build(pc).requires_grad_(True)
    ln = model.layers[0]["ln1"]
    assert ln["scale"].dtype == torch.bfloat16
    with torch.no_grad():
        assert ln["scale"].dtype == torch.float32
    assert model.layers[0]["attn"].cast("wq", torch.float32).dtype == (
        torch.float32)


def test_train_state_tree_is_the_reference_layout():
    """``param_tree`` has the reference's keys, each stacked leaf the list
    of per-layer parameters; its leaf order is the reference's, each
    stacked leaf's layers in a row (the VLM's nested stacks (group,
    layer))."""
    for arch in ("qwen2_1_5b", "llama32_vision_90b", "whisper_large_v3"):
        rc, params, pc, model = _pair(arch)
        tree = C.param_tree(model)
        ref = _ref_flat(params)
        assert list(_stacked(tree)) == list(ref)
        for key, want in ref.items():
            np.testing.assert_array_equal(_stacked(tree)[key].reshape(
                want.shape), want)
        assert len(leaves(tree)) == len(list(model.parameters()))
