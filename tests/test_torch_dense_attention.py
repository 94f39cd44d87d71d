"""The reference's dense attention in the port (``attention_impl="dense"``,
the dry run's "baseline" profile) against the reference's, on the CPU.

The reference's parameters (``init_params(..., jax.random.key(0))``) are
carried into the port; inputs come from a numpy seed.  In f32 compute the
two packages differ only in the order of f32 sums: ``atol = rtol = 1e-5``
on the attention layer's output.  The cases: qwen2's GQA (12 q heads to 2
KV heads in the smoke config's 4 to 2), gemma3's sliding window (a local
and a global layer), deepseek-v2's MLA prefill.  The default,
``attention_impl="chunked"``, keeps K5: a dense layer calls it not once,
a chunked one once."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.nn import layers as RL
from repro.nn.param import init_params as ref_init
from repro_torch.configs import get_config
from repro_torch.models.common import _fill
from repro_torch.nn import layers as L
from repro_torch.nn.param import Params

B, S = 2, 16
TOL = dict(atol=1e-5, rtol=1e-5)

#: (arch, is_global): the GQA, windowed and MLA cases
CASES = [("qwen2-1.5b", True), ("gemma3-12b", False), ("gemma3-12b", True),
         ("deepseek-v2-236b", True)]


def _pair(arch, impl):
    kw = dict(compute_dtype="float32", attention_impl=impl)
    rc = dataclasses.replace(ref_config(arch, smoke=True), **kw)
    pc = dataclasses.replace(get_config(arch, smoke=True), **kw)
    template = RL.mla_template if pc.use_mla else RL.attention_template
    tree = ref_init(template(rc), jax.random.key(0))
    params = Params((L.mla_template if pc.use_mla
                     else L.attention_template)(pc))
    _fill(params, jax.tree.map(np.asarray, tree))
    return rc, tree, pc, params


def _run(arch, is_global, impl, seed=0):
    """-> (the reference's output, the port's, the port's K5 calls)."""
    rc, tree, pc, params = _pair(arch, impl)
    x = np.random.default_rng(seed).normal(
        size=(B, S, pc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if pc.use_mla:
        want = RL.mla_apply(tree, rc, jnp.asarray(x), jnp.asarray(pos))
    else:
        want = RL.attention_apply(tree, rc, jnp.asarray(x), jnp.asarray(pos),
                                  jnp.asarray(is_global))
    k5 = L._k5.flash_attention
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return k5(*a, **kw)

    with mock.patch.object(L._k5, "flash_attention", counted):
        tp = torch.as_tensor(pos)
        got = (L.mla_apply(params, pc, torch.as_tensor(x), tp) if pc.use_mla
               else L.attention_apply(params, pc, torch.as_tensor(x), tp,
                                      is_global))
    return np.asarray(want), got.detach().numpy(), len(calls)


@pytest.mark.parametrize("arch,is_global", CASES)
def test_dense_attention_equals_the_references(arch, is_global):
    want, got, calls = _run(arch, is_global, "dense")
    assert calls == 0
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch,is_global", CASES)
def test_chunked_attention_stays_on_k5(arch, is_global):
    """The default sends the layer's attention to K5, once; at the smoke
    configs' 16 positions the reference's "chunked" is its dense path
    (chunks start at 8192), so the two agree within K5's f32 rounding of
    the probabilities, which the dense path rounds to the compute type."""
    want, got, calls = _run(arch, is_global, "chunked")
    assert calls == 1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_window_bites_in_the_smoke_config():
    """gemma3-smoke's window is shorter than the 16 positions, so a local
    layer's dense mask differs from a global one's."""
    cfg = get_config("gemma3-12b", smoke=True)
    assert 0 < cfg.window < S
    local = _run("gemma3-12b", False, "dense")[1]
    glob = _run("gemma3-12b", True, "dense")[1]
    assert not np.allclose(local, glob)


def test_unknown_attention_impl_is_refused():
    _, _, pc, params = _pair("qwen2-1.5b", "chunked")
    pc = dataclasses.replace(pc, attention_impl="flash")
    x = torch.zeros((B, S, pc.d_model))
    pos = torch.arange(S).expand(B, S)
    with pytest.raises(ValueError, match="attention_impl"):
        L.attention_apply(params, pc, x, pos, True)
