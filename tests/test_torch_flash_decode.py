"""The port's flash-decode (``repro_torch.nn.layers.gqa_decode_block``,
``mla_decode_block``) against the JAX package, on the CPU.

Under a mesh whose rules split a decode cache's positions over ranks
(``cache_seq``), each rank runs the decode attention's local step on its
own block of positions and the blocks combine by all-reduces of the
softmax's max and sum and of the output.  Here the blocks lie side by side
on one device: the cache's T = 64 positions cut into n in {1, 2, 4, 8}
blocks and stacked on the batch (``layers.fold_blocks``), the all-reduces
a max or sum over the stack (``layers.block_reduce``): the same functions
the mesh calls, with the collectives replaced.  The result is held to the
reference's whole-positions attention on the same arrays (seeded numpy,
f32): ``repro.nn.layers._gqa_scores_softmax_out`` for GQA (causal, and the
window of 8 on a local and on a global layer, so that whole blocks are
masked; GQA ratios 1 and 4) and ``repro.nn.layers.mla_decode`` for MLA's
absorbed form (the port's ``mla_decode`` with its attention split into
blocks).  The position is 0, a block boundary (32), inside a block (37) and
T - 1.

Tolerance: relative L2 :data:`REL_L2` = 1e-5 (f32; the split sums the
softmax's denominator and the output in another order).  Two planted
faults must exceed it: one block's partials dropped from the sums (the
block that holds the position), and each block's own maximum used in place
of the global one.
"""
import dataclasses

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

#: the split against the whole-positions reference, f32
REL_L2 = 1e-5

B, T, D = 2, 64, 16
BLOCKS = (1, 2, 4, 8)
POSITIONS = (0, 32, 37, T - 1)
WINDOW = 8
#: mask kind -> (window, is_global)
MASKS = {"causal": (0, True), "local": (WINDOW, False),
         "global": (WINDOW, True)}
#: (q heads, KV heads)
HEADS = ((4, 4), (8, 2))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _dropping(n: int, block: int):
    """A planted fault: :func:`layers.block_reduce` with ``block``'s
    partials left out of every sum."""
    def reduce(x, op):
        xs = x.unflatten(0, (n, -1))
        keep = torch.arange(n) != block
        r = xs.amax(0) if op == "max" else xs[keep].sum(0)
        return r.repeat(n, *(1,) * (r.dim() - 1))
    return reduce


def _local_max(n: int):
    """A planted fault: each block's own maximum in place of the global
    one (the sums still reduced)."""
    whole = L.block_reduce(n)
    return lambda x, op: x if op == "max" else whole(x, op)


def _gqa_inputs(H, K, pos, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, K, D)).astype(np.float32)
    v = rng.normal(size=(B, T, K, D)).astype(np.float32)
    window, is_global = MASKS[mask_kind]
    dk = pos - np.arange(T)
    mask = dk >= 0
    if window > 0 and not is_global:
        mask &= dk < window
    mask = np.broadcast_to(mask, (B, 1, 1, 1, T)).copy()
    return q, k, v, mask


def _gqa_split(q, k, v, mask, n, reduce=None):
    """The port's local step and combine on ``n`` blocks side by side."""
    q, k, v, mask = map(torch.as_tensor, (q, k, v, mask))
    out = L.gqa_decode_block(q.repeat(n, 1, 1, 1), L.fold_blocks(k, n),
                             L.fold_blocks(v, n), L.fold_blocks(mask, n, 4),
                             reduce or L.block_reduce(n))
    assert bool(torch.isfinite(out).all())
    return out[:B].numpy()


def _gqa_reference(q, k, v, mask):
    return np.asarray(RL._gqa_scores_softmax_out(
        None, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask)))


@pytest.mark.parametrize("heads", HEADS, ids=["mha", "gqa4"])
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("n", BLOCKS)
def test_gqa_split_equals_reference(n, pos, mask_kind, heads):
    q, k, v, mask = _gqa_inputs(*heads, pos, mask_kind)
    rel = _rel_l2(_gqa_split(q, k, v, mask, n), _gqa_reference(q, k, v, mask))
    assert rel <= REL_L2, rel


def test_whole_blocks_are_masked_in_the_window_cases():
    """The local layer's window at position 37 leaves six of eight blocks
    with no position unmasked, and each of them adds nothing."""
    _q, _k, _v, mask = _gqa_inputs(8, 2, 37, "local")
    held = mask[0, 0, 0, 0].reshape(8, T // 8).any(1)
    assert held.tolist() == [False] * 3 + [True] * 2 + [False] * 3


@pytest.mark.parametrize("fault", ["dropped block", "local max"])
@pytest.mark.parametrize("mask_kind,pos", [("causal", T - 1),
                                           ("local", 37)])
@pytest.mark.parametrize("n", BLOCKS[1:])
def test_gqa_planted_faults_fail_the_gate(n, mask_kind, pos, fault):
    q, k, v, mask = _gqa_inputs(8, 2, pos, mask_kind)
    reduce = (_dropping(n, pos // (T // n)) if fault == "dropped block"
              else _local_max(n))
    rel = _rel_l2(_gqa_split(q, k, v, mask, n, reduce),
                  _gqa_reference(q, k, v, mask))
    assert rel > 100 * REL_L2, rel


# -- MLA's absorbed decode ---------------------------------------------------

ARCH = "deepseek_v2_236b"


def _mla_setup(pos, seed=0):
    """deepseek-smoke's MLA layer in f32 (the reference's parameters
    carried across), a token and f32 caches of random rows."""
    kw = dict(compute_dtype="float32")
    rc = dataclasses.replace(ref_config(ARCH, smoke=True), **kw)
    pc = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
    tree = ref_init(RL.mla_template(rc), jax.random.key(seed))
    params = Params(L.mla_template(pc))
    _fill(params, jax.tree.map(np.asarray, tree))
    rng = np.random.default_rng(seed + pos)
    x = rng.normal(size=(B, 1, pc.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, T, pc.kv_lora_rank)).astype(np.float32)
    krope = rng.normal(size=(B, T, pc.qk_rope_dim)).astype(np.float32)
    want, _, _ = RL.mla_decode(tree, rc, jnp.asarray(x.copy()),
                               jnp.asarray(ckv.copy()),
                               jnp.asarray(krope.copy()), jnp.int32(pos))
    return pc, params, x, ckv, krope, np.asarray(want)


def _mla_split(monkeypatch, pc, params, x, ckv, krope, pos, n, reduce=None):
    """The port's ``mla_decode`` with its attention run on ``n`` blocks of
    the compressed cache side by side (its other steps as they are)."""
    def split(q_abs, q_rope, ck, kr, p, scale):
        Bq, Tc = ck.shape[:2]
        mask = torch.arange(Tc).expand(Bq, Tc) <= p
        out = L.mla_decode_block(
            q_abs.repeat(n, 1, 1, 1), q_rope.repeat(n, 1, 1, 1),
            L.fold_blocks(ck, n), L.fold_blocks(kr, n),
            L.fold_blocks(mask, n)[:, None, None, :], scale,
            reduce or L.block_reduce(n))
        assert bool(torch.isfinite(out).all())
        return out[:Bq]

    monkeypatch.setattr(L, "_mla_attention", split)
    got, _, _ = L.mla_decode(params, pc, torch.as_tensor(x),
                             torch.as_tensor(ckv), torch.as_tensor(krope),
                             torch.full((1,), pos, dtype=torch.int64))
    return got.numpy()


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("n", BLOCKS)
def test_mla_split_equals_reference(monkeypatch, n, pos):
    pc, params, x, ckv, krope, want = _mla_setup(pos)
    got = _mla_split(monkeypatch, pc, params, x, ckv, krope, pos, n)
    rel = _rel_l2(got, want)
    assert rel <= REL_L2, rel


@pytest.mark.parametrize("fault", ["dropped block", "local max"])
@pytest.mark.parametrize("n", BLOCKS[1:])
def test_mla_planted_faults_fail_the_gate(monkeypatch, n, fault):
    pos = 37
    pc, params, x, ckv, krope, want = _mla_setup(pos)
    reduce = (_dropping(n, pos // (T // n)) if fault == "dropped block"
              else _local_max(n))
    got = _mla_split(monkeypatch, pc, params, x, ckv, krope, pos, n, reduce)
    rel = _rel_l2(got, want)
    assert rel > 100 * REL_L2, rel


def test_whole_positions_take_the_reference_path():
    """A plain cache, or a DTensor-free call, never counts as split: the
    un-meshed decode keeps its bits (``test_torch_decode_graph.py`` holds
    them)."""
    assert not L.positions_split(torch.zeros((B, T, 2, D)))
