"""K3 (``csrc/epoch.cu``) on the CPU: an emulation of the kernel's own
algorithm (feasibility counts kept in the grant; on pooled PS-DSF /
rPS-DSF the grid's two-phase select over a split of the cells) against its
plain version, which the wrapper runs for CPU tensors, and against the
reference's Pallas kernel in interpret mode, on the same numpy inputs.
Equality is exact: every grant and every state array."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypo import given, settings, st
from repro.kernels.epoch_persistent.ops import persistent_epoch as pallas_epoch
from repro_torch.core import engine_torch
from repro_torch.kernels.epoch_persistent import ref

PAIRS = [(c, p) for c in ("drf", "tsf", "psdsf", "rpsdsf")
         for p in ("pooled", "rrr")]
# blocks of the grid shape: the card's 132, one slice, uneven slices, and
# more blocks than the small shapes have groups
GRIDS = [132, 2, 3, 7, 64]
NAMES = "ns js count X tot FREE used pidx pos".split()


def instance(seed, N, J, R, *, pad_n=0, pad_j=0):
    """Quarter-quantized demands against integer capacities (exact sums),
    phi in {0.5, 1, 2}, random placement; the last ``pad_n`` frameworks
    and ``pad_j`` servers padded as the engine pads them."""
    rng = np.random.default_rng(seed)
    D = rng.integers(1, 9, (N, R)) / 4
    C = rng.integers(2, 9, (J, R)).astype(np.float64)
    wanted = rng.integers(1, 7, N).astype(np.float64)
    allowed = rng.random((N, J)) > 0.25
    if pad_n:
        D[N - pad_n:] = 0.0
        wanted[N - pad_n:] = 0.0
        allowed[N - pad_n:] = False
    if pad_j:
        C[J - pad_j:] = 0.0
        allowed[:, J - pad_j:] = False
    return dict(X=np.zeros((N, J)), D=D, TD=D, C=C, FREE=C.copy(),
                phi=np.array([0.5, 1.0, 2.0])[np.arange(N) % 3],
                wanted=wanted, allowed=allowed)


CASES = {
    # name: (seed, N, J, R, pad_n, pad_j, lookahead, limit, max_steps)
    "base": (0, 16, 32, 2, 0, 0, False, 2, 256),
    "lookahead, no limit": (1, 24, 64, 3, 0, 0, True, 0, 256),
    "padded, R 4": (2, 64, 256, 4, 13, 56, False, 3, 512),
}


def state_of(k, crit, pol, lookahead, limit, seed, pad_j=0):
    """The kernel's arguments; RRR permutations of the real servers, the
    padded ones after them, as the engine draws them."""
    J = k["C"].shape[0]
    real = J - pad_j
    prng = np.random.default_rng(seed + 100)
    perms = np.tile(np.arange(J), (16 if pol == "rrr" else 1, 1))
    if pol == "rrr":
        for row in perms:
            row[:real] = prng.permutation(real)
    t = {name: torch.as_tensor(v) for name, v in k.items()}
    return engine_torch.epoch_state(
        t["X"], t["D"], t["TD"], t["C"], t["FREE"], t["phi"], t["wanted"],
        t["allowed"], torch.as_tensor(perms.astype(np.int32)),
        torch.zeros(J, dtype=torch.int32), 0, 0, real, limit, 1e-9,
        kind=crit, lookahead=lookahead, use_limit=bool(limit))


def fresh(state):
    return tuple(a.clone() if torch.is_tensor(a) else a for a in state)


def assert_same(got, want, got_in, want_in, what):
    for a, b, name in zip(got, want, NAMES):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), \
            f"{what}: {name}"
    # in place: s, cap, dom, feas
    for i, name in ((5, "s"), (3, "cap"), (4, "dom"), (6, "feas")):
        assert torch.equal(got_in[i], want_in[i]), f"{what}: {name}"


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("crit,pol", PAIRS)
def test_emulation_equals_plain_and_pallas(crit, pol, case):
    """Every split of the cells gives the plain version's grants and state;
    the grants are the reference kernel's too."""
    seed, N, J, R, pad_n, pad_j, la, limit, max_steps = CASES[case]
    k = instance(seed, N, J, R, pad_n=pad_n, pad_j=pad_j)
    state = state_of(k, crit, pol, la, limit, seed, pad_j)
    kw = dict(kind=crit, policy=pol, lookahead=la, use_limit=bool(limit),
              max_steps=max_steps)
    want_in = fresh(state)
    want = ref.persistent_epoch_ref(*want_in, **kw)
    count = int(want[2])
    assert 0 < count < max_steps
    for grid in GRIDS if (crit, pol) in (
            ("psdsf", "pooled"), ("rpsdsf", "pooled")) else GRIDS[:1]:
        got_in = fresh(state)
        got = ref.persistent_epoch_emulated(*got_in, **kw, grid=grid)
        assert_same(got, want, got_in, want_in,
                    f"{crit}/{pol} {case}, grid {grid}")
    if case != "padded, R 4":       # the interpreter is slow at that size
        # copies, and a blocking read: JAX on the CPU may alias numpy memory
        pallas = jax.block_until_ready(pallas_epoch(
            *(jnp.array(a.numpy()) if torch.is_tensor(a) else a
              for a in state), interpret=True, **kw))
        for a, b, name in zip(want, pallas, NAMES):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{crit}/{pol} {name}")


@pytest.mark.parametrize("crit,pol", PAIRS)
def test_segments_cut_by_max_steps_resume(crit, pol):
    """An epoch cut into segments of 5 grants, each resumed from the state
    and the RRR cursor the last one left, as the engine chains them: the
    grants are one epoch's, and every launch counts its masks anew."""
    k = instance(3, 16, 32, 2)
    state = state_of(k, crit, pol, False, 2, 3)
    kw = dict(kind=crit, policy=pol, lookahead=False, use_limit=True)
    want_in = fresh(state)
    want = ref.persistent_epoch_ref(*want_in, **kw, max_steps=256)
    total = int(want[2])
    assert total > 10
    seq, cur = [], fresh(state)
    while True:
        out = ref.persistent_epoch_emulated(*cur, **kw, max_steps=5,
                                            grid=3)
        c = int(out[2])
        seq += list(zip(out[0][:c].tolist(), out[1][:c].tolist()))
        if c < 5:
            break
        X, tot, FREE, used = out[3], out[4], out[5], out[6]
        assert X is cur[0] and used is cur[7]       # updated in place
        cur = cur[:16] + (int(out[7]), int(out[8])) + cur[18:]
    assert seq == list(zip(want[0][:total].tolist(),
                           want[1][:total].tolist()))
    assert_same(out[3:7], want[3:7], cur, want_in, f"{crit}/{pol} chained")


def test_rrr_wraps_and_starts_new_rounds():
    """The RRR cases wrap: the cursor ends past the first permutation."""
    k = instance(0, 16, 32, 2)
    state = state_of(k, "rpsdsf", "rrr", False, 2, 0)
    out = ref.persistent_epoch_emulated(
        *fresh(state), kind="rpsdsf", policy="rrr", lookahead=False,
        use_limit=True, max_steps=256)
    assert int(out[7]) >= 1


def test_grid_blocks_split_the_float4_groups():
    """Blocks 1.. own contiguous slices of 4-cell groups."""
    blocks = ref.grid_blocks(2, 16, 3)               # 8 groups, 4 a block
    assert blocks.tolist() == [1] * 16 + [2] * 16
    assert ref.grid_blocks(1, 12, 3).tolist() == [1] * 8 + [2] * 4


def _near_tied(seed, n, planted):
    """Masked scores of ``n`` cells, quarter-quantized from 1 up, with the
    ``planted`` (index, score) pairs."""
    rng = np.random.default_rng(seed)
    masked = torch.as_tensor(rng.integers(4, 40, n) / 4, dtype=torch.float32)
    for i, v in planted:
        masked[i] = float(v)
    return masked


@pytest.mark.parametrize("planted,near_tie", [
    # an exact tie across blocks: each part's first is exact
    ([(90, 0.5), (10, 0.5)], False),
    # a near-tie within one block: its own tolerance is the global one
    ([(20, 0.5), (12, np.float32(0.5) * np.float32(1 + 5e-7))], False),
    # near-tied parts: block 1's least (0.5 + 4 ulp) sets a tolerance that
    # admits its cell 3 (0.5 + 9 ulp), which the global one (from 0.5 at
    # cell 90) does not: the near-tie round
    ([(90, 0.5), (30, np.nextafter(np.float32(0.5), 1, dtype=np.float32)
                  * np.float32(1 + 7e-7)),
      (3, np.float32(0.5) * np.float32(1 + 1.5e-6))], True),
    # a row-and-column part (block 0) that wins
    ([(44, 0.25), (90, 0.25)], False),
])
def test_grid_pick_equals_the_tie_low_rule(planted, near_tie):
    """The one-barrier pick is the plain tie-low rule (the first index
    within 1e-9 + 1e-6 |min| of the minimum) on exact ties, on near-ties
    inside one part and across parts, and where the granting block's row
    and column hold the pick."""
    from repro_torch.core.engine_torch import _argmin_tie_low

    masked = _near_tied(len(planted), 128, planted)
    held = torch.zeros(128, dtype=torch.bool)
    held[40:48] = True                        # block 0's row
    blocks = ref.grid_blocks(1, 128, 5)       # 32 cells a block
    got, ran = ref.grid_pick(masked, held, blocks, 5)
    want = int(_argmin_tie_low(masked, torch.ones(128, dtype=torch.bool)))
    assert (got, ran) == (want, near_tie)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10_000), pair=st.sampled_from(PAIRS),
       grid=st.integers(2, 9))
def test_counts_equal_the_mask_after_every_grant(seed, pair, grid):
    """After every grant the kept counts are the mask's row and column
    sums and their total, whatever the instance and the split."""
    crit, pol = pair
    rng = np.random.default_rng(seed)
    N, J = int(rng.integers(2, 20)), 4 * int(rng.integers(1, 12))
    la, limit = bool(rng.integers(2)), int(rng.integers(0, 3))
    k = instance(seed, N, J, int(rng.integers(1, 4)))
    state = state_of(k, crit, pol, la, limit, seed)
    seen = []

    def on_grant(feas, rowcnt, colcnt, total):
        assert torch.equal(rowcnt, feas.sum(1, dtype=torch.int32))
        assert torch.equal(colcnt, feas.sum(0, dtype=torch.int32))
        assert total == int(feas.sum())
        seen.append(total)

    kw = dict(kind=crit, policy=pol, lookahead=la, use_limit=bool(limit),
              max_steps=128)
    ref.persistent_epoch_emulated(*fresh(state), **kw, grid=grid,
                                  on_grant=on_grant)
    assert len(seen) == int(ref.persistent_epoch_ref(*fresh(state),
                                                     **kw)[2])
