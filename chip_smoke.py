#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--phases kernels,allocator,des] [--seed 0]

Run from the root of a checkout; it needs one CUDA card and builds every
kernel from the sources in the checkout (nvcc into ``build/``, Triton at
first launch).  Phases:

0. header: the card's name and power limit, then the kernel builds;
1. kernels: each kernel against its plain PyTorch version on the card at
   the fleet shapes, exact equality required (K1 at (512,) and (4096,),
   K2 at (512, 4096), random quantized scores with about half masked plus
   an all-masked case; K3 whole epochs for 4 criteria x {pooled, rrr});
   times of kernel, plain version and the PyTorch yardstick call;
2. allocator: the main path, ``OnlineAllocator(device="cuda")`` with
   ``begin_epoch(use_kernel="fused")``/``commit_epoch``, 3 epochs per
   criterion x policy at the fleet size (512 frameworks x 4096 agents), on
   the default persistent kernel; each epoch is then replayed through
   ``engine_torch.run_epoch`` from its frozen view on the plain loop, on
   the tiles loop (K1/K2) and on the tiles loop with K1's and K2's plain
   versions.  Persistent must equal the plain loop and the tiles loop its
   plain-select run, grant for grant; tiles against the plain loop may
   differ only on a tie (exact across 128-wide tiles, or within the f32
   tie tolerance), as the reference's tile kernels do.  On the paper's
   6-agent cluster the fused path must equal the numpy epoch;
3. des: ``SparkMesosSim`` at the fleet size with async fused epochs, run
   until every job has finished, and a small simulation that must equal
   the same simulation on the CPU.

After every phase the allocator fault counters must be zero.  Launches
are counted per path, from zero just before it to just after it: K3 over
the allocator's fleet epochs, K1/K2 over the tiles-loop replays; each
must have launched.  The last lines are the kernels
JSON, the ``nvidia-smi`` name and power limit, and the device JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

FLEET_N, FLEET_J = 512, 4096
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")
POLICIES = ("pooled", "rrr")


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- the fleet configuration -------------------------------------------------

def fleet(n_fw=FLEET_N, n_agents=FLEET_J):
    """Agents split in thirds over the paper's three agent types; PI and WC
    frameworks alternating, phi cycling (0.5, 1, 2), 12 executors wanted,
    every 8th framework placed on the (8, 8) agents only."""
    from repro_torch.core.simulator import HETEROGENEOUS_AGENTS, PI, WC

    types = []
    for _name, cap in HETEROGENEOUS_AGENTS:
        if cap not in types:
            types.append(cap)
    agents = [(f"agent{j:05d}", types[3 * j // n_agents])
              for j in range(n_agents)]
    narrow = [a for a, cap in agents if cap == (8.0, 8.0)]
    fws = [dict(fid=f"fw{i:04d}", demand=(PI if i % 2 == 0 else WC).demand,
                wanted=PI.max_executors, phi=(0.5, 1.0, 2.0)[i % 3],
                allowed=narrow if i % 8 == 7 else None)
           for i in range(n_fw)]
    return agents, fws


def fleet_arrays(agents, fws):
    names = [a for a, _ in agents]
    col = {a: j for j, a in enumerate(names)}
    N, J = len(fws), len(agents)
    allowed = np.ones((N, J), bool)
    for i, f in enumerate(fws):
        if f["allowed"] is not None:
            allowed[i] = False
            allowed[i, [col[a] for a in f["allowed"]]] = True
    D = np.array([f["demand"] for f in fws], np.float64)
    C = np.array([c for _, c in agents], np.float64)
    return dict(X=np.zeros((N, J)), D=D, TD=D.copy(), C=C, FREE=C.copy(),
                phi=np.array([f["phi"] for f in fws]),
                wanted=np.array([float(f["wanted"]) for f in fws]),
                allowed=allowed)


def build_allocator(agents, fws, crit, pol, device, seed):
    from repro_torch.core.online import OnlineAllocator

    al = OnlineAllocator(2, criterion=crit, server_policy=pol, seed=seed,
                         device=device)
    for name, cap in agents:
        al.add_agent(name, cap)
    for f in fws:
        al.register(f["fid"], demand=f["demand"], wanted_tasks=f["wanted"],
                    phi=f["phi"], allowed_agents=f["allowed"])
    return al


def check_faults(al, where):
    fs = al.fault_stats
    bad = {k: getattr(fs, k) for k in ("dispatch_failures", "commit_failures",
                                       "host_fallbacks")}
    check(not any(bad.values()), f"{where}: fault counters {bad}")


# -- timing ------------------------------------------------------------------

def cuda_ms(fn, reps, warmup=2):
    """Mean device time of fn() over reps runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 1: kernels against their plain versions ---------------------------

def kernels_phase(rng, dev, agents, fws):
    import torch

    from repro_torch.core import engine_torch
    from repro_torch.kernels.epoch_persistent import ops as k3
    from repro_torch.kernels.epoch_persistent.ref import persistent_epoch_ref
    from repro_torch.kernels.psdsf_score import ops as tiles

    rows = {}

    def scores(shape):
        # quarter-quantized scores: plenty of exact ties, across tiles too
        return torch.as_tensor(
            np.round(rng.standard_normal(shape) * 4) / 4, dtype=torch.float32,
            device=dev)

    # K1 / K2: exact (val, index) equality, random and all-masked inputs
    for L in (FLEET_N, FLEET_J):
        s = scores(L)
        ok = torch.as_tensor(rng.random(L) < 0.5, device=dev)
        for okv in (ok, torch.zeros_like(ok)):
            got = tiles.masked_argmin1d(s, okv)
            want = tiles.masked_argmin1d_ref(s, okv)
            check(int(got[1]) == int(want[1]) and float(got[0]) ==
                  float(want[0]), f"K1 at ({L},): {got} != {want}")
        masked = torch.where(ok, s, tiles.BIG)
        ms = cuda_ms(lambda: tiles.masked_argmin1d(s, ok), 200)
        plain = cuda_ms(lambda: tiles.masked_argmin1d_ref(s, ok), 200)
        lib = cuda_ms(lambda: torch.min(masked, dim=0), 200)
        log(f"K1 masked_argmin1d ({L},): {ms:.4f} ms, plain {plain:.4f} ms, "
            f"torch.min {lib:.4f} ms")
        if L == FLEET_N:
            rows["masked_argmin1d"] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, max_abs_err=0.0,
                bound_ms=(L * 5 + 8) / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes")
    s = scores((FLEET_N, FLEET_J))
    feas = torch.as_tensor(rng.random((FLEET_N, FLEET_J)) < 0.5, device=dev)
    for fv in (feas, torch.zeros_like(feas)):
        got = tiles.masked_argmin2d(s, fv)
        want = tiles.masked_argmin2d_ref(s, fv)
        check([float(got[0]), int(got[1]), int(got[2])] ==
              [float(want[0]), int(want[1]), int(want[2])],
              f"K2 at {tuple(s.shape)}: {got} != {want}")
    masked = torch.where(feas, s, tiles.BIG).reshape(-1)
    ms = cuda_ms(lambda: tiles.masked_argmin2d(s, feas), 100)
    plain = cuda_ms(lambda: tiles.masked_argmin2d_ref(s, feas), 20)
    lib = cuda_ms(lambda: torch.min(masked, dim=0), 100)
    log(f"K2 masked_argmin2d {tuple(s.shape)}: {ms:.4f} ms, plain "
        f"{plain:.4f} ms, torch.min {lib:.4f} ms")
    rows["masked_argmin2d"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, max_abs_err=0.0,
        bound_ms=(s.numel() * 5 + 12) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes")

    # K3: whole fleet epochs, every returned and in-place array equal
    arr = fleet_arrays(agents, fws)
    N, J = arr["X"].shape
    bound = engine_torch.grant_bound(arr["TD"], arr["FREE"],
                                     arr["X"].sum(1), arr["wanted"], 1)
    max_steps = engine_torch._bucket(bound, lo=16)
    t = {k: torch.as_tensor(v, device=dev) for k, v in arr.items()}
    for crit in CRITERIA:
        for pol in POLICIES:
            if pol == "rrr":
                K = engine_torch.rrr_perm_budget(bound, J)
                perms = np.stack([rng.permutation(J) for _ in range(K)])
            else:
                perms = np.arange(J)[None, :]
            perms = torch.as_tensor(perms, dtype=torch.int32, device=dev)
            state = engine_torch.epoch_state(
                t["X"], t["D"], t["TD"], t["C"], t["FREE"], t["phi"],
                t["wanted"], t["allowed"], perms,
                torch.zeros(J, dtype=torch.int32, device=dev), 0, 0, J, 1,
                1e-9, kind=crit, lookahead=False, use_limit=True)
            kw = dict(kind=crit, policy=pol, lookahead=False, use_limit=True,
                      max_steps=max_steps)

            def fresh():
                return tuple(a.clone() if torch.is_tensor(a) else a
                             for a in state)

            a_in, b_in = fresh(), fresh()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = k3.persistent_epoch(*a_in, **kw)
            torch.cuda.synchronize()
            t_kernel = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            b = persistent_epoch_ref(*b_in, **kw)
            torch.cuda.synchronize()
            t_plain = (time.perf_counter() - t0) * 1e3
            # returned arrays, then the in-place s, feas, dom, cap
            pairs = list(zip(a, b)) + [(a_in[i], b_in[i]) for i in (5, 3, 4)]
            pairs.append((a_in[6].view(torch.bool) if a_in[6].dtype ==
                          torch.uint8 else a_in[6], b_in[6]))
            err = 0.0
            for x, y in pairs:
                check(torch.equal(x, y),
                      f"K3 {crit}/{pol}: kernel and plain version differ")
                if x.is_floating_point():
                    err = max(err, float((x - y).abs().max()))
            count = int(a[2])
            reps = 3 if (crit, pol) == ("rpsdsf", "pooled") else 1
            ms = cuda_ms(lambda: k3.persistent_epoch(*fresh(), **kw), reps,
                         warmup=0)
            log(f"K3 persistent_epoch {crit}/{pol}: {count} grants, "
                f"{ms:.2f} ms ({ms / max(count, 1) * 1e3:.1f} us/grant; "
                f"first launch {t_kernel:.2f} ms), plain {t_plain:.1f} ms")
            if (crit, pol) == ("rpsdsf", "pooled"):
                state_bytes = sum(x.numel() * x.element_size()
                                  for x in state[:8])
                const_bytes = sum(x.numel() * x.element_size()
                                  for x in state[8:16])
                nbytes = const_bytes + 2 * state_bytes + 8 * count + 12
                ops = count * N * J
                bound_ms = max(nbytes / HBM_BYTES_PER_S,
                               ops / F32_OPS_PER_S) * 1e3
                rows["persistent_epoch"] = dict(
                    ms=ms, plain_ms=t_plain, library_ms=None,
                    max_abs_err=err, bound_ms=bound_ms,
                    bound_by=("operations" if ops / F32_OPS_PER_S >
                              nbytes / HBM_BYTES_PER_S else "bytes"))
    return rows


# -- phase 2: the allocator main path ----------------------------------------

LAUNCH_COUNTERS = ("masked_argmin1d", "masked_argmin2d", "persistent_epoch")


def counters():
    from repro_torch.kernels.epoch_persistent import ops as k3
    from repro_torch.kernels.psdsf_score import ops as tiles

    return {"masked_argmin1d": tiles.masked_argmin1d,
            "masked_argmin2d": tiles.masked_argmin2d,
            "persistent_epoch": k3.persistent_epoch}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def replay(crit, pol, ep, dev, kernel):
    """The allocator's fused epoch ``ep`` again, through the engine's entry
    point, from its frozen view with the rng rewound to the epoch's start
    (the allocator's own recovery replay): -> the (n, j) grant sequence."""
    from repro_torch.core import engine_torch

    rng = np.random.default_rng()
    rng.bit_generator.state = ep.rng_state0
    v = ep.view
    return engine_torch.run_epoch(
        crit, pol, X=v.X, D=v.D, C=v.C, FREE=v.FREE, phi=v.phi,
        allowed=v.allowed, wanted=v.wanted, true_demands=ep.TD,
        per_agent_limit=ep.per_agent_limit, lookahead=False, rng=rng,
        kernel=kernel, device=dev)


def plain_selects():
    """Swap the tiles loop's two selects for K1's and K2's plain versions,
    so that the same loop runs once with the kernels and once without."""
    from contextlib import ExitStack
    from unittest import mock

    from repro_torch.core import engine_torch
    from repro_torch.kernels.psdsf_score import ops as tiles

    def argmin1d(vec, ok):
        return tiles.masked_argmin1d_ref(vec, ok)[1]

    def argmin2d(mat, ok):
        _, n, j = tiles.masked_argmin2d_ref(mat, ok)
        return n, j

    stack = ExitStack()
    stack.enter_context(mock.patch.object(engine_torch, "_tiles_1d", argmin1d))
    stack.enter_context(mock.patch.object(engine_torch, "_tiles_2d", argmin2d))
    return stack


def first_tie(ep, seq_ref, seq_tiles, crit, dev):
    """Explain the first divergence of the tiles loop from the plain loop.
    -> a description if both picks are feasible and tied, else None.  Two
    ties are the reference's own caveats of its tile kernels: an exact tie
    across 128-wide tiles (tile order wins), and an f32 near-tie inside the
    tolerance 1e-9 + 1e-6 |min| (the plain rule takes the lower index, the
    tile kernels the strict minimum)."""
    import torch

    from repro_torch.core import engine_torch
    from repro_torch.kernels.psdsf_score.ops import _block

    view, TD = ep.view, ep.TD
    k = next(i for i, (x, y) in enumerate(zip(seq_ref, seq_tiles)) if x != y)
    X, FREE = view.X.copy(), view.FREE.copy()
    used = np.zeros(len(view.agents), np.int32)
    for n, j in seq_ref[:k]:
        X[n, j] += 1
        FREE[j] -= TD[n]
        used[j] += 1
    g = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    st = engine_torch.epoch_state(
        g(X), g(view.D), g(TD), g(view.C), g(FREE), g(view.phi),
        g(view.wanted), g(view.allowed), None, g(used), 0, 0,
        len(view.agents), 1, 1e-9, kind=crit, lookahead=False,
        use_limit=True)
    s, feas = st[5], st[6]
    picks = [seq_ref[k], seq_tiles[k]]
    if not all(bool(feas[n, j]) for n, j in picks):
        return None
    vals = [float(s[n, j] if s.dim() == 2 else s[n]) for n, j in picks]
    bn = _block(s.shape[0], 128)
    bj = _block(s.shape[1], 128) if s.dim() == 2 else 1
    tiles_of = [(n // bn, j // bj) for n, j in picks]
    where = (f"grant {k}: plain {picks[0]} score {vals[0]!r} vs tiles "
             f"{picks[1]} score {vals[1]!r}")
    if vals[0] == vals[1] and tiles_of[0] != tiles_of[1]:
        return f"exact tie across tiles {tiles_of[0]}/{tiles_of[1]}, {where}"
    lo = min(vals)
    if vals[1] < vals[0] <= lo + (1e-9 + 1e-6 * abs(lo)):
        return f"f32 near-tie within the tolerance, {where}"
    return None


def allocator_phase(dev, agents, fws, seed, epochs=3):
    """-> the launches of each kernel on its path: K3 over the allocator's
    fleet epochs (the default path), K1/K2 over the tiles-loop replays of
    the same epochs.  Each path is counted from zero and read right after
    it, before anything else launches."""
    import torch

    from repro_torch.core.online import OnlineAllocator
    from repro_torch.core.simulator import HETEROGENEOUS_AGENTS, PI, WC

    launches = dict.fromkeys(LAUNCH_COUNTERS, 0)
    for crit in CRITERIA:
        for pol in POLICIES:
            # the default path: the allocator's fused epochs on K3
            al = build_allocator(agents, fws, crit, pol, dev, seed)
            eps, ms = [], {}
            reset_counts()
            for _ in range(epochs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ep = al.begin_epoch(per_agent_limit=1, use_kernel="fused")
                check(ep.handle is not None,
                      f"{crit}/{pol}: epoch did not dispatch")
                grants = al.commit_epoch(ep)
                torch.cuda.synchronize()
                ms.setdefault("persistent", []).append(
                    (time.perf_counter() - t0) * 1e3)
                eps.append(ep)
                for g in grants[::3]:      # later epochs start non-empty
                    al.release_executor(g.fid, g.agent)
            n = read_counts()
            check_faults(al, f"allocator {crit}/{pol}")
            check(n["persistent_epoch"] >= epochs and
                  n["masked_argmin1d"] == n["masked_argmin2d"] == 0,
                  f"{crit}/{pol}: persistent path launches {n}")
            launches["persistent_epoch"] += n["persistent_epoch"]
            seqs = {"persistent": [ep.handle.result() for ep in eps]}
            # the same epochs through the engine: the plain loop, the tiles
            # loop on K1/K2, and the tiles loop on their plain versions
            for path, kernel in (("plain", None), ("tiles", "tiles"),
                                 ("tiles-plain", "tiles")):
                reset_counts()
                with plain_selects() if path == "tiles-plain" else \
                        contextlib.nullcontext():
                    seqs[path] = []
                    for ep in eps:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        seqs[path].append(replay(crit, pol, ep, dev, kernel))
                        torch.cuda.synchronize()
                        ms.setdefault(path, []).append(
                            (time.perf_counter() - t0) * 1e3)
                n = read_counts()
                if path == "tiles":
                    check(n["persistent_epoch"] == 0 and
                          n["masked_argmin1d"] + n["masked_argmin2d"] > 0,
                          f"{crit}/{pol}: tiles path launches {n}")
                    for k in ("masked_argmin1d", "masked_argmin2d"):
                        launches[k] += n[k]
                else:
                    check(not any(n.values()),
                          f"{crit}/{pol}: {path} path launched {n}")
            check(seqs["persistent"] == seqs["plain"],
                  f"{crit}/{pol}: persistent kernel grants differ from the "
                  "plain loop")
            check(seqs["tiles"] == seqs["tiles-plain"],
                  f"{crit}/{pol}: the tiles loop on K1/K2 differs from the "
                  "same loop on their plain versions")
            note = "equal"
            if seqs["tiles"] != seqs["plain"]:
                e = next(i for i in range(epochs)
                         if seqs["tiles"][i] != seqs["plain"][i])
                tie = first_tie(eps[e], seqs["plain"][e], seqs["tiles"][e],
                                crit, dev)
                check(tie is not None, f"{crit}/{pol}: tiles grants differ "
                      f"from the plain loop in epoch {e}, not on a tie")
                note = f"first divergence in epoch {e}, on an {tie}"
            log(f"allocator {crit}/{pol}: grants/epoch "
                f"{[len(s) for s in seqs['plain']]}; epoch ms " + ", ".join(
                    f"{k} {['%.1f' % x for x in v]}" for k, v in ms.items())
                + f"; tiles vs plain loop: {note}")
            # the paper's 6-agent cluster: fused on the card == numpy epoch
            small = {}
            for uk in ("fused", False):
                al = OnlineAllocator(2, criterion=crit, server_policy=pol,
                                     seed=seed, device=dev)
                for name, cap in HETEROGENEOUS_AGENTS:
                    al.add_agent(name, cap)
                for i, spec in enumerate((PI, WC, PI)):
                    al.register(f"f{i}", demand=spec.demand, wanted_tasks=12,
                                phi=(1.0, 2.0, 0.5)[i])
                small[uk] = [(g.fid, g.agent) for g in
                             al.allocate_batched(use_kernel=uk)]
                check_faults(al, f"small {crit}/{pol}")
            check(small["fused"] == small[False] and small[False],
                  f"{crit}/{pol}: fused epoch on the card differs from the "
                  "numpy epoch on the paper's cluster")
    return launches


# -- phase 3: the simulator ------------------------------------------------

def des_phase(dev, agents, seed):
    import torch

    from repro_torch.core import metrics
    from repro_torch.core.simulator import (
        HETEROGENEOUS_AGENTS,
        PI,
        WC,
        SimConfig,
        SparkMesosSim,
    )
    from repro_torch.kernels.epoch_persistent import ops as k3

    def run(device, agents_, until, **kw):
        cfg = SimConfig(criterion="rpsdsf", server_policy="rrr", batched=True,
                        use_kernel="fused", async_epochs=True, seed=seed,
                        device=device, **kw)
        hook = metrics.GrantLogHook()
        sim = SparkMesosSim(agents_, {"Pi": PI, "WordCount": WC}, cfg,
                            hooks=[hook])
        r = sim.run(until=until)
        check_faults(sim.alloc, f"des on {device}")
        return sim, r, hook.grants

    # small: the card's run equals the CPU's (plain version of every kernel)
    fp = {}
    for device in (dev, "cpu"):
        _sim, r, grants = run(device, HETEROGENEOUS_AGENTS, float("inf"),
                              jobs_per_queue=2)
        fp[str(device)] = (r.makespan, float(r.timeline.sum()), grants)
    check(fp[str(dev)] == fp["cpu"], "small DES on the card differs from "
          "the CPU run")

    k3.persistent_epoch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim, r, grants = run(dev, agents, float("inf"), n_queues_per_group=256,
                         jobs_per_queue=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k3.persistent_epoch.launches
    check(launches > 0, "des: the persistent kernel never launched")
    n_done = sum(len(v) for v in r.job_durations.values())
    check(not sim.jobs and n_done == 512, f"des: {n_done} of 512 jobs done")
    check(np.isfinite(r.timeline).all() and r.timeline.shape[1] == 5,
          "des: timeline not finite")
    util = r.timeline[:, 1:3]
    check(((util >= -1e-9) & (util <= 1 + 1e-9)).all(),
          "des: allocated share outside [0, 1]")
    n_grants = len(grants)
    log(f"des rpsdsf/rrr {len(agents)} agents, {n_done} jobs: "
        f"{sim.alloc.epoch_counter} epochs, {n_grants} grants, K3 launches "
        f"{launches}, makespan {r.makespan:.1f} s simulated in {wall:.1f} s "
        f"wall, {n_grants / wall:.1f} grants/s")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,allocator,des",
                    help="comma list of kernels, allocator, des")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.epoch_persistent import ops as k3
    from repro_torch.kernels.psdsf_score import kernel as tiles_kernel

    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = k3.library()          # nvcc; raises on a build error
    tiles_kernel.compiled()     # imports Triton
    from repro_torch import _build

    log(f"built {Path(lib._name).name} in {time.perf_counter() - t0:.1f} s; "
        "ptxas: " + " | ".join(
            ln.strip() for ln in
            _build.library_path(k3.SOURCE).with_suffix(".log")
            .read_text().splitlines() if "registers" in ln or "spill" in ln))
    rng = np.random.default_rng(args.seed)
    agents, fws = fleet()
    rows = {}
    if "kernels" in phases:
        rows = kernels_phase(rng, dev, agents, fws)
    launches = {}
    if "allocator" in phases:
        launches = allocator_phase(dev, agents, fws, args.seed)
        log(f"launches (K3 over the allocator's fleet epochs, K1/K2 over "
            f"the tiles-loop replays): {launches}")
        for name, n in launches.items():
            check(n > 0, f"main path never launched {name}")
    if "des" in phases:
        des_phase(dev, agents, args.seed)
    meta = {
        "masked_argmin1d": dict(
            route="triton",
            source="src/repro_torch/kernels/psdsf_score/kernel.py",
            replaces="src/repro/kernels/psdsf_score/kernel.py:90"),
        "masked_argmin2d": dict(
            route="triton",
            source="src/repro_torch/kernels/psdsf_score/kernel.py",
            replaces="src/repro/kernels/psdsf_score/kernel.py:136"),
        "persistent_epoch": dict(
            route="cuda",
            source="src/repro_torch/kernels/epoch_persistent/csrc/epoch.cu",
            replaces="src/repro/kernels/epoch_persistent/ops.py:49"),
    }
    if rows and launches:
        out = [dict(name=name, **meta[name], launches=launches[name],
                    **rows[name]) for name in meta]
        log(json.dumps({"kernels": out}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
