#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--phases kernels,allocator,...] [--seed 0]

Run from the root of a checkout; it needs one CUDA card and builds every
kernel from the sources in the checkout (nvcc into ``build/``).  Phases:

0. header: the card's name and power limit, then the kernel builds (one
   nvcc per CUDA source, in parallel) and each kernel's registers and
   spills from ptxas;
1. kernels: each kernel against its plain PyTorch version on the card at
   the fleet shapes, exact equality required (K1 at (512,), (4096,) and
   (7,), K2 at (3, 2), (130, 129), (9, 300), (512, 4096) and (4096, 4096),
   every edge case of ``ref.argmin_cases``: quantized ties, -0.0 against
   +0.0, feasible cells at BIG, inf, all masked, NaN (the first feasible
   NaN wins); with and without ``out``,
   on contiguous inputs and on views; then K1's and K2's time a call with
   and without ``out``, host enqueue, device time, the launch floor, the
   plain versions captured as a CUDA graph (and eager) and two PyTorch
   yardsticks; K3 whole epochs for 4 criteria x {pooled, rrr} (pooled
   PS-DSF / rPS-DSF on a grid of more than one block, the others on one),
   each timed a launch and a grant beside its plain version on the loop's
   graphs (a second run, after the capture), the grid path's time split by
   phase (its profile), and the barrier floor (the grid path's barriers
   alone, ``ops.barrier_floor``); K4
   at (512, 4096, 2), (300, 257, 3), (128, 128, 8) and (1, 1, 1) on
   quarter-quantized and on non-dyadic inputs, with an exhausted row, a
   blocked column and an all-infeasible case, with and without ``out``,
   then a run of picks on one ``PickOut`` whose mirror updates ride only in
   its pending words; K4's time a call with and without ``out``, a pick's
   round trip (launch and ``PickOut.result``), host enqueue, device time
   and the launch floor, and its plain version;
2. allocator: the main path, ``OnlineAllocator(device="cuda")`` with
   ``begin_epoch(use_kernel="fused")``/``commit_epoch``, 3 epochs per
   criterion x policy at the fleet size (512 frameworks x 4096 agents), on
   the default persistent kernel; each epoch is then replayed through
   ``engine_torch.run_epoch`` from its frozen view on the plain loop, on
   the tiles loop (K1/K2) and on the tiles loop with K1's and K2's plain
   versions, each on the loop's captured CUDA graphs (chunks of
   ``engine_torch.CHUNK`` steps, one alive-flag read a chunk; printed per
   path: ms an epoch and us a grant without the captures, chunk replays,
   flag reads, captures and their seconds).  Persistent must equal the
   plain loop and the tiles loop its plain-select run, grant for grant;
   tiles against the plain loop may differ only on a tie (exact across
   128-wide tiles, or within the f32 tie tolerance), as the reference's
   tile kernels do.  The first epoch of rPS-DSF/pooled and of DRF/RRR is
   also run on the same step eagerly (``engine_torch.run_loop_eager``, one
   flag read a grant) and must equal the graphed loop; both times are
   printed.  The first fleet
   epoch's begin+commit is printed for all eight pairs (limit 0.5 s), split
   into begin, the wait for K3 and its readback, and the apply, with the
   time the garbage collector took inside it.  On
   the paper's 6-agent cluster the fused path must equal the numpy epoch;
3. des: ``SparkMesosSim`` at the fleet size with async fused epochs, run
   until every job has finished, and a small simulation that must equal
   the same simulation on the CPU;
4. serve: the allocator-as-a-service front end
   (``repro_torch.launch.alloc_serve.serve``) at the fleet size, rPS-DSF
   pooled, 4 request profiles x 8 rounds without the epoch cache, on the
   per-grant backend (K4 once a pick).  The same serve with K4 swapped for
   its plain version must give the same decisions, grant for grant, and K4
   must launch exactly once per grant plus once per epoch (the pick that
   ends it).  Then the same fleet serve on the fused path (K3) and on
   ``"auto"`` with the cache, and the ``--inject-faults`` chaos serve, which
   must stay available with between 1 and the 6 injected dispatch failures;
5. gang: ``repro_torch.launch.cluster_sim.run`` and ``run_des`` on the card,
   equal to the same runs on the CPU;
6. models: K5 (flash attention) against its plain version at the
   qwen2-1.5b prefill shape (4, 12, 2048, 128) x (4, 2, 2048, 128) bf16, at
   granite-moe-3b's (4, 24, 2048, 64) x (4, 8, 2048, 64) bf16 (both timed
   beside their bound and SDPA), in
   f32, with a window below the key tile, non-causal with T != S, at a
   ragged S, in f16 and with rows that see no key, each on the kernel the
   wrapper's rule picks (``flash_tc.cu``, the tensor cores, for bf16 / f16
   at D >= 64; ``flash.cu``, the CUDA cores, for f32) and within that
   kernel's stated tolerance; the tensor-core kernel timed beside the
   CUDA-core one at the same shape, the plain version and
   ``scaled_dot_product_attention`` (a yardstick only).  K6 (WKV6) at the
   rwkv6-3b prefill shape (4, 2048, 40, 64), at S = 2000 and under strong
   decay, output and final state, within the tolerance printed beside it,
   timed beside its plain version.  Then the
   model serve path, ``repro_torch.launch.serve.serve`` at full width
   (batch 4, prompt 2048, 32 tokens, weights from a seeded generator) for
   qwen2-1.5b (K5 exactly once a layer in the prefill, all on the
   tensor-core kernel: 28), granite-moe-3b-a800m (K5: 32; its 40-expert
   MoE on the batch-local capacity grid in the prefill, dropless in the
   decode) and rwkv6-3b
   (K6: 32), each launch shadowed by the plain version on the same inputs
   (gated at the kernel's tolerance), against the same serve with the
   kernel swapped for its plain version, teacher-forced with the first
   run's tokens: the caches of the first two layers within a relative L2
   tolerance (for granite also in a prefill on the plain version with
   every layer's experts forced to the K5 run's, drops equal layer by
   layer); the other layers, prefill and decode logits,
   greedy-token agreement, granite's routing agreement by layer and its
   capacity-drop share are printed, not gated.  Those two serves decode
   eagerly (``serve.decode_eager``: they record ``decode_step``); the
   timed serve decodes on the captured graph, one capture, one replay a
   step, and its tokens and each step's logits (copied after each replay)
   must equal the first, eager, kernel serve's bit for bit; the same serve
   on the eager decode is timed beside it.  Printed per model: ms a step
   and tokens/s a sequence, graphed and eager, against the 20 tokens/s
   limit; the capture's seconds; and under torch.profiler the busy share
   and kernels a step of the eager step and of the graph's replays, and
   the step's byte bound (``decode_bytes``);
7. fill: progressive filling, the paper's Section 2
   (``repro_torch.core.filling_torch``).  The paper's tables through
   ``launch.paper_tables`` on the card: the rows of PS-DSF and
   rPS-DSF pooled (one K3 launch each) and BF-DRF (the step loop) equal
   the numpy filler's exactly; DRF, TSF and RRR-PS-DSF as 200 trials,
   each trial mean within 0.8 of ``run_trials(seed=1)``'s; every one of
   200 RRR-rPS-DSF trials (19, 2, 2, 19); the totals beside the paper's.  The fleet (512 frameworks x 4096 agents,
   its placement constraints, no wanted cap) filled to exhaustion, pooled,
   for the four criteria: one K3 launch a fill, equal to the same fill with
   K3 swapped for its plain version (the plain loop on its graphs) in the
   allocation and the grant count, nothing feasible left and no residual
   below -1e-4.  RRR trials (DRF and rPS-DSF, random ties) at the fleet
   size, 8 to exhaustion, on the step loop's captured graph (one capture a
   criterion; ms a step printed without it).  The paper's
   Figure 3-8 driver on the card equal to the CPU (2 seeds of its 8) and
   the Figure 9 driver on the card with both claims passing.

Outside the chaos serve the allocator fault counters must be zero.
Launches are counted per path, from zero just before it to just after it:
K3 over the allocator's fleet epochs, K1/K2 over the tiles-loop replays
(one a step of each replayed chunk, dead steps included: a replay adds its
graph's launches to the counters, a capture adds none),
K4 over the fleet serve on the per-grant backend, K5 (qwen2-1.5b and
granite-moe-3b-a800m) and K6 (rwkv6-3b) over the prefills of their model
serves, K3 over each pooled fill (once a fill,
the K3 row's ``fill_launches`` in the JSON); each must have launched.  The
last lines are the kernels JSON, the ``nvidia-smi`` name and power limit,
and the device JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

FLEET_N, FLEET_J = 512, 4096
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
SFU_PER_S = 16 * 132 * 1.98e9   # H100 SXM exponentials: 16 a clock a SM
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


def ptxas_summary(text):
    """-> one line per kernel of an ``nvcc -Xptxas -v`` log: its template
    arguments, registers, spill stores and loads, and any ptxas warning."""
    def short(mangled):
        args = re.search(r"I(\w+?)Li(\d+)E", mangled)
        if args:
            return f"{args.group(1).lstrip('0123456789')}, D={args.group(2)}"
        for name in ("argmin2d_kernel", "argmin1d_kernel", "noop_kernel"):
            if name in mangled:
                path = {"ILb1E": "<vec>", "ILb0E": "<scalar>"}
                return name + next((v for k, v in path.items()
                                    if k in mangled), "")
        return mangled[-40:]

    out, name, spills = [], None, "spills not reported"
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spills = short(m.group(1)), "spills not reported"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
        if "warning" in ln or "C75" in ln:
            out.append(re.sub(r"'(\S+)'", lambda w: short(w.group(1)),
                              ln.split(":", 1)[-1].strip()))
    return out


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

@contextlib.contextmanager
def gc_clock():
    """-> a dict that receives, when the block ends, the wall ms spent in
    Python's garbage collector inside it and its full collections."""
    out = {"ms": 0.0, "full": 0}
    start = []

    def hook(phase, info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            out["ms"] += (time.perf_counter() - start.pop()) * 1e3
            out["full"] += info["generation"] == 2

    gc.callbacks.append(hook)
    try:
        yield out
    finally:
        gc.callbacks.remove(hook)


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


def device_times(fn, counts=None):
    """Run fn() under torch.profiler (CUDA activity) -> ({kernel name:
    device us}, None), or (None, reason) when the profiler does not start
    or records no device time here.  fn runs either way.  ``counts``, a
    dict, receives each kernel's number of recorded launches."""
    from torch.profiler import ProfilerActivity, profile

    try:        # a measurement, not a check: a profiler fault is reported
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:
        prof, why = None, f"profiler did not start: {exc!r}"
    try:
        fn()
    finally:
        if prof is not None:
            prof.stop()
    if prof is None:
        return None, why
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    times = {e.key: e.self_device_time_total for e in events}
    if counts is not None:
        counts.update((e.key, e.count) for e in events)
    if not times:
        return None, "the profiler recorded no device time"
    return times, None


K4_KERNELS = ("psdsf_pick_kernel",)


def enqueue_us(fn, calls=1000):
    """Host time a call of fn(), no sync (``perf_counter`` over calls)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_us(fn, pattern, calls=50, tries=3):
    """Device time a launch of each kernel whose name matches the regex
    ``pattern``, over ``calls`` calls of fn() (torch.profiler; each kernel's
    time over its recorded launches, since a long profile may not keep
    every one) -> (the sum over those kernels in us, "name us, ...") or
    (None, why)."""
    import torch

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    for _ in range(tries):      # a profile may come back empty now and then
        counts = {}
        times, why = device_times(run, counts)
        if times is not None:
            break
    else:
        return None, f"{why}, {tries} tries"
    ours, launches = {}, {}
    for k, v in times.items():
        m = re.search(pattern, k)
        if m:
            ours[m.group(0)] = ours.get(m.group(0), 0.0) + v
            launches[m.group(0)] = launches.get(m.group(0), 0) + counts[k]
    ours = {k: v / launches[k] for k, v in ours.items()}
    if not ours:
        return None, f"no kernel named {pattern} in the profile"
    return sum(ours.values()), ", ".join(
        f"{k} {v:.2f} us x {launches[k]}" for k, v in ours.items())


# -- phase 1: kernels against their plain versions ---------------------------

PSDSF_SHAPES = ((FLEET_N, FLEET_J, 2), (300, 257, 3), (128, 128, 8),
                (1, 1, 1))


def psdsf_inputs(rng, N, J, R, family, dev):
    """K4's inputs: quarter-quantized (many exact ties, zero x) or
    non-dyadic (phi in {1, 2, 3}, residuals in thirds: division rounding),
    with one exhausted row (d = 3e38, as the per-grant backend marks it:
    inf and NaN scores) and one blocked column (zero residual)."""
    import torch

    if family == "quantized":
        x = rng.integers(0, 16, N) / 4
        phi = np.ones(N)
        d = rng.integers(1, 12, (N, R)) / 4
        res = rng.integers(0, 24, (J, R)) / 4
    else:
        x = rng.uniform(0, 20, N)
        phi = np.array([1.0, 2.0, 3.0])[np.arange(N) % 3]
        d = rng.uniform(0.5, 5, (N, R))
        res = rng.integers(0, 25, (J, R)) / 3
    d[N // 2] = 3.0e38
    res[J // 2] = 0.0
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (x, phi, d, res)]


def psdsf_phase(rng, dev):
    """K4 against its plain version: exact (val, n, j) at every shape and
    input family and on an all-infeasible case, with and without ``out``;
    then 64 picks on one ``PickOut`` whose mirror updates ride only in its
    pending words, against the plain version on eagerly updated inputs.
    Then times at the fleet shape: a call with and without ``out``
    (CUDA events over back-to-back calls), a pick's round trip (launch and
    ``result``, the host's clock), the host's enqueue, the device time
    (torch.profiler), the launch floor and the plain version.  -> the
    kernels row."""
    import torch

    from repro_torch.kernels.psdsf_score import ops as k4
    from repro_torch.kernels.psdsf_score import ref as k4_ref

    def triple(r):
        return [float(r[0]), int(r[1]), int(r[2])]

    for N, J, R in PSDSF_SHAPES:
        out = k4.PickOut(dev, R)
        for family in ("quantized", "non-dyadic"):
            args = psdsf_inputs(rng, N, J, R, family, dev)
            cases = [("", args)]
            cases.append((" all-infeasible", args[:2] + [args[2] + 100.0,
                                                         args[3]]))
            for label, a in cases:
                want = triple(k4.psdsf_argmin_ref(*a))
                for how, got in (("", k4.psdsf_argmin(*a)),
                                 (" with out", k4.psdsf_argmin(*a, out=out))):
                    got = triple(got)
                    check(got == want, f"K4 at ({N}, {J}, {R}) {family}"
                          f"{label}{how}: {got} != {want}")
                check(list(out.result()) == want[1:],
                      f"K4 at ({N}, {J}, {R}): pinned pair {out.result()} "
                      f"!= {want[1:]}")
                check(label == "" or got[1] == -1,
                      f"K4 at ({N}, {J}, {R}): all-infeasible found {got}")
    N, J, R = PSDSF_SHAPES[0]
    lazy = psdsf_inputs(rng, N, J, R, "non-dyadic", dev)
    lazy[3] += 4.0
    eager = [a.clone() for a in lazy]
    out = k4.PickOut(dev, R)
    tot = np.zeros(N)
    for step in range(64):
        k4.psdsf_argmin(*lazy, out=out)
        n, j = out.result()
        want = triple(k4.psdsf_argmin_ref(*eager))
        check([float(out.views[0]), n, j] == want
              and all(torch.equal(a, b) for a, b in zip(lazy, eager)),
              f"K4 pick {step} with a pending update: {(n, j)} != {want} "
              "or the mirrors differ")
        if n < 0:
            break
        tot[n] += 1
        row = (eager[3][j] - eager[2][n]).double().cpu().numpy() / 3.0
        upd = (n, 1.0, j, row, bool(tot[n] >= 3))
        k4_ref.apply_update(eager[0], eager[2], eager[3], upd)
        out.defer(*upd)
    args = psdsf_inputs(rng, N, J, R, "non-dyadic", dev)
    out = k4.PickOut(dev, R)
    ms = cuda_ms(lambda: k4.psdsf_argmin(*args, out=out), 1000)
    fresh = cuda_ms(lambda: k4.psdsf_argmin(*args), 200)
    host = enqueue_us(lambda: k4.psdsf_argmin(*args, out=out))

    def pick():
        k4.psdsf_argmin(*args, out=out)
        out.result()

    pick_us = enqueue_us(pick)
    dev_us, dev_why = device_us(lambda: k4.psdsf_argmin(*args, out=out),
                                r"psdsf_pick\w*")
    index = torch.cuda.current_device()
    floor_ms = cuda_ms(lambda: k4.noop_launch(index), 1000)
    plain = cuda_ms(lambda: k4.psdsf_argmin_ref(*args), 50)
    # each input read once, (val, n, j) written once; per cell 5 operations
    # a resource (quotient, two selects, max, feasibility compare) and 3 more
    # (product, mask, min)
    nbytes = sum(a.numel() * a.element_size() for a in args) + 12
    ops = N * J * (5 * R + 3)
    log(f"K4 psdsf_argmin ({N}, {J}, {R}): {ms:.4f} ms a call with out, "
        f"{fresh:.4f} ms without; a pick (launch + result) {pick_us:.2f} us; "
        f"host enqueue {host:.2f} us; device "
        + (f"{dev_us:.2f} us a launch ({dev_why})" if dev_us else
           f"not measured ({dev_why})")
        + f"; launch floor {floor_ms:.4f} ms; plain {plain:.4f} ms; equal "
        f"to the plain version on {len(PSDSF_SHAPES)} shapes x 2 families + "
        f"all-infeasible, with and without out, and over {step + 1} picks "
        "with pending updates")
    return dict(ms=ms, plain_ms=plain, library_ms=None, max_abs_err=0.0,
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             ops / F32_OPS_PER_S) * 1e3,
                bound_by=("operations" if ops / F32_OPS_PER_S >
                          nbytes / HBM_BYTES_PER_S else "bytes"))


ARGMIN_SHAPES_1D = ((FLEET_N,), (FLEET_J,), (7,))
ARGMIN_SHAPES_2D = ((3, 2), (130, 129), (9, 300), (FLEET_N, FLEET_J),
                    (4096, 4096))


def argmin_sweep(rng, dev):
    """K1 and K2 against their plain versions on every edge case of their
    contract (``ref.argmin_cases``): exact value (sign of zero included)
    and index, with and without ``out``, on contiguous inputs and on views
    (strided columns for K1; for K2 a base and row stride off the 16-byte
    grid, the kernel's scalar path).  -> the number of cases."""
    import torch

    from repro_torch.kernels.psdsf_score import ops as tiles
    from repro_torch.kernels.psdsf_score.ref import argmin_cases

    def same(got, want, what):     # a NaN value equals a NaN
        a = [float(got[0])] + [int(x) for x in got[1:]]
        b = [float(want[0])] + [int(x) for x in want[1:]]
        nans = np.isnan(a[0]) and np.isnan(b[0])
        check(a[1:] == b[1:] and (a[0] == b[0] or nans) and
              np.signbit(a[0]) == np.signbit(b[0]), f"{what}: {a} != {b}")

    n = 0
    for ndim, shapes in ((1, ARGMIN_SHAPES_1D), (2, ARGMIN_SHAPES_2D)):
        fn = tiles.masked_argmin1d if ndim == 1 else tiles.masked_argmin2d
        plain = (tiles.masked_argmin1d_ref if ndim == 1
                 else tiles.masked_argmin2d_ref)
        out = tiles.ArgminOut(dev, ndim)
        for shape in shapes:
            for label, s, m in argmin_cases(rng, shape):
                s = torch.as_tensor(s, device=dev)
                m = torch.as_tensor(m, device=dev)
                want = plain(s, m)
                wide = (shape[0], 3) if ndim == 1 else (shape[0],
                                                        shape[1] + 1)
                sv = torch.zeros(wide, device=dev)
                mv = torch.zeros(wide, dtype=torch.uint8, device=dev)
                if ndim == 1:
                    sv[:, 1], mv[:, 1] = s, m
                    view = (sv[:, 1], mv[:, 1])
                else:
                    sv[:, 1:], mv[:, 1:] = s, m
                    view = (sv[:, 1:], mv[:, 1:])
                for args, how in (((s, m), "contiguous"), (view, "view")):
                    what = f"K{ndim} at {shape} {label}, {how}"
                    same(fn(*args), want, what)
                    same(fn(*args, out=out), want, what + ", out")
                    n += 1
    return n


def argmin_phase(rng, dev):
    """K1 and K2: the edge-case sweep, then times at the main path's shapes
    -> the kernels rows.  Per call: CUDA-event means of back-to-back calls
    with ``out`` (what the tiles loop makes) and without; the host's
    enqueue time (``perf_counter`` over 1,000 calls, no sync); the device
    time a launch (torch.profiler); the plain version; two yardsticks,
    ``torch.min(masked, dim=0)`` on a premasked copy and ``torch.where`` +
    ``torch.min``, the whole function; and the launch floor, an empty
    kernel launched through the same ctypes interface."""
    import torch

    from repro_torch.kernels.psdsf_score import ops as tiles

    t0 = time.perf_counter()
    n = argmin_sweep(rng, dev)
    log(f"K1/K2 edge-case sweep: {n} cases x (with, without out) equal to "
        f"the plain versions ({time.perf_counter() - t0:.1f} s)")

    index = torch.cuda.current_device()
    floor_ms = cuda_ms(lambda: tiles.noop_launch(index), 1000)
    floor_us = enqueue_us(lambda: tiles.noop_launch(index))
    log(f"launch floor (empty kernel through the argmin.cu interface): "
        f"{floor_ms:.4f} ms a call, host enqueue {floor_us:.2f} us")
    rows = {}
    for name, shape in (("masked_argmin1d", (FLEET_N,)),
                        ("masked_argmin1d", (FLEET_J,)),
                        ("masked_argmin2d", (FLEET_N, FLEET_J))):
        fn = getattr(tiles, name)
        plain_fn = getattr(tiles, name + "_ref")
        s = torch.as_tensor(np.round(rng.standard_normal(shape) * 4) / 4,
                            dtype=torch.float32, device=dev)
        ok = torch.as_tensor(rng.random(shape) < 0.5, device=dev)
        out = tiles.ArgminOut(dev, len(shape))
        masked = torch.where(ok, s, tiles.BIG).reshape(-1)
        reps = 1000
        with_out = cuda_ms(lambda: fn(s, ok, out=out), reps)
        fresh = cuda_ms(lambda: fn(s, ok), reps)
        host_out = enqueue_us(lambda: fn(s, ok, out=out))
        host_fresh = enqueue_us(lambda: fn(s, ok))
        dev_us, dev_why = device_us(lambda: fn(s, ok, out=out),
                                    r"argmin\w*")
        plain_eager = cuda_ms(lambda: plain_fn(s, ok), 50)
        plain = graph_ms(lambda: plain_fn(s, ok), 200)
        lib = cuda_ms(lambda: torch.min(masked, dim=0), reps)
        lib_where = cuda_ms(lambda: torch.min(
            torch.where(ok, s, tiles.BIG).reshape(-1), dim=0), reps)
        nbytes = s.numel() * 5 + 4 * (1 + len(shape))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"{'K1' if len(shape) == 1 else 'K2'} {name} {shape}: "
            f"{with_out:.4f} ms a call with out, {fresh:.4f} ms without; "
            f"host enqueue {host_out:.2f} / {host_fresh:.2f} us; device "
            + (f"{dev_us:.2f} us a launch ({dev_why})" if dev_us else
               f"not measured ({dev_why})")
            + f"; plain {plain:.4f} ms as a graph ({plain_eager:.4f} ms "
            f"eager); torch.min {lib:.4f} ms, torch.where"
            f" + torch.min {lib_where:.4f} ms; launch floor "
            f"{floor_ms:.4f} ms; bound {bound:.3g} ms (bytes)")
        if shape != (FLEET_J,):
            rows[name] = dict(ms=with_out, plain_ms=plain,
                              plain_eager_ms=plain_eager, library_ms=lib,
                              max_abs_err=0.0, bound_ms=bound,
                              bound_by="bytes")
    return rows


def kernels_phase(rng, dev, agents, fws):
    import torch

    from repro_torch.core import engine_torch
    from repro_torch.kernels.epoch_persistent import ops as k3
    from repro_torch.kernels.epoch_persistent.ref import persistent_epoch_ref

    rows = argmin_phase(rng, dev)

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
            b = persistent_epoch_ref(*b_in, **kw)       # captures its graph
            torch.cuda.synchronize()
            t_capture = (time.perf_counter() - t0) * 1e3
            c_in = fresh()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            persistent_epoch_ref(*c_in, **kw)           # replays it
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
            grid = k3.persistent_epoch.grid
            check(grid > 1 if (pol == "pooled" and crit in ("psdsf",
                                                            "rpsdsf"))
                  else grid == 1, f"K3 {crit}/{pol}: grid {grid}")
            inputs = [fresh() for _ in range(5)]   # made outside the timing
            ms = cuda_ms(lambda: k3.persistent_epoch(*inputs.pop(), **kw), 5,
                         warmup=0)
            log(f"K3 persistent_epoch {crit}/{pol}: {count} grants, "
                f"{ms:.2f} ms an epoch ({ms / max(count, 1) * 1e3:.2f} us a "
                f"grant; first launch {t_kernel:.2f} ms), grid {grid}, "
                f"plain {t_plain:.1f} ms on the loop's graph "
                f"({t_plain / max(count, 1) * 1e3:.1f} us a grant; "
                f"{t_capture:.1f} ms with its capture)")
            if grid > 1:
                k3_phases(k3, fresh(), kw, count)
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
                              nbytes / HBM_BYTES_PER_S else "bytes"),
                    grid=grid)
                steps = count
    # the barrier floor: the grid path's grid.sync() a grant, alone, on
    # K3's own grid
    grid = rows["persistent_epoch"]["grid"]
    R = arr["D"].shape[1]
    check(grid == k3.grid_size(dev, R), f"K3 grid {grid} is not "
          f"grid_size {k3.grid_size(dev, R)}")
    floor = cuda_ms(lambda: k3.barrier_floor(steps, dev, R), 5)
    rows["persistent_epoch"]["barrier_floor_ms"] = floor
    log(f"K3 barrier floor: {steps} grid.sync() on {grid} blocks of K3's "
        f"size, {floor:.3f} ms ({floor / steps * 1e3:.3f} us a barrier)")
    return rows


def k3_phases(k3, state, kw, count):
    """Where a grant's time goes on K3's grid path: one more launch with
    the per-phase profile (the profiled build: SM clocks of thread 0 in
    block 0, which grants, and block 1, which keeps a slice), in us a
    grant at the clock rate the profiled loop ran at (its cycles over the
    launch's CUDA-event time)."""
    import torch

    prof = torch.zeros(k3.PROFILE_WORDS, dtype=torch.int64,
                       device=state[0].device)
    ms = cuda_ms(lambda: k3.persistent_epoch(*state, **kw, profile=prof), 1,
                 warmup=0)
    p = prof.tolist()
    hz = max(p[4], p[9]) / (ms * 1e-3)
    names = ("phase 1", "barrier", "pick")
    log(f"  K3 phases (us a grant; profiled launch {ms:.2f} ms, "
        f"{hz / 1e9:.3f} GHz): " + "; ".join(
            f"block {b} ({'grant' if b == 0 else 'slice'}): " + ", ".join(
                f"{name} {p[5 * b + q] / count / hz * 1e6:.2f}"
                for q, name in enumerate(names)) for b in (0, 1))
        + f"; near-tie rounds {p[3]}")


# -- phase 2: the allocator main path ----------------------------------------

LAUNCH_COUNTERS = ("masked_argmin1d", "masked_argmin2d", "persistent_epoch",
                   "psdsf_argmin", "flash_attention", "wkv6")


def counters():
    from repro_torch.kernels.epoch_persistent import ops as k3
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.psdsf_score import ops as tiles
    from repro_torch.kernels.rwkv6 import ops as k6

    return {"masked_argmin1d": tiles.masked_argmin1d,
            "masked_argmin2d": tiles.masked_argmin2d,
            "persistent_epoch": k3.persistent_epoch,
            "psdsf_argmin": tiles.psdsf_argmin,
            "flash_attention": k5.flash_attention,
            "wkv6": k6.wkv6}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0
        for name in getattr(fn, "variant_launches", ()):
            fn.variant_launches[name] = 0


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

    def argmin1d(vec, ok, out):
        return tiles.masked_argmin1d_ref(vec, ok)[1]

    def argmin2d(mat, ok, out):
        _, n, j = tiles.masked_argmin2d_ref(mat, ok)
        return n, j

    stack = ExitStack()
    stack.enter_context(mock.patch.object(engine_torch, "_tiles_1d", argmin1d))
    stack.enter_context(mock.patch.object(engine_torch, "_tiles_2d", argmin2d))
    return stack


@contextlib.contextmanager
def graph_counts():
    """-> a dict that receives, for the epoch loop's graphs inside the
    block, the chunk replays, the alive-flag reads (each one host sync),
    the captures and the seconds they took."""
    from unittest import mock

    from repro_torch.core import engine_torch as et

    n = dict(replays=0, reads=0, captures=0, capture_s=0.0)
    init, replay_, alive = (et.LoopGraph.__init__, et.LoopGraph.replay,
                            et.LoopGraph.alive)

    def timed_init(self, *a, **k):
        t0 = time.perf_counter()
        init(self, *a, **k)
        n["captures"] += 1
        n["capture_s"] += time.perf_counter() - t0

    def counted_replay(self):
        n["replays"] += 1
        return replay_(self)

    def counted_alive(self):
        n["reads"] += 1
        return alive(self)

    with mock.patch.object(et.LoopGraph, "__init__", timed_init), \
            mock.patch.object(et.LoopGraph, "replay", counted_replay), \
            mock.patch.object(et.LoopGraph, "alive", counted_alive):
        yield n


def eager_loop():
    """Run the engine's loop with its step eagerly on the card, one flag
    read a grant (``engine_torch.run_loop_eager``): what the graphs are
    held to."""
    from unittest import mock

    from repro_torch.core import engine_torch

    return mock.patch.object(engine_torch, "run_loop",
                             engine_torch.run_loop_eager)


def graph_ms(fn, reps):
    """Mean device time of fn() captured once as a CUDA graph and
    replayed (CUDA events)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


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


#: the pairs whose first fleet epoch is also run on the eager step
EAGER_CHECKS = (("rpsdsf", "pooled"), ("drf", "rrr"))


def allocator_phase(dev, agents, fws, seed, epochs=3):
    """-> the launches of each kernel on its path: K3 over the allocator's
    fleet epochs (the default path), K1/K2 over the tiles-loop replays of
    the same epochs.  Each path is counted from zero and read right after
    it, before anything else launches."""
    import torch

    from repro_torch.core.online import OnlineAllocator
    from repro_torch.core.simulator import HETEROGENEOUS_AGENTS, PI, WC

    from repro_torch.kernels.epoch_persistent import ops as k3

    launches = dict.fromkeys(LAUNCH_COUNTERS[:3], 0)
    first, replay_s = {}, dict.fromkeys(("plain", "tiles", "tiles-plain"), 0.0)
    for crit in CRITERIA:
        for pol in POLICIES:
            # the default path: the allocator's fused epochs on K3
            al = build_allocator(agents, fws, crit, pol, dev, seed)
            eps, ms = [], {}
            reset_counts()
            for _ in range(epochs):
                torch.cuda.synchronize()
                with gc_clock() as in_gc:
                    t0 = time.perf_counter()
                    ep = al.begin_epoch(per_agent_limit=1,
                                        use_kernel="fused")
                    t_begin = time.perf_counter()
                    check(ep.handle is not None,
                          f"{crit}/{pol}: epoch did not dispatch")
                    ep.handle.result()    # K3 and the readback (idempotent)
                    t_wait = time.perf_counter()
                    grants = al.commit_epoch(ep)
                    torch.cuda.synchronize()
                    t_end = time.perf_counter()
                ms.setdefault("persistent", []).append((t_end - t0) * 1e3)
                ms.setdefault("split", []).append(
                    ((t_begin - t0) * 1e3, (t_wait - t_begin) * 1e3,
                     (t_end - t_wait) * 1e3, in_gc["ms"], in_gc["full"]))
                eps.append(ep)
                for g in grants[::3]:      # later epochs start non-empty
                    al.release_executor(g.fid, g.agent)
            n = read_counts()
            first[f"{crit}/{pol}"] = (ms["persistent"][0],
                                      *ms.pop("split")[0])
            wide = pol == "pooled" and crit in ("psdsf", "rpsdsf")
            check(k3.persistent_epoch.grid > 1 if wide else
                  k3.persistent_epoch.grid == 1,
                  f"{crit}/{pol}: K3 grid {k3.persistent_epoch.grid}")
            check_faults(al, f"allocator {crit}/{pol}")
            check(n["persistent_epoch"] >= epochs and
                  n["masked_argmin1d"] == n["masked_argmin2d"] == 0,
                  f"{crit}/{pol}: persistent path launches {n}")
            launches["persistent_epoch"] += n["persistent_epoch"]
            seqs = {"persistent": [ep.handle.result() for ep in eps]}
            # the same epochs through the engine: the plain loop, the tiles
            # loop on K1/K2, and the tiles loop on their plain versions, each
            # on the loop's captured graphs
            graphs = {}
            for path, kernel in (("plain", None), ("tiles", "tiles"),
                                 ("tiles-plain", "tiles")):
                reset_counts()
                with plain_selects() if path == "tiles-plain" else \
                        contextlib.nullcontext(), graph_counts() as g:
                    seqs[path] = []
                    for ep in eps:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        seqs[path].append(replay(crit, pol, ep, dev, kernel))
                        torch.cuda.synchronize()
                        ms.setdefault(path, []).append(
                            (time.perf_counter() - t0) * 1e3)
                graphs[path] = g
                replay_s[path] += sum(ms[path]) / 1e3
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
                check(g["replays"] > 0 and g["reads"] <= g["replays"],
                      f"{crit}/{pol}: {path} path ran no graph ({g})")
            grants = sum(len(x) for x in seqs["plain"])
            log(f"graphs {crit}/{pol} ({grants} grants over {epochs} "
                "epochs; ms an epoch without the captures, us a grant, chunk "
                "replays, flag reads (host syncs besides the readback), "
                "captures and their seconds): " + "; ".join(
                    f"{path} {(sum(ms[path]) - g['capture_s'] * 1e3) / epochs:.1f}"
                    f" ms, {(sum(ms[path]) - g['capture_s'] * 1e3) / grants * 1e3:.1f}"
                    f" us, {g['replays']} replays, {g['reads']} reads, "
                    f"{g['captures']} captures {g['capture_s']:.2f} s"
                    for path, g in graphs.items()))
            if (crit, pol) in EAGER_CHECKS:
                # graph against the same step run eagerly, on one epoch
                with eager_loop(), graph_counts() as g:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eager = replay(crit, pol, eps[0], dev, None)
                    torch.cuda.synchronize()
                    eager_ms = (time.perf_counter() - t0) * 1e3
                check(eager == seqs["plain"][0] and g["replays"] == 0,
                      f"{crit}/{pol}: the graphed loop differs from the "
                      "eager step")
                log(f"graph vs eager {crit}/{pol}, epoch 0 ({len(eager)} "
                    f"grants): equal; graphed {ms['plain'][0]:.1f} ms "
                    f"(capture included), eager {eager_ms:.1f} ms "
                    f"({eager_ms / len(eager) * 1e3:.1f} us a grant)")
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
    log("first fleet epoch, begin+commit on K3 (limit 500 ms; in brackets: "
        "begin, the host prep and the launch; the wait for K3 and the "
        "readback; the f64 re-validation and apply; of all that, the time "
        "in Python's garbage collector, and its full collections): "
        + ", ".join(f"{k} {v:.1f} [{b:.1f}, {w:.1f}, {a:.1f}; gc {g:.1f} "
                    f"ms, {f} full] ms" for k, (v, b, w, a, g, f)
                    in first.items()))
    log(f"replays of the {len(first) * epochs} fleet epochs on the graphs, "
        f"{sum(replay_s.values()):.1f} s (captures included): " + ", ".join(
            f"{k} {v:.1f} s" for k, v in replay_s.items()))
    return launches


# -- the chunk sweep (not a default phase) ----------------------------------

CHUNK_SWEEP = (16, 32, 64, 128, 256)
#: a late fleet epoch's grants (the allocator phase's third epochs take
#: 1,138-1,395), and the first epoch's
SWEEP_STEPS = (1200, 4096)


def chunks_phase(dev, agents, fws):
    """The graphed plain loop's time a segment for each chunk size in
    ``CHUNK_SWEEP``, on the fleet's first epoch state cut at
    ``SWEEP_STEPS`` grants (the last chunk then runs dead steps past the
    cut), rPS-DSF/pooled and DRF/RRR: the second run of each (graph
    captured), CUDA-event time, and the first run's capture."""
    import torch

    from repro_torch.core import engine_torch as et

    arr = fleet_arrays(agents, fws)
    N, J = arr["X"].shape
    t = {k: torch.as_tensor(v, device=dev) for k, v in arr.items()}
    rng = np.random.default_rng(0)
    chunk0 = et.CHUNK
    try:
        for crit, pol in EAGER_CHECKS:
            perms = (np.stack([rng.permutation(J) for _ in range(8)])
                     if pol == "rrr" else np.arange(J)[None, :])
            state = et.epoch_state(
                t["X"], t["D"], t["TD"], t["C"], t["FREE"], t["phi"],
                t["wanted"], t["allowed"],
                torch.as_tensor(perms, dtype=torch.int32, device=dev),
                torch.zeros(J, dtype=torch.int32, device=dev), 0, 0, J, 1,
                1e-9, kind=crit, lookahead=False, use_limit=True)
            for steps in SWEEP_STEPS:
                row = []
                for chunk in CHUNK_SWEEP:
                    et.CHUNK = chunk
                    kw = dict(kind=crit, policy=pol, lookahead=False,
                              use_limit=True, max_steps=steps)
                    inputs = [tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in state) for _ in range(2)]
                    with graph_counts() as g:
                        out = et.run_loop(*inputs.pop(), **kw)
                        check(int(out[2]) == steps, f"chunks {crit}/{pol}: "
                              f"{int(out[2])} grants, not {steps}")
                        ms = cuda_ms(lambda: et.run_loop(*inputs.pop(),
                                                         **kw), 1, warmup=0)
                    row.append(f"{chunk}: {ms:.1f} ms ({ms / steps * 1e3:.1f}"
                               f" us a grant, capture {g['capture_s']:.2f} s)")
                log(f"chunk sweep {crit}/{pol}, {steps} grants: "
                    + "; ".join(row))
    finally:
        et.CHUNK = chunk0


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


# -- phase 4: the allocator-as-a-service front end ----------------------------

def serve_once(label, dev, faults_ok=False, **kw):
    """One ``alloc_serve.serve`` run; -> (stats, wall seconds, the grants of
    every epoch as (fid, agent, executors) lists).  Prints decisions/s, the
    epoch latency p50/p99 (host clock around each ``drain_epoch``, which
    ends in the epoch's readback) and the service's own per-decision
    p50/p99."""
    from unittest import mock

    import torch

    from repro_torch.launch import alloc_serve

    grants, epoch_ms = [], []
    drain = alloc_serve.AllocatorService.drain_epoch

    def recording_drain(self):
        t0 = time.perf_counter()
        out = drain(self)
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        grants.append([(g.fid, g.agent, g.n_executors) for g in out])
        return out

    with mock.patch.object(alloc_serve.AllocatorService, "drain_epoch",
                           recording_drain):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = alloc_serve.serve(device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    faults = out["health"]["faults"]
    if not faults_ok:
        check(not any(faults[k] for k in ("dispatch_failures",
                                          "commit_failures",
                                          "host_fallbacks", "quarantines")),
              f"serve {label}: fault counters {faults}")
    lat = out["latency"]
    cache = out["cache"]
    log(f"serve {label}: {out['epochs']} epochs, {out['decisions']} "
        f"decisions in {wall:.3f} s wall, {out['decisions_per_s']:.1f} "
        f"decisions/s; epoch latency p50 {np.percentile(epoch_ms, 50):.2f} "
        f"ms p99 {np.percentile(epoch_ms, 99):.2f} ms; per decision p50 "
        f"{lat['p50_ms']:.4f} ms p99 {lat['p99_ms']:.4f} ms"
        + ("" if cache is None else
           f"; cache hits {cache['hits']} misses {cache['misses']}"))
    return out, wall, grants


def pergrant_split(dev, fleet):
    """Where a per-grant pick's time goes, on a short instrumented serve
    (host timers, under torch.profiler): K4's host enqueue of its two
    launches, the (n, j) readback (the rest of the select, which waits for
    the kernel), the engine's apply (host bookkeeping and the in-place
    mirror writes) and the rest of the allocator's grant loop; on the
    device, K4's kernels, the other kernels and copies, and the device's
    busy share of the epochs.  -> the split in microseconds a pick."""
    from types import SimpleNamespace
    from unittest import mock

    import torch

    from repro_torch.core import engine
    from repro_torch.kernels.psdsf_score import ops as k4

    host = dict(launch=0.0, select=0.0, apply=0.0)
    launch, select, apply = (k4.psdsf_argmin, engine.BatchedEpoch.select,
                             engine.BatchedEpoch.apply)

    def timed(fn, key):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            host[key] += time.perf_counter() - t0
            return out
        return wrapper

    # the engine reaches K4 through its module alias _kops; the wrapper
    # itself stays in place, so its launch count keeps counting
    backend = SimpleNamespace(psdsf_argmin=timed(launch, "launch"),
                              PickOut=k4.PickOut)
    n0 = launch.launches
    run = {}

    def serve():
        run["out"] = serve_once("pergrant, instrumented", dev,
                                **dict(fleet, rounds=2))[0]
        torch.cuda.synchronize()

    with mock.patch.object(engine, "_kops", backend), \
            mock.patch.object(engine.BatchedEpoch, "select",
                              timed(select, "select")), \
            mock.patch.object(engine.BatchedEpoch, "apply",
                              timed(apply, "apply")):
        times, why = device_times(serve)
    picks = launch.launches - n0
    epoch_s = run["out"]["latency"]["total_s"]
    us = lambda sec: sec / picks * 1e6  # noqa: E731
    split = dict(
        k4_host_us=us(host["launch"]),
        readback_us=us(host["select"] - host["launch"]),
        apply_us=us(host["apply"]),
        rest_us=us(epoch_s - host["select"] - host["apply"]),
        epoch_us=us(epoch_s))
    if times:
        k4_dev = sum(v for k, v in times.items()
                     if any(name in k for name in K4_KERNELS))
        split.update(k4_device_us=k4_dev / picks,
                     other_device_us=(sum(times.values()) - k4_dev) / picks,
                     device_busy_share=sum(times.values()) / (epoch_s * 1e6))
    log("per-grant split (us a pick, instrumented run, " + (
        why or "device times by torch.profiler") + "): " + ", ".join(
        f"{k} {v:.4g}" for k, v in split.items()))
    if times:
        log("device time by kernel (us a pick): " + ", ".join(
            f"{k} {v / picks:.2f}" for k, v in sorted(
                times.items(), key=lambda kv: -kv[1])[:8]))
    return split


def serve_phase(dev, seed):
    """-> K4's launches over the fleet serve on the per-grant backend."""
    from unittest import mock

    import torch

    from repro_torch.kernels.psdsf_score import ops as k4
    from repro_torch.launch import alloc_serve

    fleet = dict(n_agents=FLEET_J, n_frameworks=FLEET_N, n_profiles=4,
                 rounds=8, criterion="rpsdsf", server_policy="pooled",
                 seed=seed)
    reset_counts()
    out, _wall, grants_k4 = serve_once("pergrant (K4)", dev,
                                       use_kernel="pergrant",
                                       epoch_cache=False, **fleet)
    n = read_counts()
    want = out["decisions"] + out["epochs"]
    check(n["psdsf_argmin"] == want and n["persistent_epoch"] == 0,
          f"serve pergrant: launches {n}, expected K4 = decisions + epochs "
          f"= {want}")
    with mock.patch.object(k4, "psdsf_argmin", k4.psdsf_argmin_ref):
        _, _, grants_plain = serve_once("pergrant (K4's plain version)", dev,
                                        use_kernel="pergrant",
                                        epoch_cache=False, **fleet)
    check(grants_k4 == grants_plain, "serve pergrant: K4 decisions differ "
          "from its plain version's")
    log(f"serve pergrant: K4 == plain version over {len(grants_k4)} epochs, "
        f"{out['decisions']} decisions; K4 launches {n['psdsf_argmin']} = "
        "decisions + epochs")
    pergrant_split(dev, dict(fleet, use_kernel="pergrant", epoch_cache=False))
    reset_counts()
    _, _, grants = serve_once("fused (K3)", dev, use_kernel="fused",
                              epoch_cache=False, **fleet)
    log(f"serve fused: launches {read_counts()}; decisions per epoch "
        f"{[len(g) for g in grants]}")
    run = {}

    def fused():      # again for 2 rounds, under the profiler
        run["out"] = serve_once("fused (K3), profiled", dev,
                                use_kernel="fused", epoch_cache=False,
                                **dict(fleet, rounds=2))[0]
        torch.cuda.synchronize()

    times, why = device_times(fused)
    if times:
        share = sum(times.values()) / 1e6 / run["out"]["latency"]["total_s"]
        why = f"device busy share {share:.4f} (torch.profiler)"
    log(f"serve fused, profiled: {why}")
    reset_counts()
    serve_once("auto + cache", dev, use_kernel="auto", epoch_cache=True,
               **fleet)
    log(f"serve auto + cache: launches {read_counts()}")
    # the chaos serve: alloc_serve's own availability asserts
    out = alloc_serve.main(["--smoke", "--inject-faults", "--device",
                            str(dev), "--seed", str(seed)])
    f = out["health"]["faults"]
    check(1 <= f["dispatch_failures"] <= 6,
          f"chaos serve: {f['dispatch_failures']} dispatch failures, "
          "expected 1 to the 6 injected")
    log(f"serve chaos: {out['epochs']} epochs, dispatch failures "
        f"{f['dispatch_failures']}, host fallbacks {f['host_fallbacks']}, "
        f"quarantines {f['quarantines']}, status {out['health']['status']}")
    return n["psdsf_argmin"]


# -- phase 5: the gang entry points -------------------------------------------

def gang_phase(dev, seed):
    from repro_torch.launch import cluster_sim

    logs = {d: cluster_sim.run("rpsdsf", seed, verbose=False, batched=True,
                               device=d) for d in (dev, "cpu")}
    check(logs[dev] == logs["cpu"] and all(
        np.isfinite(list(e.values())).all() for e in logs[dev]),
        "gang: cluster_sim.run on the card differs from the CPU run")
    des = {}
    for d in (dev, "cpu"):
        r, fair, _slow = cluster_sim.run_des("rpsdsf", seed, verbose=False,
                                             device=d)
        des[d] = (r.makespan, float(r.timeline.sum()), fair)
    check(des[dev] == des["cpu"] and np.isfinite(des[dev][0]),
          "gang: cluster_sim.run_des on the card differs from the CPU run")
    log(f"gang: run rpsdsf {len(logs[dev])} epochs, last jain "
        f"{logs[dev][-1]['jain']:.4f}; run_des makespan {des[dev][0]:.1f} s, "
        f"jain-tw {des[dev][2]['jain_tw_mean']:.4f}; card == CPU")


# -- phase 6: the model serve path (K5, K6) -----------------------------------

BF16_OPS_PER_S = 989e12         # H100 SXM bf16 dense tensor cores
QWEN_ATTN = (4, 12, 2, 2048, 2048, 128)     # B, H, K, S, T, D of one prefill
GRANITE_ATTN = (4, 24, 8, 2048, 2048, 64)   # granite-moe-3b's prefill
RWKV_WKV = (4, 2048, 40, 64)                # B, S, H, D of one prefill
# K5's tolerances are stated once, by variant, in
# repro_torch.kernels.flash_attention.ops.tolerance: f32 rtol 1e-5, atol 2e-5;
# the tensor-core kernel bf16 rtol 2**-7, atol 2**-8 max|v| (f16 2**-10,
# 2**-11 max|v|), the bound of rounding P before the PV product
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
WKV_TOL_STRONG = dict(rtol=1e-3, atol=2e-3)   # outputs reach ~1e2
# the full-width serve swapped onto the plain version is gated on its first
# two layers only: there each cache value may have been rounded to bf16 the
# other way once (2**-7 relative).  Deeper layers diverge, whatever the
# kernel: the reference's fan-in rule (the second-to-last dim, so H or K for
# wq/wk, not E) gives qwen2-1.5b attention scores of about 300 standard
# deviations, and a one-ulp difference grows ~10x a layer (PERF.md, Findings).
# The kernel is gated instead at every layer of the serve, on the layer's
# own inputs (the shadow check).
SERVE_FIRST_LAYERS_REL_L2 = 2 ** -7
SERVE_KW = dict(smoke=False, batch=4, prompt_len=2048, gen=32)
DECODE_LIMIT_PER_SEQ = 20     # PERF.md section 2: tokens/s a sequence


def _close(got, want, rtol, atol):
    """-> (within tolerance, max abs error) of two tensors, in f32."""
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return bool(torch.isclose(got, want, rtol=rtol, atol=atol).all()), err


def flash_phase(dev):
    """K5 against its plain version at the qwen2-1.5b and granite-moe-3b
    prefill shapes and on the edge cases, each on the kernel the wrapper's
    rule picks and within that kernel's tolerance; then the timing block at
    both prefill shapes.  -> the kernels row (qwen2-1.5b's shape, granite's
    in ``granite_prefill``)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as k5

    g = torch.Generator(dev).manual_seed(5)
    cases = [
        ("qwen2-1.5b prefill", QWEN_ATTN, torch.bfloat16, True, 0),
        ("granite-moe-3b prefill", GRANITE_ATTN, torch.bfloat16, True, 0),
        ("f32", (2, 12, 2, 512, 512, 128), torch.float32, True, 0),
        ("window 48 below the key tile, gemma3-style", (2, 8, 4, 1000,
                                                         1000, 256),
         torch.bfloat16, True, 48),
        ("non-causal, T != S", (2, 4, 2, 300, 700, 64), torch.bfloat16,
         False, 0),
        ("ragged S", (3, 12, 2, 1999, 1999, 128), torch.bfloat16, True, 0),
        ("f16", (2, 12, 2, 1024, 1024, 128), torch.float16, True, 0),
        ("rows 19-47 with no valid key", (1, 2, 1, 48, 16, 64),
         torch.bfloat16, False, 4),
    ]
    errs, inputs = {}, {}
    for label, (B, H, K, S, T, D), dtype, causal, window in cases:
        q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
        k = torch.randn((B, T, K, D), generator=g, device=dev).to(dtype)
        v = torch.randn((B, T, K, D), generator=g, device=dev).to(dtype)
        variant = k5.variant(dtype, D)
        n0 = k5.flash_attention.variant_launches[variant]
        got = k5.flash_attention(q, k, v, causal=causal, window=window)
        want = k5.flash_attention_ref(q, k, v, causal=causal, window=window)
        tol = k5.tolerance(variant, dtype, v)
        ok, err = _close(got, want, **tol)
        log(f"K5 {label} {(B, H, K, S, T, D)} {dtype} on {variant}: max abs "
            f"err {err:.3g} (tolerance rtol {tol['rtol']:.3g} atol "
            f"{tol['atol']:.3g})")
        check(k5.flash_attention.variant_launches[variant] == n0 + 1,
              f"K5 {label}: {variant} did not launch")
        check(ok, f"K5 {label}: kernel differs from its plain version "
              f"(max abs err {err})")
        if label.startswith("rows"):
            check(bool((got[:, 19:] == 0).all()), "K5: a row with no valid "
                  "key is not 0")
        if label.endswith("prefill"):
            errs[label], inputs[label] = err, (q, k, v)
        del got, want
    q, k, v = inputs["qwen2-1.5b prefill"]
    B, H, K, S, T, D = QWEN_ATTN
    variant = k5.variant(q.dtype, D)
    ms = cuda_ms(lambda: k5.flash_attention(q, k, v, causal=True), 20)
    simt = cuda_ms(lambda: k5.launch("flash", q, k, v, causal=True), 5)
    plain = cuda_ms(lambda: k5.flash_attention_ref(q, k, v, causal=True), 3)
    lib, how = sdpa_ms(q, k, v)
    bound, bound_by = attention_bound(q, k)
    flops = 2 * B * H * S * T * D
    # granite-moe-3b's prefill shape: D = 64, three query heads a kv head
    qg, kg, vg = inputs["granite-moe-3b prefill"]
    granite = dict(
        shape=[list(qg.shape), list(kg.shape)],
        ms=cuda_ms(lambda: k5.flash_attention(qg, kg, vg, causal=True), 20),
        plain_ms=cuda_ms(lambda: k5.flash_attention_ref(qg, kg, vg,
                                                        causal=True), 3),
        library_ms=sdpa_ms(qg, kg, vg)[0],
        max_abs_err=errs["granite-moe-3b prefill"])
    granite["bound_ms"], granite["bound_by"] = attention_bound(qg, kg)
    log(f"K5 flash_attention {GRANITE_ATTN} bf16 causal: "
        f"{k5.variant(qg.dtype, qg.shape[-1])} {granite['ms']:.4f} ms "
        f"({granite['bound_ms'] / granite['ms']:.1%} of the bound "
        f"{granite['bound_ms']:.4f} ms, {granite['bound_by']}); plain "
        f"{granite['plain_ms']:.4f} ms; scaled_dot_product_attention "
        f"({how}) {granite['library_ms']:.4f} ms")
    del inputs, qg, kg, vg
    # head dim 256 (gemma3-12b's heads), where the kernel compiles its
    # warpgroups' turns out
    B2, H2, K2, S2, D2 = 4, 16, 8, 2048, 256
    q2 = torch.randn((B2, S2, H2, D2), generator=g, device=dev).to(q.dtype)
    k2, v2 = (torch.randn((B2, S2, K2, D2), generator=g, device=dev)
              .to(q.dtype) for _ in range(2))
    ms256 = cuda_ms(lambda: k5.flash_attention(q2, k2, v2, causal=True), 20)
    log(f"K5 flash_attention {(B2, H2, K2, S2, S2, D2)} bf16 causal: "
        f"{k5.variant(q2.dtype, D2)} {ms256:.4f} ms "
        f"({2 * B2 * H2 * S2 * S2 * D2 / ms256 / 1e9:.1f} TFLOP/s)")
    del q2, k2, v2
    log(f"K5 flash_attention {QWEN_ATTN} bf16 causal: {variant} {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} of the bound "
        f"{bound:.4f} ms); the CUDA-core kernel flash {simt:.4f} ms "
        f"({flops / simt / 1e9:.1f} TFLOP/s); plain {plain:.4f} ms; "
        f"scaled_dot_product_attention ({how}) {lib:.4f} ms "
        f"({flops / lib / 1e9:.1f} TFLOP/s)")
    return dict(variant=variant, ms=ms, plain_ms=plain, library_ms=lib,
                max_abs_err=errs["qwen2-1.5b prefill"], bound_ms=bound,
                bound_by=bound_by, cuda_core_ms=simt,
                granite_prefill=granite)


def sdpa_ms(q, k, v):
    """-> (ms, how) of ``scaled_dot_product_attention`` on K5's inputs
    (q (B, S, H, D), k/v (B, T, K, D)), causal: the yardstick only, never
    on the port's path."""
    import torch.nn.functional as F

    H, K = q.shape[2], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    try:
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20), "enable_gqa"
    except TypeError:
        kr, vr = (x.repeat_interleave(H // K, dim=1) for x in (kt, vt))
        return (cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kr, vr, is_causal=True), 20),
            "k/v repeated (no enable_gqa in this torch)")


def attention_bound(q, k):
    """-> (ms, what bounds it) of causal bf16 attention on these inputs:
    q and the output, k and v each moved once; 2·B·H·S·T·D operations (half
    of QK^T and PV) on the tensor cores."""
    B, S, H, D = q.shape
    T = k.shape[1]
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": 2 * B * H * S * T * D / BF16_OPS_PER_S}
    what = max(times, key=times.get)
    return times[what] * 1e3, what


def wkv6_phase(dev):
    """K6 against its plain version (output and final state) at the
    rwkv6-3b prefill shape, at S = 2000 (a padded tail) and under strong
    decay; -> the kernels row."""
    import torch

    from repro_torch.kernels.rwkv6 import ops as k6

    g = torch.Generator(dev).manual_seed(6)

    def inputs(B, S, H, D, strong):
        r, k, v = (torch.randn((B, S, H, D), generator=g, device=dev) * 0.5
                   for _ in range(3))
        z = torch.randn((B, S, H, D), generator=g, device=dev)
        lw = -torch.exp(z * 2.0 + 2.0 if strong else z * 0.5)
        return r, k, v, lw, torch.randn((H, D), generator=g, device=dev) * 0.5

    main_err, main_args = None, None
    for label, shape, strong in (("rwkv6-3b prefill", RWKV_WKV, False),
                                 ("S = 2000, padded", (4, 2000, 40, 64),
                                  False),
                                 ("strong decay", (2, 1024, 40, 64), True)):
        args = inputs(*shape, strong)
        y, s = k6.wkv6(*args)
        yr, sr = k6.wkv6_ref(*args)
        tol = WKV_TOL_STRONG if strong else WKV_TOL
        ok_y, err_y = _close(y, yr, **tol)
        ok_s, err_s = _close(s, sr, **tol)
        log(f"K6 {label} {shape}: max abs err y {err_y:.3g}, final state "
            f"{err_s:.3g} (tolerance rtol {tol['rtol']:.3g} atol "
            f"{tol['atol']:.3g}); finite {bool(torch.isfinite(y).all())}")
        check(ok_y and ok_s and bool(torch.isfinite(y).all()),
              f"K6 {label}: kernel differs from its plain version")
        if main_args is None:
            main_err, main_args = max(err_y, err_s), args
    B, S, H, D = RWKV_WKV
    ms = cuda_ms(lambda: k6.wkv6(*main_args), 10)
    plain = cuda_ms(lambda: k6.wkv6_ref(*main_args), 3)
    per_launch, why = device_us(lambda: k6.wkv6(*main_args),
                                r"wkv6_(intra|scan|inter)", calls=10)
    C, nC = 64, -(-S // 64)
    nbytes = 5 * B * S * H * D * 4 + H * D * 4 + B * H * D * D * 4
    # per chunk of a stream: the intra-chunk scores (difference, exp, two
    # products and a sum per pair and channel), their product with v, and
    # the two (C, D) x (D, D) products of the state
    ops = B * H * nC * (4 * (C * (C - 1) // 2) * D + 2 * C * C * D
                        + 4 * C * D * D)
    # the exponentials the function needs: the strict lower triangle of the
    # pair decays, the decays of r and of k, and each chunk's total decay
    exps = B * H * nC * ((C * (C - 1) // 2) * D + 2 * C * D + D)
    times = dict(bytes=nbytes / HBM_BYTES_PER_S,
                 operations=ops / F32_OPS_PER_S, exponentials=exps / SFU_PER_S)
    bound = max(times, key=times.get)
    log(f"K6 wkv6 {RWKV_WKV} f32: {ms:.4f} ms, plain {plain:.4f} ms; "
        "device a call: " + (f"{per_launch:.1f} us ({why})" if per_launch
                             else f"not measured ({why})")
        + "; bound " + ", ".join(f"{k} {v * 1e3:.4f} ms"
                                 for k, v in times.items()))
    return dict(ms=ms, plain_ms=plain, library_ms=None, max_abs_err=main_err,
                bound_ms=times[bound] * 1e3,
                bound_by="bytes" if bound == "bytes" else "operations")


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def serve_model(dev, arch, fam_mod, kernel_mod, kernel_name, seam, seed):
    """The full-width serve of ``arch`` (batch 4, prompt 2048, 32 tokens):
    once on the kernel, counted, recorded, and with every launch shadowed by
    the plain version on the same inputs (gated at the kernel's tolerance);
    once with the kernel swapped for its plain version, teacher-forced with
    the first run's tokens; once more on the kernel, timed.  -> the
    kernel's launches on the first run.  ``seam`` is the (module, name) of
    the alias through which the model reaches ``kernel_mod``: the shadow
    replaces the alias, so the wrapper itself stays in place and counts.

    The caches of the first two layers must agree between the first two
    runs.  A MoE model's routing can flip where a router logit differs by
    an ulp: its routing agreement by layer and its capacity-drop share are
    printed, not gated, and :func:`routed_alike` gates the first two layers
    again with the experts forced alike."""
    from types import SimpleNamespace
    from unittest import mock

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    kw = dict(SERVE_KW, seed=seed, device=dev)
    cfg = get_config(arch, smoke=kw["smoke"])
    n_layers = cfg.n_layers
    prefill, decode = fam_mod.prefill, fam_mod.decode_step
    kernel, plain = (getattr(kernel_mod, kernel_name),
                     getattr(kernel_mod, kernel_name + "_ref"))
    shadow_errs, tols = [], []

    def tolerance(*a):
        if kernel_name != "flash_attention":
            return WKV_TOL
        q, v = a[0], a[2]
        return kernel_mod.tolerance(kernel_mod.variant(q.dtype, q.shape[-1]),
                                    q.dtype, v)

    def shadowed(*a, **k):
        out = kernel(*a, **k)
        want = plain(*a, **k)
        pairs = (zip(out, want) if isinstance(out, tuple)
                 else [(out, want)])
        tols.append(tolerance(*a))
        shadow_errs.append([_close(x, y, **tols[-1]) for x, y in pairs])
        return out

    def recorded(rec, forced=None):
        def rec_prefill(*a, **k):
            logits, cache = prefill(*a, **k)
            rec["prefill"] = logits.float().cpu()
            rec["cache"] = {n: c.float().cpu() for n, c in cache.items()}
            if k.get("routing") is not None:
                rec["experts"] = [r.experts.cpu() for r in k["routing"]]
            return logits, cache

        def rec_decode(model, cfg, cache, tokens, pos, media=None):
            step = len(rec.setdefault("steps", []))
            if forced is not None:
                tokens = torch.as_tensor(forced[:, step:step + 1],
                                         dtype=torch.int32, device=dev)
            logits, cache = decode(model, cfg, cache, tokens, pos, media)
            rec["steps"].append(logits.float().cpu())
            return logits, cache

        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(fam_mod, "prefill",
                                              rec_prefill))
        stack.enter_context(mock.patch.object(fam_mod, "decode_step",
                                              rec_decode))
        # a graph calls decode_step only while it is captured: the
        # recorded (and teacher-forced) serves decode eagerly
        stack.enter_context(mock.patch.object(serve, "decode",
                                              serve.decode_eager))
        return stack

    runs = {}
    for label in ("kernel", "plain"):
        rec = {}
        forced = runs["kernel"][0]["tokens"] if label == "plain" else None
        reset_counts()
        with recorded(rec, forced), (
                mock.patch.object(*seam, SimpleNamespace(
                    **{kernel_name: shadowed}))
                if label == "kernel" else
                mock.patch.object(kernel_mod, kernel_name, plain)):
            out = serve.serve(arch, **kw)
        runs[label] = (out, rec, read_counts())
        if label == "kernel":
            n_variant = dict(getattr(getattr(kernel_mod, kernel_name),
                                     "variant_launches", {}))
        torch.cuda.empty_cache()
    (out, rec, n), (out_p, rec_p, n_p) = runs["kernel"], runs["plain"]
    launches = out["launches"]
    if kernel_name == "flash_attention":
        check(n_variant == {"flash_tc": n_layers, "flash": 0},
              f"{arch}: K5 launches by variant {n_variant}, expected the "
              f"tensor-core kernel once a layer ({n_layers})")
        log(f"serve {arch}: K5 launches by variant in the prefill "
            f"{n_variant}")
    check(launches["prefill"][kernel_name] == n_layers
          and n[kernel_name] == n_layers
          and not any(v for k, v in n.items() if k != kernel_name)
          and not any(launches["decode"].values()),
          f"{arch}: launches {launches} (counters {n}), expected "
          f"{kernel_name} = {n_layers} in the prefill and none in the decode")
    check(not any(n_p.values()), f"{arch}: the plain-version serve launched "
          f"{n_p}")
    worst = max(err for layer in shadow_errs for _ok, err in layer)
    log(f"serve {arch} shadow check: {kernel_name} == its plain version on "
        f"the same inputs at each of {len(shadow_errs)} launches, max abs "
        f"err {worst:.3g} (tolerance rtol {tols[0]['rtol']:.3g}, atol "
        f"{min(t['atol'] for t in tols):.3g}-"
        f"{max(t['atol'] for t in tols):.3g})")
    check(len(shadow_errs) == n_layers and all(
        ok for layer in shadow_errs for ok, _err in layer),
        f"{arch}: {kernel_name} differs from its plain version inside the "
        f"serve: {shadow_errs}")
    per_layer = {name: [_rel_l2(a, b) for a, b in zip(rec["cache"][name],
                                                      rec_p["cache"][name])]
                 for name in rec["cache"]}
    errs = {"prefill logits": _rel_l2(rec["prefill"], rec_p["prefill"]),
            "decode logits (worst step)": max(
                _rel_l2(a, b) for a, b in zip(rec["steps"], rec_p["steps"]))}
    check(len(rec["steps"]) == len(rec_p["steps"]) == kw["gen"] - 1,
          f"{arch}: decode steps {len(rec['steps'])}/{len(rec_p['steps'])}")
    finite = all(bool(torch.isfinite(x).all()) for x in
                 [rec["prefill"], *rec["steps"], *rec["cache"].values()])
    log(f"serve {arch} on the kernel vs on its plain version (teacher-"
        f"forced), relative L2: " + ", ".join(f"{k} {v:.3g}"
                                              for k, v in errs.items())
        + "; cache by layer " + "; ".join(
            f"{name} " + " ".join(f"{v:.1e}" for v in vals)
            for name, vals in per_layer.items())
        + f"; greedy tokens agreeing "
        f"{int((out['tokens'] == out_p['tokens']).sum())}/"
        f"{out['tokens'].size} (not gated); finite {finite}")
    if cfg.is_moe:
        agree = [float((a == b).float().mean())
                 for a, b in zip(rec["experts"], rec_p["experts"])]
        log(f"serve {arch} routing: share of (token, slot) expert choices "
            f"alike in the kernel run and the plain-version run, by layer "
            + " ".join(f"{v:.4f}" for v in agree) + f" (not gated); "
            f"capacity drops in the prefill {out['drop_share']:.4%} of the "
            f"(token, slot) pairs (plain-version run "
            f"{out_p['drop_share']:.4%})")
    first = max(v for vals in per_layer.values() for v in vals[:2])
    check(finite and first <= SERVE_FIRST_LAYERS_REL_L2,
          f"{arch}: the caches of the first two layers differ between the "
          f"serve on {kernel_name} and on its plain version by {first} "
          f"(tolerance {SERVE_FIRST_LAYERS_REL_L2})")
    eager_steps = rec["steps"]
    del rec, rec_p, runs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graphed_steps = []

    def graphed(*a, **k):       # each step's logits, copied after a replay
        return graph_decode(*a, on_step=lambda lg: graphed_steps.append(
            lg.clone()), **k)

    graph_decode = serve.decode
    with mock.patch.object(serve, "decode", graphed):
        timed = serve.serve(arch, **kw)
    peak = torch.cuda.max_memory_allocated()
    graphed_steps = [x.float().cpu() for x in graphed_steps]
    same = (len(graphed_steps) == len(eager_steps) == kw["gen"] - 1
            and all(torch.equal(a, b)
                    for a, b in zip(graphed_steps, eager_steps)))
    check(timed["captures"] == 1 and same
          and (timed["tokens"] == out["tokens"]).all(),
          f"{arch}: the graphed decode ({timed['captures']} captures) "
          f"differs from the eager kernel run: logits alike {same}, tokens "
          f"alike {int((timed['tokens'] == out['tokens']).sum())}/"
          f"{out['tokens'].size}")
    torch.cuda.empty_cache()
    with mock.patch.object(serve, "decode", serve.decode_eager):
        eager = serve.serve(arch, **kw)
    check(eager["captures"] == 0
          and (eager["tokens"] == timed["tokens"]).all(),
          f"{arch}: the eager timed serve's tokens differ from the graphed")
    drops = ("" if timed["drop_share"] is None else
             f", capacity drops {timed['drop_share']:.4%}")
    log(f"serve {arch} (timed run, decode on the graph): prefill "
        f"{timed['prefill_s'] * 1e3:.2f} ms "
        f"for {kw['batch']} x {kw['prompt_len']} tokens, decode "
        f"{timed['decode_s'] * 1e3:.2f} ms, {timed['tok_per_s']:.2f} "
        f"tokens/s ({timed['tok_per_s'] / kw['batch']:.2f} a sequence), "
        f"parameters {timed['param_bytes'] / 1e9:.3f} GB (f32), "
        f"max memory allocated {peak / 1e9:.3f} GB{drops}; "
        f"plain-version serve prefill {out_p['prefill_s'] * 1e3:.2f} ms, "
        f"first kernel serve prefill {out['prefill_s'] * 1e3:.2f} ms")
    steps = kw["gen"] - 1
    log(f"serve {arch} decode, graphed vs eager: "
        f"{timed['decode_s'] / steps * 1e3:.3f} vs "
        f"{eager['decode_s'] / steps * 1e3:.3f} ms a step, "
        f"{timed['tok_per_s'] / kw['batch']:.2f} vs "
        f"{eager['tok_per_s'] / kw['batch']:.2f} tokens/s a sequence "
        f"(limit {DECODE_LIMIT_PER_SEQ}); the capture (warm-up step and "
        f"recording) {timed['capture_s']:.3f} s; the graph's {steps} steps' "
        f"logits and tokens == the eager kernel run's bit for bit")
    torch.cuda.empty_cache()
    if cfg.is_moe:
        routed_alike(dev, arch, fam_mod, kernel_mod, seed)
    busy_shares(dev, arch, fam_mod,
                "flash_tc" if kernel_name == "flash_attention" else "wkv6")
    f32_divergence(dev, arch, fam_mod, kernel_mod, kernel_name, seed)
    return n[kernel_name]


def routed_alike(dev, arch, fam_mod, kernel_mod, seed):
    """A MoE model's prefill (the serve's prompts) on K5, then with K5
    swapped for its plain version and every layer's experts forced to the
    first run's (``layers._top_k``), so the two differ by K5 alone, as a
    dense model's serves do: the caches of the first two layers within
    SERVE_FIRST_LAYERS_REL_L2 and the capacity drops equal, layer by layer
    (gated); the deeper layers printed."""
    from unittest import mock

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.common import init_model
    from repro_torch.nn import layers

    cfg = get_config(arch)
    model = init_model(fam_mod, cfg, torch.Generator(dev).manual_seed(0))
    B, S = SERVE_KW["batch"], SERVE_KW["prompt_len"]
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, size=(B, S)), dtype=torch.int32, device=dev)
    runs = {}
    with torch.no_grad():
        routing = []
        runs["kernel"] = fam_mod.prefill(model, cfg, prompts, max_seq=S,
                                         routing=routing)[1]
        experts = iter([r.experts for r in routing])

        def forced(probs, k):
            top_i = next(experts)
            return probs.gather(1, top_i), top_i

        forced_routing = []
        with mock.patch.object(kernel_mod, "flash_attention",
                               kernel_mod.flash_attention_ref), \
                mock.patch.object(layers, "_top_k", forced):
            runs["plain"] = fam_mod.prefill(model, cfg, prompts, max_seq=S,
                                             routing=forced_routing)[1]
    drops = [int(r.dropped) for r in routing]
    same_drops = drops == [int(r.dropped) for r in forced_routing]
    per_layer = {name: [_rel_l2(a, b) for a, b in zip(
        runs["kernel"][name], runs["plain"][name])] for name in runs["kernel"]}
    first = max(v for vals in per_layer.values() for v in vals[:2])
    log(f"serve {arch} prefill on K5 vs on its plain version with the "
        f"experts forced to the K5 run's: cache by layer, relative L2 "
        + "; ".join(f"{name} " + " ".join(f"{v:.1e}" for v in vals)
                    for name, vals in per_layer.items())
        + f"; capacity drops by layer {drops}, equal {same_drops}")
    check(first <= SERVE_FIRST_LAYERS_REL_L2 and same_drops,
          f"{arch}: with the experts forced alike, the caches of the first "
          f"two layers differ between K5 and its plain version by {first} "
          f"(tolerance {SERVE_FIRST_LAYERS_REL_L2}), or the drops "
          f"({same_drops})")
    del model, runs
    torch.cuda.empty_cache()


def decode_bytes(model, cfg, cache):
    """The bytes one decode step must move: every weight it reads, once, in
    the compute type (the bf16 casts; the 1-D scales and decays, read in
    f32 or cast, are counted at the compute type's size too: under 1 MB),
    less an untied embedding table's rows past the batch's and RWKV
    channel-mix ``wr`` off its diagonal (the step reads only those); the
    K/V cache read whole, or the WKV state and the shift tokens read and
    written; the logits written."""
    import torch

    esize = torch.empty((), dtype=cfg.cdtype()).element_size()
    B = next(iter(cache.values())).shape[1]
    weights = sum(p.numel() for p in model.parameters())
    if not cfg.tie_embeddings:
        weights -= (cfg.padded_vocab - B) * cfg.d_model
    if cfg.family == "ssm":
        weights -= cfg.n_layers * (cfg.d_model ** 2 - cfg.d_model)
    state = sum(c.numel() * c.element_size() for c in cache.values())
    moved = state if cfg.family != "ssm" else 2 * state
    return weights * esize + moved + B * cfg.padded_vocab * esize


def busy_shares(dev, arch, fam_mod, kernel_key, steps=16):
    """The device's busy share of one prefill (batch 4, prompt 2048), of
    ``steps`` eager decode steps after it and of ``steps`` replays of the
    decode step captured as a CUDA graph (``serve.DecodeStep``), each under
    torch.profiler, with the device time of the kernels whose names hold
    ``kernel_key`` and the kernels a decode step; and the step's byte
    bound (:func:`decode_bytes`); printed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.common import init_model

    cfg = get_config(arch)
    model = init_model(fam_mod, cfg, torch.Generator(dev).manual_seed(0))
    B, S = SERVE_KW["batch"], SERVE_KW["prompt_len"]
    prompts = torch.randint(2, cfg.vocab_size, (B, S), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    wall, out = {}, {}

    def timed(key, fn):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall[key] = time.perf_counter() - t0
        return run

    def prefill():
        out["prefill"] = fam_mod.prefill(model, cfg, prompts,
                                         max_seq=S + 2 * steps + 2)

    def decode_line(key, times, why, launched):
        if not times:
            return why
        busy = sum(times.values()) / 1e6
        return (f"device busy share {busy / wall[key]:.4f}, "
                f"{busy / steps * 1e3:.3f} ms of device time in a "
                f"{wall[key] / steps * 1e3:.3f} ms step, "
                f"{sum(launched.values()) / steps:.0f} kernels a step")

    with torch.no_grad():
        prefill()                                           # warm
        del out["prefill"]
        torch.cuda.empty_cache()
        times_p, why_p = device_times(timed("prefill", prefill))
        logits, cache = out.pop("prefill")
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        fam_mod.decode_step(model, cfg, cache, tok, S)      # warm

        def decode():
            for i in range(steps):
                fam_mod.decode_step(model, cfg, cache, tok, S + 1 + i)

        launched = {}
        times_d, why_d = device_times(timed("decode", decode), launched)
        t0 = time.perf_counter()
        ds = serve.DecodeStep(fam_mod, model, cfg, cache, steps + 2)
        capture_s = time.perf_counter() - t0
        ds.start(tok.to(torch.int32), S + steps + 1)
        ds.step()                                           # warm

        def replays():
            for _ in range(steps):
                ds.step()

        launched_g = {}
        times_g, why_g = device_times(timed("graph", replays), launched_g)
        ds.close()
        nbytes = decode_bytes(model, cfg, cache)
    if times_p:
        busy = sum(times_p.values()) / 1e6
        kern = sum(v for k, v in times_p.items() if kernel_key in k) / 1e6
        top = sorted(times_p.items(), key=lambda kv: -kv[1])[:5]
        why_p = (f"device busy share {busy / wall['prefill']:.4f}, "
                 f"{busy * 1e3:.3f} ms of device time in a "
                 f"{wall['prefill'] * 1e3:.3f} ms prefill, of which "
                 f"{kernel_key} {kern * 1e3:.3f} ms ({kern / busy:.1%}); "
                 f"the five longest kernels: " + "; ".join(
                     f"{name[:60]} {us / 1e3:.3f} ms" for name, us in top))
    why_d = decode_line("decode", times_d, why_d, launched)
    why_g = decode_line("graph", times_g, why_g, launched_g)
    if times_g:
        top = sorted(times_g.items(), key=lambda kv: -kv[1])[:5]
        why_g += "; the five longest kernels a step: " + "; ".join(
            f"{name[:60]} {us / steps:.1f} us" for name, us in top)
    log(f"serve {arch} prefill: {why_p}; decode, eager: {why_d}; decode, "
        f"graph replays: {why_g} (torch.profiler, {steps} steps; the "
        f"graph's capture {capture_s:.3f} s); a decode step's byte bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms ({nbytes / 1e9:.3f} GB "
        f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    del model, cache, ds
    torch.cuda.empty_cache()


def f32_divergence(dev, arch, fam_mod, kernel_mod, kernel_name, seed):
    """The serve's prefill again in f32 compute, on the kernel and on its
    plain version: printed, not gated.  A growth that stays in f32 comes
    from the model amplifying any difference, not from bf16 rounding."""
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.common import init_model

    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    model = init_model(fam_mod, cfg, torch.Generator(dev).manual_seed(0))
    B, S = SERVE_KW["batch"], SERVE_KW["prompt_len"]
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, size=(B, S)), dtype=torch.int32, device=dev)
    with torch.no_grad():
        a, ca = fam_mod.prefill(model, cfg, prompts, max_seq=S)
        with mock.patch.object(kernel_mod, kernel_name,
                               getattr(kernel_mod, kernel_name + "_ref")):
            b, cb = fam_mod.prefill(model, cfg, prompts, max_seq=S)
    name = next(iter(ca))
    per_layer = [_rel_l2(x, y) for x, y in zip(ca[name], cb[name])]
    log(f"serve {arch} prefill in f32 compute, on the kernel vs on its plain "
        f"version (not gated): logits relative L2 {_rel_l2(a, b):.3g}; "
        f"cache {name} by layer " + " ".join(f"{v:.1e}" for v in per_layer)
        + f"; max |{name}| in layer 0 {float(ca[name][0].abs().max()):.4g}")
    del model, ca, cb
    torch.cuda.empty_cache()


def models_phase(dev, seed):
    """-> (kernels rows, launches) of K5 and K6: K5's over the qwen2-1.5b
    and granite-moe-3b-a800m serves' prefills, K6's over rwkv6-3b's."""
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.rwkv6 import ops as k6
    from repro_torch.models import lm, rwkv
    from repro_torch.nn import layers, ssm

    rows = {"flash_attention": flash_phase(dev), "wkv6": wkv6_phase(dev)}
    k5_serves = {}
    for arch in ("qwen2-1.5b", "granite-moe-3b-a800m"):
        t0 = time.perf_counter()
        k5_serves[arch] = serve_model(dev, arch, lm, k5, "flash_attention",
                                      (layers, "_k5"), seed)
        log(f"serve {arch}: {time.perf_counter() - t0:.1f} s")
    log(f"K5 launches by serve: {k5_serves}")
    launches = {
        "flash_attention": sum(k5_serves.values()),
        "wkv6": serve_model(dev, "rwkv6-3b", rwkv, k6, "wkv6", (ssm, "_k6"),
                            seed)}
    return rows, launches


# -- phase 7: progressive filling, the paper's Section 2 --------------------

FILL_TRIALS = 200           # paper_tables' trials a stochastic scheduler
FILL_MEAN_ATOL = 0.8        # tests/test_filling_jax.py's RRR tolerance
FLEET_FILL_STEPS = 2 ** 15  # the fleet fill takes about 14,000 grants
FLEET_TRIALS = 8
FIG_SEEDS = 2               # paper_figures' seeds, cut from 8


def fleet_fill_inputs(agents, fws, dev):
    """-> (D, C, phi, allowed) of the fleet on the card, no wanted cap."""
    import torch

    arr = fleet_arrays(agents, fws)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=dev)
    return (f(arr["D"]), f(arr["C"]), f(arr["phi"]),
            torch.as_tensor(arr["allowed"], device=dev))


def saturated(x, D, C, allowed):
    """-> (no feasible pair left, least residual) of an int (N, J)
    allocation, in f64 on the host as the numpy filler's ``Instance``
    checks it."""
    D, C = D.double().cpu().numpy(), C.double().cpu().numpy()
    x = np.asarray(x.cpu().numpy(), np.float64)
    res = C - x.T @ D
    fits = (D[:, None, :] <= res[None, :, :] + 1e-9).all(-1)
    if allowed is not None:
        fits &= allowed.cpu().numpy()
    return not fits.any(), float(res.min())


@contextlib.contextmanager
def loop_counts():
    """-> a list that receives the grant count of every
    ``engine_torch.epoch_loop`` run inside the block."""
    from unittest import mock

    from repro_torch.core import engine_torch

    counts, loop = [], engine_torch.epoch_loop

    def spy(*a, **k):
        out = loop(*a, **k)
        counts.append(int(out[2]))
        return out

    with mock.patch.object(engine_torch, "epoch_loop", spy):
        yield counts


def k3_plain():
    """Swap K3 for its plain version inside the engine."""
    from unittest import mock

    from repro_torch.core import engine_torch
    from repro_torch.kernels.epoch_persistent.ref import persistent_epoch_ref

    return mock.patch.object(engine_torch, "persistent_epoch",
                             persistent_epoch_ref)


def paper_fill(dev, seed):
    """The paper's tables on the card, through
    ``launch.paper_tables``, against the same rows from the numpy
    filler: -> K3 launches of its pooled fills (one each)."""
    import torch

    from repro_torch.core.filling import (
        PAPER_SCHEDULERS,
        progressive_fill,
        run_trials,
    )
    from repro_torch.core.filling_torch import fill_trials_torch
    from repro_torch.core.instance import paper_example
    from repro_torch.kernels.epoch_persistent import ops as k3
    from repro_torch.launch import paper_tables as pt

    inst = paper_example()
    reset_counts()
    got = pt.run(print_csv=False, device=dev)
    launches = k3.persistent_epoch.launches
    check(launches == 2, f"paper tables: K3 launched {launches} times, "
          "not once for each of PS-DSF and rPS-DSF")
    want = pt.table_rows(
        inst, {n: run_trials(inst, PAPER_SCHEDULERS[n], pt.N_TRIALS, seed=1)
               for n in pt.STOCHASTIC},
        {n: progressive_fill(inst, PAPER_SCHEDULERS[n], seed=0).x
         for n in pt.DETERMINISTIC})
    gap = 0.0
    for (table, name, i, v, _), (*_, w, _) in zip(got, want):
        if name in pt.DETERMINISTIC:
            check(v == w, f"paper tables {table} {name}[{i}]: {v} on the "
                  f"card, {w} from the numpy filler")
        elif table == "T1_alloc_mean":
            gap = max(gap, abs(v - w))
    check(gap <= FILL_MEAN_ATOL, f"paper tables: trial means {gap} from "
          "the numpy filler's")
    # the claim at filling.py's RRR-rPS-DSF: every trial is rPS-DSF's fill
    cfg = PAPER_SCHEDULERS["RRR-rPS-DSF"]
    f = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=dev)
    x = fill_trials_torch(
        f(inst.demands), f(inst.capacities), f(inst.weights), FILL_TRIALS,
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
        criterion=cfg.criterion, policy=cfg.server_policy, tie=cfg.tie,
        lookahead=cfg.lookahead).cpu().numpy()
    bad = int((x.reshape(FILL_TRIALS, 4) != [19, 2, 2, 19]).any(1).sum())
    check(bad == 0, f"fill RRR-rPS-DSF: {bad} of {FILL_TRIALS} trials "
          "differ from (19, 2, 2, 19)")

    def totals(rows):
        return {n: sum(v for t, s, _, v, _ in rows
                       if t == "T1_alloc_mean" and s == n)
                for n in pt.PAPER_T1}

    card, numpy_, paper = totals(got), totals(want), {
        k: sum(v) for k, v in pt.PAPER_T1.items()}
    log("fill, the paper's tables on the card (launch.paper_tables; total "
        "tasks, the numpy filler's and the paper's in brackets; "
        f"stochastic: means of {pt.N_TRIALS} trials, within {gap:.3f} of "
        "the numpy filler's a cell): " + ", ".join(
            f"{k} {card[k]:.2f} [{numpy_[k]:.2f}, {paper[k]:g}]"
            for k in pt.PAPER_T1)
        + f"; RRR-rPS-DSF all {FILL_TRIALS} trials (19, 2, 2, 19)")
    return launches


def fleet_fill(dev, agents, fws):
    """The pooled fleet fill to exhaustion on K3, against the same fill on
    K3's plain version: -> K3 launches (one a fill)."""
    import torch

    from repro_torch.core.filling_torch import progressive_fill_torch
    from repro_torch.kernels.epoch_persistent import ops as k3

    D, C, phi, allowed = fleet_fill_inputs(agents, fws, dev)
    launches = 0
    for crit in CRITERIA:
        kw = dict(criterion=crit, policy="pooled", tie="low",
                  lookahead=False, max_steps=FLEET_FILL_STEPS,
                  allowed=allowed)

        def fill():
            return progressive_fill_torch(D, C, phi, None, **kw)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with loop_counts() as count:
            x = fill()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        n = k3.persistent_epoch.launches
        check(n == 1, f"fleet fill {crit}: K3 launched {n} times")
        launches += n
        grid = k3.persistent_epoch.grid
        ms = cuda_ms(fill, 3, warmup=0)
        with k3_plain(), loop_counts() as count_plain, graph_counts() as g:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fill()
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        check(g["replays"] > 0, f"fleet fill {crit}: K3's plain version "
              "ran no graph")
        check(torch.equal(x, y) and count == count_plain,
              f"fleet fill {crit}: K3 ({count}) differs from its plain "
              f"version ({count_plain})")
        grants = int(x.sum())
        check(count == [grants] and grants < FLEET_FILL_STEPS,
              f"fleet fill {crit}: {count} grants, budget "
              f"{FLEET_FILL_STEPS}")
        full, least = saturated(x, D, C, allowed)
        check(full and least >= -1e-4, f"fleet fill {crit}: a feasible "
              f"pair is left or a residual is {least}")
        log(f"fleet fill {crit}/pooled {D.shape[0]}x{C.shape[0]}: {grants} "
            f"grants, {ms:.2f} ms a fill ({ms / grants * 1e3:.2f} us a "
            f"grant; first {first_ms:.2f} ms), K3 launches {n} on grid "
            f"{grid}; K3's plain version {plain_s:.2f} s on the loop's graph "
            f"({(plain_s - g['capture_s']) / grants * 1e6:.1f} us a grant "
            f"without its capture of {g['capture_s']:.2f} s; {g['replays']} "
            f"replays, {g['reads']} flag reads), equal; saturated, "
            f"least residual {least:g}")
    return launches


def fleet_trials(dev, agents, fws, seed):
    """RRR trials at the fleet size on the step loop, each to exhaustion."""
    import torch

    from repro_torch.core import filling_torch

    from unittest import mock

    D, C, phi, allowed = fleet_fill_inputs(agents, fws, dev)
    init = filling_torch._FillGraph.__init__
    for crit in ("drf", "rpsdsf"):
        capture = []

        def timed_init(self, *a, **k):
            t = time.perf_counter()
            init(self, *a, **k)
            capture.append(time.perf_counter() - t)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(filling_torch._FillGraph, "__init__",
                               timed_init):
            x = filling_torch.fill_trials_torch(
                D, C, phi, FLEET_TRIALS,
                generator=torch.Generator(device=dev).manual_seed(seed),
                criterion=crit, policy="rrr", tie="random", lookahead=False,
                max_steps=FLEET_FILL_STEPS, allowed=allowed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - sum(capture)
        check(len(capture) == 1, f"fleet trials {crit}/rrr: {len(capture)} "
              "captures of the step loop, not one")
        grants = x.sum((1, 2)).tolist()
        steps = max(grants)
        check(steps < FLEET_FILL_STEPS, f"fleet trials {crit}/rrr: the step "
              "budget ran out")
        for t in range(FLEET_TRIALS):
            full, least = saturated(x[t], D, C, allowed)
            check(full and least >= -1e-4, f"fleet trials {crit}/rrr: trial "
                  f"{t} left a feasible pair or a residual of {least}")
        log(f"fleet trials {crit}/rrr tie random: {FLEET_TRIALS} trials of "
            f"{D.shape[0]}x{C.shape[0]}, grants {min(grants)}-{steps}, "
            f"{steps} steps in {wall:.2f} s on the step loop's graph, "
            f"without its capture of {capture[0]:.2f} s ({steps / wall:.0f} "
            f"steps/s, {wall / steps * 1e3:.3f} ms a step of all trials; one "
            f"replay and one alive read every {filling_torch.ALIVE_EVERY} "
            "steps); every trial saturated")


def paper_drivers(dev):
    """The paper's Figure 3-8 and Figure 9 drivers on the card."""
    import io
    from unittest import mock

    from repro_torch.launch import fig9_adaptation, paper_figures

    seeds = len(paper_figures.SEEDS)
    with mock.patch.object(paper_figures, "SEEDS", range(FIG_SEEDS)):
        rows = {d: paper_figures.run(print_csv=False, device=d)
                for d in (dev, "cpu")}
    check(rows[dev].keys() == rows["cpu"].keys() and all(
        np.array_equal(rows[dev][k], rows["cpu"][k]) for k in rows["cpu"]),
        "paper_figures on the card differs from the CPU")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fig9_adaptation.run(device=dev)
    claims = [ln for ln in buf.getvalue().splitlines()
              if ln.startswith("# CLAIM")]
    check(len(claims) == 2 and all("PASS" in ln for ln in claims),
          f"fig9_adaptation on the card: {claims}")
    log(f"paper_figures: {len(rows[dev])} configurations on the card == "
        f"CPU (seeds cut from {seeds} to {FIG_SEEDS}); fig9_adaptation on "
        "the card: " + "; ".join(claims))


def fill_phase(dev, agents, fws, seed):
    """-> K3's launches over the phase's pooled fills."""
    t0 = time.perf_counter()
    parts, launches = {}, 0
    for part, fn in (("paper tables", lambda: paper_fill(dev, seed)),
                     ("fleet fills", lambda: fleet_fill(dev, agents, fws)),
                     ("fleet trials", lambda: fleet_trials(dev, agents, fws,
                                                           seed)),
                     ("figure scripts", lambda: paper_drivers(dev))):
        t = time.perf_counter()
        launches += fn() or 0
        parts[part] = time.perf_counter() - t
    log(f"fill phase {time.perf_counter() - t0:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="kernels,allocator,des,serve,gang,models,fill",
                    help="comma list of kernels, allocator, des, serve, gang, "
                    "models, fill, and chunks (a sweep of the epoch loop's "
                    "chunk size; not a default phase)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import _build
    from repro_torch.kernels.epoch_persistent import ops as k3
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.psdsf_score import ops as tiles
    from repro_torch.kernels.rwkv6 import ops as k6

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    sources = [tiles.SOURCE, k3.SOURCE, *k5.SOURCES.values(), k6.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc each
        builds = [pool.submit(_build.build, src) for src in sources]
        for b in builds:
            b.result()          # raises on a build error
    tiles.library()
    k3.library()
    for name in k5.SOURCES:
        k5.library(name)
    k6.library()
    log(f"built {', '.join(src.name for src in sources)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src in sources:
        log(f"ptxas {src.name}: " + "; ".join(ptxas_summary(
            _build.library_path(src).with_suffix(".log").read_text())))
    rng = np.random.default_rng(args.seed)
    agents, fws = fleet()
    rows = {}
    if "kernels" in phases:
        rows = kernels_phase(rng, dev, agents, fws)
        rows["psdsf_argmin"] = psdsf_phase(rng, dev)
    launches = {}
    if "allocator" in phases:
        launches = allocator_phase(dev, agents, fws, args.seed)
        log(f"launches (K3 over the allocator's fleet epochs, K1/K2 over "
            f"the tiles-loop replays): {launches}")
        for name, n in launches.items():
            check(n > 0, f"main path never launched {name}")
    if "des" in phases:
        des_phase(dev, agents, args.seed)
    if "serve" in phases:
        launches["psdsf_argmin"] = serve_phase(dev, args.seed)
        log(f"launches (K4 over the fleet serve on the per-grant backend): "
            f"{launches['psdsf_argmin']}")
        check(launches["psdsf_argmin"] > 0, "main path never launched "
              "psdsf_argmin")
    if "gang" in phases:
        gang_phase(dev, args.seed)
    if "models" in phases:
        t0 = time.perf_counter()
        model_rows, model_launches = models_phase(dev, args.seed)
        rows.update(model_rows)
        launches.update(model_launches)
        log(f"launches (K5 over the qwen2-1.5b and granite-moe-3b-a800m "
            f"serves' prefills, K6 over the rwkv6-3b serve's prefill): "
            f"{model_launches}; models phase "
            f"{time.perf_counter() - t0:.1f} s")
        for name, n in model_launches.items():
            check(n > 0, f"main path never launched {name}")
    fill_launches = None
    if "chunks" in phases:
        chunks_phase(dev, agents, fws)
    if "fill" in phases:
        fill_launches = fill_phase(dev, agents, fws, args.seed)
        log(f"launches (K3 over the pooled fills, one a fill): "
            f"{fill_launches}")
        check(fill_launches > 0, "the fill path never launched "
              "persistent_epoch")
    meta = {
        "masked_argmin1d": dict(
            route="cuda",
            source="src/repro_torch/kernels/psdsf_score/csrc/argmin.cu",
            replaces="src/repro/kernels/psdsf_score/kernel.py:91"),
        "masked_argmin2d": dict(
            route="cuda",
            source="src/repro_torch/kernels/psdsf_score/csrc/argmin.cu",
            replaces="src/repro/kernels/psdsf_score/kernel.py:137"),
        "persistent_epoch": dict(
            route="cuda",
            source="src/repro_torch/kernels/epoch_persistent/csrc/epoch.cu",
            replaces="src/repro/kernels/epoch_persistent/ops.py:49"),
        "psdsf_argmin": dict(
            route="cuda",
            source="src/repro_torch/kernels/psdsf_score/csrc/argmin.cu",
            replaces="src/repro/kernels/psdsf_score/kernel.py:169"),
        "flash_attention": dict(
            route="cuda",
            source="src/repro_torch/kernels/flash_attention/csrc/flash_tc.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:80"),
        "wkv6": dict(
            route="cuda",
            source="src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
            replaces="src/repro/kernels/rwkv6/kernel.py:67"),
    }
    log(f"chip_smoke phases {','.join(sorted(phases))}: "
        f"{time.perf_counter() - t_start:.1f} s, the builds included")
    if set(rows) == set(launches) == set(meta):
        out = [dict(name=name, **meta[name], launches=launches[name],
                    **rows[name]) for name in meta]
        if fill_launches is not None:   # the fill path's own K3 count
            out[list(meta).index("persistent_epoch")]["fill_launches"] = (
                fill_launches)
        log(json.dumps({"kernels": out}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
