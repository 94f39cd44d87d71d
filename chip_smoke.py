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
   granite-moe-3b's (4, 24, 2048, 64) x (4, 8, 2048, 64) bf16, at
   deepseek-v2's MLA prefill, q/k (4, 128, 2048, 192) and v (4, 128, 2048,
   128) bf16, at hymba-1.5b's (4, 25, 2048, 64) x (4, 5, 2048, 64)
   bf16 with its window of 1024 and with none, and at whisper-large-v3's
   encoder, (4, 1500, 20, 64) against itself, and cross-attention, q (4,
   224, 20, 64) against k/v (4, 1500, 20, 64), bf16 non-causal, and at
   llama-3.2-vision-90b's self layers, q (4, 2048, 64, 128) against k/v
   (4, 2048, 8, 128) bf16 causal, and cross layers, the same q against
   k/v (4, 1601, 8, 128) bf16 non-causal (each timed
   beside its bound and SDPA, whose backend is named; the windowed one
   beside SDPA with a boolean window mask), in
   f32, with a window below the key tile, non-causal with T != S, at a
   ragged S, in f16 and with rows that see no key, and at MLA's (192, 128)
   with a ragged S, a window and in f16 with GQA, each on the kernel the
   wrapper's rule picks (``flash_tc.cu``, the tensor cores, for bf16 / f16
   at (q/k, v) head dims (64, 64), (128, 128), (256, 256) and (192, 128);
   ``flash.cu``, the CUDA cores, for f32) and within that kernel's stated
   tolerance; the tensor-core kernel timed beside the
   CUDA-core one at the same shape, the plain version and
   ``scaled_dot_product_attention`` (a yardstick only); each case on
   ``flash_tc`` again with its log-sum-exp (the backward's input): the
   output bit for bit the same, and on the edge cases the log-sum-exp
   within f32 rounding of its plain version.  K6 (WKV6) at the
   rwkv6-3b prefill shape (4, 2048, 40, 64), at S = 2000 and under strong
   decay, output and final state, within the tolerance printed beside it,
   timed beside its plain version.  Then the
   model serve path, ``repro_torch.launch.serve.serve`` at full width
   (batch 4, prompt 2048, 32 tokens, weights from a seeded generator;
   whisper at its own shape, ``SERVE_SHAPES``) for
   qwen2-1.5b (K5 exactly once a layer in the prefill, all on the
   tensor-core kernel: 28), granite-moe-3b-a800m (K5: 32; its 40-expert
   MoE on the batch-local capacity grid in the prefill, dropless in the
   decode), deepseek-v2-236b at full width cut to 4 of its 60 layers with
   its parameters stored in bf16 (MLA attention, K5: 4, all at (192,
   128); its 160-expert MoE on the global capacity grid; the decode's
   compressed cache), hymba-1.5b at full width and depth (32 layers of
   parallel attention and Mamba heads; K5: 32, 29 of them with the window
   of 1024 and the three global layers with none, counted by window and
   gated; the Mamba head's scan in plain PyTorch, its share of the
   prefill's device time printed; the cache's ``h`` and ``conv`` gated
   with ``k`` and ``v``), whisper-large-v3 at full width and depth (32
   encoder and 32 decoder layers, batch 4, 1500 frames of the stub
   frontend, prompt 224, 224 tokens; K5: 96, all at (64, 64): 32
   non-causal at 1500 x 1500 in the encoder, 32 causal at 224 x 224 and
   32 non-causal at 224 x 1500 in the decoder, counted by (causal, S, T)
   and gated; the encoder's share of the prefill's device time printed;
   the decode cross-attends the cached ``xk``/``xv``),
   llama-3.2-vision-90b at full width cut to 2 of its 20 groups (8 self
   and 2 gated cross layers, parameters stored in bf16, 21.3 GB; 1601
   media tokens of the stub vision tower; every cross layer's two gates
   set to ``VLM_GATE`` on the served model, the reference's init leaving
   them 0; K5: 10, all at (128, 128): 8 causal at 2048 x 2048 in the self
   layers and 2 non-causal at 2048 x 1601 in the cross layers, counted by
   (causal, S, T) and gated) and rwkv6-3b
   (K6: 32), each launch shadowed by the plain version on the same inputs
   (gated at the kernel's tolerance), against the same serve with the
   kernel swapped for its plain version, teacher-forced with the first
   run's tokens (whisper's also with the first run's encoder output): the
   caches of the first two layers (whisper's ``k``, ``v``, ``xk``, ``xv``,
   and its first encoder layer's output, one attention deep as the other
   models' layer-1 caches; the VLM's ``k``, ``v`` of group 0's self
   layers 0 and 1 and the ``xk``, ``xv`` of its first two groups, which
   depend on the media alone) within a relative L2 tolerance (for granite
   also in a prefill on the plain version with every layer's experts
   forced to the K5 run's, drops equal layer by layer; for deepseek
   too); the other layers, prefill and decode logits, greedy-token
   agreement, the MoE models' routing agreement by layer and
   their capacity-drop share, and each serve's peak memory are printed, not
   gated.  Those two serves decode
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
   the Figure 9 driver on the card with both claims passing;
8. mesh: the multi-device epoch (``engine_torch.epoch_loop_mesh``) on K
   logical shards of the one card (``launch.mesh.shard_devices``; no
   interconnect is exercised) at the fleet size, from each pair's first
   allocator epoch: all eight pairs at K = 2, rPS-DSF/pooled and DRF/RRR
   at K = 1, 4 and 8, each on its captured graphs and equal to the plain
   loop's grants and final X, FREE and used, whose grants equal K3's;
   printed per run: ms an epoch and us a grant without the capture,
   captures, chunk replays, beside the plain loop and K3 on the same
   epoch.  The pooled rPS-DSF fleet fill on two shards equals K3's
   one-launch fill.  With two cards or more, K = 2 also runs on two cards
   (eagerly); otherwise the phase says it did not.  The mesh launches no
   kernel (counted from zero around each run);
9. train: K5's backward against its plain version on the card, each case
   on the kernel the rule picks (``ops.bwd_variant``: ``flash_bwd_tc.cu``,
   wgmma + TMA behind the forward kernel's log-sum-exp, for bf16 / f16 at
   (64, 64), (128, 128) and (192, 128); ``flash_bwd.cu``, the CUDA cores,
   otherwise), at qwen2-1.5b's training shape, (2, 4096, 12, 128) against
   (2, 4096, 2, 128) bf16 causal, and windowed, non-causal (S != T), MLA's
   (192, 128), f32 D-16, ragged causal S != T and (256, 256) cases, each
   gradient within ``ops.bwd_tolerance`` of its variant (relative L2) and
   two runs the same bits; at every case on ``flash_bwd_tc`` timed beside
   its bound, ``flash_bwd.cu`` on the same inputs and
   ``scaled_dot_product_attention``'s backward (and its plain version at
   the training shape).  The first micro-batch's gradients on K5's
   kernels: at full depth in bf16 against the forward kernel with the
   plain backward (the same loss bits, each layer's gradient within 0.1,
   and at two layers within the backward kernel's tolerance), and on the
   config cut to two layers in f32 against the plain versions (printed:
   the kernels against the plain versions in bf16).  K6's backward
   (``wkv6_bwd.cu``: a pre-pass, the adjoint scan, one fused chunk pass
   whose factored decays run on split-TF32 tensor cores, and du, reading
   the forward kernel's saved chunk states) against its plain backward
   (``ref.wkv6_bwd_ref``) at
   rwkv6-3b's training shape (2, 4096, 40, 64), at S = 2000 (a padded
   tail) and under strong decay with a state0 and a final state's
   cotangent, every gradient (dr, dk, dv, dlogw, du, dstate0) within
   1e-4 relative L2 (1e-3 under strong decay) and two runs the same bits;
   timed at the training shape beside its bound, the bytes its design
   moves and its earlier design's recorded time, by launch, with its
   blocks resident an SM, beside the plain backward and autograd through
   the plain forward.  rwkv6-3b's first
   micro-batch's gradients the same way as qwen2's, K6's backward kernel
   against its plain backward behind the forward kernel (full depth within
   0.1, two layers within 2**-6, f32 at two layers against the plain
   versions within 1e-3).  Then the training entry
   point, ``repro_torch.launch.train.train``, on qwen2-1.5b and on
   rwkv6-3b at full width and depth (28 and 32 layers, f32 master weights
   and AdamW moments, bf16 compute, remat "full"), cut from train_4k's
   global batch of 256 to 8 sequences of 4096 tokens in 4 micro-batches,
   for 5 steps each: every loss and grad norm finite, qwen2's K5 launched
   28 x 4 x 2 times forward (remat runs each layer's forward twice) and
   28 x 4 backward a step, every backward on ``flash_bwd_tc`` and none on
   ``flash_bwd``, rwkv6's K6 32 x 4 x 2 forward and 32 x 4 backward a
   step, neither model launching the other's kernel, peak memory
   under 80 GB; one more step under torch.profiler moves the weights
   beyond weight decay (an Adam step of at least 0.1 somewhere in the
   embedding and the first and last layers); printed: ms a step,
   tokens/s, the model-FLOP share, the loss trajectory and the profiled
   step's busy share;
10. dryrun: the dry run's trace (``repro_torch.launch.dryrun.trace_cell``
   un-meshed, no process group, on meta tensors, which take the card's
   route through K5's and K6's wrappers to their custom ops' fakes) of
   qwen2-1.5b's and rwkv6-3b's train steps at the train phase's shape and
   schedule (8 x 4096 tokens in 4 micro-batches, remat "full") and of
   qwen2-1.5b's serve prefill (batch 4, prompt 2048), after the train
   phase, in the script's process; then each cell cut to 2 layers traced
   on meta and under ``FakeTensorMode`` on ``cuda``, gated
   to be the same trace op for op (names, operand shapes, FLOPs, bytes,
   peak, arguments); held against what the train and models phases
   measured on the card: K5's and K6's custom-op calls in the trace equal
   their launches a step (a prefill), the parameters' bytes exactly, the
   traced peak within 10% of the real step's own peak (its
   ``max_memory_allocated`` less what earlier phases still held), the
   traced FLOPs 1.0-1.5x the train phase's model-FLOP count (remat "full"
   recomputes the forward), the whole phase within 30 s; printed: each
   traced step's roofline time beside its measured ms; one
   ``{"dryrun": ...}`` JSON line;
11. dist: the distributed layer on one NCCL rank (``world_size`` 1 on a
   ``HashStore``) and the one-rank ``make_smoke_mesh`` on the card, under
   ``use_mesh_rules`` with ``strategy.rules_for``: qwen2-1.5b at full width
   and depth at the train cell's shape (8 x 4096 in 4 micro-batches of 2),
   2 steps with the model placed by ``nn.param.distribute`` and the batch
   by ``data.pipeline.device_put_batch``, against 2 un-meshed steps from
   the same seed built one after the other: the losses and every
   parameter bit for bit, K5's forward and backward launched through the
   kernel boundary (``layers._flash``); rwkv6-3b at full width cut to 4
   of its 32 layers, one step of 2 x 4096, the same way (K6's forward and
   backward through ``ssm._wkv6``); one eager qwen2-1.5b decode step at
   the serve shape (batch 4) on a seeded cache placed by
   ``launch.inputs.decode_specs``, its logits bit for bit;
   granite-moe-3b-a800m at full width cut to 4 of its 32 layers (its
   batch-local grids, experts replicated), one step of 2 x 4096 at the
   published capacity factor: the loss, every parameter and each MoE
   call's dropped pairs bit for bit, K5's forward (2 a layer under remat
   "full") and backward through the boundary, then one dropless decode
   step at the serve shape, its logits bit for bit; deepseek-v2-236b at
   full width cut to 2 of its 60 layers in bf16 (its global grid, experts
   over "model"): a prefill of 4 x 2048 and one decode step, the prefill's
   logits, its ``ckv`` and ``krope`` and the decode's logits bit for bit,
   K5's (192, 128) instance through the boundary (its training does not
   fit the card); the phase within 124 s; K5 and K6 split
   by head block as 2 to 12 ranks on "model" would split them, block by
   block on the card, against the full call (``dist_split_checks``);
   ``optim.compress.compressed_psum_along`` over the NCCL group equal to
   the local decode.  Printed: ms a step both ways, losses, launches and
   peak memory beside the card's name and power limit.  The process group
   is destroyed on the way out.

Outside the chaos serve the allocator fault counters must be zero.
Launches are counted per path, from zero just before it to just after it:
K3 over the allocator's fleet epochs, K1/K2 over the tiles-loop replays
(one a step of each replayed chunk, dead steps included: a replay adds its
graph's launches to the counters, a capture adds none),
K4 over the fleet serve on the per-grant backend, K5 (qwen2-1.5b,
granite-moe-3b-a800m, deepseek-v2-236b, hymba-1.5b, whisper-large-v3 and
llama-3.2-vision-90b) and K6 (rwkv6-3b) over the prefills of their model
serves, K5's backward over qwen2-1.5b's training steps and K6's over
rwkv6-3b's (K6's forward there too, the K6 row's ``train_launches``), K3
over each
pooled fill (once a fill,
the K3 row's ``fill_launches`` in the JSON), and K5's and K6's forward and
backward over the dist phase's meshed steps (their rows'
``dist_launches``); each must have launched.  The
last lines are the kernels JSON, the ``nvidia-smi`` name and power limit,
and the device JSON.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import math
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
        args = re.search(r"I(\w+?)((?:Li\d+E)+)", mangled)
        if args:
            dims = re.findall(r"Li(\d+)E", args.group(2))
            dims = (f"D={dims[0]}" if len(set(dims)) == 1 else
                    f"DQK={dims[0]}, DV={dims[1]}")
            return f"{args.group(1).lstrip('0123456789')}, {dims}"
        for name in ("argmin2d_kernel", "argmin1d_kernel", "noop_kernel"):
            if name in mangled:
                path = {"ILb1E": "<vec>", "ILb0E": "<scalar>"}
                return name + next((v for k, v in path.items()
                                    if k in mangled), "")
        m = re.search(r"_GLOBAL__N_\w*?_[0-9a-f]{8}(\d+)", mangled)
        if m:   # a kernel in an anonymous namespace: <length><name>
            return mangled[m.end():m.end() + int(m.group(1))]
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


def device_times(fn, counts=None, ranges=None):
    """Run fn() under torch.profiler (CUDA activity) -> ({kernel name:
    device us}, None), or (None, reason) when the profiler does not start
    or records no device time here.  fn runs either way.  ``counts``, a
    dict, receives each kernel's number of recorded launches; ``ranges``, a
    dict keyed by ``record_function`` names, receives the device us each
    range spans on the stream (the CPU activity is then recorded too)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if ranges is not None:
        activities.append(ProfilerActivity.CPU)
    try:        # a measurement, not a check: a profiler fault is reported
        prof = profile(activities=activities)
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
    from torch.autograd import DeviceType

    # with the CPU activity an operator's row holds its kernels' time too,
    # and a range has a device row of its own spanning its kernels: the
    # kernels' own rows alone are counted
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0
              and (ranges is None
                   or (getattr(e, "device_type", None) == DeviceType.CUDA
                       and e.key not in ranges))]
    times = {e.key: e.self_device_time_total for e in events}
    if counts is not None:
        counts.update((e.key, e.count) for e in events)
    if ranges is not None:
        # a range's device row spans its kernels on the stream; its CPU
        # row's total of its operators' kernels is the fallback
        for e in prof.key_averages():
            if e.key not in ranges:
                continue
            if getattr(e, "device_type", None) == DeviceType.CUDA:
                ranges[e.key] = e.self_device_time_total
            elif not ranges[e.key]:
                ranges[e.key] = (getattr(e, "device_time_total", None)
                                 or getattr(e, "cuda_time_total", 0))
    if not times:
        return None, "the profiler recorded no device time"
    return times, None


K4_KERNELS = ("psdsf_pick_kernel",)


def outer_range(name, fn):
    """``fn`` with its outermost calls (not the recursive ones) inside a
    ``torch.profiler`` range ``name``: :func:`device_times`' ``ranges``
    reads the device time of the kernels they launch."""
    import torch

    depth = [0]

    def wrapped(*a, **k):
        if depth[0]:
            return fn(*a, **k)
        depth[0] += 1
        try:
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        finally:
            depth[0] -= 1
    return wrapped


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
def graph_counts(kind="LoopGraph"):
    """-> a dict that receives, for the epoch loop's graphs inside the
    block (``engine_torch.LoopGraph``, or ``kind``: ``"MeshGraph"`` for the
    mesh epoch's), the chunk replays, the alive-flag reads (each one host
    sync), the captures and the seconds they took."""
    from unittest import mock

    from repro_torch.core import engine_torch as et

    cls = getattr(et, kind)
    n = dict(replays=0, reads=0, captures=0, capture_s=0.0)
    init, replay_, alive = cls.__init__, cls.replay, cls.alive

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

    with mock.patch.object(cls, "__init__", timed_init), \
            mock.patch.object(cls, "replay", counted_replay), \
            mock.patch.object(cls, "alive", counted_alive):
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


# -- phase 8: the multi-device epoch on logical shards -----------------------

#: the mesh phase's runs: every pair at K = 2 shards, two pairs at K = 1, 4
#: and 8
MESH_RUNS = ([(c, p, 2) for c in CRITERIA for p in POLICIES]
             + [(c, p, k) for k in (1, 4, 8) for c, p in EAGER_CHECKS])


def timed(fn):
    """-> (fn(), wall ms) between two device syncs."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def step_calls(a, kw, devices=None):
    """ATen calls (views excluded) of one step of the plain loop, or with
    ``devices`` of the mesh loop, on the epoch arguments ``a``: what a
    captured chunk holds a step, about one kernel each."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import engine_torch as et

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func._schema.name.endswith(VIEW_OPS):
                self.n += 1
            return func(*args, **(kwargs or {}))

    args = et.epoch_state(*a, kind=kw["kind"], lookahead=kw["lookahead"],
                          use_limit=kw["use_limit"])
    tensors = et._loop_tensors(*args[:16])
    if devices is None:
        loop = et.EpochLoop(tensors, **kw)
    else:
        loop = et.MeshLoop(et.mesh_groups(tensors, devices, kind=kw["kind"],
                                          policy=kw["policy"]), devices, **kw)
    loop.reset(*args[16:])
    with Count() as c:
        loop.step()
    return c.n


#: ATen operations that make a view (no kernel), by schema name suffix
VIEW_OPS = ("::view", "::_unsafe_view", "::reshape", "::expand",
            "::transpose", "::t", "::select", "::slice", "::unsqueeze",
            "::squeeze", "::permute", "::alias")


def mesh_phase(dev, agents, fws, seed):
    """The multi-device epoch (``engine_torch.epoch_loop_mesh``) on K
    logical shards of the one card (``mesh.shard_devices``) at the fleet
    size, from each pair's first allocator epoch (its frozen view, the rng
    rewound): every pair at K = 2, rPS-DSF/pooled and DRF/RRR at K = 1, 4
    and 8.  Each run's grants and final X, FREE and used must equal the
    single-device plain loop's on its graphs, whose grants must equal K3's
    (the allocator's epoch); the mesh launches no kernel.  Then the pooled
    rPS-DSF fleet fill on two shards against K3's one-launch fill, and K =
    2 on two cards where the machine has them."""
    import torch

    from repro_torch.core import engine_torch as et
    from repro_torch.core.filling_torch import progressive_fill_torch
    from repro_torch.launch import mesh

    t_phase = time.perf_counter()
    firsts = {}
    for crit, pol, K in MESH_RUNS:
        if (crit, pol) not in firsts:
            al = build_allocator(agents, fws, crit, pol, dev, seed)
            reset_counts()
            ep = al.begin_epoch(per_agent_limit=1, use_kernel="fused")
            k3_seq = ep.handle.result()
            n = read_counts()
            check(n["persistent_epoch"] == 1, f"mesh {crit}/{pol}: the "
                  f"allocator's epoch launched {n}")
            with loop_calls() as calls, graph_counts() as g:
                seq, plain_ms = timed(lambda: replay(crit, pol, ep, dev,
                                                     None))
            check(seq == k3_seq and seq, f"mesh {crit}/{pol}: the plain "
                  "loop's grants differ from K3's")
            a, k, out = calls[-1]
            check(int(out[2]) == len(seq), f"mesh {crit}/{pol}: the epoch "
                  f"took {len(calls)} dispatches")
            kw = {x: v for x, v in k.items() if x not in ("kernel",
                                                          "shards")}
            k3_ms = cuda_ms(lambda: et.epoch_loop(*a, **kw), 1)
            firsts[(crit, pol)] = (a, kw, out, seq,
                                   plain_ms - g["capture_s"] * 1e3, k3_ms,
                                   step_calls(a, kw))
            al.abort_epoch(ep)
        a, kw, out, seq, plain_ms, k3_ms, plain_calls = firsts[(crit, pol)]
        reset_counts()
        with graph_counts("MeshGraph") as g:
            got, ms = timed(lambda: et.epoch_loop_mesh(
                *a, **kw, devices=mesh.shard_devices(K, dev)))
        n = read_counts()
        check(not any(n.values()), f"mesh {crit}/{pol} K={K}: launched {n}")
        count = int(got[2])
        mseq = list(zip(got[0][:count].tolist(), got[1][:count].tolist()))
        check(mseq == seq, f"mesh {crit}/{pol} K={K}: grants differ from "
              "the plain loop")
        for name, i in (("X", 3), ("FREE", 5), ("used", 6)):
            check(torch.equal(got[i], out[i]), f"mesh {crit}/{pol} K={K}: "
                  f"final {name} differs from the plain loop")
        check(g["captures"] <= 1 and g["replays"] > 0, f"mesh {crit}/{pol} "
              f"K={K}: graphs {g}")
        ms -= g["capture_s"] * 1e3
        calls = step_calls(a, kw, mesh.shard_devices(K, dev))
        log(f"mesh {crit}/{pol} K={K}: {count} grants, {ms:.1f} ms an epoch "
            f"without the capture, {ms / count * 1e3:.1f} us a grant, "
            f"{calls} ATen calls a step; {g['captures']} captures "
            f"{g['capture_s']:.2f} s, {g['replays']} chunk replays, "
            f"{g['reads']} flag reads; equal to the plain loop "
            f"({plain_ms:.1f} ms, {plain_ms / count * 1e3:.1f} us a grant, "
            f"{plain_calls} ATen calls a step) and to K3 ({k3_ms:.2f} ms, "
            f"{k3_ms / count * 1e3:.2f} us a grant)")
    # the pooled fill on two shards against K3's one-launch fill
    D, C, phi, allowed = fleet_fill_inputs(agents, fws, dev)
    kw = dict(criterion="rpsdsf", policy="pooled", tie="low",
              lookahead=False, max_steps=FLEET_FILL_STEPS, allowed=allowed)
    reset_counts()
    x3 = progressive_fill_torch(D, C, phi, None, **kw)
    n = read_counts()
    check(n["persistent_epoch"] == 1, f"mesh fill: K3 launched {n}")
    reset_counts()
    with graph_counts("MeshGraph") as g:
        xm, ms = timed(lambda: progressive_fill_torch(
            D, C, phi, None, devices=mesh.shard_devices(2, dev), **kw))
    n = read_counts()
    check(not any(n.values()), f"mesh fill: launched {n}")
    check(torch.equal(x3, xm), "mesh fill rpsdsf K=2 differs from K3's")
    grants = int(xm.sum())
    ms -= g["capture_s"] * 1e3
    log(f"mesh fill rpsdsf/pooled K=2 {D.shape[0]}x{C.shape[0]}: {grants} "
        f"grants, {ms:.1f} ms without the capture ({ms / grants * 1e3:.1f} "
        f"us a grant), {g['captures']} captures {g['capture_s']:.2f} s, "
        f"{g['replays']} replays; equal to K3's fill")
    if torch.cuda.device_count() >= 2:
        a, kw, out, seq, *_ = firsts[("rpsdsf", "pooled")]
        got, ms = timed(lambda: et.epoch_loop_mesh(
            *a, **kw, devices=mesh.make_agent_mesh(2, "cuda")))
        count = int(got[2])
        check(list(zip(got[0][:count].tolist(), got[1][:count].tolist()))
              == seq and torch.equal(got[3], out[3]), "mesh rpsdsf/pooled "
              "on two cards differs from the plain loop")
        log(f"mesh rpsdsf/pooled on two cards: {count} grants, {ms:.1f} ms "
            f"(eager, {ms / count * 1e3:.1f} us a grant); equal")
    else:
        log("mesh on two distinct cards: not run on this machine "
            f"({torch.cuda.device_count()} CUDA device)")
    log(f"mesh phase {time.perf_counter() - t_phase:.1f} s; the mesh runs "
        "launched no kernel")


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
# deepseek-v2's MLA prefill: B, H, K, S, T, D of q and k, DV of v (128
# no-RoPE + 64 RoPE dims of q and k, the RoPE key shared by every head)
MLA_ATTN = (4, 128, 128, 2048, 2048, 192, 128)
# hymba-1.5b's prefill, a GQA group of 5; 29 of its 32 layers attend
# through a window of HYMBA_WINDOW keys, the other three globally
HYMBA_ATTN = (4, 25, 5, 2048, 2048, 64)
HYMBA_WINDOW = 1024
# whisper-large-v3's prefill, MHA (K = H): the encoder attends both ways
# over its 1500 frames, the decoder's cross-attention puts the 224 prompt
# tokens against them; both non-causal
WHISPER_ENC_ATTN = (4, 20, 20, 1500, 1500, 64)
WHISPER_CROSS_ATTN = (4, 20, 20, 224, 1500, 64)
# llama-3.2-vision-90b's prefill, a GQA group of 8: its self layers attend
# causally over the 2048 prompt tokens, its cross layers put them against
# the 1601 media tokens without the mask
VLM_SELF_ATTN = (4, 64, 8, 2048, 2048, 128)
VLM_CROSS_ATTN = (4, 64, 8, 2048, 1601, 128)
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
# a model's own serve shape where it differs from SERVE_KW's: whisper's
# decoder context is 448 tokens, served as its long-form transcription
# runs it (openai/whisper: up to n_text_ctx // 2 - 1 tokens of the previous
# window's text as the prompt, n_text_ctx // 2 tokens sampled)
SERVE_SHAPES = {"whisper-large-v3": dict(prompt_len=224, gen=224)}
DECODE_LIMIT_PER_SEQ = 20     # PERF.md section 2: tokens/s a sequence


def serve_kw(cfg):
    """The serve shape of ``cfg``: SERVE_KW with the model's own
    overrides."""
    return dict(SERVE_KW, **SERVE_SHAPES.get(cfg.name, {}))


def k5_calls(cfg, prompt_len):
    """-> the K5 launches a prefill of ``prompt_len`` tokens makes, by
    (causal, S, T, window): one a layer of an LM (a local layer through
    the config's window, a global one and every layer of a model without
    a window through none); for the enc-dec family one an encoder layer
    (non-causal, M x M frames) and two a decoder layer (causal over the
    prompt, and non-causal from the prompt to the M frames); for the VLM
    one a self layer (causal over the prompt) and one a cross layer
    (non-causal from the prompt to the M media tokens)."""
    P, M = prompt_len, cfg.n_media_tokens
    if cfg.family == "encdec":
        return collections.Counter({(False, M, M, 0): cfg.n_encoder_layers,
                                    (True, P, P, 0): cfg.n_layers,
                                    (False, P, M, 0): cfg.n_layers})
    if cfg.family == "vlm":
        G = cfg.n_layers // cfg.cross_every
        return collections.Counter({(True, P, P, 0): (cfg.cross_every - 1) * G,
                                    (False, P, M, 0): G})
    return collections.Counter(
        (True, P, P, 0 if cfg.is_global_layer(i) else cfg.window)
        for i in range(cfg.n_layers))


def _close(got, want, rtol, atol):
    """-> (within tolerance, max abs error) of two tensors, in f32."""
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return bool(torch.isclose(got, want, rtol=rtol, atol=atol).all()), err


def flash_phase(dev):
    """K5 against its plain version at the qwen2-1.5b, granite-moe-3b,
    deepseek-v2 (MLA: q/k 192, v 128), hymba-1.5b (window 1024 and none),
    whisper-large-v3 (encoder and cross-attention, non-causal) and
    llama-3.2-vision-90b (self layers causal, cross layers non-causal, GQA
    8:1) prefill shapes and on the edge cases, each on the kernel the
    wrapper's rule picks and within that kernel's tolerance, and on
    ``flash_tc`` again with its log-sum-exp (:func:`lse_check`: the same
    output bits; the log-sum-exp's values on the edge cases); then the
    timing block at the nine prefill shapes.  -> the kernels row
    (qwen2-1.5b's shape, granite's in ``granite_prefill``, deepseek-v2's in
    ``mla_prefill``, hymba's in ``hymba_prefill``, by window, whisper's in
    ``whisper_prefill`` and the VLM's in ``vlm_prefill``, by
    attention)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as k5

    g = torch.Generator(dev).manual_seed(5)
    bf16 = torch.bfloat16
    cases = [
        ("qwen2-1.5b prefill", QWEN_ATTN, bf16, True, 0),
        ("granite-moe-3b prefill", GRANITE_ATTN, bf16, True, 0),
        ("deepseek-v2 MLA prefill", MLA_ATTN, bf16, True, 0),
        ("hymba-1.5b windowed prefill", HYMBA_ATTN, bf16, True,
         HYMBA_WINDOW),
        ("hymba-1.5b global prefill", HYMBA_ATTN, bf16, True, 0),
        ("whisper-large-v3 encoder prefill", WHISPER_ENC_ATTN, bf16, False,
         0),
        ("whisper-large-v3 cross prefill", WHISPER_CROSS_ATTN, bf16, False,
         0),
        ("llama-3.2-vision-90b self prefill", VLM_SELF_ATTN, bf16, True, 0),
        ("llama-3.2-vision-90b cross prefill", VLM_CROSS_ATTN, bf16, False,
         0),
        ("f32", (2, 12, 2, 512, 512, 128), torch.float32, True, 0),
        ("window 48 below the key tile, gemma3-style", (2, 8, 4, 1000,
                                                         1000, 256),
         bf16, True, 48),
        ("non-causal, T != S", (2, 4, 2, 300, 700, 64), bf16, False, 0),
        ("ragged S", (3, 12, 2, 1999, 1999, 128), bf16, True, 0),
        ("f16", (2, 12, 2, 1024, 1024, 128), torch.float16, True, 0),
        ("rows 19-47 with no valid key", (1, 2, 1, 48, 16, 64), bf16, False,
         4),
        ("MLA ragged S", (2, 16, 16, 1999, 1999, 192, 128), bf16, True, 0),
        ("MLA window 48", (2, 8, 8, 1000, 1000, 192, 128), bf16, True, 48),
        ("MLA f16, GQA 4:1", (2, 16, 4, 1024, 1024, 192, 128),
         torch.float16, True, 0),
    ]
    errs, inputs = {}, {}
    for label, shape, dtype, causal, window in cases:
        B, H, K, S, T, D, DV = (*shape, shape[-1])[:7]
        q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
        k = torch.randn((B, T, K, D), generator=g, device=dev).to(dtype)
        v = torch.randn((B, T, K, DV), generator=g, device=dev).to(dtype)
        variant = k5.variant(dtype, D, DV)
        n0 = k5.flash_attention.variant_launches[variant]
        got = k5.flash_attention(q, k, v, causal=causal, window=window)
        want = k5.flash_attention_ref(q, k, v, causal=causal, window=window)
        tol = k5.tolerance(variant, dtype, v)
        ok, err = _close(got, want, **tol)
        log(f"K5 {label} {shape} {dtype} on {variant}: max abs "
            f"err {err:.3g} (tolerance rtol {tol['rtol']:.3g} atol "
            f"{tol['atol']:.3g})")
        check(k5.flash_attention.variant_launches[variant] == n0 + 1,
              f"K5 {label}: {variant} did not launch")
        check(ok, f"K5 {label}: kernel differs from its plain version "
              f"(max abs err {err})")
        if variant == "flash_tc":
            lse_check(label, got, q, k, v, causal, window,
                      values=not label.endswith("prefill"))
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
    bound, bound_by = attention_bound(q, k, v)
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
    granite["bound_ms"], granite["bound_by"] = attention_bound(qg, kg, vg)
    log(f"K5 flash_attention {GRANITE_ATTN} bf16 causal: "
        f"{k5.variant(qg.dtype, qg.shape[-1])} {granite['ms']:.4f} ms "
        f"({granite['bound_ms'] / granite['ms']:.1%} of the bound "
        f"{granite['bound_ms']:.4f} ms, {granite['bound_by']}); plain "
        f"{granite['plain_ms']:.4f} ms; scaled_dot_product_attention "
        f"({how}) {granite['library_ms']:.4f} ms")
    del qg, kg, vg
    # deepseek-v2's MLA prefill: q/k 192, v 128, one kv head a query head
    qm, km, vm = inputs.pop("deepseek-v2 MLA prefill")
    mla = dict(
        shape=[list(qm.shape), list(km.shape), list(vm.shape)],
        variant=k5.variant(qm.dtype, qm.shape[-1], vm.shape[-1]),
        ms=cuda_ms(lambda: k5.flash_attention(qm, km, vm, causal=True), 20),
        plain_ms=cuda_ms(lambda: k5.flash_attention_ref(qm, km, vm,
                                                        causal=True), 3),
        max_abs_err=errs["deepseek-v2 MLA prefill"])
    mla["library_ms"], mla_how = sdpa_ms(qm, km, vm)
    mla["bound_ms"], mla["bound_by"] = attention_bound(qm, km, vm)
    Bm, Hm, _, Sm, Tm, Dm, DVm = MLA_ATTN
    mla_flops = Bm * Hm * Sm * Tm * (Dm + DVm)
    log(f"K5 flash_attention {MLA_ATTN} bf16 causal: {mla['variant']} "
        f"{mla['ms']:.4f} ms ({mla_flops / mla['ms'] / 1e9:.1f} TFLOP/s, "
        f"{mla['bound_ms'] / mla['ms']:.1%} of the bound "
        f"{mla['bound_ms']:.4f} ms, {mla['bound_by']}); plain "
        f"{mla['plain_ms']:.4f} ms; scaled_dot_product_attention "
        f"({mla_how}) {mla['library_ms']:.4f} ms")
    del qm, km, vm
    hymba = {}
    for kind, window in (("windowed", HYMBA_WINDOW), ("global", 0)):
        hymba[kind] = hymba_timing(inputs.pop(f"hymba-1.5b {kind} prefill"),
                                   window, errs[f"hymba-1.5b {kind} prefill"])
    whisper = {}
    for kind in ("encoder", "cross"):
        label = f"whisper-large-v3 {kind} prefill"
        whisper[kind] = attention_timing(label, inputs.pop(label),
                                         errs[label])
    vlm = {}
    for kind, causal in (("self", True), ("cross", False)):
        label = f"llama-3.2-vision-90b {kind} prefill"
        vlm[kind] = attention_timing(label, inputs.pop(label), errs[label],
                                     causal)
    del inputs
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
                granite_prefill=granite, mla_prefill=mla,
                hymba_prefill=hymba, whisper_prefill=whisper,
                vlm_prefill=vlm)


#: f32 tolerance of the forward's log-sum-exp against its plain version:
#: values up to a few tens, summed in another order through ex2.approx
LSE_TOL = dict(rtol=1e-5, atol=1e-4)


def lse_check(label, out, q, k, v, causal, window, values):
    """``flash_tc.cu`` again with its log-sum-exp: the output bit for bit
    the call's without it, the rows past S +inf, and (``values``) each row
    within :data:`LSE_TOL` of ``ref.flash_attention_lse_ref`` (+inf where
    no key is valid)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.flash_attention.ref import flash_attention_lse_ref

    again, lse = k5.launch("flash_tc", q, k, v, causal=causal,
                           window=window, with_lse=True)
    S = q.shape[1]
    check(torch.equal(again, out), f"K5 {label}: the forward's output "
          "differs with its log-sum-exp")
    check(bool(torch.isposinf(lse[..., S:]).all()), f"K5 {label}: the "
          "log-sum-exp's rows past S are not +inf")
    if not values:
        return
    want = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    got = lse[..., :S]
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    ok = (torch.equal(torch.isposinf(got), torch.isposinf(want)) and bool(
        torch.isclose(got[fin], want[fin], **LSE_TOL).all()))
    log(f"K5 {label}: the forward's log-sum-exp, max abs err {err:.3g} "
        f"(tolerance rtol {LSE_TOL['rtol']:g} atol {LSE_TOL['atol']:g}); "
        "the output's bits the same without it")
    check(ok, f"K5 {label}: the forward's log-sum-exp differs from its "
          f"plain version (max abs err {err})")


def hymba_timing(qkv, window, err):
    """K5 at hymba-1.5b's prefill shape with ``window`` (0: a global layer)
    beside its bound, its plain version and SDPA: ``is_causal`` with
    ``enable_gqa`` for a global layer, a boolean (S, T) window mask for a
    windowed one.  -> the row, printed."""
    import torch

    from repro_torch.kernels.flash_attention import ops as k5

    q, k, v = qkv
    S, T = q.shape[1], k.shape[1]
    mask = None
    if window:
        s, t = (torch.arange(n, device=q.device) for n in (S, T))
        d = s[:, None] - t[None, :]
        mask = (d >= 0) & (d < window)
    row = dict(
        shape=[list(q.shape), list(k.shape)], window=window,
        ms=cuda_ms(lambda: k5.flash_attention(q, k, v, causal=True,
                                              window=window), 20),
        plain_ms=cuda_ms(lambda: k5.flash_attention_ref(
            q, k, v, causal=True, window=window), 3),
        max_abs_err=err)
    row["library_ms"], how = sdpa_ms(q, k, v, mask)
    row["bound_ms"], row["bound_by"] = attention_bound(q, k, v, window)
    log(f"K5 flash_attention {HYMBA_ATTN} bf16 causal, window {window}: "
        f"{k5.variant(q.dtype, q.shape[-1])} {row['ms']:.4f} ms "
        f"({row['bound_ms'] / row['ms']:.1%} of the bound "
        f"{row['bound_ms']:.4f} ms, {row['bound_by']}); plain "
        f"{row['plain_ms']:.4f} ms; scaled_dot_product_attention ({how}) "
        f"{row['library_ms']:.4f} ms")
    return row


def attention_timing(label, qkv, err, causal=False):
    """K5 at a prefill shape with no window (whisper's encoder and
    cross-attention, the VLM's self and cross layers) beside its bound, its
    plain version and SDPA (``enable_gqa`` where K < H), causal or not.
    -> the row, printed."""
    from repro_torch.kernels.flash_attention import ops as k5

    q, k, v = qkv
    row = dict(
        shape=[list(q.shape), list(k.shape)], causal=causal,
        ms=cuda_ms(lambda: k5.flash_attention(q, k, v, causal=causal), 20),
        plain_ms=cuda_ms(lambda: k5.flash_attention_ref(q, k, v,
                                                        causal=causal), 3),
        max_abs_err=err)
    row["library_ms"], how = sdpa_ms(q, k, v, causal=causal)
    row["bound_ms"], row["bound_by"] = attention_bound(q, k, v,
                                                       causal=causal)
    B, S, H, D = q.shape
    flops = (1 if causal else 2) * B * H * S * k.shape[1] * (D + v.shape[-1])
    log(f"K5 flash_attention {label} {tuple(q.shape)} x {tuple(k.shape)} "
        f"bf16 {'causal' if causal else 'non-causal'}: "
        f"{k5.variant(q.dtype, D)} {row['ms']:.4f} ms "
        f"({flops / row['ms'] / 1e9:.1f} TFLOP/s, "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound "
        f"{row['bound_ms']:.4f} ms, {row['bound_by']}); plain "
        f"{row['plain_ms']:.4f} ms; scaled_dot_product_attention ({how}) "
        f"{row['library_ms']:.4f} ms")
    return row


def sdpa_backend(qt, kt, vt, mask=None, gqa=False, causal=True):
    """The backend ``scaled_dot_product_attention`` dispatches these (B, H,
    S, D) inputs to, causal (or not) or under ``mask``, by torch's own
    choice, or why it is not named."""
    import torch

    try:
        from torch.nn.attention import SDPBackend

        kw = dict(enable_gqa=True) if gqa else {}
        return SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None and causal,
            **kw)).name.lower()
    except (AttributeError, RuntimeError, TypeError, ValueError) as exc:
        # a private call: the backend is named where this torch answers it
        return f"backend not named ({type(exc).__name__})"


def sdpa_ms(q, k, v, mask=None, causal=True):
    """-> (ms, how) of ``scaled_dot_product_attention`` on K5's inputs
    (q (B, S, H, D), k (B, T, K, D), v (B, T, K, DV)), causal (or not), or
    under the boolean (S, T) ``mask`` where one is given: the yardstick
    only, never on the port's path.  ``how`` names the backend torch picks
    (for K < H, on k and v as K5 reads them, with ``enable_gqa``)."""
    import torch.nn.functional as F

    H, K = q.shape[2], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kw = dict(is_causal=causal) if mask is None else dict(attn_mask=mask)
    if K == H:
        return (cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **kw), 20), sdpa_backend(qt, kt, vt, mask,
                                                 causal=causal))
    try:
        return (cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **kw), 20),
            "enable_gqa, " + sdpa_backend(qt, kt, vt, mask, gqa=True,
                                          causal=causal))
    except TypeError:
        kr, vr = (x.repeat_interleave(H // K, dim=1) for x in (kt, vt))
        return (cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kr, vr, **kw), 20),
            "k/v repeated (no enable_gqa in this torch), "
            + sdpa_backend(qt, kr, vr, mask, causal=causal))


def attention_bound(q, k, v, window=0, causal=True):
    """-> (ms, what bounds it) of bf16 attention on these inputs: q, k, v
    and the output (B, S, H, DV) each moved once; causal, B·H·S·T·(D + DV)
    operations (half of QK^T's 2·S·T·D and of PV's 2·S·T·DV) on the tensor
    cores, or with a ``window`` 2·B·H·(D + DV) a (q, k) pair it leaves
    (``s - t`` in [0, window), S = T); non-causal, all of
    2·B·H·S·T·(D + DV)."""
    B, S, H, D = q.shape
    T, DV = k.shape[1], v.shape[-1]
    nbytes = (q.numel() + k.numel() + v.numel() + B * S * H * DV) \
        * q.element_size()
    ops = B * H * S * T * (D + DV) * (1 if causal else 2)
    if window:
        pairs = sum(min(s + 1, window) for s in range(S))
        ops = 2 * B * H * pairs * (D + DV)
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": ops / BF16_OPS_PER_S}
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
    """The full-width serve of ``arch`` (a registered name, its full config,
    or a ModelConfig; :func:`serve_kw`'s shape: batch 4, prompt 2048, 32
    tokens, whisper's prompt 224 and 224 tokens):
    once on the kernel, counted, recorded, and with every launch shadowed by
    the plain version on the same inputs (gated at the kernel's tolerance);
    once with the kernel swapped for its plain version, teacher-forced with
    the first run's tokens (an enc-dec model also with the first run's
    encoder output); once more on the kernel, timed.  -> the
    kernel's launches on the first run.  ``seam`` is the (module, name) of
    the alias through which the model reaches ``kernel_mod``: the shadow
    replaces the alias, so the wrapper itself stays in place and counts.

    The caches of the first two layers (and an enc-dec model's first
    encoder layer's output; the VLM's ``k``/``v`` taken as its self layers
    in order, (group, layer), and its ``xk``/``xv`` by group) must agree
    between the first two runs.  A MoE
    model's routing can flip where a router logit differs by an ulp: its
    routing agreement by layer and its capacity-drop share are printed,
    not gated, and :func:`routed_alike` gates the first two layers again
    with the experts forced alike."""
    from types import SimpleNamespace
    from unittest import mock

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.nn.config import ModelConfig

    cfg = (arch if isinstance(arch, ModelConfig)
           else get_config(arch, smoke=SERVE_KW["smoke"]))
    kw = dict(serve_kw(cfg), seed=seed, device=dev)
    arch = cfg.name
    if kernel_name == "flash_attention":
        want_calls = k5_calls(cfg, kw["prompt_len"])
        n_launch = sum(want_calls.values())
    else:
        n_launch = cfg.n_layers           # K6: once a layer
    encdec, vlm = cfg.family == "encdec", cfg.family == "vlm"
    prefill, decode = fam_mod.prefill, fam_mod.decode_step
    cross_layer = fam_mod._cross_layer if vlm else None
    encode = fam_mod.encode if encdec else None
    kernel, plain = (getattr(kernel_mod, kernel_name),
                     getattr(kernel_mod, kernel_name + "_ref"))
    shadow_errs, tols, dims = [], [], set()
    calls = collections.Counter()     # K5's by (causal, S, T, window)

    def tolerance(*a):
        if kernel_name != "flash_attention":
            return WKV_TOL
        q, v = a[0], a[2]
        return kernel_mod.tolerance(kernel_mod.variant(
            q.dtype, q.shape[-1], v.shape[-1]), q.dtype, v)

    def shadowed(*a, **k):
        out = kernel(*a, **k)
        if kernel_name == "flash_attention":    # (q/k, v) head dims
            dims.add((a[0].shape[-1], a[2].shape[-1]))
            calls[k.get("causal", True), a[0].shape[1], a[1].shape[1],
                  k.get("window", 0)] += 1
        want = plain(*a, **k)
        pairs = (zip(out, want) if isinstance(out, tuple)
                 else [(out, want)])
        tols.append(tolerance(*a))
        shadow_errs.append([_close(x, y, **tols[-1]) for x, y in pairs])
        return out

    def recorded(rec, forced=None, enc_out=None):
        def rec_encode(*a, **k):
            trace = []
            out = encode(*a, trace=trace, **k)
            rec["encoder"] = [x.float().cpu() for x in trace]
            rec["enc_out"] = out.float().cpu()
            if enc_out is not None:     # the first run's, in its type
                out = enc_out.to(out.device, out.dtype)
            return out

        def rec_prefill(*a, **k):
            logits, cache = prefill(*a, **k)
            rec["prefill"] = logits.float().cpu()
            rec["cache"] = {n: c.float().cpu() for n, c in cache.items()}
            if k.get("routing") is not None:
                rec["experts"] = [r.experts.cpu() for r in k["routing"]]
            return logits, cache

        def rec_cross(*a, **k):     # the prefill's (S > 1), group 0's
            out = cross_layer(*a, **k)
            if out.shape[1] > 1 and "cross" not in rec:
                rec["cross"] = out.float().cpu()
            return out

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
        if encdec:
            stack.enter_context(mock.patch.object(fam_mod, "encode",
                                                  rec_encode))
        if vlm:
            stack.enter_context(mock.patch.object(fam_mod, "_cross_layer",
                                                  rec_cross))
        stack.enter_context(mock.patch.object(fam_mod, "decode_step",
                                              rec_decode))
        # a graph calls decode_step only while it is captured: the
        # recorded (and teacher-forced) serves decode eagerly
        stack.enter_context(mock.patch.object(serve, "decode",
                                              serve.decode_eager))
        return stack

    runs, peaks = {}, {}
    for label in ("kernel", "plain"):
        rec, forced, enc_out = {}, None, None
        if label == "plain":
            forced = runs["kernel"][0]["tokens"]
            enc_out = runs["kernel"][1].get("enc_out")
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with recorded(rec, forced, enc_out), (
                mock.patch.object(*seam, SimpleNamespace(
                    **{kernel_name: shadowed}))
                if label == "kernel" else
                mock.patch.object(kernel_mod, kernel_name, plain)):
            out = serve.serve(cfg, **kw)
        runs[label] = (out, rec, read_counts())
        peaks[label] = torch.cuda.max_memory_allocated()
        if label == "kernel":
            n_variant = dict(getattr(getattr(kernel_mod, kernel_name),
                                     "variant_launches", {}))
        torch.cuda.empty_cache()
    (out, rec, n), (out_p, rec_p, n_p) = runs["kernel"], runs["plain"]
    launches = out["launches"]
    if kernel_name == "flash_attention":
        want_dims = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
                     if cfg.use_mla else (cfg.head_dim, cfg.head_dim))
        check(n_variant == {"flash_tc": n_launch, "flash": 0}
              and dims == {want_dims},
              f"{arch}: K5 launches by variant {n_variant} at (q/k, v) head "
              f"dims {dims}, expected the tensor-core kernel {n_launch} "
              f"times at {want_dims}")
        log(f"serve {arch}: K5 launches by variant in the prefill "
            f"{n_variant}, at (q/k, v) head dims {sorted(dims)}")
        check(calls == want_calls,
              f"{arch}: K5 launches by (causal, S, T, window) {dict(calls)}, "
              f"expected {dict(want_calls)}")
        by = {"window": collections.Counter(), "causal": collections.Counter(),
              "(S, T)": collections.Counter()}
        for (causal, S, T, window), c in calls.items():
            by["window"][window] += c
            by["causal"][causal] += c
            by["(S, T)"][S, T] += c
        log(f"serve {arch}: K5 launches in the prefill " + "; ".join(
            f"by {key} " + ", ".join(f"{k}: {c}" for k, c in sorted(
                counts.items(), reverse=True))
            for key, counts in by.items()))
    check(launches["prefill"][kernel_name] == n_launch
          and n[kernel_name] == n_launch
          and not any(v for k, v in n.items() if k != kernel_name)
          and not any(launches["decode"].values()),
          f"{arch}: launches {launches} (counters {n}), expected "
          f"{kernel_name} = {n_launch} in the prefill and none in the decode")
    check(not any(n_p.values()), f"{arch}: the plain-version serve launched "
          f"{n_p}")
    MEASURED["prefill", arch] = launches["prefill"][kernel_name]
    worst = max(err for layer in shadow_errs for _ok, err in layer)
    log(f"serve {arch} shadow check: {kernel_name} == its plain version on "
        f"the same inputs at each of {len(shadow_errs)} launches, max abs "
        f"err {worst:.3g} (tolerance rtol {tols[0]['rtol']:.3g}, atol "
        f"{min(t['atol'] for t in tols):.3g}-"
        f"{max(t['atol'] for t in tols):.3g})")
    check(len(shadow_errs) == n_launch and all(
        ok for layer in shadow_errs for ok, _err in layer),
        f"{arch}: {kernel_name} differs from its plain version inside the "
        f"serve: {shadow_errs}")
    def by_layer(run, name):    # the VLM's k/v, (G, 4, ...) -> (G·4, ...)
        c = run["cache"][name]
        return c.flatten(0, 1) if vlm and name in ("k", "v") else c

    per_layer = {name: [_rel_l2(a, b) for a, b in zip(
        by_layer(rec, name), by_layer(rec_p, name))] for name in rec["cache"]}
    if encdec:      # each encoder layer's output, of both serves' encodes
        per_layer["encoder"] = [_rel_l2(a, b) for a, b in zip(
            rec["encoder"], rec_p["encoder"])]
        check(len(rec["encoder"]) == len(rec_p["encoder"])
              == cfg.n_encoder_layers,
              f"{arch}: encoder layers recorded {len(rec['encoder'])}/"
              f"{len(rec_p['encoder'])}")
    errs = {"prefill logits": _rel_l2(rec["prefill"], rec_p["prefill"]),
            "decode logits (worst step)": max(
                _rel_l2(a, b) for a, b in zip(rec["steps"], rec_p["steps"]))}
    check(len(rec["steps"]) == len(rec_p["steps"]) == kw["gen"] - 1,
          f"{arch}: decode steps {len(rec['steps'])}/{len(rec_p['steps'])}")
    finite = all(bool(torch.isfinite(x).all()) for x in
                 [rec["prefill"], *rec["steps"], *rec["cache"].values(),
                  *rec.get("encoder", ())])
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
    if encdec:
        log(f"serve {arch}: the encoder's layer 0 output (gated) and layer "
            f"1 output (not gated) of the kernel serve vs the plain-version "
            f"serve's, relative L2 {per_layer['encoder'][0]:.3g} and "
            f"{per_layer['encoder'][1]:.3g}; the final encoder output "
            f"(after enc_norm) {_rel_l2(rec['enc_out'], rec_p['enc_out']):.3g}"
            f" (not gated: each layer's attention takes the last one's "
            f"difference, and under the reference's init a difference grows "
            f"about 10x a layer, whatever the kernel; layer 0's output lies "
            f"one attention deep, as an LM's layer-1 cache does; the "
            f"plain-version serve's decoder reads the kernel serve's encoder "
            f"output, so its xk and xv take their bits)")
    if vlm:
        log(f"serve {arch}: the residual after group 0's cross layer (its "
            f"four self layers' K5 calls and the cross layer's, gates "
            f"{VLM_GATE}) of the kernel serve vs the plain-version serve's, "
            f"relative L2 {_rel_l2(rec['cross'], rec_p['cross']):.3g} (not "
            f"gated: four attentions deep); the self K/V gated at group 0's "
            f"layers 0 and 1, printed for the rest in (group, layer) order; "
            f"xk and xv, which depend on the media alone, gated at groups 0 "
            f"and 1")
    # gated as deep as an LM's layer-1 cache, one attention: the first
    # two layers' caches, and the first encoder layer's output (the second
    # lies two attentions deep, and grows ~10x from the first, printed)
    first = max(v for name, vals in per_layer.items()
                for v in vals[:1 if name == "encoder" else 2])
    check(finite and first <= SERVE_FIRST_LAYERS_REL_L2,
          f"{arch}: the caches of the first two layers"
          + (" or the first encoder layer's output" if encdec else "")
          + f" differ between the serve on {kernel_name} and on its plain "
          f"version by {first} (tolerance {SERVE_FIRST_LAYERS_REL_L2})")
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
        timed = serve.serve(cfg, **kw)
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
        eager = serve.serve(cfg, **kw)
    check(eager["captures"] == 0
          and (eager["tokens"] == timed["tokens"]).all(),
          f"{arch}: the eager timed serve's tokens differ from the graphed")
    drops = ("" if timed["drop_share"] is None else
             f", capacity drops {timed['drop_share']:.4%}")
    log(f"serve {arch} (timed run, decode on the graph): prefill "
        f"{timed['prefill_s'] * 1e3:.2f} ms "
        f"for {kw['batch']} x {kw['prompt_len']} tokens"
        + (f" and {cfg.n_media_tokens} frames" if encdec else "")
        + (f" and {cfg.n_media_tokens} media tokens" if vlm else "")
        + f", decode "
        f"{timed['decode_s'] * 1e3:.2f} ms, {timed['tok_per_s']:.2f} "
        f"tokens/s ({timed['tok_per_s'] / kw['batch']:.2f} a sequence), "
        f"parameters {timed['param_bytes'] / 1e9:.3f} GB "
        f"({cfg.param_dtype}), max memory allocated {peak / 1e9:.3f} GB "
        f"(the shadowed kernel serve {peaks['kernel'] / 1e9:.3f} GB, the "
        f"plain-version serve {peaks['plain'] / 1e9:.3f} GB, of the card's "
        f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.1f})"
        f"{drops}; "
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
        routed_alike(dev, cfg, fam_mod, kernel_mod, seed)
    busy_shares(dev, cfg, fam_mod,
                "flash_tc" if kernel_name == "flash_attention" else "wkv6")
    f32_divergence(dev, cfg, fam_mod, kernel_mod, kernel_name, seed)
    return n[kernel_name]


def routed_alike(dev, cfg, fam_mod, kernel_mod, seed):
    """A MoE model's prefill (the serve's prompts) on K5, then with K5
    swapped for its plain version and every layer's experts forced to the
    first run's (``layers._top_k``), so the two differ by K5 alone, as a
    dense model's serves do: the caches of the first two layers within
    SERVE_FIRST_LAYERS_REL_L2 and the capacity drops equal, layer by layer
    (gated); the deeper layers printed."""
    from unittest import mock

    import torch

    from repro_torch.models.common import init_model
    from repro_torch.nn import layers

    arch = cfg.name
    model = init_model(fam_mod, cfg, torch.Generator(dev).manual_seed(0))
    B, S = serve_kw(cfg)["batch"], serve_kw(cfg)["prompt_len"]
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


#: the decode state a step reads and writes back whole, by family: RWKV6's
#: WKV state and shift tokens, hymba's SSM ``h`` and conv tail
STATE_REWRITTEN = {"ssm": ("wkv", "tm_last", "cm_last"),
                   "hybrid": ("h", "conv")}


def step_weights(model, cfg):
    """The parameters a decode step reads: all of them, but for the
    enc-dec family the embedding and the decoder, and for the VLM every
    group, without the cross-attention's ``wk``/``wv`` (the step reads
    the cached ``xk``/``xv`` instead; the encoder and ``enc_norm`` run at
    the prefill only)."""
    cross_kv = ("xattn.wk", "xattn.wv")
    if cfg.family == "vlm":
        return sum(p.numel() for name, p in model.named_parameters()
                   if not name.endswith(cross_kv))
    if cfg.family != "encdec":
        return sum(p.numel() for p in model.parameters())
    return (sum(p.numel() for p in model.embed.parameters())
            + sum(p.numel() for layer in model.decoder
                  for name, p in layer.named_parameters()
                  if name not in cross_kv))


def decode_bytes(model, cfg, cache, B):
    """The bytes one decode step must move: every weight it reads
    (:func:`step_weights`), once, in the compute type (the bf16 casts; the
    1-D scales and decays and hymba's ``A_log``, read in f32 or cast, are
    counted at the compute type's size too: under 2 MB), less an untied
    embedding table's rows past the batch's and RWKV channel-mix ``wr``
    off its diagonal (the step reads only those); the K/V cache (whisper's
    cross K/V too) read whole; the recurrent state
    (:data:`STATE_REWRITTEN`) read and written; the logits written.  ``B``
    is the served batch (axis 1 of the VLM's ``k`` is a group's layer)."""
    import torch

    esize = torch.empty((), dtype=cfg.cdtype()).element_size()
    weights = step_weights(model, cfg)
    if not cfg.tie_embeddings:
        weights -= (cfg.padded_vocab - B) * cfg.d_model
    if cfg.family == "ssm":
        weights -= cfg.n_layers * (cfg.d_model ** 2 - cfg.d_model)
    rewritten = STATE_REWRITTEN.get(cfg.family, ())
    moved = sum(c.numel() * c.element_size() * (2 if name in rewritten else 1)
                for name, c in cache.items())
    return weights * esize + moved + B * cfg.padded_vocab * esize


def busy_shares(dev, cfg, fam_mod, kernel_key, steps=16):
    """The device's busy share of one prefill (:func:`serve_kw`'s batch
    and prompt, an enc-dec model's media too), of ``steps`` eager decode
    steps after it and of ``steps`` replays of the decode step captured as
    a CUDA graph (``serve.DecodeStep``), each under torch.profiler, with
    the device time of the kernels whose names hold ``kernel_key`` and the
    kernels a decode step; and the step's byte bound
    (:func:`decode_bytes`); printed.  For the hybrid family also the Mamba
    heads' and their scan's share of the prefill's device time, from
    profiler ranges around their calls (:func:`outer_range`); for the
    enc-dec family the encoder's, from its kernels profiled alone (its
    prefill is host-bound, so a range would span idle gaps)."""
    from unittest import mock

    import torch

    from repro_torch.launch import serve
    from repro_torch.models.common import init_model
    from repro_torch.nn import ssm

    arch = cfg.name
    model = init_model(fam_mod, cfg, torch.Generator(dev).manual_seed(0))
    B, S = serve_kw(cfg)["batch"], serve_kw(cfg)["prompt_len"]
    prompts = torch.randint(2, cfg.vocab_size, (B, S), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    media = serve.make_media(cfg, B, dev)
    wall, out = {}, {}

    def timed(key, fn):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall[key] = time.perf_counter() - t0
        return run

    # the served cache's length at least (whisper's 448), so the byte
    # bound counts the cache a served step reads
    max_seq = max(S + 2 * steps + 2, S + serve_kw(cfg)["gen"])

    def prefill():
        out["prefill"] = fam_mod.prefill(model, cfg, prompts,
                                         max_seq=max_seq, media=media)

    def decode_line(key, times, why, launched):
        if not times:
            return why
        busy = sum(times.values()) / 1e6
        return (f"device busy share {busy / wall[key]:.4f}, "
                f"{busy / steps * 1e3:.3f} ms of device time in a "
                f"{wall[key] / steps * 1e3:.3f} ms step, "
                f"{sum(launched.values()) / steps:.0f} kernels a step")

    # profiler ranges (name: the function they wrap) by family
    wrapped = {"hybrid": {"mamba_head": (ssm, "mamba_apply"),
                          "mamba_scan": (ssm, "associative_scan")}}.get(
                              cfg.family, {})
    ranges = dict.fromkeys(wrapped, 0) or None
    with torch.no_grad():
        prefill()                                           # warm
        del out["prefill"]
        torch.cuda.empty_cache()
        with contextlib.ExitStack() as stack:
            for name, (mod, attr) in wrapped.items():
                stack.enter_context(mock.patch.object(
                    mod, attr, outer_range(name, getattr(mod, attr))))
            times_p, why_p = device_times(timed("prefill", prefill),
                                          ranges=ranges)
        times_e = None
        if cfg.family == "encdec":      # the encoder's kernels alone
            times_e, why_e = device_times(
                lambda: fam_mod.encode(model, cfg, media))
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
        nbytes = decode_bytes(model, cfg, cache, B)
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
        if cfg.family == "encdec":
            enc = sum(times_e.values()) / 1e6 if times_e else 0
            why_p += ("; the encoder, profiled alone, "
                      + (f"{enc * 1e3:.3f} ms of device time "
                         f"({enc / busy:.1%} of the prefill's)" if enc
                         else f"not measured ({why_e})"))
        if ranges:
            why_p += "; " + ", ".join(
                f"{name} {ranges[name] / 1e3:.3f} ms "
                f"({ranges[name] / 1e6 / busy:.1%} of the device time)"
                if ranges[name] else f"{name} not measured (the profiler "
                "gave its range no device time)" for name in ranges)
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


def f32_divergence(dev, cfg, fam_mod, kernel_mod, kernel_name, seed):
    """The serve's prefill again in f32 compute, on the kernel and on its
    plain version: printed, not gated.  A growth that stays in f32 comes
    from the model amplifying any difference, not from bf16 rounding.  Not
    run for a model whose parameters are stored in bf16 (deepseek-v2 cut to
    4 layers, llama-3.2-vision-90b cut to 2 groups): their f32 casts would
    double its 34 GB, or add 42.6 GB to the VLM's 21.3 GB beside K5's
    plain-version f32 scores."""
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch.launch.serve import make_media
    from repro_torch.models.common import init_model

    arch = cfg.name
    if cfg.pdtype() != torch.float32:
        log(f"serve {arch} prefill in f32 compute: not run (parameters "
            f"stored in {cfg.param_dtype}; their f32 casts would not fit "
            f"beside them)")
        return
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = init_model(fam_mod, cfg, torch.Generator(dev).manual_seed(0))
    B, S = serve_kw(cfg)["batch"], serve_kw(cfg)["prompt_len"]
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, size=(B, S)), dtype=torch.int32, device=dev)
    media = make_media(cfg, B, dev)
    with torch.no_grad():
        a, ca = fam_mod.prefill(model, cfg, prompts, max_seq=S, media=media)
        with mock.patch.object(kernel_mod, kernel_name,
                               getattr(kernel_mod, kernel_name + "_ref")):
            b, cb = fam_mod.prefill(model, cfg, prompts, max_seq=S,
                                    media=media)
    name = next(iter(ca))
    per_layer = [_rel_l2(x, y) for x, y in zip(ca[name], cb[name])]
    log(f"serve {arch} prefill in f32 compute, on the kernel vs on its plain "
        f"version (not gated): logits relative L2 {_rel_l2(a, b):.3g}; "
        f"cache {name} by layer " + " ".join(f"{v:.1e}" for v in per_layer)
        + f"; max |{name}| in layer 0 {float(ca[name][0].abs().max()):.4g}")
    del model, ca, cb
    torch.cuda.empty_cache()


def deepseek_config():
    """deepseek-v2-236b at full width (d 5120, 128 heads, MLA q_lora 1536,
    kv_lora 512, q/k 128 + 64, v 128, 160 experts top-6 + 2 shared, vocab
    102400), cut to 4 of its 60 layers and its parameters stored in bf16,
    the compute type (34 GB; a layer holds 3.97 B parameters)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=4,
                               param_dtype="bfloat16")


def vlm_config():
    """llama-3.2-vision-90b at full width (d 8192, 64 heads and 8 kv heads
    of 128, d_ff 28672, vocab 128256 untied, 1601 media tokens), cut to 2
    of its 20 groups (8 self and 2 cross layers) and its parameters stored
    in bf16, the compute type (21.3 GB; a group holds 4.28 B
    parameters)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama-3.2-vision-90b"),
                               n_layers=10, param_dtype="bfloat16")


#: the value every cross layer's ``gate_attn`` and ``gate_ffn`` takes on the
#: card's VLM serves: the reference's init leaves them 0 (each cross layer
#: the identity), so the media and the cross layers' K5 output would not
#: reach the logits
VLM_GATE = 0.5


@contextlib.contextmanager
def gates_set():
    """``serve.init_model`` wrapped so that a VLM's cross layers' gates
    are set to :data:`VLM_GATE` after its parameters are drawn."""
    from unittest import mock

    from repro_torch.launch import serve

    init = serve.init_model

    def gated(fam, cfg, generator):
        model = init(fam, cfg, generator)
        for group in model.groups:
            for name in ("gate_attn", "gate_ffn"):
                group.cross[name].fill_(VLM_GATE)
        return model

    with mock.patch.object(serve, "init_model", gated):
        yield


def models_phase(dev, seed):
    """-> (kernels rows, launches) of K5 and K6: K5's over the qwen2-1.5b,
    granite-moe-3b-a800m, deepseek-v2-236b (4 layers), hymba-1.5b,
    whisper-large-v3 and llama-3.2-vision-90b (2 groups) serves' prefills
    (whisper's 96: its encoder's self-attention, its decoder's self- and
    cross-attention; the VLM's 10: its self and cross layers), K6's over
    rwkv6-3b's."""
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.rwkv6 import ops as k6
    from repro_torch.models import encdec, hymba, lm, rwkv, vlm
    from repro_torch.nn import layers, ssm

    rows = {"flash_attention": flash_phase(dev), "wkv6": wkv6_phase(dev)}
    k5_serves = {}
    for arch, fam in (("qwen2-1.5b", lm), ("granite-moe-3b-a800m", lm),
                      (deepseek_config(), lm), ("hymba-1.5b", hymba),
                      ("whisper-large-v3", encdec), (vlm_config(), vlm)):
        t0 = time.perf_counter()
        name = getattr(arch, "name", arch)
        with gates_set() if fam is vlm else contextlib.nullcontext():
            if fam is vlm:
                log(f"serve {name}: every cross layer's gate_attn and "
                    f"gate_ffn set to {VLM_GATE} on the served model of the "
                    f"kernel, plain-version and timed serves (the package's "
                    f"init keeps the reference's zeros)")
            k5_serves[name] = serve_model(dev, arch, fam, k5,
                                          "flash_attention", (layers, "_k5"),
                                          seed)
        log(f"serve {name}: {time.perf_counter() - t0:.1f} s")
    log(f"K5 launches by serve: {k5_serves}")
    launches = {
        "flash_attention": sum(k5_serves.values()),
        "wkv6": serve_model(dev, "rwkv6-3b", rwkv, k6, "wkv6", (ssm, "_k6"),
                            seed)}
    return rows, launches


# -- phase 9: training ----------------------------------------------------

#: what the train and models phases measured on the card, for the dry
#: run's gates: ("train", arch) -> launches a step, peak, parameter bytes,
#: model FLOPs and ms a step; ("prefill", arch) -> K5's prefill launches
MEASURED: dict = {}

#: the train cells: a dense LM (K5's forward and backward) and RWKV6 (K6's)
TRAIN_ARCHS = ("qwen2-1.5b", "rwkv6-3b")
#: the one cut of train_4k (seq 4096, global batch 256): batch 8, as 4
#: micro-batches of 2, for 5 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 8, 4096, 4, 5
#: relative L2 of the first micro-batch's gradients (the embedding, layers
#: 0 and 1) on the kernels against their plain versions in f32 compute, two
#: layers at full width (see train_grad_check): f32 sums in other orders
TRAIN_GRAD_TOL_F32 = 1e-3
#: relative L2, each layer's, of the first micro-batch's bf16 gradients at
#: full depth on the backward kernel against its plain backward (one
#: forward): once two bf16 backwards round one element apart they part to
#: the level of bf16 rounding carried through the layers below, measured
#: (``flash_bwd.cu``) 2.6e-4 at layer 27 (where the backward starts) and
#: 1.5e-2 to 3.1e-2 from layer 20 down; a zero or dropped gradient reads
#: 1.0.  At two layers the gate is K5's backward kernel's own tolerance
#: (``ops.bwd_tolerance`` of the variant the training shape takes)
TRAIN_GRAD_TOL_BF16_DEEP = 0.1
#: the same gate for RWKV6 (32 layers), whose embedding gradient parts
#: furthest: measured on K6's backward kernel (H100) 1.8e-5 at layer 31,
#: 6.7e-4 to 5.0e-2 below it and 0.125 at the embedding, whose rows sum a
#: token's few positions where a weight's gradient averages them all
TRAIN_GRAD_TOL_BF16_DEEP_SSM = 0.25
#: the two-layer gate of RWKV6's bf16 gradients on K6's backward kernel
#: against its plain backward: the one K5's takes there (``flash_bwd_tc``'s
#: 4u, u = 2**-8).  K6 runs in f32, so the two backwards part by f32
#: rounding (1e-7 to 1e-6) until the gradients' bf16 casts round an
#: element apart
K6_TRAIN_GRAD_TOL_BF16 = 2.0 ** -6
#: K5's backward against its plain version: name, q, k/v, DV, type,
#: causal, window
K5_BWD_CASES = (
    ("train", (2, 4096, 12, 128), (2, 4096, 2, 128), 128, "bfloat16", True,
     0),
    ("window", (2, 1500, 8, 64), (2, 1500, 2, 64), 64, "bfloat16", True, 256),
    ("noncausal", (2, 224, 20, 64), (2, 1500, 20, 64), 64, "bfloat16", False,
     0),
    ("mla", (1, 1000, 16, 192), (1, 1000, 16, 192), 128, "bfloat16", True, 0),
    ("f32_d16", (2, 257, 4, 16), (2, 257, 2, 16), 16, "float32", True, 0),
    ("ragged", (1, 333, 6, 128), (1, 517, 2, 128), 128, "float16", True, 0),
    ("d256", (2, 1024, 8, 256), (2, 1024, 4, 256), 256, "bfloat16", True, 0),
)
#: K6's backward against its plain backward: label, (B, S, H, D), strong
#: decay (then also a state0 and a final state's cotangent).  The training
#: shape is rwkv6-3b's micro-batch, 2 x 4096 tokens of 40 heads of 64
K6_BWD_CASES = (("train", (2, 4096, 40, 64), False),
                ("S = 2000, padded", (2, 2000, 40, 64), False),
                ("strong decay", (2, 1024, 40, 64), True))
#: relative L2 a gradient of K6's backward kernel against its plain
#: backward: f32 sums in other orders (the CPU emulation of its algorithm
#: reads 3e-8 to 5e-7 from the plain backward); under strong decay the
#: exponents are differences of cumulative log-decays near -1e3 to -1e4
K6_BWD_TOL, K6_BWD_TOL_STRONG = 1e-4, 1e-3
K6_NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")


class SeamK5:
    """K5 through the ``layers._k5`` seam as an autograd Function of a
    chosen forward and backward: ``forward(q, k, v, causal, window)`` and
    ``backward(q, k, v, out, dout, causal=, window=)``."""

    def __init__(self, forward, backward):
        self.forward, self.backward = forward, backward

    def flash_attention(self, q, k, v, causal=True, window=0):
        import torch

        seam = self

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v):
                out = seam.forward(q, k, v, causal, window)
                ctx.save_for_backward(q, k, v, out)
                return out

            @staticmethod
            def backward(ctx, dout):
                return seam.backward(*ctx.saved_tensors, dout.contiguous(),
                                     causal=causal, window=window)
        return Fn.apply(q, k, v)


def k5_seams():
    """-> {"plain": K5's plain versions, forward (``ref.flash_attention_ref``)
    and backward (``ref.flash_attention_bwd_ref``); "mixed": the forward
    kernel (its launch, as ``ops`` dispatches it) with the plain
    backward}."""
    from repro_torch.kernels.flash_attention import ops, ref

    def plain_fwd(q, k, v, causal, window):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return {"plain": SeamK5(plain_fwd, ref.flash_attention_bwd_ref),
            "mixed": SeamK5(ops._forward, ref.flash_attention_bwd_ref)}


def bwd_bound(q, k, v, causal, window):
    """-> (ms, what bounds it) of K5's backward on these inputs: q, k, v,
    the output and its gradient read once, dq, dk, dv written once; five
    products over the visible (query, key) pairs (s = q k^T, dP = dO v^T,
    dV, dQ, dK), 2·B·H·pairs·(3D + 2DV) operations, at the inputs' type's
    peak (bf16 / f16 tensor cores, f32 CUDA cores)."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_mask

    B, S, H, D = q.shape
    T, K, DV = k.shape[1], k.shape[2], v.shape[-1]
    pairs = int(attention_mask(S, T, causal, window, "cpu").sum())
    nbytes = (B * S * H * (2 * D + 2 * DV) + 2 * B * T * K * (D + DV)) \
        * q.element_size()
    ops = 2 * B * H * pairs * (3 * D + 2 * DV)
    peak = F32_OPS_PER_S if q.dtype == torch.float32 else BF16_OPS_PER_S
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / peak}
    what = max(times, key=times.get)
    return times[what] * 1e3, what


def sdpa_bwd_ms(q, k, v, dout, causal, window):
    """-> (ms, backend) of ``scaled_dot_product_attention``'s backward on
    K5's inputs (a yardstick only): ``is_causal`` (or not), or a boolean
    (S, T) mask under a window, ``enable_gqa`` where K < H."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import attention_mask

    S, H, T, K = q.shape[1], q.shape[2], k.shape[1], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    mask = (attention_mask(S, T, causal, window, q.device) if window
            else None)
    kw = dict(is_causal=causal) if mask is None else dict(attn_mask=mask)
    gqa = dict(enable_gqa=True) if K < H else {}
    o = F.scaled_dot_product_attention(qt, kt, vt, **kw, **gqa)
    gt = dout.transpose(1, 2).contiguous()
    ms = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), gt,
                                             retain_graph=True), 5)
    how = sdpa_backend(qt.detach(), kt.detach(), vt.detach(), mask,
                       gqa=bool(gqa), causal=causal)
    return ms, ("enable_gqa, " if gqa else "") + how


def k5_bwd_checks(dev):
    """K5's backward against its plain version on the card at
    :data:`K5_BWD_CASES`, each case on the kernel that ``ops.bwd_variant``
    picks behind the forward kernel (``flash_bwd_tc`` reads the forward's
    log-sum-exp): each gradient within ``ops.bwd_tolerance`` of its variant
    (relative L2), two runs the same bits, one launch counted on the
    variant.  Every case on ``flash_bwd_tc`` is timed beside its bound,
    ``flash_bwd.cu`` on the same inputs (``ops.bwd_launch``) and
    ``scaled_dot_product_attention``'s backward (a yardstick only); the
    training shape also beside its plain version.  -> the kernels row (the
    training shape's numbers, the other cases under ``cases``)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    gen = torch.Generator(dev).manual_seed(7)
    row, cases = {}, {}
    for name, qs, ks, DV, dt, causal, window in K5_BWD_CASES:
        dt = getattr(torch, dt)
        q = torch.randn(qs, generator=gen, device=dev).to(dt)
        k = torch.randn(ks, generator=gen, device=dev).to(dt)
        v = torch.randn((*ks[:3], DV), generator=gen, device=dev).to(dt)
        kw = dict(causal=causal, window=window)
        variant = k5.bwd_variant(dt, qs[-1], DV)
        lse = None
        with torch.no_grad():
            if variant == "flash_bwd_tc":
                out, lse = k5.launch("flash_tc", q, k, v, with_lse=True, **kw)
            else:
                out = k5.flash_attention(q, k, v, **kw)
        dout = torch.randn(out.shape, generator=gen, device=dev).to(dt)
        args = (q, k, v, out, dout)
        n0 = k5.flash_attention.bwd_variant_launches[variant]
        got = k5.flash_attention_bwd(*args, lse=lse, **kw)
        again = k5.flash_attention_bwd(*args, lse=lse, **kw)
        torch.cuda.synchronize()
        check(k5.flash_attention.bwd_variant_launches[variant] == n0 + 2,
              f"K5 backward {name}: {variant} did not launch")
        want = flash_attention_bwd_ref(*args, **kw)
        tol = k5.bwd_tolerance(variant, dt)
        errs = [_rel_l2(g, w) for g, w in zip(got, want)]
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        log(f"K5 backward {name}: q {qs} k/v {ks} DV {DV} {dt} causal "
            f"{causal} window {window} on {variant}: dq/dk/dv relative L2 "
            + "/".join(f"{e:.3e}" for e in errs)
            + f" (gate {tol:.3e}), max abs {err:.3e}")
        check(all(e <= tol for e in errs),
              f"K5 backward {name} differs from its plain version: {errs}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K5 backward {name}: two runs differ")
        del got, again, want
        if variant != "flash_bwd_tc":
            continue
        ms = cuda_ms(lambda: k5.flash_attention_bwd(*args, lse=lse, **kw),
                     10)
        simt = cuda_ms(lambda: k5.bwd_launch("flash_bwd", *args, **kw), 2,
                       warmup=1)
        bound, by = bwd_bound(q, k, v, causal, window)
        lib, how = sdpa_bwd_ms(q, k, v, dout, causal, window)
        log(f"K5 backward {name} on flash_bwd_tc: {ms:.4f} ms a call, bound "
            f"{bound:.4f} ms ({by}; {bound / ms:.1%} of it); flash_bwd.cu "
            f"{simt:.4f} ms ({simt / ms:.1f}x); SDPA's backward ({how}) "
            f"{lib:.4f} ms")
        cases[name] = dict(ms=ms, bound_ms=bound, bound_by=by,
                           cuda_core_ms=simt, library_ms=lib,
                           max_abs_err=err)
        if name == "train":
            plain = cuda_ms(lambda: flash_attention_bwd_ref(*args, **kw), 3)
            def once():          # the profiler stops after the launches end
                k5.flash_attention_bwd(*args, lse=lse, **kw)
                torch.cuda.synchronize()
            split, why = device_times(once)
            split = ", ".join(
                f"{n.split('<')[0].split('::')[-1]} {us:.1f} us"
                for n, us in split.items()) if split else why
            log(f"K5 backward at the training shape: plain version "
                f"{plain:.4f} ms; device time by launch: {split}")
            row = dict(variant=variant, max_abs_err=err, ms=ms,
                       plain_ms=plain, bound_ms=bound, bound_by=by,
                       library_ms=lib, cuda_core_ms=simt)
    row["cases"] = cases
    return row

class PlainK6:
    """K6's plain version under autograd, forward and backward, in the
    wrapper's place (``ssm._k6``)."""

    @staticmethod
    def wkv6(r, k, v, logw, u, *, chunk=64, state0=None):
        from repro_torch.kernels.rwkv6.ref import wkv6_ref

        return wkv6_ref(r, k, v, logw, u, chunk=chunk, state0=state0)


def plain_wkv6_bwd(*args, starts=None, **kw):
    """K6's plain backward in ``ops.wkv6_bwd``'s place: the forward kernel's
    saved states unread."""
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref

    return wkv6_bwd_ref(*args, **kw)


def grad_seams(cfg):
    """-> ({seam: a factory of the context manager that swaps it in}, the
    two-layer bf16 gate) of ``cfg``'s family.  "kernel": the kernels, no
    swap; "mixed": the forward kernel with the plain backward; "plain":
    both plain versions.  K5's through ``layers._k5`` (:func:`k5_seams`)
    for an LM; K6's for RWKV6, the plain backward in ``ops.wkv6_bwd``'s
    place and the plain forward under autograd in ``ssm._k6``'s."""
    from unittest import mock

    import torch

    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.rwkv6 import ops as k6
    from repro_torch.nn import layers, ssm

    if cfg.family == "ssm":
        return ({"kernel": contextlib.nullcontext,
                 "mixed": lambda: mock.patch.object(k6, "wkv6_bwd",
                                                    plain_wkv6_bwd),
                 "plain": lambda: mock.patch.object(ssm, "_k6", PlainK6)},
                K6_TRAIN_GRAD_TOL_BF16)
    seams = k5_seams()
    return ({"kernel": contextlib.nullcontext,
             "mixed": lambda: mock.patch.object(layers, "_k5",
                                                seams["mixed"]),
             "plain": lambda: mock.patch.object(layers, "_k5",
                                                seams["plain"])},
            k5.bwd_tolerance(k5.bwd_variant(torch.bfloat16, cfg.head_dim),
                             torch.bfloat16))


def k6_bwd_bound(B, S, H, D, C=64):
    """-> (ms, what bounds it, {what: ms}) of K6's backward at (B, S, H, D)
    with no state0 and no final-state cotangent, the largest of: the bytes
    that must move (r, k, v, logw and dy read once, dr, dk, dv and dlogw
    written once, u and du), the f32 operations and the exponentials (at
    the SFU's 16 a clock a SM).  A chunk of C tokens (P = C(C-1)/2 pairs)
    takes the scores (difference, exp, two products and a sum a pair and
    channel, as :func:`wkv6_phase` counts the forward's), d_att = dy v^T
    and att^T dy (2 each a pair with the diagonal and channel), dr' and
    dk'' through the decays (5 a pair and channel: one product shared, two
    multiply-adds), the four (C, D) x (D, D) products of the state's
    shares (8·C·D^2) and the adjoint's update (2·D^2); exponentials: the
    pair decays, exp(cum_prev) and exp(total - cum) a token and channel,
    exp(total) a channel."""
    nC = -(-S // C)
    P = C * (C - 1) // 2
    n = B * S * H * D
    nbytes = 9 * n * 4 + 2 * H * D * 4
    ops = B * H * nC * (9 * P * D + 4 * (P + C) * D + 8 * C * D * D
                        + 2 * D * D)
    exps = B * H * nC * (P * D + 2 * C * D + D)
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": ops / F32_OPS_PER_S * 1e3,
             "exponentials": exps / SFU_PER_S * 1e3}
    what = max(times, key=times.get)
    return times[what], what, times


def k6_bwd_design_bytes(B, S, H, D, C=64):
    """-> the bytes ``wkv6_bwd.cu``'s launches move at (B, S, H, D) with
    no state0 and no final-state cotangent: the pre-pass reads r, lw and dy
    and writes q and total; the scan reads and writes q and reads total;
    the chunk pass reads r, k, v, lw, dy, S and G and writes dr, dk, dv,
    dlw and its part of du; du reads those parts (a chunk's tiles whole,
    rows past S included)."""
    chunks = B * H * -(-S // C)
    tile, state, vec = C * D * 4, D * D * 4, D * 4
    pre = 3 * tile + state + vec
    scan = 2 * state + vec
    chunk = 5 * tile + 2 * state + 4 * tile + vec
    return chunks * (pre + scan + chunk + vec) + H * D * 4


def k6_bwd_checks(dev):
    """K6's backward kernel (``wkv6_bwd.cu``) against its plain backward
    (``ref.wkv6_bwd_ref``) on the card at :data:`K6_BWD_CASES`, with the
    draws of :func:`wkv6_phase` (r, k, v, u at 0.5 sigma, log-decays
    -exp(0.5 z), under strong decay -exp(2 z + 2)) and a cotangent dy of
    one sigma, on identical inputs and the forward kernel's saved starting
    states: each gradient within :data:`K6_BWD_TOL` (relative L2), two runs
    the same bits, one launch counted each.  At the training shape it is
    timed beside its bound (:func:`k6_bwd_bound`), by launch, beside the
    plain backward and autograd through the plain forward (``wkv6_ref``)
    on the card, with the bytes its design moves (in the log line) and its
    blocks resident an SM.  -> the kernels row (the training shape's
    numbers, each case's distances under ``cases``)."""
    import ctypes

    import torch

    from repro_torch.kernels.rwkv6 import ops as k6

    g = torch.Generator(dev).manual_seed(6)
    row, cases = {}, {}
    for label, shape, strong in K6_BWD_CASES:
        B, S, H, D = shape
        r, k, v = (torch.randn(shape, generator=g, device=dev) * 0.5
                   for _ in range(3))
        z = torch.randn(shape, generator=g, device=dev)
        lw = -torch.exp(z * 2.0 + 2.0 if strong else z * 0.5)
        u = torch.randn((H, D), generator=g, device=dev) * 0.5
        dy = torch.randn(shape, generator=g, device=dev)
        s0 = ds = None
        if strong:
            s0, ds = (torch.randn((B, H, D, D), generator=g, device=dev)
                      for _ in range(2))
        args, kw = (r, k, v, lw, u, dy), dict(state0=s0, ds_end=ds)
        with torch.no_grad():
            starts = k6._launch(r, k, v, lw, u, s0, 64)[2]
        n0 = k6.wkv6.bwd_launches
        got = k6.wkv6_bwd(*args, starts=starts, **kw)
        again = k6.wkv6_bwd(*args, starts=starts, **kw)
        torch.cuda.synchronize()
        check(k6.wkv6.bwd_launches == n0 + 2,
              f"K6 backward {label}: the kernel did not launch")
        want = k6.wkv6_bwd_ref(*args, **kw)
        tol = K6_BWD_TOL_STRONG if strong else K6_BWD_TOL
        errs = [_rel_l2(a, b) for a, b in zip(got, want)]
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        log(f"K6 backward {label} {shape}"
            + (" with state0 and ds_end" if strong else "")
            + ": relative L2 " + ", ".join(
                f"{n} {e:.3e}" for n, e in zip(K6_NAMES, errs))
            + f" (gate {tol:.0e}), max abs {err:.3e}, finite {finite}")
        check(finite and all(e <= tol for e in errs),
              f"K6 backward {label} differs from its plain backward: {errs}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K6 backward {label}: two runs differ")
        cases[label] = dict(zip(K6_NAMES, errs), max_abs_err=err)
        del got, again, want
        if label != "train":
            continue
        ms = cuda_ms(lambda: k6.wkv6_bwd(*args, starts=starts), 10)
        per_launch, why = device_us(
            lambda: k6.wkv6_bwd(*args, starts=starts),
            r"wkv6_bwd_(pre|scan|chunk|du)", calls=10)
        plain_bwd = cuda_ms(lambda: k6.wkv6_bwd_ref(*args), 3, warmup=1)
        ins = [t.clone().requires_grad_(True) for t in args[:5]]
        y, _ = k6.wkv6_ref(*ins)
        plain = cuda_ms(lambda: torch.autograd.grad(y, ins, dy,
                                                    retain_graph=True),
                        3, warmup=1)
        del y, ins
        torch.cuda.empty_cache()
        bound, by, times = k6_bwd_bound(B, S, H, D)
        moved = k6_bwd_design_bytes(B, S, H, D)
        resident = k6.bwd_library().wkv6_bwd_residency
        resident.argtypes, resident.restype = [ctypes.c_int], ctypes.c_int
        blocks = {"pre": resident(0), "chunk": resident(1)}
        log(f"K6 backward {shape} f32: {ms:.4f} ms a call, bound "
            f"{bound:.4f} ms ({by}; {bound / ms:.1%} of it; "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            + f"); the design moves {moved / 1e9:.3f} GB, "
            f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; device a call: "
            + (f"{per_launch:.1f} us ({why})" if per_launch
               else f"not measured ({why})")
            + f"; blocks resident an SM {blocks}; plain backward "
            f"{plain_bwd:.4f} ms, autograd through the plain forward "
            f"{plain:.4f} ms")
        check(blocks["chunk"] >= 2, f"K6 backward: the chunk pass keeps "
              f"{blocks['chunk']} blocks an SM, not two")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                   plain_bwd_ms=plain_bwd, bound_ms=bound,
                   bound_by="bytes" if by == "bytes" else "operations",
                   library_ms=None, device_us=per_launch,
                   resident_blocks=blocks)
    row["cases"] = cases
    return row


def first_grads(model, cfg, tokens, labels, seam):
    """-> (loss, {parameter name: gradient}) of one micro-batch with the
    kernels swapped as ``seam()`` (a context manager, :func:`grad_seams`)
    swaps them; every gradient present and finite."""
    import torch

    from repro_torch.models import common as C

    for p in model.parameters():
        p.grad = None
    with seam():
        loss = C.lm_loss(C.get_family(cfg).forward(model, cfg, tokens),
                         labels)
        loss.backward()
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()]
    check(not missing, f"train ({cfg.compute_dtype}): parameters without a "
          f"finite gradient: {missing[:5]} ({len(missing)})")
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), grads


def rel_by_layer(got, want) -> dict:
    """Relative L2 of two gradient dicts, by layer ("embed", "0", ...), in
    f64."""
    sums = {}
    for n in want:
        where = n.split(".")[1] if n.startswith("layers.") else "embed"
        a, b = sums.get(where, (0.0, 0.0))
        sums[where] = (
            a + float((got[n].double() - want[n].double()).square().sum()),
            b + float(want[n].double().square().sum()))
    return {w: (a / max(b, 1e-300)) ** 0.5 for w, (a, b) in sums.items()}


def train_grad_check(dev, cfg, tokens, labels):
    """The first micro-batch's gradients (the f32 parameters', relative L2
    by layer) on the kernels (forward and backward: K5's for an LM, K6's
    for RWKV6) against the seams of :func:`grad_seams`, from one set of
    weights a config.

    Gated in the training type, bf16: the kernels against the forward
    kernel with the plain backward ("mixed").  Their forwards are the same
    launches, so the losses must be the same bits and the gradients differ
    only by the backward's rounding, carried back through the layers: on
    the config cut to two layers at full width each layer's within the
    seam's two-layer gate (K5: ``ops.bwd_tolerance`` of the variant the
    config's head dims take in bf16, the backward kernel's own,
    ``flash_bwd_tc``: 2**-6; K6: :data:`K6_TRAIN_GRAD_TOL_BF16`); at full
    depth within :data:`TRAIN_GRAD_TOL_BF16_DEEP` (RWKV6:
    :data:`TRAIN_GRAD_TOL_BF16_DEEP_SSM`).  A zero or dropped
    gradient reads 1.0 and fails both.  Gated in f32 compute, on the two
    layers (K5's ``flash.cu`` forward and the backward's f32 instance; K6
    is f32 in either type): the embedding's and layers 0-1's gradients on
    the kernels within :data:`TRAIN_GRAD_TOL_F32` of the plain versions'.
    Printed, not gated: the kernels against the plain versions in bf16, at
    full depth (not RWKV6's: autograd through K6's plain forward holds
    about 20 GB a layer at the training shape) and at two layers, and the
    two layers' bf16 gradients against the f32 plain ones.  There the
    forwards round apart, and under the reference's init a one-ulp
    difference grows about 10x a layer, so two bf16 runs differ by O(1):
    the JAX package's own bf16 gradient at two layers lies 1.39-1.67 from
    its f32 one, and the port's on the CPU 1.21-1.47 from its own and
    0.87-1.24 from the JAX package's bf16 one
    (``tests/_torch_bf16_witness.py``)."""
    import torch

    from repro_torch.models import common as C

    seams, tol = grad_seams(cfg)
    cut = dataclasses.replace(cfg, n_layers=2)
    cut32 = dataclasses.replace(cut, compute_dtype="float32")
    deep = (("kernel", "mixed") if cfg.family == "ssm"
            else ("kernel", "mixed", "plain"))
    for c, names in ((cfg, deep), (cut, ("kernel", "mixed", "plain")),
                     (cut32, ("kernel", "plain"))):
        model = C.init_model(C.get_family(c), c,
                             torch.Generator(dev).manual_seed(0))
        model.requires_grad_(True)
        runs = {k: first_grads(model, c, tokens, labels, seams[k])
                for k in names}
        where = ["embed", *map(str, range(c.n_layers))]
        rels = {k: rel_by_layer(runs["kernel"][1], runs[k][1])
                for k in names[1:]}
        for k, rel in rels.items():
            log(f"train {c.name}, {c.n_layers} layers, {c.compute_dtype}: "
                f"first micro-batch loss {runs['kernel'][0]:.6f} on the "
                f"kernels, {runs[k][0]:.6f} on the {k} seam; gradient "
                f"relative L2 by layer: "
                + ", ".join(f"{w} {rel[w]:.3e}" for w in where))
        if c is cfg:
            norm = sum(float(g.double().square().sum())
                       for g in runs["kernel"][1].values()) ** 0.5
            log(f"train {c.name}, {c.n_layers} layers: the first "
                f"micro-batch's gradient norm (f64) {norm:.4e}")
        if c is not cut32:
            limit = (tol if c is cut else TRAIN_GRAD_TOL_BF16_DEEP_SSM
                     if c.family == "ssm" else TRAIN_GRAD_TOL_BF16_DEEP)
            check(runs["kernel"][0] == runs["mixed"][0], "train (bf16): the "
                  "forward kernel gives other losses under the two seams")
            bad = {w: r for w, r in rels["mixed"].items() if not r <= limit}
            check(not bad, f"train {c.name} (bf16, {c.n_layers} layers): "
                  f"gradients on the backward kernel differ from those on "
                  f"its plain version by more than {limit:.3e}: {bad}")
        if c is cut:
            bf16 = {k: runs[k][1] for k in ("kernel", "plain")}
        elif c is cut32:
            check(all(rels["plain"][w] <= TRAIN_GRAD_TOL_F32 for w in where),
                  f"train {c.name} (f32): gradients differ from the plain "
                  f"versions' by more than {TRAIN_GRAD_TOL_F32}: "
                  f"{rels['plain']}")
            truth = runs["plain"][1]
            kern = rel_by_layer(bf16["kernel"], truth)
            plain = rel_by_layer(bf16["plain"], truth)
            log(f"train {c.name}, 2 layers, bf16 against the f32 plain "
                f"gradient: "
                + ", ".join(f"{w} kernels {kern[w]:.3e}, plain versions "
                            f"{plain[w]:.3e}" for w in where))
            del bf16, truth
        del model, runs
        torch.cuda.empty_cache()


def adam_steps(metrics, opt, after, before):
    """Gate one train step's update beyond weight decay: AdamW sets ``p -=
    lr * (a + weight_decay * p)``, so each parameter's Adam step ``a`` is
    ``(before - after) / lr - weight_decay * before`` (in f64).  A step
    that applies weight decay alone (a clip scale of 0) leaves ``a`` at
    f32 rounding, about 1e-5 here; an Adam step on a real gradient moves
    the elements whose clipped gradient passes ``eps`` by up to about 1.
    Printed by leaf group (the embedding, the first and the last layer):
    the largest and the root mean square |a|; gated: the largest of all at
    least 0.1, and every one finite."""
    lr, wd = metrics["lr"], opt.weight_decay
    check(lr > 0 and np.isfinite(metrics["grad_norm"]),
          f"train: the profiled step's metrics {metrics}")
    groups = {}
    for path, p in after.items():
        a = ((before[path].double() - p.detach().double()) / lr
             - wd * before[path].double())
        where = f"layer {path[-1]}" if path[0] == "layers" else "embed"
        g = groups.setdefault(where, [0.0, 0.0, 0])
        g[0] = max(g[0], float(a.abs().max()))
        g[1] += float(a.square().sum())
        g[2] += a.numel()
    log(f"train, the profiled step (lr {lr:.3e}, grad norm "
        f"{metrics['grad_norm']:.4e}): Adam's step |a| beyond weight decay, "
        + "; ".join(f"{w} max {m:.3e} rms {(sq / n) ** 0.5:.3e}"
                    for w, (m, sq, n) in groups.items()))
    top = max(m for m, _, _ in groups.values())
    check(np.isfinite(top) and top >= 0.1, f"train: the profiled step moved "
          f"no weight beyond weight decay (largest Adam step {top:.3e})")


def train_cell(dev, cfg, loader):
    """The training entry point ``repro_torch.launch.train.train`` on
    ``cfg`` at full width and depth (f32 master weights and moments, bf16
    compute, remat "full"): :data:`TRAIN_STEPS` steps of
    :data:`TRAIN_BATCH` x :data:`TRAIN_SEQ` tokens in :data:`TRAIN_ACCUM`
    micro-batches, the kernels' launches counted and gated (an LM's K5,
    RWKV6's K6: forward twice a layer and micro-batch under remat, backward
    once; the other kernel none; K5's backward all on ``flash_bwd_tc``),
    every loss and grad norm finite, peak memory under 80 GB; one more step
    under torch.profiler for the busy share, the kernel's forward and
    backward device time and the update (:func:`adam_steps`); printed: ms
    a step, tokens/s, the model-FLOP share (6·N·tokens, an LM's attention
    added, at the bf16 peak), the loss trajectory and peak memory.
    ``loader`` yields the batches after the first.  -> ({kernels row:
    backward launches}, {kernels row: forward launches})."""
    import torch

    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.rwkv6 import ops as k6
    from repro_torch.launch import train as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import TrainConfig, make_train_step
    from repro_torch.tree import leaves_with_paths

    wkv = cfg.family == "ssm"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)     # earlier phases' leftovers
    k5.flash_attention.launches = k5.flash_attention.bwd_launches = 0
    k5.flash_attention.bwd_variant_launches = dict.fromkeys(k5.BWD_SOURCES,
                                                            0)
    k6.wkv6.launches = k6.wkv6.bwd_launches = 0
    t0 = time.perf_counter()
    r = T.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                log_every=1, device="cuda", accum_steps=TRAIN_ACCUM)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5n = (k5.flash_attention.launches, k5.flash_attention.bwd_launches)
    k6n = (k6.wkv6.launches, k6.wkv6.bwd_launches)
    by_variant = dict(k5.flash_attention.bwd_variant_launches)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    want = cfg.n_layers * TRAIN_ACCUM * TRAIN_STEPS
    fwd, bwd = k6n if wkv else k5n
    log(f"train {cfg.name}: {TRAIN_STEPS} steps in {wall:.1f} s (model init "
        f"included); {'K6' if wkv else 'K5'} launches forward {fwd} "
        f"(expected {2 * want}: remat runs each layer's forward twice), "
        f"backward {bwd} (expected {want}); K5 {k5n}, by variant "
        f"{by_variant}, K6 {k6n}; peak memory {peak:.3f} GB, "
        f"{held / 1e9:.3f} GB of it held before the cell")
    check(fwd == 2 * want and bwd == want,
          f"train {cfg.name}: launches forward {fwd}, backward {bwd}")
    check((k5n if wkv else k6n) == (0, 0),
          f"train {cfg.name}: K5 launches {k5n}, K6 launches {k6n}")
    if not wkv:
        check(by_variant == dict(flash_bwd_tc=want, flash_bwd=0),
              f"train: K5 backward launches by variant {by_variant}")
    check(all(np.isfinite(r["losses"])), f"train: losses {r['losses']}")
    check(all(np.isfinite(r["grad_norms"])),
          f"train: grad norms {r['grad_norms']}")
    check(peak < 80.0, f"train {cfg.name}: peak memory {peak:.3f} GB")
    state = r["state"]
    n_params = sum(p.numel() for p in state["model"].parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    attn = 0 if wkv else 3 * (TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ
                              * TRAIN_SEQ * 2 * cfg.head_dim) * cfg.n_layers
    flops = 6 * n_params * tokens + attn
    MEASURED["train", cfg.name] = dict(
        fwd=fwd // TRAIN_STEPS, bwd=bwd // TRAIN_STEPS,
        peak_bytes=torch.cuda.max_memory_allocated(dev) - held,
        held_bytes=held, model_flops=flops,
        param_bytes=sum(p.numel() * p.element_size()
                        for p in state["model"].parameters()),
        step_ms=[s_ * 1e3 for s_ in r["step_s"]])
    for i, (loss, s) in enumerate(zip(r["losses"], r["step_s"])):
        log(f"train {cfg.name} step {i}: loss {loss:.6f}, gnorm "
            f"{r['grad_norms'][i]:.4f}, lr {r['lrs'][i]:.3e}, {s * 1e3:.1f} "
            f"ms, {tokens / s:.0f} tokens/s, model-FLOP share "
            f"{flops / s / BF16_OPS_PER_S:.2%}")

    # one more step under the profiler: the device's busy share, and the
    # update beyond weight decay of the embedding and the first and last
    # layers
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, TrainConfig(accum_steps=TRAIN_ACCUM, opt=opt))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(loader).items()}
    wall = {}
    watched = {path: p for path, p in leaves_with_paths(state["params"])
               if path[0] != "layers" or path[-1] in (0, cfg.n_layers - 1)}
    before = {path: p.detach().clone() for path, p in watched.items()}

    def one():
        torch.cuda.synchronize()
        t = time.perf_counter()
        wall["metrics"] = {k: float(v) for k, v in step(state, batch).items()}
        wall["s"] = time.perf_counter() - t
    times, why = device_times(one)
    adam_steps(wall["metrics"], opt, watched, before)
    del watched, before
    if times:
        busy = sum(times.values()) / 1e6
        top = sorted(times.items(), key=lambda kv: -kv[1])[:4]
        log(f"train {cfg.name} step under torch.profiler: "
            f"{wall['s'] * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
            f"({busy / wall['s']:.2%}); top kernels "
            + "; ".join(f"{k[:60]} {v / 1e3:.1f} ms" for k, v in top))
        parts = ((("forward", r"wkv6_(intra|scan|inter)\b"),
                  ("backward", r"wkv6_bwd_")) if wkv else
                 (("forward", "flash_tc_fwd"), ("backward", "flash_bwd_tc_")))
        us = {part: sum(v for k, v in times.items() if re.search(pat, k))
              for part, pat in parts}
        log(f"train {cfg.name} step under torch.profiler: "
            f"{'K6' if wkv else 'K5'} " + ", ".join(
                f"{part} {t / 1e3:.1f} ms ({t / 1e6 / busy:.1%} of the "
                f"device time)" for part, t in us.items()))
    else:
        log(f"train {cfg.name} step busy share not measured: {why}")
    log(f"train {cfg.name}: {n_params} parameters, "
        f"{6 * n_params * tokens / 1e12:.1f} TFLOP (6·N·tokens) + "
        f"{attn / 1e12:.1f} TFLOP of attention a step")
    del state, r
    torch.cuda.empty_cache()
    name = "wkv6" if wkv else "flash_attention"
    return {name + "_bwd": bwd}, {name: fwd}


def train_phase(dev, seed):
    """K5's and K6's backward kernels checked and timed
    (:func:`k5_bwd_checks`, :func:`k6_bwd_checks`), then for each of
    :data:`TRAIN_ARCHS` the first micro-batch's gradients
    (:func:`train_grad_check`) and the train cell (:func:`train_cell`).
    -> (kernels rows, {row: backward launches}, {row: forward launches
    in training})."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, HostDataLoader

    rows = {"flash_attention_bwd": k5_bwd_checks(dev),
            "wkv6_bwd": k6_bwd_checks(dev)}
    bwd, fwd = {}, {}
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch)
        check(cfg.remat == "full" and cfg.param_dtype == "float32"
              and cfg.compute_dtype == "bfloat16", f"train config {cfg}")
        loader = HostDataLoader(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=TRAIN_SEQ,
                                           global_batch=TRAIN_BATCH))
        first = next(loader)
        mb = TRAIN_BATCH // TRAIN_ACCUM
        t0 = time.perf_counter()
        train_grad_check(dev, cfg, *(torch.as_tensor(first[k][:mb],
                                                     device=dev)
                                     for k in ("tokens", "labels")))
        log(f"train {cfg.name}: gradient checks "
            f"{time.perf_counter() - t0:.1f} s")
        b, f = train_cell(dev, cfg, loader)
        bwd.update(b)
        fwd.update(f)
    return rows, bwd, fwd


# -- phase 10: the dry run, held against the card ---------------------------

#: the dry run's peak against the real step's own peak (the card's
#: ``max_memory_allocated`` less what was allocated when the cell began)
DRYRUN_PEAK_RTOL = 0.10
#: the traced FLOPs against the train phase's model-FLOP count: remat
#: "full" runs each layer's forward twice (about 4/3 of 6·N·tokens)
DRYRUN_FLOP_RATIO = (1.0, 1.5)
#: the phase, from its start to its end (its processes' start included)
DRYRUN_LIMIT_S = 30.0
#: the depth at which the meta trace is held against the fake CUDA one
DRYRUN_CUT_LAYERS = 2


def _dryrun_cell(arch, kind, seq, batch, device, n_layers=None):
    """One cell traced in this process (:func:`repro_torch.launch.dryrun.
    trace_cell`, un-meshed): ``arch``'s train step (:data:`TRAIN_ACCUM`
    micro-batches) or serve prefill at ``batch`` x ``seq``, on meta tensors
    (``device="meta"``) or under ``FakeTensorMode`` on ``device``, at
    ``n_layers`` (None: the config's) -> (the cell, its seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import strategy
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.train.steps import TrainConfig

    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if device == "meta"
          else FakeTensorMode()):
        cell = dryrun.trace_cell(
            cfg, ShapeSpec(kind, seq, batch, kind),
            make_abstract_mesh((1, 1), ("data", "model")),
            strategy.rules_for(cfg), device,
            TrainConfig(accum_steps=TRAIN_ACCUM))
    return cell, time.perf_counter() - t0


def dryrun_trace(arch, kind, seq, batch):
    """One cell of the dry run on meta tensors (:func:`_dryrun_cell`) ->
    what the gates read (custom-op calls, FLOPs, bytes, peak, parameter
    and argument bytes) and the trace's seconds."""
    from repro_torch.launch import trace_analysis
    from repro_torch.models.common import param_tree
    from repro_torch.tree import leaves

    cell, secs = _dryrun_cell(arch, kind, seq, batch, "meta")
    trace = cell["trace"]
    tot = trace_analysis.analyze(trace)
    return dict(
        trace_s=secs, ops=len(trace.ops),
        calls={n: trace.calls("repro_torch." + n) for n in
               ("flash_fwd", "flash_bwd", "wkv6_fwd", "wkv6_bwd")},
        flops=tot.flops, hbm_bytes=tot.hbm_bytes,
        peak_bytes=trace.peak_bytes,
        param_bytes=sum(p.numel() * p.element_size()
                        for p in leaves(param_tree(cell["model"]))),
        argument_bytes=cell["argument_bytes"])


def dryrun_same(arch, kind, seq, batch, device):
    """The cell at :data:`DRYRUN_CUT_LAYERS` layers traced on meta tensors
    and under ``FakeTensorMode`` on ``device`` (the card's type) -> where
    the two traces first differ (their device ops one by one: name,
    operand shapes, FLOPs, bytes; then the peak and the argument bytes;
    None: nowhere), the device ops, the host ops of each, and the two
    traces' seconds."""
    meta, t_meta = _dryrun_cell(arch, kind, seq, batch, "meta",
                                DRYRUN_CUT_LAYERS)
    fake, t_fake = _dryrun_cell(arch, kind, seq, batch, device,
                                DRYRUN_CUT_LAYERS)
    m, f = meta["trace"], fake["trace"]
    # a CPU tensor's op is the host's (under remat, checkpoint copies the
    # CUDA generator's state on the host where the process holds CUDA)
    m_ops, f_ops = ([op for op in t.ops if op.device != "cpu"]
                    for t in (m, f))
    diff = None
    for i, (a, b) in enumerate(zip(m_ops, f_ops)):
        if (a.name, a.shapes, a.flops, a.bytes) != (b.name, b.shapes,
                                                    b.flops, b.bytes):
            diff = f"op {i}: {a.name} {a.shapes} against {b.name} {b.shapes}"
            break
    if diff is None and len(m_ops) != len(f_ops):
        diff = f"{len(m_ops)} ops against {len(f_ops)}"
    if diff is None and (m.peak_bytes, meta["argument_bytes"]) != (
            f.peak_bytes, fake["argument_bytes"]):
        diff = (f"peak {m.peak_bytes} against {f.peak_bytes}, arguments "
                f"{meta['argument_bytes']} against {fake['argument_bytes']}")
    return dict(diff=diff, ops=len(m_ops), meta_s=t_meta, fake_s=t_fake,
                host_ops=[len(m.ops) - len(m_ops), len(f.ops) - len(f_ops)])


#: the dry run's cells: the train cells and qwen2-1.5b's serve prefill
DRYRUN_CELLS = ([(a, "train", TRAIN_SEQ, TRAIN_BATCH) for a in TRAIN_ARCHS]
                + [("qwen2-1.5b", "prefill", SERVE_KW["prompt_len"],
                    SERVE_KW["batch"])])


def dryrun_phase(dev):
    """The dry run's traces of :data:`DRYRUN_CELLS` on meta tensors, then
    each cell cut to :data:`DRYRUN_CUT_LAYERS` layers on meta and on fake
    tensors of ``dev``'s type (gated: the same trace), all in this
    process, whose imports are warm; held against :data:`MEASURED`
    (gated where the train and models phases ran; otherwise the launches
    against the configs' counts and the rest printed); the whole phase
    within :data:`DRYRUN_LIMIT_S` -> {cell: what was traced and
    compared}."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    rows = [dryrun_trace(*c) for c in DRYRUN_CELLS]
    whole_s = time.perf_counter() - t_phase
    sames = [dryrun_same(*c, dev.type) for c in DRYRUN_CELLS]
    traces_s = time.perf_counter() - t_phase
    log(f"dryrun: the traces took {traces_s:.1f} s (the whole cells "
        f"{whole_s:.1f} s, then the cut comparisons)")
    out = {}
    for (arch, kind, seq, _batch), row, sm in zip(DRYRUN_CELLS, rows, sames):
        cfg = get_config(arch)
        calls = row["calls"]
        roof_ms = max(row["flops"] / BF16_OPS_PER_S,
                      row["hbm_bytes"] / HBM_BYTES_PER_S) * 1e3
        row.update(kind=kind, roofline_ms=roof_ms, cut_same=sm)
        key = f"{cfg.name} {kind}"
        out[key] = row
        log(f"dryrun {key} at {DRYRUN_CUT_LAYERS} layers: meta "
            f"{sm['meta_s']:.1f} s, fake {dev.type} {sm['fake_s']:.1f} s, "
            f"{sm['ops']} ops on the device (host ops {sm['host_ops'][0]} "
            f"and {sm['host_ops'][1]}), " + (
                "the same trace" if sm["diff"] is None else
                f"first difference: {sm['diff']}"))
        check(sm["diff"] is None, f"dryrun {key}: the meta trace differs "
              f"from the fake {dev.type} one at {DRYRUN_CUT_LAYERS} layers: "
              f"{sm['diff']}")
        wkv = cfg.family == "ssm"
        fwd, bwd = ("wkv6_fwd", "wkv6_bwd") if wkv else ("flash_fwd",
                                                         "flash_bwd")
        log(f"dryrun {key}: traced in {row['trace_s']:.1f} s on meta, "
            f"{row['ops']} ops; custom-op calls {calls}; parameters "
            f"{row['param_bytes']} B, arguments {row['argument_bytes']} B, "
            f"peak {row['peak_bytes'] / 1e9:.3f} GB; {row['flops']:.4e} "
            f"FLOP, {row['hbm_bytes']:.4e} B; roofline {roof_ms:.1f} ms "
            f"(max of FLOPs at 989 TFLOP/s and bytes at 3.35 TB/s)")
        if kind == "prefill":
            want = MEASURED.get(("prefill", cfg.name))
            src = "the models phase's launches"
            if want is None:
                want, src = sum(k5_calls(cfg, seq).values()), \
                    "the config's count (the models phase did not run)"
            check(calls == dict(flash_fwd=want, flash_bwd=0, wkv6_fwd=0,
                                wkv6_bwd=0),
                  f"dryrun {key}: calls {calls}, {src} {want}")
            log(f"dryrun {key}: K5 calls {calls['flash_fwd']} = {src} "
                f"{want}")
            continue
        m = MEASURED.get(("train", cfg.name))
        steps = cfg.n_layers * TRAIN_ACCUM
        want_f, want_b = (m["fwd"], m["bwd"]) if m else (2 * steps, steps)
        other = ("flash_fwd", "flash_bwd") if wkv else ("wkv6_fwd",
                                                        "wkv6_bwd")
        check(calls[fwd] == want_f and calls[bwd] == want_b
              and not any(calls[n] for n in other),
              f"dryrun {key}: calls {calls}, the card launched forward "
              f"{want_f} and backward {want_b} a step")
        if m is None:
            log(f"dryrun {key}: parameters, peak and FLOPs not gated (the "
                f"train phase did not run)")
            continue
        ratio = row["peak_bytes"] / m["peak_bytes"]
        flop_ratio = row["flops"] / m["model_flops"]
        row.update(measured_peak_bytes=m["peak_bytes"], peak_ratio=ratio,
                   held_before_bytes=m["held_bytes"],
                   model_flops=m["model_flops"], flop_ratio=flop_ratio,
                   measured_ms=m["step_ms"])
        log(f"dryrun {key}: calls forward {calls[fwd]} / backward "
            f"{calls[bwd]} = the card's {want_f} / {want_b} a step; "
            f"parameters {row['param_bytes']} B (card {m['param_bytes']} "
            f"B); peak {row['peak_bytes'] / 1e9:.3f} GB predicted, "
            f"{m['peak_bytes'] / 1e9:.3f} GB the cell's own on the card "
            f"({m['held_bytes'] / 1e9:.3f} GB held before it; ratio "
            f"{ratio:.4f}); FLOPs {row['flops']:.4e} traced, "
            f"{m['model_flops']:.4e} model (ratio {flop_ratio:.4f}); "
            f"roofline {roof_ms:.1f} ms, measured "
            + ", ".join(f"{t:.1f}" for t in m["step_ms"]) + " ms a step")
        check(row["param_bytes"] == m["param_bytes"],
              f"dryrun {key}: parameter bytes {row['param_bytes']} != the "
              f"card's {m['param_bytes']}")
        check(abs(ratio - 1) <= DRYRUN_PEAK_RTOL,
              f"dryrun {key}: peak {row['peak_bytes']} against the card's "
              f"{m['peak_bytes']} (ratio {ratio:.4f})")
        check(DRYRUN_FLOP_RATIO[0] <= flop_ratio <= DRYRUN_FLOP_RATIO[1],
              f"dryrun {key}: traced FLOPs {row['flops']:.4e} are "
              f"{flop_ratio:.4f}x the model count {m['model_flops']:.4e}")
    elapsed = time.perf_counter() - t_phase
    log(f"dryrun phase: {elapsed:.1f} s (limit {DRYRUN_LIMIT_S:.0f} s)")
    log(json.dumps({"dryrun": dict(cells=out, seconds=elapsed,
                                   traces_s=traces_s)}))
    check(elapsed <= DRYRUN_LIMIT_S,
          f"dryrun phase took {elapsed:.1f} s (limit {DRYRUN_LIMIT_S:.0f} s)")
    return out


# -- phase 11: the distributed layer through the rules ----------------------

#: the meshed train steps of each model (each against as many un-meshed
#: ones built from the same seed), and rwkv6-3b's cut for this phase
DIST_QWEN_STEPS, DIST_RWKV_STEPS, DIST_RWKV_LAYERS = 2, 1, 4
#: rwkv6-3b's and granite-moe-3b-a800m's batch here: 2 sequences of 4096
#: in one micro-batch
DIST_RWKV_BATCH = 2
#: granite-moe-3b-a800m's cut (4 of its 32 layers) and deepseek-v2-236b's
#: (2 of its 60, bf16 parameters: about 18 GB)
DIST_GRANITE_LAYERS, DIST_DEEPSEEK_LAYERS = 4, 2
#: the phase, from its start to its end: 34 s for qwen2-1.5b, rwkv6-3b and
#: the splits, and 90 s for the MoE families
DIST_LIMIT_S = 124.0


def dist_counts():
    """-> (K5 forward, K5 backward, K6 forward, K6 backward) launches."""
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.rwkv6 import ops as k6
    return (k5.flash_attention.launches, k5.flash_attention.bwd_launches,
            k6.wkv6.launches, k6.wkv6.bwd_launches)


def dist_reset():
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.rwkv6 import ops as k6
    k5.flash_attention.launches = k5.flash_attention.bwd_launches = 0
    k6.wkv6.launches = k6.wkv6.bwd_launches = 0


def host_copy(t):
    """A parameter or loss (a DTensor's whole) on the host, bits kept."""
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().to("cpu", copy=True)


def dist_train(dev, cfg, batch, steps, accum, mesh=None, rules=None,
               seed=0, tree=None, grads=False, opt=None):
    """``steps`` train steps of ``cfg`` on the host batch ``batch`` in
    ``accum`` micro-batches, by AdamW ``opt`` (by default lr 3e-3 with no
    warm-up: every step moves the weights), from the reference's parameter
    tree ``tree`` (numpy arrays) or, without one, from weights drawn from
    seed ``seed`` on ``dev``: un-meshed (``mesh`` None) or through the rules
    (``distribute`` of the model, ``device_put_batch`` of the batch, under
    ``use_mesh_rules``).  The one harness of a meshed against an un-meshed
    run, on the card here and on gloo ranks of the CPU in
    ``tests/_torch_multirank_run.py``.  -> {"losses", "params" (on the
    host), "grads" (the first step's gradients, whole and on the host, with
    ``grads``; else None), "grad_norms" (each step's, before the clip),
    "dropped" (the dropped (token, slot) pairs of each MoE layer's forward
    on a micro-batch, in call order: remat's recomputation stops at the
    layer's last saved tensor, before the call returns), "ms" a step,
    "counts" (the kernels' launches over the steps), "state"}."""
    import torch

    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.distributed.sharding import use_mesh_rules
    from repro_torch.models.common import (get_family, init_model,
                                           load_reference_params)
    from repro_torch.nn import layers
    from repro_torch.nn.param import distribute
    from repro_torch.optim import adamw
    from repro_torch.train.steps import (TrainConfig, init_state,
                                         make_train_step)
    from repro_torch.tree import leaves

    fam = get_family(cfg)
    opt = opt or adamw.AdamWConfig(lr=3e-3, warmup_steps=0,
                                   total_steps=steps)
    step = make_train_step(cfg, TrainConfig(accum_steps=accum, opt=opt))
    ctx = (use_mesh_rules(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    first, routed = [], []
    update, moe = adamw.update, layers.moe_apply

    def recording(ocfg, params, g, *a):     # the step's averaged gradients
        if grads and not first:
            first.extend(host_copy(t) for t in leaves(g))
        return update(ocfg, params, g, *a)

    def routing(*a, **kw):                  # each MoE call's drops
        kw["routing"] = got = []
        out = moe(*a, **kw)
        routed.append(got[0].dropped)
        return out

    with ctx:
        model = (init_model(fam, cfg, torch.Generator(dev).manual_seed(seed))
                 if tree is None else load_reference_params(fam.build(cfg),
                                                            tree))
        if mesh is not None:
            model = distribute(model, mesh, rules)
            b = device_put_batch(batch, mesh, rules)
        else:
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        state = init_state(cfg, model)
        losses, norms, ms, dropped = [], [], [], []
        dist_reset()
        adamw.update, layers.moe_apply = recording, routing
        try:
            for _ in range(steps):
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = step(state, b)
                losses.append(host_copy(metrics["loss"]))
                norms.append(host_copy(metrics["grad_norm"]))
                ms.append((time.perf_counter() - t0) * 1e3)
                dropped.extend(int(host_copy(d)) for d in routed)
                routed.clear()
        finally:
            adamw.update, layers.moe_apply = update, moe
        counts = dist_counts()
    return {"losses": losses, "grad_norms": norms,
            "params": [host_copy(p) for p in leaves(state["params"])],
            "grads": first or None, "dropped": dropped, "ms": ms,
            "counts": counts, "state": state}


def dist_decode(dev, cfg, model, shape, cache, tokens, pos, mesh=None,
                rules=None, with_cache=False):
    """One eager decode step of ``model`` at ``pos`` on a copy of
    ``cache``, un-meshed or with the cache and tokens placed by
    ``decode_specs`` (the cache keeps its own dtype) -> the logits on the
    host; with ``with_cache``, (the logits, the copy after the step, its
    entries DTensors on a mesh)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import placements, use_mesh_rules
    from repro_torch.launch.inputs import decode_specs
    from repro_torch.models.common import get_family

    fam = get_family(cfg)
    cache = {k: v.clone() for k, v in cache.items()}
    with torch.no_grad():
        if mesh is None:
            logits, _ = fam.decode_step(model, cfg, cache, tokens, pos)
            return (host_copy(logits), cache) if with_cache else \
                host_copy(logits)
        with use_mesh_rules(mesh, rules):
            specs = decode_specs(cfg, shape, mesh, rules)
            for k, v in specs["cache"].items():
                check(tuple(v.shape) == tuple(cache[k].shape),
                      f"dist: cache_specs {k} {v} against {cache[k].shape}")
            put = lambda t, spec: distribute_tensor(          # noqa: E731
                t, mesh, placements(spec, mesh), src_data_rank=None)
            cache = {k: put(v, specs["cache"][k].spec)
                     for k, v in cache.items()}
            logits, _ = fam.decode_step(model, cfg, cache,
                                        put(tokens, specs["tokens"].spec),
                                        pos)
            return (host_copy(logits), cache) if with_cache else \
                host_copy(logits)


def dist_prefill(dev, cfg, prompts, tokens, shape, mesh=None, rules=None,
                 seed=0):
    """A model of ``cfg`` drawn from seed ``seed`` on ``dev``, un-meshed
    (``mesh`` None) or placed by ``distribute`` with the prompts placed by
    ``launch.inputs.prefill_specs``: its prefill of ``prompts`` (B, S),
    then one eager decode step of ``tokens`` at position S on a cache of
    ``shape.seq_len`` positions that holds the prefill's rows
    (:func:`dist_decode`).  -> {"logits" (the prefill's), "cache" (its
    entries whole), "decode" (the step's logits), all on the host; "ms"
    (prefill, decode); "counts" (the kernels' launches in the prefill)}."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import placements, use_mesh_rules
    from repro_torch.launch.inputs import prefill_specs
    from repro_torch.models.common import get_family, init_model
    from repro_torch.nn.param import distribute

    fam = get_family(cfg)
    B, S = prompts.shape
    ctx = (use_mesh_rules(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    with ctx, torch.no_grad():
        model = init_model(fam, cfg, torch.Generator(dev).manual_seed(seed))
        toks = prompts
        if mesh is not None:
            model = distribute(model, mesh, rules)
            spec = prefill_specs(cfg, ShapeSpec("prefill", S, B, "prefill"),
                                 mesh, rules)["tokens"].spec
            toks = distribute_tensor(prompts, mesh, placements(spec, mesh),
                                     src_data_rank=None)
        dist_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fam.prefill(model, cfg, toks)
        logits = host_copy(logits)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        counts = dist_counts()
        cache = {k: host_copy(v) for k, v in cache.items()}
    full = {}
    for k, v in cache.items():          # the prefill's rows, then zeros
        full[k] = torch.zeros((*v.shape[:2], shape.seq_len, *v.shape[3:]),
                              dtype=v.dtype, device=dev)
        full[k][:, :, :S] = v.to(dev)
    t0 = time.perf_counter()
    decode = dist_decode(dev, cfg, model, shape, full, tokens, S, mesh, rules)
    decode_ms = (time.perf_counter() - t0) * 1e3
    return {"logits": logits, "cache": cache, "decode": decode,
            "ms": (prefill_ms, decode_ms), "counts": counts}


#: the head blocks the kernels' boundary is held to on one card: qwen2-1.5b's
#: 12 q heads to 2 KV heads in 2, 4, 6 and 12 blocks (6, 3, 2 or 1 q heads
#: a block: a whole group, or part of one), rwkv6-3b's 40 heads in 2, 4, 8
DIST_K5_SPLITS, DIST_K6_SPLITS = (2, 4, 6, 12), (2, 4, 8)


def dist_split_checks(dev, seed):
    """The kernels' boundary split by head on one card: what n ranks on the
    "model" axis would each hand K5 and K6 (``layers._by_heads``,
    ``ssm._wkv6``), run block by block.  K5 at the dist phase's micro-batch,
    q (2, 4096, 12, 128) against k/v (2, 4096, 2, 128) bf16 causal: each q
    head block (a contiguous copy, as a rank's shard is) with the strided
    k/v head slice ``layers._kv_block`` gives it, forward and backward; the
    joined output and dq the full call's bits (a q head's rows are the same
    kernel's on the same values either way), dk/dv summed over the blocks
    in bf16 (the all-reduce of their partial sums) within
    ``ops.bwd_tolerance`` of the full call's.  K6 at (2, 4096, 40, 64) f32
    with a starting state and the final state's gradient:
    r/k/v/log-decay, ``u`` and the state by head block, forward and
    backward, joined: the full call's bits (its heads are independent).
    Each split's distances are printed."""
    import torch

    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.rwkv6 import ops as k6
    from repro_torch.nn.layers import _kv_block

    g = torch.Generator(dev).manual_seed(seed + 3)
    bf = torch.bfloat16
    B, S, H, Hk, D = TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ, 12, 2, 128
    q, dout = (torch.randn((B, S, H, D), generator=g, device=dev).to(bf)
               for _ in range(2))
    k, v = (torch.randn((B, S, Hk, D), generator=g, device=dev).to(bf)
            for _ in range(2))

    def k5_call(heads, a=0, b=Hk):
        qq = q[:, :, heads].clone().requires_grad_()
        kk, vv = (t.clone().requires_grad_() for t in (k, v))
        out = k5.flash_attention(qq, kk[:, :, a:b], vv[:, :, a:b],
                                 causal=True)
        out.backward(dout[:, :, heads])
        return out.detach(), qq.grad, kk.grad, vv.grad

    def bits(got, want):
        return all(torch.equal(x, y) for x, y in zip(got, want))

    want = k5_call(slice(None))
    btol = k5.bwd_tolerance(k5.bwd_variant(bf, D, D), bf)
    for n in DIST_K5_SPLITS:
        hl, parts = H // n, []
        for i in range(n):
            a, b = _kv_block(H, Hk, i, n)
            parts.append(((a, b), k5_call(slice(i * hl, (i + 1) * hl), a, b)))
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        for _, p in parts:          # bf16 sums, as the all-reduce takes them
            dk += p[2]
            dv += p[3]
        got = (torch.cat([p[0] for _, p in parts], 2),
               torch.cat([p[1] for _, p in parts], 2), dk, dv)
        same = bits(got[:2], want[:2])
        rels = [_rel_l2(x, y) for x, y in zip(got[2:], want[2:])]
        log(f"dist split K5, {n} blocks of {hl} q heads (KV heads "
            f"{sorted({ab for ab, _ in parts})}): output and dq the full "
            f"call's bits {same}; dk/dv relative L2 "
            + "/".join(f"{r:.3e}" for r in rels) + f" (gate {btol:.3e}), "
            f"their bits {bits(got[2:], want[2:])}")
        check(same and all(r <= btol for r in rels),
              f"dist split K5 into {n} blocks differs from the full call")
    del q, k, v, dout, want, got, parts

    B, H, D = DIST_RWKV_BATCH, 40, 64
    r, kk, vv, dy = (torch.randn((B, S, H, D), generator=g, device=dev) * 0.5
                     for _ in range(4))
    lw = -torch.exp(torch.randn((B, S, H, D), generator=g, device=dev) * 0.5)
    u = torch.randn((H, D), generator=g, device=dev) * 0.5
    s0, ds = (torch.randn((B, H, D, D), generator=g, device=dev) * 0.1
              for _ in range(2))

    def k6_call(h):
        ins = [t[:, :, h].clone().requires_grad_() for t in (r, kk, vv, lw)]
        ins += [u[h].clone().requires_grad_(),
                s0[:, h].clone().requires_grad_()]
        y, s_end = k6.wkv6(*ins[:5], state0=ins[5])
        torch.autograd.backward((y, s_end), (dy[:, :, h], ds[:, h]))
        return [y.detach(), s_end.detach()] + [t.grad for t in ins]

    want = k6_call(slice(None))
    names = ("y", "state", "dr", "dk", "dv", "dlogw", "du", "dstate0")
    dims = (2, 1, 2, 2, 2, 2, 0, 1)
    for n in DIST_K6_SPLITS:
        hl = H // n
        parts = [k6_call(slice(i * hl, (i + 1) * hl)) for i in range(n)]
        got = [torch.cat([p[j] for p in parts], d) for j, d in enumerate(dims)]
        same = {m: bool(torch.equal(x, y))
                for m, x, y in zip(names, got, want)}
        log(f"dist split K6, {n} blocks of {hl} heads: the full call's bits "
            + ", ".join(f"{m} {e}" for m, e in same.items()))
        check(all(same.values()),
              f"dist split K6 into {n} blocks differs from the full call")


#: flash-decode's position splits held on one card: (label, q's shape,
#: the cache's (B, T, K, D), window, is_global, block counts).  qwen2-1.5b's
#: serve decode, and gemma3-12b's long_500k global and local layers
DIST_DECODE_SPLITS = (
    ("qwen2-1.5b", (4, 1, 12, 128), (4, 32768, 2, 128), 0, True,
     (2, 4, 8, 16)),
    ("gemma3-12b global", (1, 1, 16, 256), (1, 524288, 8, 256), 1024, True,
     (16, 256)),
    ("gemma3-12b local", (1, 1, 16, 256), (1, 524288, 8, 256), 1024, False,
     (16, 256)))
#: deepseek-v2-236b's MLA decode: 128 heads, the compressed cache (B, T,
#: kv_lora 512) and (B, T, rope 64), q/k heads 128 + 64 wide, in 16 blocks
DIST_MLA_SPLIT = (4, 32768, 128, 512, 64, 128, 16)
#: the split against the whole positions, relative L2: f32 (the sums'
#: order), bf16 two units of bf16 roundoff (u = 2**-8): each path rounds
#: the output once, and a weight rounds apart only where its f32 value
#: lies within the denominator's reordering of a rounding boundary
DECODE_SPLIT_F32, DECODE_SPLIT_BF16 = 1e-5, 2 * 2.0 ** -8


def dist_decode_splits(dev, seed):
    """Flash-decode's local step and combine at full width on the card:
    the cache's positions cut into n blocks as n ranks of a mesh hold them,
    side by side (``layers.fold_blocks``), each block's step the function
    the mesh calls (``layers.gqa_decode_block``, ``mla_decode_block``) and
    the all-reduces a max or sum over the blocks (``layers.block_reduce``).
    Each split, at a position on a block boundary (T / 2), is held to the
    whole-positions path on plain tensors (``layers._decode_attention``,
    ``layers._mla_attention``), in f32 and in bf16, its distance printed;
    the same split with the partials of the block that holds position
    T / 2 - 1 dropped from the sums must fail the gate.  The whole path's
    bf16 products accumulate in f32 throughout, as the reference's dot
    does (cuBLAS's reduced-precision split-K reduction is off for the
    check)."""
    import torch

    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        _decode_splits(dev, seed)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def _decode_splits(dev, seed):
    import types

    import torch

    from repro_torch.nn import layers as L

    g = torch.Generator(dev).manual_seed(seed + 4)

    def dropping(n, block):             # the planted fault
        def reduce(x, op):
            xs = x.unflatten(0, (n, -1))
            keep = torch.arange(n, device=x.device) != block
            r = xs.amax(0) if op == "max" else xs[keep].sum(0)
            return r.repeat(n, *(1,) * (r.dim() - 1))
        return reduce

    def held(label, T, n, want, split, gate):
        rel = _rel_l2(split(L.block_reduce(n)), want)
        bad = _rel_l2(split(dropping(n, (T // 2 - 1) // (T // n))), want)
        log(f"dist decode split {label}, {n} blocks of {T // n}: relative "
            f"L2 {rel:.3e} (gate {gate:.3e}); a block dropped {bad:.3e}")
        check(rel <= gate, f"dist decode split {label} into {n} blocks "
              f"differs from the whole positions: {rel:.3e}")
        check(bad > gate, f"dist decode split {label}: a dropped block "
              f"passes the gate ({bad:.3e})")

    for label, qs, cs, window, is_global, splits in DIST_DECODE_SPLITS:
        B, T = cs[:2]
        pos = torch.full((1,), T // 2, dtype=torch.int64, device=dev)
        q = torch.randn(qs, generator=g, device=dev)
        k, v = (torch.randn(cs, generator=g, device=dev) for _ in range(2))
        mask = L.causal_window_mask(
            pos.view(1, 1), torch.arange(T, dtype=torch.int32, device=dev)[
                None], window, is_global)[:, None, None].expand(
                    B, 1, 1, 1, T)
        cfg = types.SimpleNamespace(window=window)
        for dt, gate in ((torch.float32, DECODE_SPLIT_F32),
                         (torch.bfloat16, DECODE_SPLIT_BF16)):
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            want = L._decode_attention(cfg, qd, kd, vd, pos, is_global)
            for n in splits:
                kf, vf = L.fold_blocks(kd, n), L.fold_blocks(vd, n)
                mf, qf = L.fold_blocks(mask, n, 4), qd.repeat(n, 1, 1, 1)
                held(f"{label} {str(dt)[6:]}", T, n, want,
                     lambda red: L.gqa_decode_block(qf, kf, vf, mf, red)[:B],
                     gate)
                del kf, vf
            del qd, kd, vd, want
        del q, k, v, mask
        torch.cuda.empty_cache()

    B, T, H, kr, dr, dn, n = DIST_MLA_SPLIT
    pos = torch.full((1,), T // 2, dtype=torch.int64, device=dev)
    scale = 1.0 / math.sqrt(dn + dr)
    ins = [torch.randn(s, generator=g, device=dev) for s in (
        (B, 1, H, kr), (B, 1, H, dr), (B, T, kr), (B, T, dr))]
    mask = (torch.arange(T, device=dev) <= pos).expand(B, T)
    for dt, gate in ((torch.float32, DECODE_SPLIT_F32),
                     (torch.bfloat16, DECODE_SPLIT_BF16)):
        qa, qr, ckv, krope = (t.to(dt) for t in ins)
        want = L._mla_attention(qa, qr, ckv, krope, pos, scale)
        qaf, qrf = qa.repeat(n, 1, 1, 1), qr.repeat(n, 1, 1, 1)
        cf, rf = L.fold_blocks(ckv, n), L.fold_blocks(krope, n)
        mf = L.fold_blocks(mask, n)[:, None, None, :]
        held(f"deepseek-v2-236b MLA {str(dt)[6:]}", T, n, want,
             lambda red: L.mla_decode_block(qaf, qrf, cf, rf, mf, scale,
                                            red)[:B], gate)


def dist_same(label, got, want):
    """Bit-for-bit equality of two lists of host tensors; a difference is
    named."""
    import torch
    check(len(got) == len(want), f"dist {label}: {len(got)} against "
          f"{len(want)} tensors")
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if a.shape != b.shape or not torch.equal(a, b)]
    check(not bad, f"dist {label}: {len(bad)} of {len(want)} tensors differ, "
          f"the first at leaf {bad[:1]} (max abs "
          f"{[float((got[i].float() - want[i].float()).abs().max()) for i in bad[:1]]})")


def dist_granite(dev, mesh, seed, card):
    """granite-moe-3b-a800m at full width (d 1536, 40 experts top-8, expert
    d_ff 512, GQA 24/8 of 64) cut to :data:`DIST_GRANITE_LAYERS` layers,
    under its own rules (experts replicated, tensor parallelism inside
    them; the batch-local grids): one train step of 2 x 4096 at the
    published capacity factor 1.25, meshed and as one un-meshed step from
    the same seed, built one after the other; the loss, every parameter and
    each MoE call's dropped pairs bit for bit, K5's forward and backward
    through the kernel boundary.  Then one dropless decode step at the
    serve shape (batch 4) on a seeded cache of 2048 + 32 positions, its
    logits bit for bit.  -> K5's (forward, backward) launches over the
    meshed step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, HostDataLoader
    from repro_torch.distributed import strategy
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              n_layers=DIST_GRANITE_LAYERS)
    rules = strategy.rules_for(cfg)
    batch = next(HostDataLoader(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=DIST_RWKV_BATCH, seed=seed)))
    B, prompt, gen = SERVE_KW["batch"], SERVE_KW["prompt_len"], \
        SERVE_KW["gen"]
    shape = ShapeSpec("serve", prompt + gen, B, "decode")
    g = torch.Generator(dev).manual_seed(seed + 4)
    cache = {k: torch.randn(v.shape, generator=g, device=dev).to(v.dtype)
             for k, v in lm.init_cache(cfg, B, prompt + gen,
                                       device=dev).items()}
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                           device=dev, dtype=torch.int32)
    runs, launches = {}, None
    for label, m in (("un-meshed", None), ("meshed", mesh)):
        r = m and rules
        run = dist_train(dev, cfg, batch, 1, 1, m, r, seed)
        counts = run["counts"]
        t0 = time.perf_counter()
        logits = dist_decode(dev, cfg, run["state"]["model"], shape, cache,
                             tokens, prompt, m, r)
        decode_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        runs[label] = (run["losses"], run["params"], run["dropped"], logits)
        log(f"dist granite-moe-3b-a800m ({DIST_GRANITE_LAYERS} of 32 layers) "
            f"{label}: 1 step of {DIST_RWKV_BATCH} x {TRAIN_SEQ}, ms a step "
            f"{[round(t, 1) for t in run['ms']]}, loss "
            f"{[float(l) for l in run['losses']]}, dropped pairs by MoE call "
            f"{run['dropped']}, K5 launches forward {counts[0]} backward "
            f"{counts[1]}; the decode step {decode_ms:.1f} ms; peak memory "
            f"{peak:.3f} GB ({card})")
        if m is not None:
            want = DIST_GRANITE_LAYERS
            check(counts[0] == 2 * want and counts[1] == want,
                  f"dist granite-moe-3b-a800m: K5 launches {counts[:2]}, "
                  f"expected ({2 * want}, {want}) through the boundary")
            launches = counts[:2]
        del run
        gc.collect()
        torch.cuda.empty_cache()
    (la, pa, da, xa), (lb, pb, db, xb) = runs["un-meshed"], runs["meshed"]
    dist_same("granite-moe-3b-a800m loss", lb, la)
    dist_same("granite-moe-3b-a800m parameters", pb, pa)
    dist_same("granite-moe-3b-a800m decode logits", [xb], [xa])
    check(db == da and sum(da) > 0, f"dist granite-moe-3b-a800m: dropped "
          f"pairs {db} meshed against {da}")
    check(bool(torch.isfinite(xa).all()), "dist granite: logits finite")
    log(f"dist granite-moe-3b-a800m: meshed = un-meshed bit for bit: "
        f"{len(la)} loss, {len(pa)} parameters, the dropped pairs of "
        f"{len(da)} MoE calls, decode logits {tuple(xa.shape)} at position "
        f"{prompt}")
    return launches


def dist_deepseek(dev, mesh, seed, card):
    """deepseek-v2-236b at full width (MLA, 160 experts top-6 + 2 shared,
    the global grid) cut to :data:`DIST_DEEPSEEK_LAYERS` layers in bf16,
    under its own rules (experts over "model", the grid's capacity
    replicated): a prefill of 4 x 2048 and one decode step
    (:func:`dist_prefill`), meshed and un-meshed from the same seed, built
    one after the other; the prefill's logits, its compressed caches (ckv,
    krope) and the decode's logits bit for bit, K5's (192, 128) instance
    through the kernel boundary, once a layer.  A train step at this width
    does not fit the card (16 bytes a parameter, 3.97 G a layer).  -> K5's
    launches over the meshed prefill."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import strategy

    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              n_layers=DIST_DEEPSEEK_LAYERS,
                              param_dtype="bfloat16")
    rules = strategy.rules_for(cfg)
    B, prompt, gen = SERVE_KW["batch"], SERVE_KW["prompt_len"], \
        SERVE_KW["gen"]
    shape = ShapeSpec("serve", prompt + gen, B, "decode")
    g = torch.Generator(dev).manual_seed(seed + 5)
    prompts = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g,
                            device=dev, dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                           device=dev, dtype=torch.int32)
    runs, launches = {}, None
    for label, m in (("un-meshed", None), ("meshed", mesh)):
        torch.cuda.reset_peak_memory_stats(dev)
        run = dist_prefill(dev, cfg, prompts, tokens, shape, m, m and rules,
                           seed)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        counts = run["counts"]
        runs[label] = run
        log(f"dist deepseek-v2-236b ({DIST_DEEPSEEK_LAYERS} of 60 layers, "
            f"bf16) {label}: prefill of {B} x {prompt} "
            f"{run['ms'][0]:.1f} ms, the decode step {run['ms'][1]:.1f} ms, "
            f"K5 launches {counts[0]}; peak memory {peak:.3f} GB ({card})")
        if m is not None:
            check(counts[0] == DIST_DEEPSEEK_LAYERS,
                  f"dist deepseek-v2-236b: K5 launches {counts[0]}, expected "
                  f"{DIST_DEEPSEEK_LAYERS} through the boundary")
            launches = counts[0]
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs["un-meshed"], runs["meshed"]
    dist_same("deepseek-v2-236b prefill logits", [b["logits"]], [a["logits"]])
    dist_same("deepseek-v2-236b caches", [b["cache"][k] for k in a["cache"]],
              list(a["cache"].values()))
    dist_same("deepseek-v2-236b decode logits", [b["decode"]], [a["decode"]])
    check(all(bool(torch.isfinite(t).all()) for t in
              (a["logits"], a["decode"])), "dist deepseek: logits finite")
    log(f"dist deepseek-v2-236b: meshed = un-meshed bit for bit: prefill "
        f"logits {tuple(a['logits'].shape)}, caches "
        f"{ {k: tuple(v.shape) for k, v in a['cache'].items()} }, decode "
        f"logits {tuple(a['decode'].shape)} at position {prompt}")
    return launches


def dist_phase(dev, seed):
    """The distributed layer on one NCCL rank (``world_size`` 1 on a
    ``HashStore``): ``launch.mesh.make_smoke_mesh`` on the card and
    ``use_mesh_rules`` with ``strategy.rules_for(cfg)``.  qwen2-1.5b at
    full width and depth, the train cell's shape (8 x 4096 in 4
    micro-batches of 2): :data:`DIST_QWEN_STEPS` steps meshed
    (``nn.param.distribute``, ``data.pipeline.device_put_batch``) and as
    many un-meshed from the same seed, built one after the other; the
    losses and every parameter bit for bit, K5's forward and backward
    launched through the kernel boundary.  rwkv6-3b at full width cut to
    :data:`DIST_RWKV_LAYERS` layers, one step of 2 x 4096, the same way,
    K6's forward and backward through the boundary.  One eager qwen2-1.5b
    decode step at the serve shape (batch 4) on a seeded cache placed by
    ``launch.inputs.cache_specs``: the logits bit for bit.  The MoE
    families (:func:`dist_granite`, :func:`dist_deepseek`).  The kernels'
    head split (:func:`dist_split_checks`) and flash-decode's position
    split (:func:`dist_decode_splits`).
    ``optim.compress.compressed_psum_along`` on the NCCL group equal to the
    local decode.  The process group is destroyed on the way out; the
    phase's seconds are gated at :data:`DIST_LIMIT_S`.  -> the K5,
    K5-backward, K6 and K6-backward launches over the meshed steps and
    prefill."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, HostDataLoader
    from repro_torch.distributed import strategy
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import compress

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_smoke_mesh("cuda")
        out = {}
        card = nvidia_smi()

        # qwen2-1.5b: train, then one decode step on the trained weights
        cfg = get_config("qwen2-1.5b")
        rules = strategy.rules_for(cfg)
        batch = next(HostDataLoader(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_BATCH, seed=seed)))
        B, prompt, gen = SERVE_KW["batch"], SERVE_KW["prompt_len"], \
            SERVE_KW["gen"]
        shape = ShapeSpec("serve", prompt + gen, B, "decode")
        from repro_torch.models import lm
        g = torch.Generator(dev).manual_seed(seed + 1)
        cache = {k: torch.randn(v.shape, generator=g, device=dev).to(v.dtype)
                 for k, v in lm.init_cache(cfg, B, prompt + gen,
                                           device=dev).items()}
        tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                               device=dev, dtype=torch.int32)
        runs = {}
        for label, m in (("un-meshed", None), ("meshed", mesh)):
            r = m and rules
            run = dist_train(dev, cfg, batch, DIST_QWEN_STEPS, TRAIN_ACCUM,
                             m, r, seed)
            losses, params, ms, counts = (run["losses"], run["params"],
                                          run["ms"], run["counts"])
            logits = dist_decode(dev, cfg, run["state"]["model"], shape,
                                 cache, tokens, prompt, m, r)
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            runs[label] = (losses, params, logits)
            log(f"dist qwen2-1.5b {label}: {DIST_QWEN_STEPS} steps of "
                f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_ACCUM} micro-batches, "
                f"ms a step {[round(t, 1) for t in ms]}, losses "
                f"{[float(l) for l in losses]}, K5 launches forward "
                f"{counts[0]} backward {counts[1]}, K6 {counts[2:]}; peak "
                f"memory {peak:.3f} GB ({card})")
            if m is not None:
                want = cfg.n_layers * TRAIN_ACCUM * DIST_QWEN_STEPS
                check(counts[0] == 2 * want and counts[1] == want,
                      f"dist qwen2-1.5b: K5 launches {counts[:2]}, expected "
                      f"({2 * want}, {want}) through the boundary")
                out["flash_attention"], out["flash_attention_bwd"] = \
                    counts[:2]
            del run, params, losses
            gc.collect()
            torch.cuda.empty_cache()
        (la, pa, xa), (lb, pb, xb) = runs["un-meshed"], runs["meshed"]
        dist_same("qwen2-1.5b losses", lb, la)
        dist_same("qwen2-1.5b parameters", pb, pa)
        dist_same("qwen2-1.5b decode logits", [xb], [xa])
        check(bool(torch.isfinite(xa).all()), "dist: decode logits finite")
        log(f"dist qwen2-1.5b: meshed = un-meshed bit for bit: "
            f"{len(la)} losses, {len(pa)} parameters, decode logits "
            f"{tuple(xa.shape)} at position {prompt} (cache {shape})")
        del runs, pa, pb, cache
        gc.collect()
        torch.cuda.empty_cache()

        # rwkv6-3b cut to DIST_RWKV_LAYERS layers: one step
        cfg = dataclasses.replace(get_config("rwkv6-3b"),
                                  n_layers=DIST_RWKV_LAYERS)
        rules = strategy.rules_for(cfg)
        batch = next(HostDataLoader(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
            global_batch=DIST_RWKV_BATCH, seed=seed)))
        runs = {}
        for label, m in (("un-meshed", None), ("meshed", mesh)):
            r = m and rules
            run = dist_train(dev, cfg, batch, DIST_RWKV_STEPS, 1, m, r, seed)
            losses, params, ms, counts = (run["losses"], run["params"],
                                          run["ms"], run["counts"])
            runs[label] = (losses, params)
            log(f"dist rwkv6-3b ({DIST_RWKV_LAYERS} of 32 layers) {label}: "
                f"{DIST_RWKV_STEPS} step of {DIST_RWKV_BATCH} x {TRAIN_SEQ}, "
                f"ms a step {[round(t, 1) for t in ms]}, losses "
                f"{[float(l) for l in losses]}, K6 launches forward "
                f"{counts[2]} backward {counts[3]}, K5 {counts[:2]} ({card})")
            if m is not None:
                want = DIST_RWKV_LAYERS * DIST_RWKV_STEPS
                check(counts[2] == 2 * want and counts[3] == want,
                      f"dist rwkv6-3b: K6 launches {counts[2:]}, expected "
                      f"({2 * want}, {want}) through the boundary")
                out["wkv6"], out["wkv6_bwd"] = counts[2:]
            del run, params, losses
            gc.collect()
            torch.cuda.empty_cache()
        (la, pa), (lb, pb) = runs["un-meshed"], runs["meshed"]
        dist_same("rwkv6-3b losses", lb, la)
        dist_same("rwkv6-3b parameters", pb, pa)
        log(f"dist rwkv6-3b: meshed = un-meshed bit for bit: {len(la)} "
            f"loss, {len(pa)} parameters")
        del runs, pa, pb
        gc.collect()
        torch.cuda.empty_cache()

        # the MoE families: granite's batch-local grids, deepseek's global
        fwd, bwd = dist_granite(dev, mesh, seed, card)
        fwd += dist_deepseek(dev, mesh, seed, card)
        out["flash_attention"] += fwd
        out["flash_attention_bwd"] += bwd

        dist_split_checks(dev, seed)
        dist_decode_splits(dev, seed)

        # the compressed all-reduce on the NCCL group
        g = torch.Generator(dev).manual_seed(seed + 2)
        grads = {"a": torch.randn((4096, 1536), generator=g, device=dev),
                 "b": [torch.randn((8960,), generator=g, device=dev)]}
        codes, scales, _ = compress.compress_with_feedback(
            grads, compress.init_error_feedback(grads))
        summed = compress.compressed_psum_along(codes, scales, mesh, "data")
        from repro_torch.tree import leaves
        dist_same("compressed_psum_along", [host_copy(t)
                                            for t in leaves(summed)],
                  [host_copy(t) for t in leaves(compress.decompress(
                      codes, scales))])
        log("dist: compressed_psum_along over the NCCL group = the local "
            "decode, bit for bit")
    finally:
        dist.destroy_process_group()
    elapsed = time.perf_counter() - t_phase
    log(f"dist phase: {elapsed:.1f} s (limit {DIST_LIMIT_S:.0f} s)")
    check(elapsed <= DIST_LIMIT_S, f"dist phase took {elapsed:.1f} s "
          f"(limit {DIST_LIMIT_S:.0f} s)")
    return out


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
def loop_calls():
    """-> a list that receives ``(args, kwargs, outputs)`` of every
    ``engine_torch.epoch_loop`` run inside the block."""
    from unittest import mock

    from repro_torch.core import engine_torch

    calls, loop = [], engine_torch.epoch_loop

    def spy(*a, **k):
        out = loop(*a, **k)
        calls.append((a, k, out))
        return out

    with mock.patch.object(engine_torch, "epoch_loop", spy):
        yield calls


def grant_counts(calls):
    return [int(out[2]) for _a, _k, out in calls]


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
        with loop_calls() as calls:
            x = fill()
        count = grant_counts(calls)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        n = k3.persistent_epoch.launches
        check(n == 1, f"fleet fill {crit}: K3 launched {n} times")
        launches += n
        grid = k3.persistent_epoch.grid
        ms = cuda_ms(fill, 3, warmup=0)
        with k3_plain(), loop_calls() as calls, graph_counts() as g:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fill()
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        count_plain = grant_counts(calls)
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
                    default="kernels,allocator,des,serve,gang,models,fill,"
                    "mesh,train,dryrun,dist",
                    help="comma list of kernels, allocator, des, serve, gang, "
                    "models, fill, mesh, train, dryrun, dist, and chunks (a "
                    "sweep of the epoch loop's chunk size; not a default "
                    "phase)")
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
    sources = [tiles.SOURCE, k3.SOURCE, *k5.SOURCES.values(),
               *k5.BWD_SOURCES.values(), k6.SOURCE, k6.BWD_SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc each
        builds = [pool.submit(_build.build, src) for src in sources]
        for b in builds:
            b.result()          # raises on a build error
    tiles.library()
    k3.library()
    for name in k5.SOURCES:
        k5.library(name)
    for name in k5.BWD_SOURCES:
        k5.bwd_library(name)
    k6.library()
    k6.bwd_library()
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
        log(f"launches (K5 over the qwen2-1.5b, granite-moe-3b-a800m, "
            f"deepseek-v2-236b, hymba-1.5b, whisper-large-v3 and "
            f"llama-3.2-vision-90b serves' prefills, K6 over the rwkv6-3b "
            f"serve's prefill): "
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
    if "mesh" in phases:
        mesh_phase(dev, agents, fws, args.seed)
    train_fwd = {}
    if "train" in phases:
        t0 = time.perf_counter()
        train_rows, train_bwd, train_fwd = train_phase(dev, args.seed)
        rows.update(train_rows)
        launches.update(train_bwd)
        log(f"launches (the backward kernels over the "
            f"{' and '.join(TRAIN_ARCHS)} training steps): {train_bwd}; "
            f"the forward kernels' {train_fwd}; train phase "
            f"{time.perf_counter() - t0:.1f} s")
        for name, n in {**train_bwd, **train_fwd}.items():
            check(n > 0, f"the train path never launched {name}")
    if "dryrun" in phases:
        dryrun_phase(dev)
    dist_launches = {}
    if "dist" in phases:
        t0 = time.perf_counter()
        dist_launches = dist_phase(dev, args.seed)
        log(f"launches (the kernels through the boundary over the meshed "
            f"qwen2-1.5b, rwkv6-3b and granite-moe-3b-a800m steps and "
            f"deepseek-v2-236b's prefill): {dist_launches}; dist phase "
            f"{time.perf_counter() - t0:.1f} s")
        for name, n in dist_launches.items():
            check(n > 0, f"the meshed train path never launched {name}")
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
        # no Pallas counterpart: the reference differentiates the XLA twin
        # of its flash kernel
        "flash_attention_bwd": dict(
            route="cuda",
            source="src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_bwd_tc.cu",
            replaces="src/repro/nn/layers.py:104"),
        # no Pallas counterpart: the reference differentiates the chunked
        # XLA twin of its WKV6 kernel
        "wkv6_bwd": dict(
            route="cuda",
            source="src/repro_torch/kernels/rwkv6/csrc/wkv6_bwd.cu",
            replaces="src/repro/nn/ssm.py:118"),
    }
    log(f"chip_smoke phases {','.join(sorted(phases))}: "
        f"{time.perf_counter() - t_start:.1f} s, the builds included")
    if set(rows) == set(launches) == set(meta):
        out = [dict(name=name, **meta[name], launches=launches[name],
                    **rows[name]) for name in meta]
        if fill_launches is not None:   # the fill path's own K3 count
            out[list(meta).index("persistent_epoch")]["fill_launches"] = (
                fill_launches)
        for name, n in train_fwd.items():   # the train path's forwards
            out[list(meta).index(name)]["train_launches"] = n
        for name, n in dist_launches.items():   # through the rules
            out[list(meta).index(name)]["dist_launches"] = n
        log(json.dumps({"kernels": out}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
