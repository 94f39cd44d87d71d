"""Progressive filling on PyTorch: the port of the reference's vectorized
filler (``filling_jax``).

The exact numpy filler (:mod:`repro_torch.core.filling`) recomputes every
score in f64 on the host; this one keeps the allocation on the tensors'
device and computes in f32, as the reference's device engine does.  CPU
tensors stay on the CPU and CUDA tensors on the card; nothing is moved.

Feasibility, criterion scores and the best-fit metric are
:mod:`repro_torch.core.criteria`'s functions with ``xp=torch``, the
formulas the numpy filler and the allocator use, written for one trial and
mapped over the trials with ``torch.func.vmap``; this module owns the
control flow and the random draws.  Two bodies:

  * **deterministic pooled** (``tie="low"``, ``policy="pooled"``, all four
    criteria): the shared device-resident epoch loop,
    :func:`repro_torch.core.engine_torch.epoch_loop` with its default
    kernel.  On the card that is the persistent epoch kernel (one launch
    a fill); on the CPU its plain version, which is the plain loop.  The
    servers are padded to a multiple of 4 (the kernel reads rows four
    cells at a time) with zero-capacity servers that are not allowed, and
    the result is cropped back;
  * **the step loop** (RRR, ``tie="random"``, best-fit): one grant a
    step for every trial of a leading T dimension, full recompute of
    feasibility and scores, as the reference's ``while_loop`` body
    (:class:`StepFill`).  A trial that has finished is frozen (its steps
    are no-ops), as ``vmap`` of a ``while_loop`` freezes it; the host asks
    whether any trial is alive once every :data:`ALIVE_EVERY` steps.  On
    the card those steps are one captured CUDA graph, kept per
    configuration and shape (:class:`_FillGraph`) and replayed; the
    random numbers of a chunk are drawn before it, outside the graph.

Randomness comes from ``torch.Generator`` objects on the tensors' device
in place of PRNG keys.  A batch of trials draws each trial's numbers from
that trial's own generator (:func:`trial_generators`), so a trial in a
batch equals the same trial filled alone.  RRR results therefore agree
with the reference and the numpy filler in distribution, not draw for
draw; deterministic configurations agree bit for bit.

With ``devices > 1`` the deterministic pooled fill runs on the mesh epoch
(:func:`repro_torch.core.engine_torch.epoch_loop_mesh`, the reference's
``epoch_loop_mesh``) in place of the persistent kernel, on the unpadded
servers, whose count the mesh's shards must divide (as in the reference).
"""
from __future__ import annotations

import torch

from repro_torch.core import criteria, engine_torch
from repro_torch.kernels import KernelError
from repro_torch.launch.mesh import AgentMesh

POL_RRR, POL_POOLED, POL_BESTFIT = 0, 1, 2
_POL = {"rrr": POL_RRR, "pooled": POL_POOLED, "bestfit": POL_BESTFIT}

#: steps between the host's checks that some trial is still alive
ALIVE_EVERY = 32
#: most uniforms a trial draws in one call (a block of its steps' draws)
DRAW_BLOCK = 2 ** 20
#: the persistent epoch kernel reads server rows this many cells at a time
J_MULTIPLE = 4
#: incremented once per captured chunk of the step loop (:class:`_FillGraph`;
#: kept in ``engine_torch``'s graph cache)
CAPTURE_COUNT = 0


def trial_generators(generator: torch.Generator, trials: int,
                     device) -> list[torch.Generator]:
    """One generator a trial on ``device``, seeded from ``generator``
    (the counterpart of splitting a PRNG key into per-trial keys)."""
    seeds = torch.randint(0, 2**62, (trials,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def is_deterministic(policy: str, tie: str) -> bool:
    """Does the configuration draw no random numbers?"""
    return policy != "rrr" and tie == "low"


def progressive_fill_torch(D, C, phi, generator=None, *, criterion="drf",
                           policy="rrr", lookahead=False, tie="low",
                           max_steps=4096, shards=1, devices=1, x0=None,
                           allowed=None) -> torch.Tensor:
    """Run progressive filling on the tensors' device; returns the (N, J)
    int32 allocation.

    ``generator`` (a ``torch.Generator`` on that device) is needed only
    where the configuration draws random numbers.  ``shards`` is passed to
    the deterministic pooled path's epoch loop; ``devices`` (a count of
    devices of the tensors' type, or an
    :class:`~repro_torch.launch.mesh.AgentMesh`) above one runs that path
    on the mesh epoch instead.  The step loop ignores both, as the
    reference's does."""
    if _POL[policy] == POL_POOLED and tie == "low":
        return _pooled_fill(D, C, phi, criterion=criterion,
                            lookahead=lookahead, max_steps=max_steps,
                            shards=shards, devices=devices, x0=x0,
                            allowed=allowed)
    return _step_fill(D, C, phi, [generator], trials=1, criterion=criterion,
                      policy=policy, lookahead=lookahead, tie=tie,
                      max_steps=max_steps, x0=x0, allowed=allowed)[0]


def fill_trials_torch(D, C, phi, trials: int, *, generator=None, **kw):
    """``trials`` independent fills -> (T, N, J) int32.  A deterministic
    configuration is filled once and broadcast to every trial (all T
    results would be equal); the others run as one batch, each trial on
    its own generator from :func:`trial_generators`."""
    policy, tie = kw.get("policy", "rrr"), kw.get("tie", "low")
    if is_deterministic(policy, tie):
        x = progressive_fill_torch(D, C, phi, generator, **kw)
        return x.unsqueeze(0).expand(trials, -1, -1).clone()
    gens = trial_generators(generator, trials, D.device)
    kw = {k: v for k, v in kw.items() if k not in ("shards", "devices")}
    return _step_fill(D, C, phi, gens, trials=trials, **kw)


# -- the deterministic pooled path: the shared epoch loop ----------------------

def _pooled_fill(D, C, phi, *, criterion, lookahead, max_steps, shards,
                 devices, x0, allowed):
    kind = criteria.get_criterion(criterion).name
    dev = D.device
    f32 = torch.float32
    N, J = D.shape[0], C.shape[0]
    mesh = (devices.size if isinstance(devices, AgentMesh)
            else int(devices)) > 1
    # the mesh takes the reference's unpadded servers (J must divide)
    Jp = J if mesh else -(-J // J_MULTIPLE) * J_MULTIPLE
    D, phi = D.to(f32), phi.to(f32)
    Cp = torch.zeros((Jp, C.shape[1]), dtype=f32, device=dev)
    Cp[:J] = C.to(f32)
    allowed_m = torch.zeros((N, Jp), dtype=torch.bool, device=dev)
    allowed_m[:, :J] = True if allowed is None else allowed.bool()
    Xf = torch.zeros((N, Jp), dtype=f32, device=dev)
    if x0 is not None:
        Xf[:, :J] = x0.to(torch.int32).to(f32)
    FREE = criteria.residual_capacities(Xf, D, Cp, xp=torch)
    perms = torch.arange(Jp, dtype=torch.int32, device=dev)[None, :]
    loop_args = (
        Xf, D, D, Cp, FREE, phi,
        torch.full((N,), 3.0e38, dtype=f32, device=dev),   # no wanted caps
        allowed_m, perms, torch.zeros(Jp, dtype=torch.int32, device=dev),
        0, 0, J, 0, 1e-6)
    kw = dict(kind=kind, policy="pooled", lookahead=lookahead,
              use_limit=False, max_steps=max_steps)
    if mesh:
        _ns, _js, _cnt, x_fin, *_rest = engine_torch.epoch_loop_mesh(
            *loop_args, **kw, devices=devices)
    else:
        _ns, _js, _cnt, x_fin, *_rest = engine_torch.epoch_loop(
            *loop_args, **kw, shards=shards)
    return x_fin[:, :J].to(torch.int32)


# -- the step loop: RRR, random ties, best-fit ---------------------------------

def _residual(X, D, C):
    """(J, R) residual capacities of one trial's int32 allocation."""
    return criteria.residual_capacities(X.to(torch.float32), D, C, xp=torch)


def _feasible(X, D, C, allowed):
    """(N, J) one-more-task feasibility of one trial's int32 allocation."""
    feas = (D[:, None, :] <= _residual(X, D, C)[None, :, :] + 1e-6).all(-1)
    if allowed is not None:
        feas = feas & allowed
    return feas


def _masked_argmin(scores, mask, noise=None):
    """(T,) argmin over each row's ``mask``-True entries; with ``noise``
    (T, L) uniform over the row's argmin set (the largest noise among the
    minima wins)."""
    s = torch.where(mask, scores, torch.inf)
    if noise is None:
        return s.argmin(1)
    m = s.amin(1, keepdim=True).expand_as(s)
    at_min = torch.isclose(s, m, rtol=0.0, atol=1e-9) & mask
    return (at_min * (1.0 + noise)).argmax(1)


def _inverse(perm, arange):
    """(T, J) rank of each server within its trial's permutation."""
    return torch.empty_like(perm).scatter_(1, perm, arange)


class StepFill:
    """The step loop of a batch of T trials: the tensors it reads and
    writes, and :meth:`step`, one grant a trial with no host sync.

    ``X`` (T, N, J) int32, the RRR permutations ``perm`` (T, J) and
    positions ``pos`` (T,), and the step count ``steps`` (1,) are its
    state; ``u`` (T, chunk, n_draws) holds the random numbers of the next
    :meth:`run` of ``chunk`` steps, drawn outside it (:meth:`draw`), so a
    captured run draws nothing.  A trial with nothing feasible, or a step
    at ``max_steps`` or past it, changes nothing."""

    def __init__(self, D, C, phi, allowed, trials, *, criterion, policy,
                 lookahead, tie, chunk):
        dev = D.device
        f32, i64 = torch.float32, torch.int64
        self.D, self.C, self.phi, self.allowed = D, C, phi, allowed
        N, J = D.shape[0], C.shape[0]
        T = trials
        self.pol = _POL[policy]
        self.random_tie = tie == "random"
        self.chunk = chunk
        self.crit = crit = criteria.get_criterion(criterion)
        self.rows = torch.arange(T, device=dev)
        self.arangeJ = torch.arange(J, dtype=i64, device=dev).expand(T, J)
        # one trial's feasibility, scores and best-fit metric, mapped over T
        self.feasible = torch.func.vmap(lambda X: _feasible(X, D, C, allowed))
        self.scores = torch.func.vmap(lambda X: crit.matrix_scores(
            X, D, C, phi, lookahead=lookahead, xp=torch, allowed=allowed))
        self.bestfit = torch.func.vmap(lambda X, d: criteria.bestfit_scores(
            _residual(X, D, C), d, metric="cosine", xp=torch))
        # a step draws two permutations' keys (RRR) and the tie noise, in
        # f64 so that permutation keys tie with negligible probability.
        # Each trial draws a block of steps' numbers at once from its own
        # generator (at most DRAW_BLOCK numbers, and no more steps than a
        # chunk).
        n_noise = N * J if self.pol == POL_POOLED and crit.server_specific \
            else N
        self.n_keys = 2 * J if self.pol == POL_RRR else 0
        self.n_draws = self.n_keys + (n_noise if self.random_tie else 0)
        self.block = max(1, min(chunk, DRAW_BLOCK // max(self.n_draws, 1)))
        self.X = torch.zeros((T, N, J), dtype=torch.int32, device=dev)
        self.perm = (torch.zeros((T, J), dtype=i64, device=dev)
                     if self.pol == POL_RRR else None)
        self.pos = torch.zeros(T, dtype=i64, device=dev)
        self.steps = torch.zeros(1, dtype=i64, device=dev)
        self.max_steps = torch.zeros(1, dtype=i64, device=dev)
        self.u = (torch.zeros((T, chunk, self.n_draws), dtype=torch.float64,
                              device=dev) if self.n_draws else None)
        self.flag = torch.zeros(1, dtype=torch.bool, device=dev)
        self._drawn = (-1, None)    # (block number, block) last drawn

    def start(self, gens, x0, max_steps):
        """A fresh batch: ``x0`` (or zeros) in every trial, the first RRR
        permutations drawn, step 0 of ``max_steps``."""
        if x0 is None:
            self.X.zero_()
        else:
            self.X.copy_(x0.to(device=self.X.device, dtype=torch.int32)
                         .expand_as(self.X))
        if self.pol == POL_RRR:
            self.perm.copy_(_draws(gens, self.X.shape[2]).argsort(1))
        self.pos.zero_()
        self.steps.zero_()
        self.max_steps.fill_(max_steps)
        self._drawn = (-1, None)
        self.flag.copy_(self.alive_now())

    def draw(self, gens, first: int, max_steps: int):
        """Fill ``u`` with the numbers of steps ``first`` .. ``first +
        chunk - 1``: each trial draws a block of ``block`` steps from its
        own generator when a step opens one, as an uncaptured step loop
        draws them, so every trial consumes the same numbers whatever the
        chunk."""
        if not self.n_draws:
            return
        k = 0
        while k < self.chunk and first + k < max_steps:
            b, off = divmod(first + k, self.block)
            if self._drawn[0] != b:
                self._drawn = (b, _draws(gens, self.block, self.n_draws))
            take = min(self.block - off, self.chunk - k)
            self.u[:, k:k + take] = self._drawn[1][:, off:off + take]
            k += take

    def alive_now(self):
        """(1,) bool: some trial can take a grant and steps are left."""
        return (self.feasible(self.X).any() & (self.steps < self.max_steps))

    def step(self, k: int):
        """One grant for every trial that is alive, on ``u[:, k]``."""
        X, rows, arangeJ = self.X, self.rows, self.arangeJ
        J = X.shape[2]
        crit = self.crit
        feas = self.feasible(X)
        alive = feas.flatten(1).any(1) & (self.steps < self.max_steps)
        sc = self.scores(X)
        u = self.u[:, k] if self.n_draws else None
        noise = u[:, self.n_keys:].float() if self.random_tie else None
        if self.pol == POL_RRR:
            perm, pos = self.perm, self.pos
            rank = _inverse(perm, arangeJ)
            server_ok = feas.any(1)                              # (T, J)
            ahead = server_ok & (rank >= pos[:, None])
            use_wrap = ~ahead.any(1, keepdim=True)
            new_perm = u[:, :J].argsort(1)
            new_rank = _inverse(new_perm, arangeJ)
            eff_rank = torch.where(use_wrap, new_rank, rank)
            eff_mask = torch.where(use_wrap, server_ok, ahead)
            j = _masked_argmin(eff_rank.to(torch.float32), eff_mask)
            n = _masked_argmin(sc[rows, :, j], feas[rows, :, j], noise)
            p = eff_rank[rows, j] + 1
            p = torch.where(p >= J, 0, p)
            # a round that wraps to its start gets a fresh permutation of
            # its own
            nxt = torch.where(use_wrap, new_perm, perm)
            nxt = torch.where((p == 0)[:, None], u[:, J:2 * J].argsort(1),
                              nxt)
            perm.copy_(torch.where(alive[:, None], nxt, perm))
            pos.copy_(torch.where(alive, p, pos))
        elif self.pol == POL_POOLED:
            if crit.server_specific:
                flat = _masked_argmin(sc.flatten(1), feas.flatten(1), noise)
                n, j = flat // J, flat % J
            else:
                n = _masked_argmin(sc[:, :, 0], feas.any(2), noise)
                j = _masked_argmin(arangeJ.to(torch.float32), feas[rows, n])
        else:   # best-fit: the framework first, then its best-fit server
            per_fw = torch.where(feas, sc, torch.inf).amin(2)
            n = _masked_argmin(per_fw, feas.any(2), noise)
            j = _masked_argmin(self.bestfit(X, self.D[n]), feas[rows, n])
        X[rows, n, j] += alive.to(torch.int32)
        self.steps += 1

    def run(self):
        """``chunk`` steps, then the alive flag for the next."""
        for k in range(self.chunk):
            self.step(k)
        self.flag.copy_(self.alive_now())


def _draws(gens, *shape):
    """(T, *shape) f64 uniforms, trial t's from ``gens[t]``."""
    return torch.stack([torch.rand(shape, dtype=torch.float64, generator=g,
                                   device=g.device) for g in gens])


class _FillGraph(engine_torch.CapturedGraph):
    """A :class:`StepFill` on its own buffers with its :meth:`StepFill.run`
    captured as one CUDA graph; :func:`_step_fill` keeps one per
    configuration and shape and copies each fill's inputs in."""

    def __init__(self, D, C, phi, allowed, trials, fill_kw):
        global CAPTURE_COUNT
        self.D, self.C, self.phi = D.clone(), C.clone(), phi.clone()
        self.allowed = None if allowed is None else allowed.clone()
        self.fill = StepFill(self.D, self.C, self.phi, self.allowed, trials,
                             **fill_kw)
        # the warm-up step is dead: no steps are left (max_steps is 0)
        super().__init__(D.device, lambda: self.fill.step(0), self.fill.run)
        CAPTURE_COUNT += 1

    def load(self, D, C, phi, allowed):
        self.D.copy_(D)
        self.C.copy_(C)
        self.phi.copy_(phi)
        if allowed is not None:
            self.allowed.copy_(allowed)


def _drive(fill: StepFill, run, gens, x0, max_steps):
    """The step loop to its end: chunks of ``fill.chunk`` steps by
    ``run()``, the alive flag read between two -> the allocation."""
    fill.start(gens, x0, max_steps)
    first = 0
    while first < max_steps and bool(fill.flag.item()):
        fill.draw(gens, first, max_steps)
        run()
        first += fill.chunk
    return fill.X.clone()


def _step_fill(D, C, phi, gens, *, trials, criterion="drf", policy="rrr",
               lookahead=False, tie="low", max_steps=4096, x0=None,
               allowed=None):
    """The step loop of :data:`ALIVE_EVERY`-step chunks.  On the card each
    chunk is one replay of the cached :class:`_FillGraph` of this
    configuration and shape; on the CPU the same steps run eagerly."""
    f32 = torch.float32
    D, C, phi = D.to(f32), C.to(f32), phi.to(f32)
    if allowed is not None:
        allowed = allowed.bool()
    fill_kw = dict(criterion=criteria.get_criterion(criterion).name,
                   policy=policy, lookahead=lookahead, tie=tie,
                   chunk=ALIVE_EVERY)
    if D.device.type != "cuda":
        fill = StepFill(D, C, phi, allowed, trials, **fill_kw)
        return _drive(fill, fill.run, gens, x0, max_steps)
    key = ("fill", str(D.device), trials, *D.shape, C.shape[0],
           tuple(sorted(fill_kw.items())), allowed is None)
    g = engine_torch.cached_graph(
        key, lambda: _FillGraph(D, C, phi, allowed, trials, fill_kw),
        "step fill")
    with g.use():
        g.load(D, C, phi, allowed)
        try:
            return _drive(g.fill, g.graph.replay, gens, x0, max_steps)
        except torch.AcceleratorError as exc:    # a fault on the card
            raise KernelError(f"step fill faulted on the device: "
                              f"{exc}") from exc
