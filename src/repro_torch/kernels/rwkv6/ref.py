"""Plain PyTorch versions of the WKV6 recurrence.

* :func:`wkv6_ref` — K6's plain version: the chunk-parallel form of
  ``repro.nn.ssm.wkv6_chunked`` (zero padding to a multiple of the chunk,
  every exponent <= 0), with the chunks taken one after the other so that
  its memory is one chunk's (B, C, C, H, D) decays, not the whole
  sequence's.  Returns ``(y, state_end)``.
* :func:`wkv6_scan` — the exact token-by-token recurrence
  (``repro.nn.ssm.wkv6_scan``): the decode step and the oracle.
* :func:`wkv6_three_phase` — an emulation of ``csrc/wkv6.cu``'s algorithm
  (every chunk's own part at once, the scan of the state over the chunks,
  every chunk's inter-chunk part at once), for the tests.
* :func:`wkv6_bwd_ref` — the plain backward: the gradient of
  :func:`wkv6_ref` written out chunk by chunk in reverse, not autograd.
  Returns ``(dr, dk, dv, dlogw, du, dstate0)``.
* :func:`wkv6_bwd_factored` — an emulation of ``csrc/wkv6_bwd.cu``'s
  algorithm (the pre-pass, the adjoint scan, the fused chunk pass with its
  factored decays over sub-chunks and its TF32 products), for the tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _work_type(t) -> torch.dtype:
    """f32, or f64 for f64 inputs (a gradient check's finite differences)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _chunks(t, chunk):
    """(B,S,H,D) -> (B,nC,C,H,D) in :func:`_work_type`, zero padded to a
    multiple of chunk."""
    B, S, H, D = t.shape
    pad = (-S) % chunk
    t = t.to(_work_type(t))
    if pad:
        t = F.pad(t, (0, 0, 0, 0, 0, pad))
    return t.reshape(B, (S + pad) // chunk, chunk, H, D)


def wkv6_ref(r, k, v, logw, u, *, chunk: int = 64, state0=None,
             starts: bool = False):
    """r/k/v/logw: (B,S,H,D); u: (H,D); state0: (B,H,D,D) or None ->
    (y (B,S,H,D) f32, state (B,H,D,D) f32); f64 inputs stay f64.
    ``starts``: also each chunk's starting state (B,H,nC,D,D), as
    ``csrc/wkv6.cu`` leaves them for its backward."""
    B, S, H, D = r.shape
    f32 = _work_type(r)
    rc, kc, vc, wc = (_chunks(t, chunk) for t in (r, k, v, logw))
    nC = rc.shape[1]
    u = u.to(f32)
    s = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if state0 is None else state0.to(f32))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)[:, :, None, None]
    ys, kept = [], []
    for n in range(nC):
        if starts:
            kept.append(s)
        rn, kn, vn, wn = rc[:, n], kc[:, n], vc[:, n], wc[:, n]  # (B,c,H,D)
        cum = torch.cumsum(wn, dim=1)                            # inclusive
        cum_prev = cum - wn                                      # exclusive
        total = cum[:, -1:]                                      # (B,1,H,D)
        # intra-chunk: exp(cum_prev[t] - cum[j]) for j < t, all <= 0
        dec = torch.exp(cum_prev[:, :, None] - cum[:, None])     # (B,t,j,H,D)
        att = torch.sum(rn[:, :, None] * kn[:, None]
                        * torch.where(tri, dec, 0.0), dim=-1)    # (B,t,j,H)
        diag = torch.sum(rn * u * kn, dim=-1)                    # (B,c,H)
        y_intra = (torch.einsum("bijh,bjhd->bihd", att, vn)
                   + diag[..., None] * vn)
        # inter-chunk: the state at the chunk's start
        r_dec = rn * torch.exp(cum_prev)
        y_inter = torch.einsum("bchd,bhde->bche", r_dec, s)
        ys.append(y_intra + y_inter)
        k_dec = kn * torch.exp(total - cum)
        s = (torch.exp(total[:, 0])[..., None] * s
             + torch.einsum("bchd,bche->bhde", k_dec, vn))
    y = torch.cat(ys, dim=1)[:, :S]
    if starts:
        return y, s, torch.stack(kept, dim=2)
    return y, s


def wkv6_scan(r, k, v, logw, u, state0=None):
    """Exact recurrence.  r/k/v/logw: (B,S,H,D) -> (y (B,S,H,D) f32,
    state (B,H,D,D) f32); the state maps the k-dim to the v-dim."""
    B, S, H, D = r.shape
    f32 = torch.float32
    r, k, v, logw = (t.to(f32) for t in (r, k, v, logw))
    s = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if state0 is None else state0.to(f32))
    uu = u.to(f32)[None, :, :, None]
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B,H,D,D)
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, t], s + uu * kv))
        s = torch.exp(logw[:, t])[..., None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv6_three_phase(r, k, v, logw, u, *, chunk: int = 64, state0=None):
    """K6 as ``csrc/wkv6.cu`` computes it, in three phases: (a) every
    chunk at once: the cumulative log-decays (in token order), the
    strict lower triangle of the scores, ``att @ v + diag * v`` and the
    chunk's state increment ``(k * exp(total - cum))^T v``; (b) the scan of
    the state over the chunks, keeping each chunk's starting state; (c)
    every chunk at once: ``y += (r * exp(cum_prev)) @ S_start``.  Same
    arguments and results as :func:`wkv6_ref`."""
    B, S, H, D = r.shape
    f32 = torch.float32
    rc, kc, vc, wc = (_chunks(t, chunk) for t in (r, k, v, logw))
    nC = rc.shape[1]
    u = u.to(f32)
    # (a) the chunks' own parts, (B, nC, C, H, D)
    cum = torch.cumsum(wc, dim=2)
    cum_prev = cum - wc
    total = cum[:, :, -1]                                    # (B,nC,H,D)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)[:, :, None, None]
    dec = torch.exp(cum_prev[:, :, :, None] - cum[:, :, None])
    att = torch.sum(rc[:, :, :, None] * kc[:, :, None]
                    * torch.where(tri, dec, 0.0), dim=-1)     # (B,nC,t,j,H)
    diag = torch.sum(rc * u * kc, dim=-1)
    y = torch.einsum("bntjh,bnjhd->bnthd", att, vc) + diag[..., None] * vc
    k_dec = kc * torch.exp(total[:, :, None] - cum)
    inc = torch.einsum("bnchd,bnche->bnhde", k_dec, vc)       # (B,nC,H,D,D)
    # (b) the scan over the chunks
    s = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if state0 is None else state0.to(f32))
    starts = []
    for n in range(nC):
        starts.append(s)
        s = torch.exp(total[:, n])[..., None] * s + inc[:, n]
    # (c) the chunks' inter-chunk parts
    y = y + torch.einsum("bnchd,bnhde->bnche", rc * torch.exp(cum_prev),
                         torch.stack(starts, dim=1))
    return y.reshape(B, nC * chunk, H, D)[:, :S], s


def wkv6_bwd_ref(r, k, v, logw, u, dy, *, chunk: int = 64, state0=None,
                 ds_end=None):
    """The gradient of :func:`wkv6_ref` at ``(r, k, v, logw, u, state0)``
    for the cotangents ``dy`` of ``y`` and ``ds_end`` of the final state
    (None: zero) -> ``(dr, dk, dv, dlogw, du, dstate0)`` in f32.

    The chunk-parallel form written out, not autograd: the chunks' starting
    states by the forward's scan, then the chunks in reverse, carrying the
    state's adjoint ``G`` (the gradient of a chunk's starting state):
    ``G_c = exp(total_c) * G_{c+1} + (r * exp(cum_prev))^T dy_c`` from
    ``G_nC = ds_end``; ``dstate0 = G_0``.  Within a chunk, with the scores
    ``A[t, j] = sum_d r[t,d] k[j,d] exp(cum_prev[t,d] - cum[j,d])``, j < t,
    and ``dA[t, j] = dy_t . v_j``:

    * dv: ``A^T dy``, the bonus ``(r_j . u k_j) dy_j`` and ``k_dec G_{c+1}``;
    * dr, dk: ``dA`` through the same decays, the bonus
      ``(dy_t . v_t) u k_t`` (and ``u r_t``), and the state's shares
      ``exp(cum_prev) * (dy S_start^T)`` and ``exp(total - cum) *
      (v G_{c+1}^T)``;
    * du: ``sum (dy_t . v_t) r_t k_t``;
    * dlogw[s]: the gradients of cum, cum_prev and total gathered by sums
      inside the chunk: ``sum_{t>s} r_t dr'_t - sum_{t>=s} k_t dk''_t +
      sum_{t<s} k_t dk'''_t + exp(total) sum_e S_start G_{c+1}``, where dr'
      is dr without the bonus, dk'' dk's intra-chunk share and dk''' its
      state share.

    Every exponent is a difference of cumulative log-decays that is <= 0,
    as in the forward.  f64 inputs stay f64."""
    B, S, H, D = r.shape
    f32 = _work_type(r)
    rc, kc, vc, wc, gc = (_chunks(t, chunk) for t in (r, k, v, logw, dy))
    nC = rc.shape[1]
    u = u.to(f32)
    s = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if state0 is None else state0.to(f32))
    starts = []
    for n in range(nC):
        starts.append(s)
        cum = torch.cumsum(wc[:, n], dim=1)
        total = cum[:, -1:]
        k_dec = kc[:, n] * torch.exp(total - cum)
        s = (torch.exp(total[:, 0])[..., None] * s
             + torch.einsum("bchd,bche->bhde", k_dec, vc[:, n]))
    G = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if ds_end is None else ds_end.to(f32))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)[:, :, None]
    dr, dk, dv, dw = ([None] * nC for _ in range(4))
    du = torch.zeros((H, D), dtype=f32, device=r.device)
    for n in reversed(range(nC)):
        rn, kn, vn, wn, gn = rc[:, n], kc[:, n], vc[:, n], wc[:, n], gc[:, n]
        cum = torch.cumsum(wn, dim=1)
        cum_prev = cum - wn
        total = cum[:, -1:]
        dec = torch.where(tri[..., None],
                          torch.exp(cum_prev[:, :, None] - cum[:, None]),
                          0.0)                                   # (B,t,j,H,D)
        att = torch.sum(rn[:, :, None] * kn[:, None] * dec, dim=-1)
        diag = torch.sum(rn * u * kn, dim=-1)                    # (B,c,H)
        d_att = torch.where(tri, torch.einsum("bthe,bjhe->btjh", gn, vn), 0.0)
        d_diag = torch.sum(gn * vn, dim=-1)                      # (B,c,H)
        x = d_att[..., None] * dec                               # (B,t,j,H,D)
        dr_intra = torch.sum(x * kn[:, None], dim=2)
        dk_intra = torch.sum(x * rn[:, :, None], dim=1)
        S0 = starts[n]
        dr_state = torch.exp(cum_prev) * torch.einsum("bthe,bhde->bthd",
                                                      gn, S0)
        k_decay = torch.exp(total - cum)
        dk_state = k_decay * torch.einsum("bjhe,bhde->bjhd", vn, G)
        dv[n] = (torch.einsum("btjh,bthe->bjhe", att, gn)
                 + diag[..., None] * gn
                 + torch.einsum("bjhd,bhde->bjhe", kn * k_decay, G))
        dr[n] = dr_intra + d_diag[..., None] * u * kn + dr_state
        dk[n] = dk_intra + d_diag[..., None] * u * rn + dk_state
        du = du + torch.sum(d_diag[..., None] * rn * kn, dim=(0, 1))
        a = rn * (dr_intra + dr_state)
        b = kn * dk_intra
        c = kn * dk_state
        after = torch.flip(torch.cumsum(torch.flip(a, (1,)), 1), (1,)) - a
        from_s = torch.flip(torch.cumsum(torch.flip(b, (1,)), 1), (1,))
        before = torch.cumsum(c, 1) - c
        e = torch.exp(total[:, 0]) * torch.sum(S0 * G, dim=-1)   # (B,H,D)
        dw[n] = after - from_s + before + e[:, None]
        G = (torch.exp(total[:, 0])[..., None] * G
             + torch.einsum("bthd,bthe->bhde", rn * torch.exp(cum_prev), gn))

    def whole(parts):
        return torch.stack(parts, dim=1).reshape(B, nC * chunk, H, D)[:, :S]

    return whole(dr), whole(dk), whole(dv), whole(dw), du, G




#: rows of a sub-chunk in ``csrc/wkv6_bwd.cu``: the 16 rows of an
#: ``mma.m16n8k8`` tile
SUB = 16


def tf32(x):
    """x rounded to TF32 as the backward kernel rounds it: the low 13 bits
    of the f32 mantissa cleared (through an int32 view)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def tf32_mm(a, b, mode="split"):
    """``a @ b`` with a tensor core's operands: ``"split"`` the kernel's
    three TF32 products, hi·hi + hi·lo + lo·hi (hi = tf32(x), lo =
    tf32(x - hi)); ``"one"`` one TF32 product; None plain f32."""
    if mode is None:
        return a @ b
    ah, bh = tf32(a), tf32(b)
    if mode == "one":
        return ah @ bh
    if mode != "split":
        raise ValueError(f"tf32 mode {mode!r}")
    return tf32(a - ah) @ bh + ah @ tf32(b - bh) + ah @ bh


def wkv6_bwd_factored(r, k, v, logw, u, dy, *, chunk: int = 64,
                      state0=None, ds_end=None, tf32_mode="split"):
    """K6's backward as ``csrc/wkv6_bwd.cu`` computes it, for the tests.

    (p) the pre-pass, every chunk at once: the cumulative log-decays in
    token order and ``q = (r * exp(cum_prev))^T dy``; (b') the adjoint scan
    of the state over the chunks in reverse from ``ds_end``, keeping each
    chunk's ``G_{c+1}``; (f) the fused chunk pass, every chunk at once, its
    rows cut into sub-chunks of :data:`SUB` tokens (the chunk padded to a
    multiple of it by zero tokens).  For a query sub-chunk a and the keys
    before it the pair decay ``exp(cum_prev[t] - cum[j])`` is factored at
    ``ref_a = cum_prev[a_start]``: ``exp(cum_prev[t] - ref_a)`` and
    ``exp(ref_a - cum[j])``, both <= 1 (an underflowing factor loses nothing
    the exact decay keeps), for ``att`` and dr's share; for a key sub-chunk
    b and the queries after it at ``ref_b = cum[b_end]`` for dk's share.  The
    diagonal ``SUB x SUB`` blocks keep the exact pairwise exponentials.
    Every product a tensor core takes (``d_att = dy v^T``, the factored
    ``att``, ``att^T dy``, dr's and dk's factored shares, ``dy S^T``,
    ``v G^T``, ``(k exp(total - cum)) G`` and q) goes through
    :func:`tf32_mm` with ``tf32_mode``; the rest is f32 as on the CUDA
    cores.  du: the chunks' parts summed over the batch and the chunks in
    order.  Same arguments and results as :func:`wkv6_bwd_ref`."""
    B, S, H, D = r.shape
    f32 = torch.float32
    L = SUB
    Cp = -(-chunk // L) * L

    def tiles(t):   # (B, nC, H, Cp, D), zero tokens past S and the chunk
        t = _chunks(t, chunk).to(f32)
        return F.pad(t, (0, 0, 0, 0, 0, Cp - chunk)).permute(0, 1, 3, 2, 4)

    rc, kc, vc, wc, gc = (tiles(t) for t in (r, k, v, logw, dy))
    nC = rc.shape[1]
    mm = lambda a, b: tf32_mm(a, b, tf32_mode)  # noqa: E731
    tr = lambda t: t.transpose(-1, -2)          # noqa: E731
    uu = u.to(f32)[:, None, :]                  # (H, 1, D)
    cum = torch.cumsum(wc, dim=3)
    cp = cum - wc
    total = cum[:, :, :, -1:]                   # (B, nC, H, 1, D)
    # (p) the pre-pass
    q = mm(tr(rc * torch.exp(cp)), gc)          # (B, nC, H, D, D)
    # the forward's starting states (its scratch after its launches)
    k_decay = torch.exp(total - cum)
    inc = tr(kc * k_decay) @ vc
    s = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if state0 is None else state0.to(f32))
    starts = []
    for n in range(nC):
        starts.append(s)
        s = torch.exp(total[:, n, :, 0])[..., None] * s + inc[:, n]
    starts = torch.stack(starts, dim=1)
    # (b') the adjoint scan
    G = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if ds_end is None else ds_end.to(f32))
    after = [None] * nC
    for n in reversed(range(nC)):
        after[n] = G
        G = torch.exp(total[:, n, :, 0])[..., None] * G + q[:, n]
    after = torch.stack(after, dim=1)
    # (f) the fused chunk pass
    full = mm(gc, tr(vc))                       # dy_t . v_j, (.., t, j)
    d_diag = torch.diagonal(full, dim1=-2, dim2=-1)[..., None]
    d_att = torch.tril(full, -1)
    att = torch.zeros_like(full)
    dr, dk = torch.zeros_like(rc), torch.zeros_like(kc)
    for a in range(Cp // L):
        rows = slice(a * L, a * L + L)
        # the diagonal block, exact on the CUDA cores
        dec = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                    device=r.device), -1)[..., None]
        dec = torch.where(dec, torch.exp(cp[..., rows, None, :]
                                         - cum[..., None, rows, :]), 0.0)
        rt, kt = rc[..., rows, :], kc[..., rows, :]
        att[..., rows, rows] = torch.sum(
            rt[..., :, None, :] * kt[..., None, :, :] * dec, dim=-1)
        x = d_att[..., rows, rows, None] * dec          # (.., t, j, D)
        dr[..., rows, :] += torch.sum(x * kt[..., None, :, :], dim=-2)
        dk[..., rows, :] += torch.sum(x * rt[..., :, None, :], dim=-3)
        if a > 0:      # queries of a against the keys before it
            before = slice(0, a * L)
            ref = cp[..., a * L:a * L + 1, :]
            eq = torch.exp(cp[..., rows, :] - ref)
            kq = kc[..., before, :] * torch.exp(ref - cum[..., before, :])
            att[..., rows, before] = mm(rt * eq, tr(kq))
            dr[..., rows, :] += eq * mm(d_att[..., rows, before], kq)
        if a < Cp // L - 1:   # keys of a against the queries after it
            later = slice(a * L + L, Cp)
            ref = cum[..., a * L + L - 1:a * L + L, :]
            rq = rc[..., later, :] * torch.exp(cp[..., later, :] - ref)
            dk[..., rows, :] += (torch.exp(ref - cum[..., rows, :])
                                 * mm(tr(d_att[..., later, rows]), rq))
    att = att + torch.diag_embed(torch.sum(rc * uu * kc, dim=-1))
    dk_intra = dk
    dr = dr + torch.exp(cp) * mm(gc, tr(starts))
    dk_state = k_decay * mm(vc, tr(after))
    dv = mm(tr(att), gc) + mm(kc * k_decay, after)
    e = torch.exp(total) * torch.sum(starts * after, dim=-1)[..., None, :]
    x, y, z = rc * dr, kc * dk_intra, kc * dk_state
    rev = lambda t: torch.flip(torch.cumsum(torch.flip(t, (3,)), 3), (3,))  # noqa: E731,E501
    dw = (rev(x) - x) - rev(y) + (torch.cumsum(z, 3) - z) + e
    dr = dr + d_diag * uu * kc
    dk = dk_intra + dk_state + d_diag * uu * rc
    du_parts = torch.sum(d_diag * rc * kc, dim=3)   # (B, nC, H, D)
    du = torch.zeros((H, D), dtype=f32, device=r.device)
    for bb in range(B):
        for n in range(nC):
            du = du + du_parts[bb, n]

    def whole(t):
        t = t.permute(0, 1, 3, 2, 4)[:, :, :chunk]
        return t.reshape(B, nC * chunk, H, D)[:, :S]

    return whole(dr), whole(dk), whole(dv), whole(dw), du, G
