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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def wkv6_ref(r, k, v, logw, u, *, chunk: int = 64, state0=None):
    """r/k/v/logw: (B,S,H,D); u: (H,D); state0: (B,H,D,D) or None ->
    (y (B,S,H,D) f32, state (B,H,D,D) f32)."""
    B, S, H, D = r.shape
    f32 = torch.float32
    pad = (-S) % chunk
    nC = (S + pad) // chunk

    def prep(t):
        t = t.to(f32)
        if pad:
            t = F.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(B, nC, chunk, H, D)

    rc, kc, vc, wc = prep(r), prep(k), prep(v), prep(logw)
    u = u.to(f32)
    s = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if state0 is None else state0.to(f32))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)[:, :, None, None]
    ys = []
    for n in range(nC):
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
    pad = (-S) % chunk
    nC = (S + pad) // chunk

    def prep(t):
        t = t.to(f32)
        if pad:
            t = F.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(B, nC, chunk, H, D)

    rc, kc, vc, wc = prep(r), prep(k), prep(v), prep(logw)
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
