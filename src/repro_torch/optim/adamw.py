"""AdamW with decoupled weight decay, f32 moments, a cosine schedule and
global gradient clipping: the reference's ``optim/adamw.py`` in PyTorch,
with one departure: the global norm is summed in f64 (see
:func:`global_norm`).

Trees are nested dicts and lists of tensors (:mod:`repro_torch.tree`),
walked in the reference's leaf order.  :func:`update` writes the new
parameters and moments in place (the reference returns new trees; the
port keeps one copy of its f32 master weights and moments) and takes no
host sync: the clip scale, the learning rate and the bias corrections stay
0-d tensors on the device."""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step):
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; ``step`` a
    0-d integer tensor -> a 0-d f32 tensor on its device."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                           1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params):
    """Zero f32 moments ``{"m", "v"}`` of the parameter tree's structure."""
    def zeros(p):        # a DTensor parameter's moments share its placements
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree):
    """sqrt of the sum of the leaves' sums of squares, taken in leaf order
    and in f64 -> a 0-d f64 tensor.  The reference sums in f32, which
    overflows to inf once the norm passes about 1.8e19 (as the reference's
    init gives qwen2-1.5b at full depth); its clip scale is then 0 and a
    step applies weight decay alone.  In f64 the norm is finite for any
    finite f32 gradient, and below that size equals the f32 sum to its
    rounding."""
    return torch.sqrt(sum(
        torch.square(torch.linalg.vector_norm(g, dtype=torch.float64))
        for g in leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads, opt, step):
    """One AdamW step on trees of one structure, in place: the parameters
    and ``opt["m"]``/``opt["v"]``.  ``step`` is the 0-d integer step count
    before this step.  -> metrics ``{"grad_norm", "lr"}``, 0-d tensors
    (the norm in f64, the clip scale applied to the f32 gradients)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    t = step.float() + 1.0
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt["m"]),
                          leaves(opt["v"])):
        g = g.float() * scale.float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        step_ = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        step_ += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step_)
    return {"grad_norm": gnorm, "lr": lr}
