"""int8 error-feedback gradient compression: the reference's
``optim/compress.py`` in PyTorch.

Gradients are quantized to int8 with a per-tensor scale before a
cross-pod all-reduce; the quantization residual is carried in an
error-feedback buffer so the compression bias vanishes over steps
(EF-SGD).  The all-reduce itself (the reference's
``compressed_psum_along``) needs a process group and comes with the
distributed slice.  Trees are nested dicts and lists of tensors
(:mod:`repro_torch.tree`)."""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize(g, scale=None):
    """g (f32) -> (int8 codes, scale).  Symmetric per-tensor quantization,
    rounding half to even, as the reference's quantize does."""
    if scale is None:
        scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def compress_with_feedback(grads, ef):
    """-> (int8 codes tree, scales tree, new error-feedback tree): the
    codes decode to (g + ef) minus the new residual, which the feedback
    carries to the next step."""
    out = []
    for g, e in zip(leaves(grads), leaves(ef)):
        target = g.float() + e
        q, s = quantize(target)
        out.append((q, s, target - dequantize(q, s)))
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress(codes, scales):
    return tree_map(dequantize, codes, scales)
