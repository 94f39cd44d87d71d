"""int8 error-feedback gradient compression: the reference's
``optim/compress.py`` in PyTorch.

Gradients are quantized to int8 with a per-tensor scale before a
cross-pod all-reduce; the quantization residual is carried in an
error-feedback buffer so the compression bias vanishes over steps
(EF-SGD).  :func:`compressed_psum_along` all-reduces the decoded values
over one dimension of a ``DeviceMesh``.  Trees are nested dicts and lists
of tensors (:mod:`repro_torch.tree`)."""
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


def compressed_psum_along(codes, scales, mesh, axis: str):
    """All-reduce int8 codes' decoded values over the mesh dimension
    ``axis`` (e.g. "pod") -> the tree of sums, one f32 tensor a leaf, the
    same on every rank of that dimension's group.  Each rank decodes its
    local codes at its local scale (``q.float() * s``) and the decoded
    values are summed.  (The reference also takes the maximum of the scales
    over the axis and then returns only the sums; that maximum changes no
    output, so it is not taken.)"""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    out = []
    for q, s in zip(leaves(codes), leaves(scales)):
        g = q.float() * s
        dist.all_reduce(g, group=group)
        out.append(g)
    return unflatten(codes, out)
