"""Assigned input shapes per architecture and the applicability matrix.

Shapes (LM family, seq_len x global_batch):
  train_4k     4,096 x 256   -> train_step
  prefill_32k  32,768 x 32   -> prefill (serve)
  decode_32k   32,768 x 128  -> decode_step (one token, 32k KV cache)
  long_500k    524,288 x 1   -> decode_step (sub-quadratic archs only)

long_500k runs only for archs with sub-quadratic sequence mixing:
rwkv6 (O(1) state), hymba (SWA + SSM), gemma3 (40/48 sliding-window layers).
Pure full-attention archs skip it (noted in DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# archs that may run long_500k (sub-quadratic sequence mixing)
LONG_OK = {"rwkv6_3b", "hymba_1_5b", "gemma3_12b"}


def shapes_for(arch: str):
    from repro_torch.configs import canonical

    a = canonical(arch)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if a in LONG_OK:
        out.append("long_500k")
    return out


def all_cells():
    """Every (arch, shape) dry-run cell — 33 total."""
    from repro_torch.configs import ARCHS

    return [(a, s) for a in ARCHS for s in shapes_for(a)]
