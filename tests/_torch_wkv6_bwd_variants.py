"""Where K6's backward spends its time, on the card: ``csrc/wkv6_bwd.cu``
rebuilt with one part cut out or cheapened at a time, each variant timed
at rwkv6-3b's micro-batch shape against the source as it is, in turns
(as built, each variant, as built).  A variant that cuts work computes
wrong gradients: it is timed, never used.  Each variant's build prints
its registers and spills::

    PYTHONPATH=src python tests/_torch_wkv6_bwd_variants.py
"""
import sys

import torch

from repro_torch import _build
from repro_torch.kernels.rwkv6 import ops

SHAPE = (2, 4096, 40, 64)
INCLUDE = '#include "wkv6_tile.cuh"\n'
#: name -> the edits (old text, new text) that make the variant
VARIANTS = {
    "as built": [],
    "no diagonal dr/dk terms": [
        ("for (int t = 1; t < 16; ++t) {", "for (int t = 1; t < 1; ++t) {")],
    "no diagonal att tiles": [
        ("it < 4 * 136; it += NTB", "it < 0; it += NTB")],
    "__expf for expf": [(INCLUDE, INCLUDE + "#define expf __expf\n")],
    "one TF32 product, not three": [
        ("      mma_tf32(acc[n], al, bh0, bh1);\n"
         "      mma_tf32(acc[n], ah, bl0, bl1);\n", "")],
}


def build(name, text):
    """-> the variant's library, built by ``_build`` and loaded as ``ops``
    loads the backward (its argument types set); prints ptxas's line for
    the chunk pass.  The variant is written into the build directory, its
    header included by its path in ``csrc``."""
    stem = "wkv6_bwd_variant_" + "".join(c if c.isalnum() else "_"
                                         for c in name)
    src = _build.BUILD_DIR / f"{stem}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text.replace(
        INCLUDE, f'#include "{ops.CSRC / "wkv6_tile.cuh"}"\n'))
    ops._LIBS.pop("wkv6_bwd", None)
    lib = ops._load(src, "wkv6_bwd", 17)
    log = _build.library_path(src).with_suffix(".log").read_text()
    log = log.splitlines()
    at = next(i for i, ln in enumerate(log) if "wkv6_bwd_chunk" in ln)
    print(f"{name}: " + "; ".join(ln.split(":", 1)[-1].strip()
                                  for ln in log[at + 2:at + 4]), flush=True)
    return lib


def main():
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(30)
    B, S, H, D = SHAPE
    r, k, v = (torch.randn(SHAPE, generator=g, device=dev) * 0.5
               for _ in range(3))
    lw = -torch.exp(torch.randn(SHAPE, generator=g, device=dev) * 0.5)
    u = torch.randn((H, D), generator=g, device=dev) * 0.5
    dy = torch.randn(SHAPE, generator=g, device=dev)
    with torch.no_grad():
        starts = ops._launch(r, k, v, lw, u, None, 64)[2]
    text = ops.BWD_SOURCE.read_text()
    libs = {}
    for name, edits in VARIANTS.items():
        variant = text
        for old, new in edits:
            if old not in variant:
                raise SystemExit(f"{name}: the source no longer holds "
                                 f"{old!r}")
            variant = variant.replace(old, new)
        libs[name] = build(name, variant)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for name in [*VARIANTS, "as built"]:
        ops._LIBS["wkv6_bwd"] = libs[name]
        for _ in range(3):
            ops.wkv6_bwd(r, k, v, lw, u, dy, starts=starts)
        t0.record()
        for _ in range(20):
            ops.wkv6_bwd(r, k, v, lw, u, dy, starts=starts)
        t1.record()
        torch.cuda.synchronize()
        print(f"K6 backward {SHAPE} f32, {name}: "
              f"{t0.elapsed_time(t1) / 20:.4f} ms a call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
