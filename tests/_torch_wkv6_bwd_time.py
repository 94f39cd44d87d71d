"""K6's backward on the card, timed at rwkv6-3b's micro-batch shape: the
ms a call of ``ops.wkv6_bwd`` (``chip_smoke.cuda_ms``, 20 calls after 3),
its device time by launch (``chip_smoke.device_us`` over 10 calls), and
its gradients' relative L2 from the plain backward on the same inputs.
``repro_torch`` is imported from ``PYTHONPATH`` before ``chip_smoke``, so
one copy of this script times any checkout, and two checkouts compare in
one call on one card (parent, change, change, parent)::

    PYTHONPATH=<a checkout>/src python tests/_torch_wkv6_bwd_time.py [label]
"""
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels.rwkv6 import ops

sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
from chip_smoke import K6_NAMES, _rel_l2, cuda_ms, device_us  # noqa: E402

SHAPE = (2, 4096, 40, 64)


def main(label="this checkout"):
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    g = torch.Generator(dev).manual_seed(30)
    B, S, H, D = SHAPE
    r, k, v = (torch.randn(SHAPE, generator=g, device=dev) * 0.5
               for _ in range(3))
    lw = -torch.exp(torch.randn(SHAPE, generator=g, device=dev) * 0.5)
    u = torch.randn((H, D), generator=g, device=dev) * 0.5
    dy = torch.randn(SHAPE, generator=g, device=dev)
    with torch.no_grad():
        starts = ops._launch(r, k, v, lw, u, None, 64)[2]
    args = (r, k, v, lw, u, dy)
    got = ops.wkv6_bwd(*args, starts=starts)
    want = ops.wkv6_bwd_ref(*args)
    errs = [_rel_l2(a, b) for a, b in zip(got, want)]
    del got, want
    ms = cuda_ms(lambda: ops.wkv6_bwd(*args, starts=starts), 20, warmup=3)
    us, by = device_us(lambda: ops.wkv6_bwd(*args, starts=starts),
                       r"wkv6_bwd_\w+", calls=10)
    print(f"K6 backward {SHAPE} f32 ({label}, {ops.__file__}, {card}): "
          f"{ms:.4f} ms a call; device a call: "
          + (f"{us:.1f} us ({by})" if us else f"not measured ({by})")
          + "; relative L2 from the plain backward: "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(K6_NAMES, errs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
