"""K6's forward on the card, the same bits across two checkouts: each
run draws the same inputs from a seeded generator on the card (the
rwkv6-3b prefill shape, a padded tail, strong decay from a state) and
either saves ``wkv6``'s outputs, without grad, or compares them with a
saved file bit for bit.  ``repro_torch`` is imported from ``PYTHONPATH``,
so one copy of this script serves both checkouts::

    PYTHONPATH=<other checkout>/src python tests/_torch_wkv6_bits.py save F
    PYTHONPATH=src python tests/_torch_wkv6_bits.py compare F
"""
import sys

import torch

from repro_torch.kernels.rwkv6 import ops

SHAPES = (((4, 2048, 40, 64), False), ((4, 2000, 40, 64), False),
          ((2, 1024, 40, 64), True))


def outputs():
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(29)
    out = []
    for shape, strong in SHAPES:
        B, S, H, D = shape
        r, k, v = (torch.randn(shape, generator=g, device=dev) * 0.5
                   for _ in range(3))
        z = torch.randn(shape, generator=g, device=dev)
        lw = -torch.exp(z * 2.0 + 2.0 if strong else z * 0.5)
        u = torch.randn((H, D), generator=g, device=dev) * 0.5
        s0 = (torch.randn((B, H, D, D), generator=g, device=dev)
              if strong else None)
        with torch.no_grad():
            out.extend(t.cpu() for t in ops.wkv6(r, k, v, lw, u, state0=s0))
    return out


def main(mode, path):
    got = outputs()
    if mode == "save":
        torch.save(got, path)
        print(f"saved {len(got)} tensors from {ops.__file__}")
        return 0
    want = torch.load(path)
    same = [torch.equal(a, b) for a, b in zip(got, want)]
    print(f"K6 forward, {ops.__file__} against {path}: the same bits "
          f"{same}")
    return 0 if all(same) and len(got) == len(want) else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
