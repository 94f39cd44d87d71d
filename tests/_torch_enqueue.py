"""K5's and K6's host enqueue on the card through their wrappers, one
checkout at a time: the calls a model makes (without grad, and a forward
with its backward under grad) at small shapes, where the host bounds a
call.  ``repro_torch`` is imported from ``PYTHONPATH``, so one copy of this
script times two checkouts, run in turns in one session::

    PYTHONPATH=<checkout>/src python tests/_torch_enqueue.py LABEL

prints one JSON line, ``{"label": LABEL, "us": {call: [host us a call,
one a repeat]}}``: each repeat times 200 calls with ``perf_counter`` and
no sync inside, after 50 calls of warm-up.
"""
import json
import sys
import time

import torch

from repro_torch.kernels.flash_attention import ops as k5
from repro_torch.kernels.rwkv6 import ops as k6

CALLS, REPEATS, WARM = 200, 5, 50


def host_us(fn):
    for _ in range(WARM):
        fn()
    out = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        out.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return out


def main(label):
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    bf16 = torch.bfloat16
    q = torch.randn((1, 128, 12, 128), generator=g, device=dev, dtype=bf16)
    kv = torch.randn((1, 128, 2, 128), generator=g, device=dev, dtype=bf16)
    dout = torch.randn_like(q)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, kv, kv))
    r = torch.randn((1, 64, 4, 64), generator=g, device=dev)
    lw = -torch.rand((1, 64, 4, 64), generator=g, device=dev)
    u = torch.randn((4, 64), generator=g, device=dev)
    rg, ug = r.clone().requires_grad_(True), u.clone().requires_grad_(True)
    dy = torch.randn_like(r)

    def k5_train():
        k5.flash_attention(qg, kg, vg).backward(dout)

    def k6_train():
        k6.wkv6(rg, r, r, lw, ug)[0].backward(dy)

    with torch.no_grad():
        us = {"flash_attention": host_us(lambda: k5.flash_attention(q, kv,
                                                                    kv)),
              "wkv6": host_us(lambda: k6.wkv6(r, r, r, lw, u))}
    us["flash_attention fwd+bwd"] = host_us(k5_train)
    us["wkv6 fwd+bwd"] = host_us(k6_train)
    print(json.dumps({"label": label, "us": us}))


if __name__ == "__main__":
    main(sys.argv[1])
