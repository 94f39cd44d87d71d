"""Where the train step's gradients on the card part from the CPU's, for
each family that trains on the card, at the configs and batch of
``tests/test_torch_cuda.py::test_train_step_on_card_equals_plain``.

One train step's gradient, leaf by leaf as the optimizer receives it
(``_train_case``, ``_train_run``), in four runs: on the card with K5's
and K6's kernels ("kern"), on the card with the forward kernels and the
plain backwards ("mixed"), on the card with both plain versions
("plain"), and on the CPU ("cpu").
Printed for each pair: the losses, the four leaves furthest apart and the
median (relative L2).  For the VLM also three controls, each a fault put
into K5's backward on the card, against the CPU: the cross-attention's dk
zeroed, its dv scaled by 1 + 1e-3, the self-attention's dq scaled by
1 + 1e-3; for RWKV6 one, K6's dr scaled by 1 + 1e-3.

Run on a machine with a card, from the repository's root::

    PYTHONPATH=src python tests/_torch_card_grads.py [arch,...]
"""
import os
import sys
from unittest import mock

import numpy as np
import torch

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import chip_smoke  # noqa: E402
import test_torch_cuda as T  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as k6  # noqa: E402
from repro_torch.nn import layers, ssm  # noqa: E402


def compare(a, b) -> str:
    r = sorted(((T._rel_l2(a[1][k], w), k) for k, w in b[1].items()),
               reverse=True)
    return (f"loss {a[0]!r} vs {b[0]!r}; furthest "
            + ", ".join(f"{k} {v:.3e}" for v, k in r[:4])
            + f"; median {np.median([v for v, _ in r]):.3e}")


def faulty(fault):
    """K5's backward on the card with ``fault(causal, dq, dk, dv)`` applied
    to its gradients."""
    real = ops.flash_attention_bwd

    def bwd(*args, causal=True, window=0, **kw):
        return fault(causal, *real(*args, causal=causal, window=window,
                                   **kw))
    return bwd


CONTROLS = {
    "cross dk zeroed": lambda c, dq, dk, dv: (dq, dk if c else 0 * dk, dv),
    "cross dv x (1 + 1e-3)": lambda c, dq, dk, dv: (
        dq, dk, dv if c else dv * (1 + 1e-3)),
    "self dq x (1 + 1e-3)": lambda c, dq, dk, dv: (
        dq * (1 + 1e-3) if c else dq, dk, dv),
}


def k6_dr_scaled(*args, **kw):
    dr, *rest = k6.bwd_launch(*args, **kw)
    return (dr * (1 + 1e-3), *rest)


def main(archs):
    dev = torch.device("cuda")
    seams = chip_smoke.k5_seams()
    k6_seams = {"mixed": (k6, "wkv6_bwd", chip_smoke.plain_wkv6_bwd),
                "plain": (ssm, "_k6", chip_smoke.PlainK6)}
    for arch in archs:
        cfg, tree, batch = T._train_case(arch)
        runs = {"kern": T._train_run(cfg, tree, batch, dev)}
        for name in ("mixed", "plain"):
            with mock.patch.object(layers, "_k5", seams[name]), \
                    mock.patch.object(*k6_seams[name]):
                runs[name] = T._train_run(cfg, tree, batch, dev)
        runs["cpu"] = T._train_run(cfg, tree, batch, torch.device("cpu"))
        for a, b in (("kern", "mixed"), ("kern", "plain"), ("plain", "cpu"),
                     ("kern", "cpu")):
            print(f"{arch} {cfg.compute_dtype} {a} vs {b}: "
                  + compare(runs[a], runs[b]), flush=True)
        if cfg.family == "ssm":
            with mock.patch.object(k6, "wkv6_bwd", k6_dr_scaled):
                run = T._train_run(cfg, tree, batch, dev)
            print(f"{arch} control (K6 dr x (1 + 1e-3)) vs cpu: "
                  + compare(run, runs["cpu"]), flush=True)
        if cfg.family != "vlm":
            continue
        for name, fault in CONTROLS.items():
            with mock.patch.object(ops, "flash_attention_bwd", faulty(fault)):
                run = T._train_run(cfg, tree, batch, dev)
            print(f"{arch} control ({name}) vs cpu: "
                  + compare(run, runs["cpu"]), flush=True)


if __name__ == "__main__":
    main(sys.argv[1].split(",") if len(sys.argv) > 1 else T.TRAINED)
