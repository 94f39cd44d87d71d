"""How far qwen2-1.5b's bf16 gradients lie from its f32 ones, in the JAX
package and in the port, at full width on the CPU.

The model is qwen2-1.5b at its full width (d 1536, 12 heads over 2 KV
heads, vocab 151936) cut to two layers, with the reference's parameters
(``init_params(..., jax.random.key(0))``) carried into the port.  One
micro-batch from the data pipeline (``HostDataLoader``, seed 0) goes
through the reference's ``loss_fn`` (``train/steps.py``: the parameters
cast to the compute type, the forward, ``lm_loss``) under
``jax.value_and_grad`` and through the port's forward and ``lm_loss``
under autograd, each in f32 and in bf16 compute.  Printed: the relative
L2 distance (f64) of each pair of gradients, by layer as ``chip_smoke.py``
groups them (``embed``: every leaf outside the layer stack; ``0``, ``1``:
each layer's leaves).

Run from the repository's root (about 9 GB of memory, 80 s)::

    PYTHONPATH=src python tests/_torch_bf16_witness.py [--seq 256] [--batch 2]
"""
import argparse
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models.common import get_family as ref_family
from repro.models.common import lm_loss as ref_lm_loss
from repro.nn.param import init_params as ref_init
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, HostDataLoader
from repro_torch.models import common as C
from repro_torch.tree import leaves_with_paths

ARCH = "qwen2_1_5b"
LAYERS = 2


def ref_grads(rc, tree, batch):
    """-> (loss, {layer group: [f32 gradient arrays]}) of the reference."""
    fam = ref_family(rc)

    def loss_fn(params, b):
        params = jax.tree.map(lambda p: p.astype(rc.cdtype()), params)
        return ref_lm_loss(fam.forward(params, rc, b["tokens"]), b["labels"])

    params = jax.tree.map(jax.numpy.asarray, tree)
    b = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params, b)
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(g)[0]:
        x = np.asarray(x, np.float32)
        if getattr(path[0], "key", None) == "layers":
            for i in range(x.shape[0]):
                out.setdefault(str(i), []).append(x[i])
        else:
            out.setdefault("embed", []).append(x)
    return float(loss), out


def port_grads(pc, tree, batch):
    """-> (loss, {layer group: [f32 gradient arrays]}) of the port, its
    leaves in the reference's order within each group."""
    model = C.load_reference_params(C.get_family(pc).build(pc), tree)
    model.requires_grad_(True)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss = C.lm_loss(C.get_family(pc).forward(model, pc, b["tokens"]),
                     b["labels"])
    loss.backward()
    out = {}
    for path, p in leaves_with_paths(C.param_tree(model)):
        # a stacked leaf's path ends in its layer's index
        where = str(path[-1]) if path[0] == "layers" else "embed"
        out.setdefault(where, []).append(p.grad.detach().float().numpy())
    return float(loss.detach()), out


def rel(a, b):
    """Relative L2 of two groups' gradients, in f64."""
    num = sum(float(np.sum((x.astype(np.float64) - y.astype(np.float64)) ** 2))
              for x, y in zip(a, b))
    den = sum(float(np.sum(y.astype(np.float64) ** 2)) for y in b)
    return (num / den) ** 0.5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    rc = dataclasses.replace(ref_config(ARCH), n_layers=LAYERS)
    pc = dataclasses.replace(get_config(ARCH), n_layers=LAYERS)
    tree = jax.tree.map(np.asarray, ref_init(ref_family(rc).template(rc),
                                             jax.random.key(0)))
    first = next(HostDataLoader(DataConfig(
        vocab_size=pc.vocab_size, seq_len=args.seq,
        global_batch=args.batch)))
    batch = {k: first[k] for k in ("tokens", "labels")}
    runs = {}
    for dt in ("float32", "bfloat16"):
        runs["jax", dt] = ref_grads(
            dataclasses.replace(rc, compute_dtype=dt), tree, batch)
        runs["port", dt] = port_grads(
            dataclasses.replace(pc, compute_dtype=dt), tree, batch)
    print(f"{ARCH} at full width, {LAYERS} layers, batch {args.batch} x "
          f"{args.seq} tokens; losses: " + ", ".join(
              f"{w} {dt} {loss:.6f}" for (w, dt), (loss, _) in runs.items()))
    pairs = ((("jax", "bfloat16"), ("jax", "float32")),
             (("port", "bfloat16"), ("port", "float32")),
             (("port", "bfloat16"), ("jax", "bfloat16")),
             (("port", "float32"), ("jax", "float32")),
             (("port", "bfloat16"), ("jax", "float32")))
    for a, b in pairs:
        ga, gb = runs[a][1], runs[b][1]
        print(f"{a[0]} {a[1]} against {b[0]} {b[1]}: relative L2 by layer "
              + ", ".join(f"{w} {rel(ga[w], gb[w]):.3e}" for w in gb))


if __name__ == "__main__":
    main()
