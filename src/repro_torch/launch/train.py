"""End-to-end training entry point: data pipeline -> train step ->
checkpoint/restart -> straggler and heartbeat hooks (the reference's
``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen2-1.5b --smoke --device cpu --steps 100 --batch 8 --seq 128

Runs on the card (``--device cuda``, the default) unless asked for the CPU;
``--full`` trains the full published configuration.  On the card every
attention layer's forward and backward run on K5's kernels
(``flash_tc.cu``/``flash.cu`` and ``flash_bwd_tc.cu``/``flash_bwd.cu``),
and every RWKV6 time-mix's on K6's (``wkv6.cu`` and ``wkv6_bwd.cu``).  The
step runs eagerly (the reference jits it and donates the state).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.core.engine_torch import resolve_device
from repro_torch.data.pipeline import DataConfig, HostDataLoader
from repro_torch.fault.tolerance import HeartbeatMonitor, StragglerMonitor
from repro_torch.models.common import get_family, init_model
from repro_torch.nn.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import TrainConfig, init_state, make_train_step
from repro_torch.tree import leaves


def make_media(cfg, batch, device=None):
    if cfg.family in ("encdec", "vlm"):
        # frontend stub: deterministic pseudo-embeddings
        rng = np.random.default_rng(0)
        return torch.as_tensor(
            rng.normal(size=(batch, cfg.n_media_tokens, cfg.d_model)) * 0.02,
            dtype=torch.float32, device=device)
    return None


def saved(state) -> dict:
    """The part of a train state a checkpoint holds: parameters, moments
    and step (the model holds the same parameter tensors)."""
    return {"params": state["params"], "opt": state["opt"],
            "step": state["step"]}


@torch.no_grad()
def load_into(state, tree) -> None:
    """Copy a restored :func:`saved` tree into ``state``'s tensors."""
    for dst, src in zip(leaves(saved(state)), leaves(tree)):
        dst.copy_(src)
    state["model"].drop_casts()


def train(arch: str | ModelConfig, smoke: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 128, ckpt_dir: str | None = None,
          ckpt_every: int = 25, lr: float = 3e-3, log_every: int = 10,
          resume: bool = False, device="cuda", accum_steps: int = 1):
    """Train ``arch`` (a registered architecture, its smoke or full config
    by ``smoke``, or a :class:`ModelConfig`) from weights drawn from
    ``torch.Generator`` seed 0 on the device, on the reference's synthetic
    token stream, for ``steps`` steps of ``batch`` sequences of ``seq``
    tokens (``accum_steps`` micro-batches a step).  -> ``{"losses",
    "grad_norms", "lrs", "step_s", "state", "device"}``: the host's float of
    each step's loss (the reference returns these losses), grad norm and
    learning rate, each step's seconds to that read, and the final
    state."""
    dev = resolve_device(device)
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch,
                                                                  smoke=smoke)
    fam = get_family(cfg)
    tcfg = TrainConfig(
        accum_steps=accum_steps,
        opt=AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                        total_steps=steps),
    )

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    loader = HostDataLoader(dcfg)
    media = make_media(cfg, batch, dev)

    model = init_model(fam, cfg, torch.Generator(dev).manual_seed(0))
    state = init_state(cfg, model)

    store = CheckpointStore(ckpt_dir, keep=2) if ckpt_dir else None
    start_step = 0
    if store and resume and store.latest_step() is not None:
        tree, extras = store.restore(saved(state))
        load_into(state, tree)
        loader.restore(extras["data"])
        start_step = int(extras["step"])
        print(f"[resume] restored step {start_step}")

    step_fn = make_train_step(cfg, tcfg)
    straggler = StragglerMonitor(n_hosts=1)
    heartbeat = HeartbeatMonitor(n_hosts=1, timeout=3600)

    out = {"losses": [], "grad_norms": [], "lrs": [], "step_s": []}
    for i, host_batch in zip(range(start_step, steps), loader):
        b = {k: torch.as_tensor(v, device=dev) for k, v in host_batch.items()}
        if media is not None:
            b["media"] = media
        t0 = time.perf_counter()
        metrics = step_fn(state, b)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        straggler.record(0, dt)
        heartbeat.beat(0)
        out["losses"].append(loss)
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["lrs"].append(float(metrics["lr"]))
        out["step_s"].append(dt)
        if (i + 1) % log_every == 0:
            print(f"step {i+1:5d} loss {loss:8.4f} "
                  f"gnorm {out['grad_norms'][-1]:7.3f} "
                  f"lr {out['lrs'][-1]:.2e} {dt*1e3:7.1f} ms")
        if store and (i + 1) % ckpt_every == 0:
            store.save(i + 1, saved(state),
                       extras={"step": i + 1, "data": loader.state()},
                       blocking=False)
    if store:
        store.wait()
    return {**out, "state": state, "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = train(args.arch, smoke=args.smoke, steps=args.steps,
              batch=args.batch, seq=args.seq, lr=args.lr,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              resume=args.resume, device=args.device,
              accum_steps=args.accum_steps)
    losses = r["losses"]
    print(f"first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean loss {np.mean(losses[-10:]):.4f} on {r['device']}")
    return r


if __name__ == "__main__":
    main()
