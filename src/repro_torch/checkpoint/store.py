"""Checkpointing in the reference's on-disk layout: npz files, atomic
manifests, keep-k retention and an async writer.

Layout (the reference's ``checkpoint/store.py``):
    <dir>/step_000000123/
        shard_00000.npz          the tree's leaves, a0, a1, ... in leaf order
        manifest.json            key paths + dtypes + shapes + step + extras
    <dir>/LATEST                 atomic pointer (write tmp + rename)

A tree is nested dicts and lists of tensors (:mod:`repro_torch.tree`), its
leaves and key paths in the reference's order and naming, so a checkpoint
written by either package is read by the other.  A bf16 (or other type
numpy lacks) is stored as its raw bits and restored through the manifest's
dtype.  Restore places each tensor on the target device: the one-process
counterpart of the reference's reshard on load.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import keypaths, leaves, unflatten

#: the manifest's dtype names (numpy's, as the reference writes them)
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
          torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_TYPES = {name: dt for dt, name in _NAMES.items()}
#: types numpy lacks, stored as raw bits of their width
_RAW = {torch.bfloat16: (torch.int16, np.uint16)}


def _to_host(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().to("cpu", copy=True)   # a snapshot
    if t.dtype in _RAW:
        signed, unsigned = _RAW[t.dtype]
        return t.view(signed).numpy().view(unsigned)
    return t.numpy()


def _from_host(a: np.ndarray, name: str) -> torch.Tensor:
    dt = _TYPES[name]
    if dt in _RAW:
        return torch.from_numpy(a.view(np.int16).copy()).view(dt)
    return torch.from_numpy(np.array(a)).to(dt)   # keeps a 0-d shape


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, extras: Optional[dict] = None,
             blocking: bool = True) -> str:
        """Save a tree of tensors.  blocking=False -> a background write
        (the tree is first copied to host memory, so training can step)."""
        names = keypaths(tree)
        dtypes = [_NAMES[torch.as_tensor(x).dtype] for x in leaves(tree)]
        host = [_to_host(x) for x in leaves(tree)]
        if blocking:
            return self._write(step, names, host, dtypes, extras or {})
        self.wait()
        self._pending = threading.Thread(
            target=self._write, args=(step, names, host, dtypes, extras or {}),
            daemon=True,
        )
        self._pending.start()
        return self._step_dir(step)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def _write(self, step, names, host_arrays, dtypes, extras) -> str:
        with self._lock:
            d = self._step_dir(step)
            tmp = d + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_00000.npz"),
                     **{f"a{i}": a for i, a in enumerate(host_arrays)})
            manifest = {
                "step": step,
                "names": names,
                "dtypes": dtypes,
                "shapes": [list(a.shape) for a in host_arrays],
                "extras": extras,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(d):
                shutil.rmtree(d)
            os.rename(tmp, d)                      # atomic publish
            self._write_latest(step)
            self._gc()
            return d

    def _write_latest(self, step: int):
        tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(self.dir, "LATEST"))

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self):
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, n, "manifest.json")):
                    out.append(int(n[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if os.path.exists(p):
            with open(p) as f:
                s = int(f.read().strip())
            if os.path.exists(os.path.join(self._step_dir(s), "manifest.json")):
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device=None) -> tuple:
        """-> (tree, extras).  ``tree_like`` gives the structure; each
        tensor goes to ``device``, or where ``tree_like``'s leaf lies."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like = leaves(tree_like)
        if len(like) != len(manifest["dtypes"]):
            raise ValueError(f"checkpoint holds {len(manifest['dtypes'])} "
                             f"leaves, the tree {len(like)}")
        with np.load(os.path.join(d, "shard_00000.npz")) as data:
            placed = [
                _from_host(data[f"a{i}"], dt).to(
                    device if device is not None
                    else torch.as_tensor(x).device)
                for i, (dt, x) in enumerate(zip(manifest["dtypes"], like))]
        return unflatten(tree_like, placed), manifest["extras"]
