"""Synthetic deterministic data pipeline: corpus generation, sequence
packing, per-host sharded feeding.

Real deployments swap `SyntheticCorpus` for a tokenized dataset; everything
downstream (packing, batching, host sharding, prefetch) is dataset-agnostic.
Determinism: every sample is a pure function of (seed, index) so restarts
and elastic rescales reproduce the exact token stream (checkpointing stores
just the cursor).
"""
from __future__ import annotations

import dataclasses
import threading
import queue as _queue
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3          # heavy-tailed token distribution
    mean_doc_len: int = 512      # documents are packed into sequences
    pad_id: int = 0
    eod_id: int = 1


class SyntheticCorpus:
    """Deterministic infinite stream of variable-length 'documents'."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def doc(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, idx))
        n = max(8, int(rng.exponential(self.cfg.mean_doc_len)))
        toks = rng.zipf(self.cfg.zipf_a, size=n)
        toks = np.clip(toks + 1, 2, self.cfg.vocab_size - 1)  # 0/1 reserved
        return toks.astype(np.int32)


class PackedSequenceIterator:
    """Packs documents into fixed-length sequences with EOD separators.

    State = (doc cursor, carry buffer) — checkpointable via state()/restore().
    """

    def __init__(self, cfg: DataConfig, start_doc: int = 0):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg)
        self.cursor = start_doc
        self.carry = np.zeros(0, np.int32)

    def state(self) -> dict:
        return {"cursor": self.cursor, "carry": self.carry.tolist()}

    def restore(self, state: dict) -> None:
        self.cursor = int(state["cursor"])
        self.carry = np.asarray(state["carry"], np.int32)

    def next_sequence(self) -> np.ndarray:
        need = self.cfg.seq_len + 1  # +1 for the shifted labels
        buf = [self.carry]
        have = len(self.carry)
        while have < need:
            d = self.corpus.doc(self.cursor)
            self.cursor += 1
            buf.append(d)
            buf.append(np.array([self.cfg.eod_id], np.int32))
            have += len(d) + 1
        cat = np.concatenate(buf)
        self.carry = cat[need:]
        return cat[:need]


class HostDataLoader:
    """Feeds this host's shard of the global batch, with background prefetch.

    On a multi-host fleet each host owns global_batch / n_hosts rows (row
    assignment is by host id so the global stream is identical regardless of
    topology — elastic rescales re-partition rows, not content).
    """

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1,
                 prefetch: int = 2):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.rows = range(
            host_id * (cfg.global_batch // n_hosts),
            (host_id + 1) * (cfg.global_batch // n_hosts),
        )
        # one independent packed stream per batch row (deterministic)
        self.iters = {
            r: PackedSequenceIterator(
                dataclasses.replace(cfg, seed=cfg.seed + 7919 * r)
            )
            for r in self.rows
        }
        self.step = 0
        self._q: _queue.Queue = _queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def state(self) -> dict:
        return {"step": self.step,
                "iters": {r: it.state() for r, it in self.iters.items()}}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        for r, s in state["iters"].items():
            self.iters[int(r)].restore(s)

    def _make_batch(self) -> dict:
        rows = [self.iters[r].next_sequence() for r in self.rows]
        arr = np.stack(rows)                       # (local_B, S+1)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        self.step += 1
        return self._make_batch()

    # background prefetch (optional)
    def start_prefetch(self):
        def worker():
            while not self._stop.is_set():
                try:
                    self._q.put(self._make_batch(), timeout=0.2)
                except _queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_prefetched(self) -> dict:
        self.step += 1
        return self._q.get()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)


def device_put_batch(batch: dict, mesh, rules) -> dict:
    """Place a host batch onto the mesh with the batch sharding rules."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import placements

    out = {}
    for k, v in batch.items():
        axes = ("batch", "seq") if v.ndim == 2 else ("batch",) + (None,) * (v.ndim - 1)
        pl = placements(rules.pspec(axes, v.shape, mesh), mesh)
        v = torch.as_tensor(v).to(mesh.device_type)
        out[k] = distribute_tensor(v, mesh, pl, src_data_rank=None)
    return out
